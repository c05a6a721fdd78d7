"""``acyclic_latency_p95_s``: the 95th percentile of the seconds from a
request's due time (its client's previous reply) to its reply, over
every request due in the window, those answered after the close too
(host clock)."""
from portbench.measure import answered, percentile


def read(run):
    lat = [r.t_done - r.t_due for r in answered(run)]
    return percentile(lat, 95) if lat else None
