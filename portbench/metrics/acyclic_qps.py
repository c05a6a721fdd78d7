"""``acyclic_qps`` (and ``acyclic_qps.<cells>``): acyclic requests
served a second over the window (host clock), whatever each one did
(a message over the graph, or first a new sample's warm graph); a
request in flight at the close counts the share of its time that lay
inside the window."""
from portbench.measure import credited


def read(run):
    return credited(run) / run.window_s
