"""``server_host_ms``: the host milliseconds a request spends in the
scheduler's ``submit`` (sampling, statistics, plan, verification and
admission: the ``sched.submit`` program span), as the mean over the
submits that start in the window."""
from portbench import program_spans

program_spans.open_log()


def read(run):
    t_open, t_close = run.t_open * 1e9, run.t_close * 1e9
    subs = [r.end_ns - r.start_ns for r in program_spans.take(run)
            if r.name == "sched.submit" and t_open <= r.start_ns < t_close]
    return sum(subs) / len(subs) / 1e6 if subs else None
