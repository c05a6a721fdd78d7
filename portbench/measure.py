"""What the metric readers share: the run's record and the arithmetic
over it.  A reader (``metrics/<name>.py``) defines ``read(run)``, which
returns the metric's value, or None where the run holds nothing for it
to read (the harness then leaves the metric out of the line)."""
from __future__ import annotations

from dataclasses import dataclass, field

from .trace import Spans, Timeline


@dataclass
class Run:
    """One run of one cell, as the readers see it.  Times are
    ``time.perf_counter`` seconds; the trace is on the same clock in
    nanoseconds."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    t_open: float
    t_close: float
    setup_s: float
    requests: list                         # traffic.Request, due in the window
    graph: dict                            # n_nodes, n_entries of the graph served
    warm_samples: list[int] = field(default_factory=list)
    #: ``torch.cuda.memory_allocated`` at the opening and once the
    #: window has drained (None off the card)
    memory: dict = field(default_factory=dict)
    timeline: Timeline | None = None
    spans: Spans | None = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def credited(run: Run) -> float:
    """Requests served in the window: each one completed inside it
    counts 1, and one still in flight at the close counts the share of
    its time (from due to reply) that lay inside the window."""
    total = 0.0
    for r in run.requests:
        if r.t_done is None or r.error is not None:
            continue
        if r.t_done <= run.t_close:
            total += 1.0
        elif r.t_done > r.t_due:
            total += (run.t_close - r.t_due) / (r.t_done - r.t_due)
    return total


def answered(run: Run) -> list:
    """The requests due in the window that got an answer."""
    return [r for r in run.requests
            if r.t_done is not None and r.error is None]


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the two nearest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def is_spmv_scatter(name: str) -> bool:
    """``index_add_``'s kernels."""
    return "indexFunc" in name


def is_spmv_gather(name: str) -> bool:
    """Advanced indexing's gather kernels (``x[indices]``)."""
    return "index_elementwise_kernel" in name or "vectorized_gather" in name


def fresh_samples(run: Run) -> set[int]:
    """The sample seeds that requests of the window brought and set-up
    did not warm: the server built a warm graph for each in the window."""
    return {r.sample_seed for r in run.requests
            if r.error is None} - set(run.warm_samples)


def idle_share(run: Run) -> float | None:
    """Percent of the window with nothing on the device."""
    if run.timeline is None or not run.timeline.events:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s() / run.timeline.window_s())
