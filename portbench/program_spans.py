"""The program's own spans (``repro_torch.obs.SpanLog``), for the
readers of the ``program_span`` metrics.

The harness sees the program only through the calls it makes into it
(``submit`` and ``step``).  What the program did inside them is in its
process span log.  A reader of a program span metric opens that log when
the harness loads the reader (``open_log`` at import), which is before
the cell's graph is made, and only in a traced run: a ``--trace 0`` run
loads no per-layer reader and so opens no log.  Each run of a cell loads
its readers anew and so opens a log of its own, closing one that an
earlier run left open.  When the reader is
called, after the window, ``take`` closes the log and returns the
records from the window's opening on.  A program without the span log
gives no records, and its readers None.

``take`` also names the harness's spans by the program's, once a run:
each harness span is cut where a program span inside it starts or ends,
and each piece is labelled ``<harness label>><innermost program
span>[:<key>]``.  The idle gaps of the breakdown, which the harness
names by its spans after the readers have run, then say what the program
was doing (``step:4-path>graph.copy:indices``); a piece with no program
span in it keeps the harness label alone.
"""
from __future__ import annotations

import bisect

_log = None


def open_log():
    """Open a new span log of the program, first closing one that an
    earlier run left open (it failed before its readers ran); None where
    the program has none."""
    global _log
    try:
        from repro_torch.obs import SpanLog
    except ImportError:
        return None
    if _log is not None:
        _log.close()
    _log = SpanLog().open()
    return _log


def take(run) -> list:
    """The closed records that start at or after the window's opening
    (none without a log); names the run's harness spans by them."""
    if _log is None:
        return []
    _log.close()
    t_open = int(run.t_open * 1e9)
    recs = [r for r in _log.records
            if r.end_ns is not None and r.start_ns >= t_open]
    if run.spans is not None and not getattr(run.spans, "program_labels",
                                             False):
        run.spans.items[:] = label_pieces(run.spans.items, recs)
        run.spans.program_labels = True
    return recs


def window_end_ns(run) -> float:
    """The last reply due in the window: the trace's end where the run
    was traced, else the latest reply."""
    if run.timeline is not None:
        return run.timeline.t_end
    done = [r.t_done for r in run.requests if r.t_done is not None]
    return max(done) * 1e9 if done else run.t_close * 1e9


def union_s(recs: list, start_ns: float, end_ns: float) -> float:
    """Seconds covered by at least one of ``recs``, inside
    ``[start_ns, end_ns]``."""
    total, last = 0, start_ns
    for r in sorted(recs, key=lambda r: r.start_ns):
        s, e = max(r.start_ns, last), min(r.end_ns, end_ns)
        if e > s:
            total += e - s
            last = e
    return total / 1e9


def _label(rec, by_id: dict) -> str:
    """``name`` and, where it or a span around it has one, ``:key``."""
    node = rec
    while node is not None:
        if "key" in node.attrs:
            return f"{rec.name}:{node.attrs['key']}"
        node = by_id.get(node.parent)
    return rec.name


def label_pieces(items: list, recs: list) -> list:
    """``items`` (the harness's ``(label, start_ns, end_ns)``) cut at the
    program spans that start inside each, each piece labelled by the
    innermost program span over it."""
    by_id = {r.id: r for r in recs}
    recs = sorted(recs, key=lambda r: r.start_ns)
    starts = [r.start_ns for r in recs]
    out = []
    for label, s, e in items:
        inside = recs[bisect.bisect_left(starts, s):
                      bisect.bisect_left(starts, e)]
        cuts = sorted({s, e} | {min(max(t, s), e) for r in inside
                                 for t in (r.start_ns, r.end_ns)})
        pieces: list[list] = []
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            over = [r for r in inside if r.start_ns <= mid < r.end_ns]
            name = label
            if over:
                inner = max(over, key=lambda r: r.start_ns)
                name = f"{label}>{_label(inner, by_id)}"
            if pieces and pieces[-1][0] == name:
                pieces[-1][2] = b
            else:
                pieces.append([name, a, b])
        out += [tuple(p) for p in pieces] or [(label, s, e)]
    return out
