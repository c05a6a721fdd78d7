"""The traced run's device timeline and the host spans beside it.

``torch.profiler`` traces the device only (CUPTI activity: kernels,
copies, fills); tracing the host's operators as well would record every
PyTorch call of the program's host-paced level loop and slow the very
path the idle share measures.  The host's side is the harness's own
spans (``Spans``), one around each call it makes into the server.  The
two clocks are tied by a marker: a short spin kernel launched at the
opening of the window, whose device start is set against the host time
of its launch (a few microseconds late, which is below the idle gaps
this is used to name).
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

MARKER_KERNEL = "spin_kernel"       # the kernel torch.cuda._sleep launches


class Spans:
    """What the host was doing: ``(label, start_ns, end_ns)`` in memory,
    on ``time.perf_counter_ns``'s clock."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    def span(self, label: str):
        return _Span(self, label)


class _Span:
    __slots__ = ("spans", "label", "t0")

    def __init__(self, spans: Spans, label: str):
        self.spans, self.label = spans, label

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.spans.items.append((self.label, self.t0,
                                 time.perf_counter_ns()))


@dataclass
class Timeline:
    """Device events of the traced window, on the host clock (ns)."""

    events: list[tuple[str, int, int]] = field(default_factory=list)
    t_open: int = 0
    t_close: int = 0
    t_end: int = 0           # the last reply due in the window
    aligned: bool = False

    def in_window(self, to_end: bool = False):
        """Events clipped to the window (``to_end``: to the last reply
        due in it)."""
        close = self.t_end if to_end else self.t_close
        for name, s, e in self.events:
            if e > self.t_open and s < close:
                yield name, max(s, self.t_open), min(e, close)

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _n, s, e in sorted(self.in_window(), key=lambda x: x[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        return (self.t_close - self.t_open) / 1e9

    def device_s(self, match) -> tuple[float, int]:
        """Seconds and launches of the events whose name ``match``
        accepts, from the opening to the last reply due in the window."""
        total, n = 0, 0
        for name, s, e in self.in_window(to_end=True):
            if match(name):
                total += e - s
                n += 1
        return total / 1e9, n

    def top_ops(self, k: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for name, s, e in self.in_window():
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda x: -x[1])[:k]
        return [[name[:200], t / 1e9] for name, t in top]

    def idle_gaps(self, spans: Spans, k: int = 10) -> list[list]:
        """The ``k`` longest stretches with nothing on the device, each
        named by the host span around its middle."""
        gaps, last = [], self.t_open
        for s, e in self.busy_intervals():
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.t_close > last:
            gaps.append((last, self.t_close))
        items = sorted(spans.items, key=lambda x: x[1])
        starts = [x[1] for x in items]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = "harness"
            if i >= 0 and items[i][2] >= mid:
                label = items[i][0]
            if not self.aligned:
                label = "unaligned:" + label
            out.append([label, (e - s) / 1e9])
        return out


class DeviceTrace:
    """``torch.profiler`` over the device, opened and closed by hand
    around the measured window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.marker_host = 0

    def open(self) -> None:
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def close(self, t_open: int, t_close: int, t_end: int) -> Timeline:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        raw = self.prof.profiler.kineto_results.events()
        from torch.autograd import DeviceType
        events, names, marker = [], {}, None
        for e in raw:
            if e.device_type() == DeviceType.CPU:
                continue
            name = e.name()
            if name not in names:
                names[name] = torch._C._demangle(name) if len(name) > 1 \
                    else name
            s = e.start_ns()
            if MARKER_KERNEL in name:
                marker = s if marker is None else min(marker, s)
                continue
            events.append((names[name], s, s + e.duration_ns()))
        tl = Timeline(t_open=t_open, t_close=t_close, t_end=t_end)
        if marker is not None:
            off = marker - self.marker_host
            tl.aligned = True
        elif events:
            off = min(s for _n, s, _e in events) - t_open
        else:
            off = 0
        tl.events = [(n, s - off, e - off) for n, s, e in events]
        return tl
