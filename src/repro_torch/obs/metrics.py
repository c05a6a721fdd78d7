"""Process-wide metrics registry: counters, gauges, histograms with labels
(a copy of ``repro.obs.metrics``).

The repo's subsystems each kept private ad-hoc tallies — the plan cache
its hit/miss integers, the cursor registry its closed-reason dict, the
quantum scheduler its quanta/restart counters, the worker pool its
makespans — with no common schema or export.  :class:`MetricsRegistry`
absorbs them behind one API in the Prometheus mold:

* :class:`Counter` — monotonically increasing (``inc``);
* :class:`Gauge` — last-write-wins level (``set``/``inc``/``dec``);
* :class:`Histogram` — bucketed distribution (``observe``) with
  ``sum``/``count``/``min``/``max``, for latencies and makespans.

Metrics are identified by ``(name, labels)`` — ``registry.counter(
"cursor_closed", reason="evicted")`` and ``reason="exhausted"`` are two
series of one metric family.  Everything is plain host-side dict
arithmetic: instrumentation adds no device work, and a hot loop that
increments a pre-bound handle pays one integer add.

``get_registry()`` returns the process-wide default registry (what
:meth:`repro_torch.serve.QueryServer.metrics` snapshots); construct private
registries for isolation (tests, per-deployment export).  The full
metrics catalog lives in ``docs/OBSERVABILITY.md``.
"""
from __future__ import annotations

import threading

#: default histogram buckets (seconds-flavoured, but unit-agnostic):
#: powers of ~4 from 1ms to ~1min plus +inf.
DEFAULT_BUCKETS = (0.001, 0.004, 0.016, 0.064, 0.256, 1.024, 4.096,
                   16.384, 65.536, float("inf"))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` by any non-negative amount."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins level (queue depths, open cursors, bytes parked)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Bucketed distribution with cumulative bucket counts.

    ``snapshot()`` returns ``{"count", "sum", "min", "max", "buckets"}``
    where ``buckets`` maps each upper bound to the cumulative count of
    observations ``<=`` it (the Prometheus convention, so series diff
    cleanly across scrapes).
    """

    __slots__ = ("name", "labels", "buckets", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, name: str, labels: dict,
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.labels = labels
        self.buckets = tuple(buckets)
        if not self.buckets or self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1

    @staticmethod
    def _le(ub: float) -> str:
        """Prometheus ``le`` label text for an upper bound — explicit
        ``"+Inf"`` for the terminal bucket (scrapers require it; a float
        ``inf`` key would also render as non-standard JSON)."""
        return "+Inf" if ub == float("inf") else f"{ub:g}"

    def snapshot(self):
        """JSON-safe summary.  ``buckets`` maps the ``le`` label text
        (``"0.064"``, …, always ending in ``"+Inf"``) to the cumulative
        count of observations ``<=`` that bound; the ``+Inf`` bucket
        always equals ``count`` (the cumulative invariant —
        ``tests/test_obs.py``)."""
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {self._le(ub): c
                            for ub, c in zip(self.buckets, self.counts)}}


class MetricsRegistry:
    """Thread-safe registry of labelled metrics with one snapshot API.

    ``counter``/``gauge``/``histogram`` return the live handle for the
    ``(name, labels)`` series, creating it on first use — bind the
    handle once outside a loop and ``inc`` inside it.  ``snapshot()``
    renders every series as ``"name{k=v,...}" -> value`` (histograms:
    their summary dict); ``reset()`` forgets everything (tests).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (cls.__name__, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, **kw)
                self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, buckets: tuple[float, ...] | None = None,
                  **labels) -> Histogram:
        kw = {} if buckets is None else {"buckets": tuple(buckets)}
        return self._get(Histogram, name, labels, **kw)

    @staticmethod
    def _series_name(name: str, labels: dict) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}}"

    def snapshot(self) -> dict:
        """Point-in-time flat view of every series — JSON-serializable.

        Counters and gauges render as ``"name{k=v,...}" -> value``;
        histograms flatten Prometheus-style into ``name_count`` /
        ``name_sum`` / ``name_min`` / ``name_max`` plus cumulative
        ``name_bucket{le=...}`` series (``le=+Inf`` always present).
        """
        out: dict = {}
        with self._lock:
            for m in self._metrics.values():
                if not isinstance(m, Histogram):
                    out[self._series_name(m.name, m.labels)] = m.snapshot()
                    continue
                s = m.snapshot()
                for stat in ("count", "sum", "min", "max"):
                    out[self._series_name(f"{m.name}_{stat}",
                                          m.labels)] = s[stat]
                for le, c in s["buckets"].items():
                    out[self._series_name(f"{m.name}_bucket",
                                          {**m.labels, "le": le})] = c
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)


#: the process-wide default registry (``QueryServer.metrics()`` snapshots
#: this one unless the server was built with a private registry).
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT
