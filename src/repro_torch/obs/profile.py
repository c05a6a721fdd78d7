"""Device-side profiling: kernel calls and walls, library builds, memory
watermarks (the port of ``repro.obs.profile``).

:class:`~repro_torch.obs.trace.QueryTrace` answers *what* a query did per
GAO level — est-vs-observed cardinality, kernel-path mix, scheduler
events.  :class:`DeviceProfile` answers *why a level got slow* one layer
down:

* **jit** — the JAX package's schema, kept key for key.  ``calls``
  counts the engine's level-step dispatches exactly as the reference
  does (one per interior chunk, one per final-level call).  The port is
  eager and compiles nothing per shape, so ``compiles`` and
  ``compile_events`` count the builds or loads of the CUDA kernel
  library (``kernels/build.py``, at most one per process), attributed
  like the reference's AOT compiles;
* **kernels** — a per-family wall breakdown (``intersect``,
  ``intersect_bitset``, ``segment_outer``) of the dispatches the engine
  performs anyway.  On the card the level loop does not wait for a chunk
  before enqueueing the next, so a host clock would time the enqueue
  only: each chunk is bracketed by a pair of CUDA events instead, read
  at the level boundary, where the loop already waits for the device.
  On the CPU, where the ops run as they are called, two
  ``perf_counter`` reads bracket it.  Either way the breakdown adds
  **no kernel launch, no tensor operation and no synchronisation**;
* **memory** — watermarks sampled at GAO level boundaries.  On the card
  they are the caching allocator's counters for the engine's device
  (``memory_allocated`` as live bytes, ``active.all.current`` as live
  buffers, ``max_memory_allocated`` as ``device_peak_bytes``): host-side
  reads, no sync.  On the CPU torch has no counterpart of
  ``jax.live_arrays()``, so a sample is counted and no byte count is
  invented (the byte fields stay 0 and ``device_peak_bytes`` ``None``);
* **workers** — per-worker drain seconds (kept for schema parity; the
  port has no worker pool yet);
* **compile events** — ``{"key", "wall_s", "attribution", "t"}``, the
  attribution being the label the quantum scheduler sets per slice
  (``sched-3/q2``).

The family ``segment_outer`` names the cursor's host ``segment_expand``
(``results/expand.py``, numpy), as the JAX package names the same hook;
it is not the segment outer product kernel (``csrc/segment_outer.cu``),
which no query path runs.

Off by default: every hook is ``prof = current_profile(); if prof is
None: <nothing>``.  Activation mirrors tracing — a contextvar, so the
scheduler and the cursor find the profile without signature threading.
:meth:`DeviceProfile.publish` pushes the harvest into a
:class:`~repro_torch.obs.trace.QueryTrace` (as spans) and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (as histograms and
counters) so one export surface carries all three layers.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import time

import torch

#: schema version stamped into every profile dict export.
PROFILE_SCHEMA_VERSION = 1

#: kernel families the wall breakdown buckets dispatches into.
KERNEL_FAMILIES = ("intersect", "intersect_bitset", "segment_outer")

_ACTIVE: contextvars.ContextVar["DeviceProfile | None"] = \
    contextvars.ContextVar("repro_torch_obs_active_profile", default=None)


def current_profile() -> "DeviceProfile | None":
    """The profile active in this context, or None (profiling disabled)."""
    return _ACTIVE.get()


class DeviceProfile:
    """One query execution's device-side resource accounting.

    All recording methods are plain host dict arithmetic; the recorders
    that touch the device are :meth:`kernel_mark` and
    :meth:`record_kernel_since` (a CUDA event recorded on the stream,
    which is no launch), :meth:`settle` (reads events the caller has
    already waited for) and :meth:`sample_memory` (allocator counters).

    Attributes:
        jit: ``{"compiles", "calls", "compile_wall_s"}`` — ``calls``
            counts every level-step dispatch; ``compiles`` counts builds
            or loads of the kernel library and ``compile_wall_s`` their
            summed wall seconds.
        kernels: family -> ``{"calls", "wall_s"}``; on the card the wall
            is event-timed device time between a chunk's first and last
            operation.
        memory: watermarks — ``peak_live_bytes`` / ``peak_live_buffers``
            over the samples taken at level boundaries, ``samples``, and
            ``device_peak_bytes`` (the allocator's peak; None on the
            CPU).
        compile_events: ``[{"key", "wall_s", "attribution", "t"}]``.
        worker_spans: ``[{"worker", "backend", "dur_s"}]``.
    """

    enabled = True

    def __init__(self, query_name: str = "", engine: str = ""):
        self.meta = {"query": query_name, "engine": engine,
                     "schema": PROFILE_SCHEMA_VERSION}
        self.jit = {"compiles": 0, "calls": 0, "compile_wall_s": 0.0}
        self.kernels: dict[str, dict] = {}
        self.memory = {"samples": 0, "peak_live_bytes": 0,
                       "peak_live_buffers": 0, "device_peak_bytes": None}
        self.compile_events: list[dict] = []
        self.worker_spans: list[dict] = []
        self.attribution: str | None = None
        # (family, start event, end event) brackets not yet read
        self._pending: list[tuple] = []
        self._t0 = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def _now(self) -> float:
        return round(time.perf_counter() - self._t0, 6)

    def set_meta(self, **kw) -> None:
        self.meta.update(kw)

    def record_jit_call(self, n: int = 1) -> None:
        self.jit["calls"] += n

    def record_compile(self, key: str, wall_s: float) -> None:
        """One build or load of the kernel library: ``key`` names it, the
        event carries the current :attr:`attribution`."""
        self.jit["compiles"] += 1
        self.jit["compile_wall_s"] += float(wall_s)
        self.compile_events.append(
            {"key": str(key), "wall_s": round(float(wall_s), 6),
             "attribution": self.attribution, "t": self._now()})

    def record_kernel(self, family: str, wall_s: float,
                      calls: int = 1) -> None:
        rec = self.kernels.setdefault(family, {"calls": 0, "wall_s": 0.0})
        rec["calls"] += calls
        rec["wall_s"] += float(wall_s)

    def kernel_mark(self, device: torch.device):
        """Open a kernel bracket on ``device``: a CUDA event recorded on
        its current stream, or the host clock on the CPU."""
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def record_kernel_since(self, family: str, mark,
                            device: torch.device) -> None:
        """Close a bracket that :meth:`kernel_mark` opened: one call of
        ``family``.  On the CPU its wall is recorded now; on the card an
        end event is recorded and the pair waits for :meth:`settle`.

        Each profile holds its own events, so brackets never pair across
        profiles, even when two threads profile queries on the same
        stream; a bracket then also spans what the other thread enqueued
        between its two events, as a host clock would."""
        if device.type != "cuda":
            self.record_kernel(family, time.perf_counter() - mark)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(device))
        self.record_kernel(family, 0.0)
        self._pending.append((family, mark, end))

    def settle(self) -> None:
        """Add the event-timed walls of the closed brackets.  The caller
        has already waited for the device past their end events (the
        level loop's copy of the frontier to the host), so reading them
        does not wait."""
        pending, self._pending = self._pending, []
        for family, start, end in pending:
            self.record_kernel(family, start.elapsed_time(end) / 1e3,
                               calls=0)

    def record_worker(self, worker: int, backend: str,
                      dur_s: float) -> None:
        self.worker_spans.append({"worker": int(worker), "backend": backend,
                                  "dur_s": round(float(dur_s), 6)})

    def sample_memory(self, device: torch.device) -> None:
        """Watermark sample at a GAO level boundary.

        On the card: the caching allocator's live bytes, live blocks and
        peak for ``device`` (host-side counters, no sync).  On the CPU
        the sample is counted and nothing else is recorded: torch keeps
        no registry of live CPU tensors."""
        mem = self.memory
        mem["samples"] += 1
        if device.type != "cuda":
            return
        live = torch.cuda.memory_allocated(device)
        blocks = torch.cuda.memory_stats(device).get("active.all.current", 0)
        mem["peak_live_bytes"] = max(mem["peak_live_bytes"], int(live))
        mem["peak_live_buffers"] = max(mem["peak_live_buffers"], int(blocks))
        peak = int(torch.cuda.max_memory_allocated(device))
        mem["device_peak_bytes"] = max(mem["device_peak_bytes"] or 0, peak)

    # -- context -------------------------------------------------------------
    @contextlib.contextmanager
    def activate(self):
        """Install as :func:`current_profile` for the block's duration."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def attribute(self, label: str):
        """Label compiles recorded in the block (scheduler: per-quantum
        ``sched-<job>/q<k>`` attribution).  Nests; restores on exit."""
        prev = self.attribution
        self.attribution = label
        try:
            yield self
        finally:
            self.attribution = prev

    # -- export --------------------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-serializable snapshot of the whole profile."""
        return {"meta": dict(self.meta),
                "jit": {**self.jit,
                        "compile_wall_s": round(self.jit["compile_wall_s"],
                                                6)},
                "kernels": {f: {"calls": r["calls"],
                                "wall_s": round(r["wall_s"], 6)}
                            for f, r in sorted(self.kernels.items())},
                "memory": dict(self.memory),
                "compile_events": list(self.compile_events),
                "worker_spans": list(self.worker_spans)}

    def publish(self, trace=None, registry=None) -> None:
        """Push the harvest into the other observability surfaces.

        ``trace``: one ``profile/jit`` span (compile counts + wall) and
        one ``profile/kernel/<family>`` span per family, plus the memory
        watermark on the trace summary.  ``registry``: histograms
        ``profile_compile_seconds`` and ``profile_kernel_seconds{
        family=...}``, counter ``profile_jit_calls``, gauge
        ``profile_peak_live_bytes``.
        """
        if trace is not None:
            trace.spans.append({
                "name": "profile/jit", "t": 0.0,
                "compiles": self.jit["compiles"],
                "calls": self.jit["calls"],
                "dur_s": round(self.jit["compile_wall_s"], 6)})
            for fam, rec in sorted(self.kernels.items()):
                trace.spans.append({
                    "name": f"profile/kernel/{fam}", "t": 0.0,
                    "calls": rec["calls"],
                    "dur_s": round(rec["wall_s"], 6)})
            if self.memory["samples"]:
                trace.summary.setdefault(
                    "peak_live_bytes", self.memory["peak_live_bytes"])
        if registry is not None:
            for ev in self.compile_events:
                registry.histogram("profile_compile_seconds").observe(
                    ev["wall_s"])
            for fam, rec in self.kernels.items():
                registry.histogram("profile_kernel_seconds",
                                   family=fam).observe(rec["wall_s"])
            if self.jit["calls"]:
                registry.counter("profile_jit_calls").inc(self.jit["calls"])
            if self.memory["samples"]:
                g = registry.gauge("profile_peak_live_bytes")
                g.set(max(g.value, self.memory["peak_live_bytes"]))

    # -- derived views -------------------------------------------------------
    def kernel_wall_s(self, family: str | None = None) -> float:
        if family is not None:
            return self.kernels.get(family, {}).get("wall_s", 0.0)
        return math.fsum(r["wall_s"] for r in self.kernels.values())


class NullProfile:
    """Disabled profile: every recorder is a no-op.  Never installed as
    the context's profile — ``current_profile() is None`` is the normal
    disabled-path check — but code handed a profile directly can take
    this instead of branching on None."""

    enabled = False
    attribution = None

    def set_meta(self, **kw):
        pass

    def record_jit_call(self, n=1):
        pass

    def record_compile(self, key, wall_s):
        pass

    def record_kernel(self, family, wall_s, calls=1):
        pass

    def kernel_mark(self, device):
        return None

    def record_kernel_since(self, family, mark, device):
        pass

    def settle(self):
        pass

    def record_worker(self, worker, backend, dur_s):
        pass

    def sample_memory(self, device=None):
        pass

    @contextlib.contextmanager
    def activate(self):
        yield self

    @contextlib.contextmanager
    def attribute(self, label):
        yield self

    def publish(self, trace=None, registry=None):
        pass

    def to_dict(self):
        return {}


NULL_PROFILE = NullProfile()
