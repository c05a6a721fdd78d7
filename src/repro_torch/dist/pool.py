"""A real worker pool for the partitioned join (the port of
``repro.dist.pool``).

One ``concurrent.futures`` worker per alive schedule entry, each
draining its owned parts **in schedule order**, so the deterministic
deal from :func:`repro_torch.train.stragglers.reassign_shards` is
preserved exactly and a re-run assigns every part to the same worker.

Backend selection follows payload picklability: a task whose function
and arguments survive ``pickle`` and carry no tensor can cross a
process boundary and gets a ``spawn``-context
:class:`~concurrent.futures.ProcessPoolExecutor` (``fork`` is unsafe
once CUDA or the kernel library is initialized); anything holding a
``torch.Tensor`` stays in threads.  The join workloads are in the second
camp, and that is the right call on the card: a part's kernels and
copies release the GIL, so threads overlap one part's host work with
another's device work while sharing one kernel library.
"""
from __future__ import annotations

import io
import pickle
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Sequence

import torch


class _DeviceState(Exception):
    """Raised mid-pickle when the payload holds a tensor."""


def pick_backend(fn: Callable, sample_arg=None) -> str:
    """'process' when ``(fn, sample_arg)`` can *usefully* cross a process
    boundary: it pickles and carries no ``torch.Tensor``.

    A tensor pickles (a CPU one as it is, a CUDA one through a host
    copy), but shipping one to a spawned worker re-stages the graph and
    the executor there — strictly worse than a thread sharing them.  So
    any tensor votes 'thread', even on the CPU, as the JAX package votes
    for any ``jax.Array``."""

    class _Probe(pickle.Pickler):
        def reducer_override(self, obj):
            if isinstance(obj, torch.Tensor):
                raise _DeviceState
            return NotImplemented

    try:
        _Probe(io.BytesIO(), protocol=5).dump((fn, sample_arg))
        return "process"
    except Exception:
        return "thread"


def _drain(fn: Callable, owned: list[int], parts: Sequence) -> list[tuple]:
    """Run one worker's parts in schedule order; (pid, result, seconds)."""
    out = []
    for pid in owned:
        t0 = time.perf_counter()
        res = fn(parts[pid])
        out.append((pid, res, time.perf_counter() - t0))
    return out


class WorkerPool:
    """Deterministic-schedule pool over ``concurrent.futures``.

    ``schedule`` maps worker id -> owned part ids (the
    ``reassign_shards`` output — dead workers simply have no entry).
    :meth:`run` executes ``fn(parts[pid])`` for every scheduled part,
    one concurrent worker per schedule entry, and returns
    ``(part_results, part_time, wall_time, backend)`` where
    ``part_time`` holds each part's own execution seconds (the quantity
    the makespan stats aggregate — pool overhead shows up in
    ``wall_time``, not in the schedule accounting) and ``backend`` is
    what actually ran ('sequential' whenever <= 1 worker is alive, no
    matter what was requested).

    ``backend``: 'thread', 'process', 'sequential', or 'auto' (decide
    per :func:`pick_backend` on the first scheduled part).
    """

    def __init__(self, schedule: dict[int, list[int]],
                 backend: str = "auto"):
        if backend not in ("auto", "thread", "process", "sequential"):
            raise ValueError(f"unknown pool backend {backend!r}")
        self.schedule = {w: list(o) for w, o in schedule.items()}
        self.backend = backend

    def run(self, fn: Callable, parts: Sequence
            ) -> tuple[dict[int, object], dict[int, float], float, str]:
        n_parts = len(parts)
        workers = [(w, [p for p in owned if p < n_parts])
                   for w, owned in sorted(self.schedule.items())]
        workers = [(w, owned) for w, owned in workers if owned]
        backend = self.backend
        if backend == "auto":
            first = workers[0][1][0] if workers else None
            backend = (pick_backend(fn, parts[first])
                       if first is not None else "thread")
        # resolve the device profile in the *calling* thread: pool
        # workers run in other threads/processes and contextvars do not
        # cross that boundary, so per-worker spans are recorded here
        # from the drain timings the pool returns anyway
        from ..obs.profile import current_profile
        prof = current_profile()
        t0 = time.perf_counter()
        results: dict[int, object] = {}
        part_time: dict[int, float] = {}
        if backend == "sequential" or len(workers) <= 1:
            # <=1 alive worker: no pool exists, report what actually ran
            for _w, owned in workers:
                for pid, res, dt in _drain(fn, owned, parts):
                    results[pid] = res
                    part_time[pid] = dt
            self._observe(part_time, workers, "sequential", prof)
            return results, part_time, time.perf_counter() - t0, "sequential"
        pool_cls = (ProcessPoolExecutor if backend == "process"
                    else ThreadPoolExecutor)
        kw = {}
        if backend == "process":
            import multiprocessing as mp
            kw["mp_context"] = mp.get_context("spawn")
        with pool_cls(max_workers=len(workers), **kw) as pool:
            futs = {pool.submit(_drain, fn, owned, parts): w
                    for w, owned in workers}
            for fut in futs:
                for pid, res, dt in fut.result():
                    results[pid] = res
                    part_time[pid] = dt
        self._observe(part_time, workers, backend, prof)
        return results, part_time, time.perf_counter() - t0, backend

    @staticmethod
    def _observe(part_time: dict[int, float],
                 workers: list[tuple[int, list[int]]], backend: str,
                 prof=None) -> None:
        """Record per-worker makespans into the process metrics registry
        (and, when a device profile is active, per-worker spans)."""
        from ..obs import get_registry
        hist = get_registry().histogram("pool_worker_seconds",
                                        backend=backend)
        for w, owned in workers:
            seconds = sum(part_time.get(p, 0.0) for p in owned)
            hist.observe(seconds)
            if prof is not None:
                prof.record_worker(w, backend, seconds)
