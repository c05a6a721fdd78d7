"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the plain reference, and the result's line.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic in ``portbench/mixes/<traffic>.json`` and each metric's reader
in ``portbench/metrics/<metric>.py``; a quantity split by cells
(``<name>.<part>``, one name for each end-to-end metric it moves) is
read by ``portbench/metrics/<name>.py`` unless a reader of the full name
exists.  Nothing here is specific to one cell.

The system under test is ``repro_torch``'s query server behind its
quantum scheduler: the harness hands it the graph it made, submits the
mix's requests, steps the scheduler, and takes only its answers and
their engine labels.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import graphs, reference, traffic
from .measure import Run
from .queries import pattern
from .trace import DeviceTrace, Spans

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules the run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: how long past the close the harness waits for replies still due
DRAIN_S = 60.0
#: the largest log2 an int64 count or partial sum may reach
INT64_LOG2_LIMIT = 62.0


class SpecError(RuntimeError):
    """The benchmark's files do not define the cell asked for."""


class Bench:
    """``BENCHMARK.json`` and the benchmark's data files under ``root``."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise SpecError(f"no BENCHMARK.json under {self.root}")
        self.spec = json.loads(path.read_text())
        self.data = self.root / "portbench"

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise SpecError(f"no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._named("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, name: str) -> dict:
        path = self.data / "mixes" / f"{name}.json"
        if not path.exists():
            raise SpecError(f"no mix file {path}")
        return traffic.check_mix(json.loads(path.read_text()))

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.data / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.data / "metrics" / f"{metric.split('.')[0]}.py"
        if not path.exists():
            raise SpecError(f"no reader for {metric!r} under "
                            f"{self.data / 'metrics'}")
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def subseed(seed: int, k: int) -> int:
    """A 32-bit seed for part ``k`` of the run, drawn from ``seed``."""
    return int(np.random.SeedSequence([seed % (1 << 64), k])
               .generate_state(1)[0])


def deep_update(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = (deep_update(out[k], v)
                  if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Served:
    """The system under test: the query server behind its quantum
    scheduler, one tenant a client."""

    def __init__(self, csr, config: dict, mix: dict, device: str):
        from repro_torch.serve import (QuantumScheduler, QueryServer,
                                       TenantQuota)
        self.mix = mix
        self.server = QueryServer(csr, device=device,
                                  **config.get("server", {}))
        sc = config["scheduler"]
        self.sched = QuantumScheduler(
            self.server, quantum_rows=sc["quantum_rows"],
            default_quota=TenantQuota(
                max_frontier_bytes=sc["max_frontier_bytes"]))

    def request(self, r: traffic.Request):
        from repro_torch.serve import QueryRequest
        return QueryRequest(r.shape, selectivity=self.mix["selectivity"],
                            seed=r.sample_seed, engine=self.mix["engine"],
                            tenant=f"client{r.client}")

    def submit(self, r: traffic.Request):
        """Submit ``r``; returns the scheduler's job for it.  The
        scheduler offers no public lookup of a job's result by the token
        ``submit`` returns, so the job is found in its list and held to
        that token."""
        token = self.sched.submit(self.request(r))
        job = self.sched._jobs[-1]
        if job.token != token:
            raise RuntimeError(f"submitted {token}, found {job.token}")
        return job

    @staticmethod
    def record(r: traffic.Request, res, t_done: float) -> None:
        r.t_done = t_done
        if res.engine == "rejected":
            r.error = str(res.stats.get("error"))
            return
        r.count, r.engine = int(res.count), res.engine

    def warm(self, shapes: list[str], samples: list[int]) -> None:
        """Every shape once on every warm sample, through the scheduler:
        plans, verification, device tensors, the kernel library and the
        allocator's blocks are ready before the window."""
        for i, (p, s) in enumerate((p, s) for p in samples for s in shapes):
            self.sched.submit(self.request(traffic.Request(i, s, p)))
        bad = [r.stats.get("error") for r in self.sched.run()
               if r.engine == "rejected"]
        if bad:
            raise RuntimeError(f"warm-up rejected: {bad}")

    def serve(self, streams, t_open, t_close, spans, reqs) -> None:
        """Every client sends when its reply arrives, until the close;
        then the scheduler drains what is in flight."""
        from repro_torch.serve import AdmissionError
        inflight: list = []
        waiting: list[int] = []

        def send(client: int, now: float) -> None:
            r = streams[client].next()
            r.t_due = now
            reqs.append(r)
            try:
                with spans.span(f"submit:{r.shape}"):
                    job = self.submit(r)
            except AdmissionError as e:
                r.t_done, r.error = now, str(e)
                waiting.append(client)
                return
            inflight.append((r, job))

        for c in range(len(streams)):
            send(c, t_open)
        while inflight:
            now = time.perf_counter()
            if now > t_close + DRAIN_S:
                break
            # the acyclic jobs run whole in one quantum, first in first
            # out, so the oldest request in flight is the one stepped
            with spans.span(f"step:{inflight[0][0].shape}"):
                self.sched.step()
            now = time.perf_counter()
            still, ready = [], waiting[:]
            waiting.clear()
            for r, job in inflight:
                if job.result is None:
                    still.append((r, job))
                    continue
                self.record(r, job.result, now)
                ready.append(r.client)
            inflight[:] = still
            if now < t_close:
                for c in ready:
                    send(c, now)


def allocated(device: str) -> int | None:
    """Bytes the caching allocator holds for tensors, once the device
    has finished its work; None off the card."""
    if device != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judge(reqs: list, ref_counts: dict, peak_log2: float) -> dict:
    """The numbers compared, each with its limit."""
    answered = [r for r in reqs if r.t_done is not None and r.error is None]
    wrong = sum(1 for r in answered
                if r.count != ref_counts[(r.shape, r.sample_seed)])
    return {"wrong_counts": {"value": wrong, "limit": 0},
            "unanswered": {"value": len(reqs) - len(answered), "limit": 0},
            "count_log2_peak": {"value": peak_log2,
                                "limit": INT64_LOG2_LIMIT}}


def reference_counts(indptr, indices, mix: dict, reqs: list, device,
                     dtype=torch.int64) -> tuple[dict, float]:
    """The plain reference's count of every (shape, sample seed) that an
    answered request asked for, and the largest log2 peak."""
    g = reference.RefGraph(indptr, indices, device)
    keys = sorted({(r.shape, r.sample_seed) for r in reqs})
    counts, peak, samples = {}, 0.0, {}
    for shape, sample in keys:
        if sample not in samples:
            samples[sample] = graphs.request_samples(
                g.n, mix["selectivity"], sample)
        counts[(shape, sample)], p = reference.count(
            g, pattern(shape), samples[sample], dtype)
        peak = max(peak, p)
    return counts, peak


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             config_override: dict | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """Run ``workload`` once; returns ``(result, checks)`` (the result's
    line without its checks).  With ``control`` the result also holds
    ``control``: the checks of each control put in the program's place
    (``control.py``)."""
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    if config_override:
        config = deep_update(config, config_override)
    mix = bench.mix(cell["traffic"])
    metrics = bench.metrics(workload, trace)
    readers = {m["name"]: bench.reader(m["name"]) for m in metrics}

    from repro_torch.graphs.csr import CSRGraph

    t_graph = time.perf_counter()
    indptr, indices = graphs.make_graph(config["graph"], subseed(seed, 0),
                                        device)
    n = int(indptr.shape[0] - 1)
    if device == "cuda":
        torch.cuda.empty_cache()
    graph = {"n_nodes": n, "n_entries": int(indices.shape[0]),
             "max_degree": int(np.diff(indptr).max())}
    log(f"graph {json.dumps(graph)}")
    served = Served(CSRGraph(indptr=indptr, indices=indices, n_nodes=n),
                    config, mix, device)
    streams, warm = traffic.streams(mix, subseed(seed, 1))
    t_warm = time.perf_counter()
    served.warm(mix["shapes"], warm)
    if device == "cuda":
        torch.cuda.synchronize()
    t_ready = time.perf_counter()
    log(f"setup parts: start {t_graph - t_start:.3f} s, graph "
        f"{t_warm - t_graph:.3f} s, warm-up {t_ready - t_warm:.3f} s")

    spans, reqs = Spans(), []
    tracer = DeviceTrace() if trace and device == "cuda" else None
    if tracer is not None:
        tracer.open()
    memory = {"open": allocated(device)}
    t_open = time.perf_counter()
    t_close = t_open + seconds
    served.serve(streams, t_open, t_close, spans, reqs)
    t_end = time.perf_counter()
    memory["end"] = allocated(device)
    timeline = None
    if tracer is not None:
        timeline = tracer.close(int(t_open * 1e9), int(t_close * 1e9),
                                int(t_end * 1e9))
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)

    engines: dict[str, dict[str, int]] = {}
    for r in reqs:
        if r.engine is not None:
            by = engines.setdefault(r.shape, {})
            by[r.engine] = by.get(r.engine, 0) + 1
    log(f"engines {json.dumps(engines, sort_keys=True)}")
    log(f"window {seconds} s: {len(reqs)} requests due, drained "
        f"{t_end - t_close:.3f} s past the close")

    del served
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    answered = [r for r in reqs if r.t_done is not None and r.error is None]
    ref, peak = reference_counts(indptr, indices, mix, answered, device)
    checks = judge(reqs, ref, peak)
    control_checks = None
    if control:
        low, low_peak = reference_counts(indptr, indices, mix, answered,
                                         device, dtype=torch.float32)
        for r in answered:
            r.count = low[(r.shape, r.sample_seed)]
        control_checks = {"float32": judge(reqs, ref, low_peak)}

    run = Run(cell=cell, config=config, mix=mix, seed=seed, t_open=t_open,
              t_close=t_close, setup_s=t_open - t_start, requests=reqs,
              graph=graph, warm_samples=warm, memory=memory, timeline=timeline,
              spans=spans)
    out_metrics = {}
    for m in metrics:
        value = readers[m["name"]](run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()) and bool(answered),
              "attempted": len(reqs),
              "failed": checks["unanswered"]["value"],
              "metrics": out_metrics, "device": dev}
    if control_checks is not None:
        result["control"] = control_checks
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s()
        dev["window_s"] = timeline.window_s()
        result["breakdown"] = {"device_ops": timeline.top_ops(),
                               "idle_gaps": timeline.idle_gaps(spans)}
    return result, checks


def finish(result: dict, checks: dict) -> int:
    """Print the checks and the result's line; 0, or 3 where the
    process holds JAX or the JAX package."""
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
