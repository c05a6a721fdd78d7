"""The port's observability (``repro_torch.obs``) and the rest of its
``analysis`` on the CPU against the JAX package's, on the same numpy
inputs: ``execute_stats``' normalized dicts, ``QueryTrace`` levels
(est/obs rows, Q-errors, kernel paths) and events and their JSONL round
trip, metric snapshots (counters and histogram counts, not seconds),
``DeviceProfile`` call and family counts with the engine meters equal
with a profile on and off, EXPLAIN ANALYZE, the ``export_trace`` CLI,
``check_runtime`` and ``python -m repro_torch.analysis``.

Mirrors ``tests/test_obs.py`` and ``tests/test_profile.py`` but for the
dist, pool and bench-runner tests.  Where the port differs on purpose,
the test pins the port's behaviour and names its ROADMAP Queue 3
watch-list entry: memory on the CPU (a sample is counted, no byte count
is invented) and compiles (the port compiles nothing per shape; its
``jit.compiles`` count builds or loads of the kernel library).
"""
import ast
import dataclasses
import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from conftest import make_gdb

import repro  # noqa: F401  (x64 for the reference)
from repro.analysis.__main__ import main as j_analysis_main
from repro.core import GraphDB as JGraphDB
from repro.core import execute_stats as j_execute_stats
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import get_query as j_get_query
from repro.graphs import node_sample as j_node_sample
from repro.graphs import powerlaw_cluster as j_powerlaw_cluster
from repro.graphs.generators import zipf_graph as j_zipf_graph
from repro.obs import DeviceProfile as JDeviceProfile
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import QueryTrace as JQueryTrace
from repro.obs import explain_analyze as j_explain_analyze
from repro.obs import normalize_engine_stats as j_normalize
from repro.obs.export_trace import main as j_export_main
from repro.serve import QuantumScheduler as JQuantumScheduler
from repro.serve import QueryRequest as JQueryRequest
from repro.serve import QueryServer as JQueryServer

import repro_torch.core as T
from repro_torch.analysis import (RecompileAudit, audit_recompilation,
                                  check_runtime)
from repro_torch.analysis.__main__ import main as t_analysis_main
from repro_torch.convert import gdb_from_arrays
from repro_torch.graphs import CSRGraph
from repro_torch.kernels import build
from repro_torch.obs import (ENGINE_REQUIRED_KEYS, KERNEL_FAMILIES,
                             DeviceProfile, MetricsRegistry, NullProfile,
                             QueryTrace, current_profile, current_trace,
                             explain_analyze, normalize_engine_stats, qerror)
from repro_torch.obs.export_trace import main as t_export_main
from repro_torch.serve import QuantumScheduler, QueryRequest, QueryServer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# engine -> a query shape it supports (yannakakis needs β-acyclic), as in
# tests/test_obs.py, then vlftj on every tier-1 shape
SIX_ENGINES = [("vlftj", "3-clique"), ("lftj_ref", "3-clique"),
               ("binary", "3-clique"), ("minesweeper_ref", "3-clique"),
               ("yannakakis", "3-path"), ("hybrid", "2-lollipop")]
TIER1_SHAPES = ("3-clique", "4-clique", "4-cycle", "3-path", "2-lollipop",
                "3-lollipop")
CASES = SIX_ENGINES + [("vlftj", s) for s in TIER1_SHAPES
                       if s != "3-clique"]
#: host wall seconds: never compared between the packages
WALL_KEYS = ("level_wall_s", "wall_s", "t", "dur_s")


@pytest.fixture(scope="module")
def pair():
    """The reference's ``make_gdb(60, 3, seed=5)`` and the port's db on
    the same arrays."""
    j = make_gdb(60, 3, seed=5)
    return j, gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary,
                              device="cpu")


def _port_csr(j_csr) -> CSRGraph:
    return CSRGraph(indptr=np.asarray(j_csr.indptr, np.int64),
                    indices=np.asarray(j_csr.indices, np.int64),
                    n_nodes=int(j_csr.n_nodes))


def _plans(pair, engine, shape):
    j_db, t_db = pair
    jp = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                      engine=engine)
    tp = T.plan_query(T.get_query(shape), T.GraphStats.of(t_db),
                      engine=engine)
    assert (tp.engine, tp.gao) == (jp.engine, jp.gao)
    return jp, tp


def _no_wall(obj):
    """``obj`` without host wall seconds, JSON-normalized."""
    if isinstance(obj, dict):
        return {str(k): _no_wall(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, (list, tuple)):
        return [_no_wall(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def _levels(trace):
    return _no_wall([trace.levels[lv] for lv in sorted(trace.levels)])


# ---------------------------------------------------------------------------
# execute_stats: the normalized dict, equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,shape", CASES)
def test_execute_stats_equals_reference(pair, engine, shape):
    jp, tp = _plans(pair, engine, shape)
    jc, js = j_execute_stats(jp, pair[0])
    tc, ts = T.execute_stats(tp, pair[1])
    assert tc == jc
    assert tuple(sorted(ts)) == tuple(sorted(ENGINE_REQUIRED_KEYS))
    assert ts["name"] == engine
    assert sorted(ts["level_wall_s"]) == sorted(js["level_wall_s"])
    assert _no_wall(ts) == _no_wall(js)
    for d in (ts["level_rows"], ts["level_wall_s"], ts["level_paths"]):
        assert all(isinstance(k, int) for k in d)


def test_normalize_is_total_on_empty_stats():
    out = normalize_engine_stats("mystery", None)
    assert out == j_normalize("mystery", None)
    assert tuple(sorted(out)) == tuple(sorted(ENGINE_REQUIRED_KEYS))
    assert out["rows_expanded"] == 0 and out["raw"] == {}


# ---------------------------------------------------------------------------
# tracing: on/off parity, levels equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,shape", SIX_ENGINES)
def test_traced_count_and_levels_match_reference(pair, engine, shape):
    jp, tp = _plans(pair, engine, shape)
    ref, _ = T.execute_stats(tp, pair[1])
    jt = JQueryTrace(shape, jp.gao, engine)
    with jt.activate():
        j_execute_stats(jp, pair[0])
    tt = QueryTrace(shape, tp.gao, engine)
    with tt.activate():
        traced, _ = T.execute_stats(tp, pair[1])
    assert traced == ref == jt.summary["count"] == tt.summary["count"]
    assert _levels(tt) == _levels(jt)
    assert _no_wall(tt.summary) == _no_wall(jt.summary)
    assert tt.meta == jt.meta


def test_disabled_tracer_and_profile_add_no_launch(pair):
    """The guard: with a trace and a profile active, the vlftj meters,
    the kernel launch counters and the count equal a run with neither —
    capture is host-side harvesting of counters the engine keeps
    anyway."""
    _, tp = _plans(pair, "vlftj", "4-cycle")
    assert current_trace() is None and current_profile() is None
    build.reset_launches()
    c_off, off = T.execute_stats(tp, pair[1])
    launches_off = dict(build.LAUNCHES)
    tr, prof = QueryTrace("4-cycle", tp.gao, "vlftj"), DeviceProfile()
    with tr.activate(), prof.activate():
        c_on, on = T.execute_stats(tp, pair[1])
    assert c_on == c_off
    for meter in ("chunks", "ll_calls", "candidates"):
        assert on["raw"][meter] == off["raw"][meter], meter
    assert on["kernel_dispatches"] == off["kernel_dispatches"]
    assert on["jit_calls"] == off["jit_calls"]
    assert dict(build.LAUNCHES) == launches_off


@pytest.mark.parametrize("module", ["trace", "schema", "metrics"])
def test_harvest_modules_import_no_torch(module):
    """The port's form of the JAX package's ``obs-device-free`` lint
    rule: the harvest path (trace, schema, metrics) imports the standard
    library only, so turning tracing on cannot add device work."""
    path = ROOT / "src" / "repro_torch" / "obs" / f"{module}.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert names
    bad = [n for n in names if n.startswith(".") and n != ".."
           or n.split(".")[0] in ("torch", "numpy", "jax", "repro",
                                  "repro_torch")]
    assert not bad, f"{path.name} imports {bad}"


def test_vlftj_levels_carry_est_obs_and_paths(pair):
    jp, tp = _plans(pair, "vlftj", "3-clique")
    jt = JQueryTrace("3-clique", jp.gao, "vlftj")
    with jt.activate():
        j_execute_stats(jp, pair[0])
    tr = QueryTrace("3-clique", tp.gao, "vlftj")
    with tr.activate():
        c, _ = T.execute_stats(tp, pair[1])
    assert len(tp.level_est_rows) == len(tp.gao)
    for lv in range(len(tp.gao)):
        rec = tr.levels[lv]
        assert rec["var"] == tp.gao[lv]
        assert rec["obs_rows"] >= 0 and rec["q_error"] >= 1.0
        assert rec["est_rows"] == pytest.approx(tp.level_est_rows[lv])
        assert rec["q_error"] == jt.levels[lv]["q_error"]
    assert any("kernel" in tr.levels[lv] for lv in range(1, len(tp.gao)))
    assert tr.summary["count"] == c


# ---------------------------------------------------------------------------
# scheduled and served traces
# ---------------------------------------------------------------------------

def _twin(j_csr, **kw):
    return (JQueryServer(j_csr, **kw),
            QueryServer(_port_csr(j_csr), device="cpu", **kw))


@pytest.fixture(scope="module")
def csr300():
    return j_powerlaw_cluster(n=300, m_per_node=4, seed=0)


@pytest.fixture(scope="module")
def csr200():
    return j_powerlaw_cluster(n=200, m_per_node=3, seed=1)


def test_scheduled_trace_has_preempt_resume_and_parity(csr300):
    out = {}
    for (srv, Sched, R), key in zip(
            zip(_twin(csr300, page_rows=256),
                (JQuantumScheduler, QuantumScheduler),
                (JQueryRequest, QueryRequest)), "jt"):
        sched = Sched(srv, quantum_rows=64)
        sched.submit(R("3-path", engine="vlftj", trace=True))
        (out[key],) = sched.run()
    res, want = out["t"], out["j"]
    tr = res.trace
    assert res.count == want.count
    assert len(tr.events_named("preempt")) >= 1
    assert len(tr.events_named("resume")) >= 1
    assert _no_wall(tr.events) == _no_wall(want.trace.events)
    assert _levels(tr) == _levels(want.trace)
    assert _no_wall(tr.summary) == _no_wall(want.trace.summary)
    assert tr.summary["quanta"] == res.stats["quanta"]
    back = QueryTrace.from_jsonl(tr.to_jsonl())
    assert len(back.events_named("preempt")) == \
        len(tr.events_named("preempt"))
    assert back.summary["count"] == res.count


def test_restart_backoff_visible_in_stats_and_trace(csr300):
    out = {}
    for (srv, Sched, R), key in zip(
            zip(_twin(csr300, page_rows=256, max_open_cursors=2),
                (JQuantumScheduler, QuantumScheduler),
                (JQueryRequest, QueryRequest)), "jt"):
        sched = Sched(srv, quantum_rows=64)
        sched.submit(R("3-path", engine="vlftj", trace=True))
        assert sched.step()
        for s in range(3):
            srv.execute(R("3-clique", engine="vlftj", limit=1, seed=s))
        while sched.step():
            pass
        (out[key],) = [j.result for j in sched._jobs]
    res = out["t"]
    assert res.stats == out["j"].stats
    assert res.stats["restarts"] >= 1
    assert (res.stats["quantum_rows_final"]
            == 64 * 2 ** res.stats["restarts"])
    restarts = res.trace.events_named("restart")
    assert len(restarts) == res.stats["restarts"]
    assert restarts[0]["quantum_rows"] == 128
    assert _no_wall(res.trace.events) == _no_wall(out["j"].trace.events)


def test_server_trace_and_profile_flags_roundtrip(csr200):
    j_srv, t_srv = _twin(csr200)
    want = j_srv.execute(JQueryRequest("3-clique", engine="vlftj",
                                       trace=True, profile=True))
    res = t_srv.execute(QueryRequest("3-clique", engine="vlftj",
                                     trace=True, profile=True))
    assert res.count == want.count
    assert res.trace.summary["count"] == res.count
    assert res.stats["engine"]["name"] == "vlftj"
    assert res.profile.meta["trace_id"] == res.trace.meta["trace_id"]
    assert _levels(res.trace) == _levels(want.trace)
    assert res.profile.jit["calls"] == want.profile.jit["calls"] >= 1
    off = t_srv.execute(QueryRequest("3-clique", engine="vlftj"))
    assert off.trace is None and off.profile is None
    assert off.count == res.count


def test_explain_analyze_zipf_triangle():
    g = j_zipf_graph(500, 2500, seed=0)
    unary = {f"v{i}": j_node_sample(g.n_nodes, 4, seed=i)
             for i in range(1, 5)}
    j_db = JGraphDB(g, unary)
    t_db = gdb_from_arrays(g.indptr, g.indices, unary, device="cpu")
    want = j_explain_analyze(j_get_query("3-clique"), j_db, engine="vlftj")
    res = explain_analyze(T.get_query("3-clique"), t_db, engine="vlftj")
    assert res.count == want.count == T.count(T.get_query("3-clique"),
                                              t_db, engine="vlftj")
    assert len(res.levels) == 3
    for rec in res.levels:
        assert rec["est_rows"] is not None and rec["obs_rows"] is not None
        assert np.isfinite(rec["q_error"]) and rec["q_error"] >= 1.0
    assert _no_wall(res.levels) == _no_wall(want.levels)

    def body(r):   # the render but its first line's wall
        return r.render().splitlines()[1:]
    assert body(res) == body(want)
    assert "max q-error" in res.render()
    assert res.max_q_error == want.max_q_error


# ---------------------------------------------------------------------------
# trace object + JSONL round-trip (between the packages too)
# ---------------------------------------------------------------------------

def test_qerror_edge_cases():
    assert qerror(10, 10) == 1.0
    assert qerror(5, 20) == 4.0 and qerror(20, 5) == 4.0
    assert qerror(0, 0) == 1.0
    assert qerror(0, 7) == float("inf") and qerror(7, 0) == float("inf")


def test_trace_jsonl_roundtrip_across_packages(tmp_path, pair):
    _, tp = _plans(pair, "vlftj", "3-path")
    tr = QueryTrace("3-path", tp.gao, "vlftj")
    with tr.activate():
        T.execute_stats(tp, pair[1])
    tr.event("custom", detail="x")
    path = tmp_path / "t.jsonl"
    tr.to_jsonl(path)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    kinds = [ln["kind"] for ln in lines]
    assert kinds[0] == "header" and kinds[-1] == "summary"
    assert kinds.count("level") == len(tr.levels)
    for back in (QueryTrace.from_jsonl(path), JQueryTrace.from_jsonl(path)):
        assert back.summary["count"] == tr.summary["count"]
        assert set(back.levels) == set(tr.levels)
        assert [e["name"] for e in back.events] == \
            [e["name"] for e in tr.events]
    # the JAX package's trace of the same plan, read back by the port
    jp, _ = _plans(pair, "vlftj", "3-path")
    jt = JQueryTrace("3-path", jp.gao, "vlftj")
    with jt.activate():
        j_execute_stats(jp, pair[0])
    assert _levels(QueryTrace.from_jsonl(jt.to_jsonl())) == _levels(tr)


def test_trace_inactive_by_default():
    assert current_trace() is None
    tr = QueryTrace("q", ("a",), "vlftj")
    with tr.activate():
        assert current_trace() is tr
        with QueryTrace("inner", ("b",), "vlftj").activate() as inner:
            assert current_trace() is inner
        assert current_trace() is tr
    assert current_trace() is None


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _fill(reg):
    reg.counter("reqs", route="a").inc()
    reg.counter("reqs", route="a").inc(2)
    reg.counter("reqs", route="b").inc()
    reg.gauge("open").set(5)
    reg.gauge("open").dec(2)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg.snapshot()


def test_registry_counters_gauges_histograms():
    reg = MetricsRegistry()
    snap = _fill(reg)
    assert snap == _fill(JMetricsRegistry())
    assert snap["reqs{route=a}"] == 3 and snap["reqs{route=b}"] == 1
    assert snap["open"] == 3
    assert snap["lat_count"] == 3
    assert snap["lat_sum"] == pytest.approx(5.55)
    assert snap["lat_bucket{le=0.1}"] == 1
    assert snap["lat_bucket{le=1}"] == 2
    assert snap["lat_bucket{le=+Inf}"] == 3
    with pytest.raises(ValueError):
        reg.counter("reqs", route="a").inc(-1)
    c = reg.counter("x")
    c.inc()
    assert reg.counter("x").value == 1     # same underlying series
    reg.reset()
    assert len(reg) == 0


def test_histogram_snapshot_inf_bucket_and_cumulative():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.005, 0.05, 0.5, 50.0):
        h.observe(v)
    s = h.snapshot()
    assert list(s["buckets"])[-1] == "+Inf"
    assert s["buckets"] == {"0.01": 2, "0.1": 3, "1": 4, "+Inf": 5}
    assert s["count"] == 5
    json.dumps(s)
    assert reg.snapshot()["lat_bucket{le=+Inf}"] == 5


def _counts_only(snap):
    """A registry snapshot without the series that carry seconds, and
    without the live-bytes gauge, which the port leaves at 0 on the CPU
    (Queue 3 watch-list: "CPU memory fields")."""
    return {k: v for k, v in snap.items()
            if not re.match(r"\w*seconds_(sum|min|max|bucket)", k)
            and k != "profile_peak_live_bytes"}


def test_server_metrics_endpoint_and_scheduler_quanta(csr200):
    snaps, stats = {}, {}
    for key, (srv, Sched, R) in zip("jt", zip(
            (JQueryServer(csr200, metrics=JMetricsRegistry()),
             QueryServer(_port_csr(csr200), metrics=MetricsRegistry(),
                         device="cpu")),
            (JQuantumScheduler, QuantumScheduler),
            (JQueryRequest, QueryRequest))):
        srv.execute(R("3-clique", engine="vlftj"))
        srv.execute(R("3-clique", engine="vlftj", profile=True))
        sched = Sched(srv, quantum_rows=64)
        sched.submit(R("3-clique", engine="vlftj"))
        sched.run()
        snaps[key], stats[key] = srv.metrics(), dict(sched.stats)
    snap = snaps["t"]
    assert stats["t"] == stats["j"]
    # the port's server alone counts its warm graphs: one, the first,
    # whose edge tensors were not on the device yet
    assert snap.pop("server_warm_graphs{edges=built}") == 1
    assert _counts_only(snap) == _counts_only(snaps["j"])
    assert snap["server_plan_cache{outcome=miss}"] == 1
    assert snap["server_plan_cache{outcome=hit}"] == 2
    assert snap["server_metrics_snapshots"] == 1
    assert snap["scheduler_quanta"] == stats["t"]["quanta"]
    assert snap.get("scheduler_preemptions", 0) == stats["t"]["preemptions"]
    assert snap["profile_kernel_seconds_count{family=intersect}"] == 1
    assert snap["profile_peak_live_bytes"] == 0
    json.dumps(snap)


# ---------------------------------------------------------------------------
# device profile
# ---------------------------------------------------------------------------

def test_profile_inactive_by_default_and_null_is_inert():
    assert current_profile() is None
    p = DeviceProfile("q", "vlftj")
    with p.activate():
        assert current_profile() is p
        with DeviceProfile().activate() as inner:
            assert current_profile() is inner
        assert current_profile() is p
    assert current_profile() is None
    n = NullProfile()
    n.record_jit_call()
    n.record_compile("k", 1.0)
    n.record_kernel("intersect", 1.0)
    n.sample_memory()
    with n.activate():
        assert current_profile() is None       # never installed
    assert n.to_dict() == {}


@pytest.mark.parametrize("shape", ["3-clique", "4-cycle", "2-lollipop"])
def test_profile_harvest_matches_reference(pair, shape):
    """Calls per family and memory samples equal the JAX package's;
    every dispatch the engine metered is a recorded call.  On the CPU the
    memory fields stay empty (Queue 3 watch-list: "CPU memory fields")."""
    jp, tp = _plans(pair, "vlftj", shape)
    jprof, prof = JDeviceProfile(shape, "vlftj"), DeviceProfile(shape,
                                                                 "vlftj")
    with jprof.activate():
        jc, _ = j_execute_stats(jp, pair[0])
    with prof.activate():
        c, stats = T.execute_stats(tp, pair[1])
    assert c == jc
    assert prof.jit["calls"] == stats["raw"]["chunks"] \
        + stats["raw"]["ll_calls"] == jprof.jit["calls"]
    assert set(prof.kernels) <= set(KERNEL_FAMILIES)
    assert {f: r["calls"] for f, r in prof.kernels.items()} == \
        {f: r["calls"] for f, r in jprof.kernels.items()}
    assert prof.kernel_wall_s("intersect") > 0.0
    assert prof.kernel_wall_s() >= prof.kernel_wall_s("intersect")
    assert prof.kernel_wall_s("nope") == 0.0
    assert prof.memory["samples"] == jprof.memory["samples"] >= 1
    assert prof.memory["peak_live_bytes"] == 0
    assert prof.memory["peak_live_buffers"] == 0
    assert prof.memory["device_peak_bytes"] is None
    d = json.loads(json.dumps(prof.to_dict()))
    assert d["meta"]["query"] == shape
    assert d["jit"] == {"compiles": 0, "calls": prof.jit["calls"],
                        "compile_wall_s": 0.0}


def test_profile_segment_outer_on_rows_path(csr200):
    """Row enumeration goes through the cursor's ``segment_expand`` —
    the third family shows up only on the rows path, with the JAX
    package's call counts."""
    calls = {}
    for key, (srv, Prof, R) in zip("jt", zip(
            _twin(csr200), (JDeviceProfile, DeviceProfile),
            (JQueryRequest, QueryRequest))):
        prof = Prof("3-path", "vlftj")
        with prof.activate():
            res = srv.execute(R("3-path", engine="vlftj", limit=200))
        assert res.count > 0
        calls[key] = ({f: r["calls"] for f, r in prof.kernels.items()},
                      prof.jit["calls"])
    assert calls["t"] == calls["j"]
    assert calls["t"][0]["segment_outer"] >= 1


def test_profile_publish_into_trace_and_registry(pair):
    _, tp = _plans(pair, "vlftj", "3-clique")
    prof = DeviceProfile("3-clique", "vlftj")
    tr = QueryTrace("3-clique", tp.gao, "vlftj")
    with tr.activate(), prof.activate():
        T.execute_stats(tp, pair[1])
    reg = MetricsRegistry()
    prof.publish(trace=tr, registry=reg)
    names = [s["name"] for s in tr.spans]
    assert names == ["profile/jit", "profile/kernel/intersect"]
    assert tr.summary["peak_live_bytes"] == prof.memory["peak_live_bytes"]
    snap = reg.snapshot()
    assert snap["profile_jit_calls"] == prof.jit["calls"]
    assert snap["profile_peak_live_bytes"] == 0
    assert snap["profile_kernel_seconds_count{family=intersect}"] == 1


def test_scheduler_profile_counts_and_compiles(csr300):
    """The scheduler's per-quantum profile: the same dispatch and family
    counts as the JAX package's.  The JAX package AOT-compiles the final
    level (``compiles >= 1``, each attributed to its quantum); the port
    compiles nothing per shape, and on the CPU it builds no kernel
    library, so ``compiles`` is 0 (Queue 3 watch-list: "jit.compiles as
    library builds")."""
    out = {}
    for key, (srv, Sched, R) in zip("jt", zip(
            _twin(csr300, page_rows=256),
            (JQuantumScheduler, QuantumScheduler),
            (JQueryRequest, QueryRequest))):
        sched = Sched(srv, quantum_rows=64)
        sched.submit(R("3-path", engine="vlftj", profile=True))
        (out[key],) = sched.run()
    prof, jprof = out["t"].profile, out["j"].profile
    assert out["t"].count == out["j"].count
    assert jprof.jit["compiles"] >= 1
    for ev in jprof.compile_events:
        assert re.fullmatch(r"sched-\d+/q\d+", ev["attribution"])
    assert prof.jit["calls"] == jprof.jit["calls"]
    assert {f: r["calls"] for f, r in prof.kernels.items()} == \
        {f: r["calls"] for f, r in jprof.kernels.items()}
    assert prof.jit["compiles"] == 0 and prof.compile_events == []


def test_library_load_is_a_compile_attributed_to_its_quantum(monkeypatch):
    """A build or load of the kernel library inside an active profile is
    one compile event carrying the profile's attribution (the build
    itself is stubbed: this process has no nvcc)."""
    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "build", lambda: Path("libfake.so"))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    prof = DeviceProfile()
    with prof.activate(), prof.attribute("sched-1/q3"):
        build.library()
        build.library()                        # loaded: no second event
    assert prof.jit["compiles"] == 1
    (ev,) = prof.compile_events
    assert ev["key"] == "libfake.so" and ev["attribution"] == "sched-1/q3"
    assert ev["wall_s"] >= 0.0
    monkeypatch.setattr(build, "_lib", None)
    build.library()                            # no profile: nothing
    assert prof.jit["compiles"] == 1


def test_request_log_correlates_trace_ids(tmp_path, csr200):
    lines = {}
    for key, (srv, R) in zip("jt", zip(
            (JQueryServer(csr200, metrics=JMetricsRegistry(),
                          request_log=str(tmp_path / "j.jsonl")),
             QueryServer(_port_csr(csr200), metrics=MetricsRegistry(),
                         request_log=str(tmp_path / "t.jsonl"),
                         device="cpu")),
            (JQueryRequest, QueryRequest))):
        ok = srv.execute(R("3-clique", engine="vlftj"))
        prof_res = srv.execute(R("3-clique", engine="vlftj", profile=True))
        with pytest.raises(KeyError):
            srv.execute(R("no-such-query", engine="vlftj"))
        lines[key] = [json.loads(ln) for ln in
                      (tmp_path / f"{key}.jsonl").read_text().splitlines()]
        snap = srv.metrics_registry.snapshot()
        assert snap["server_requests{status=ok}"] == 2
        assert snap["server_requests{status=error}"] == 1
    got = lines["t"]
    assert [ln["status"] for ln in got] == ["ok", "ok", "error"]
    assert len({ln["trace_id"] for ln in got}) == 3
    assert got[0]["count"] == ok.count
    assert got[1]["profile"]["jit_calls"] == prof_res.profile.jit["calls"]
    assert got[1]["trace_id"] == prof_res.profile.meta["trace_id"]
    assert "error" in got[2] and "count" not in got[2]

    def comparable(ln):
        ln = {k: v for k, v in ln.items() if k not in ("ts", "latency_s")}
        if "profile" in ln:
            ln["profile"] = {k: v for k, v in ln["profile"].items()
                             if k in ("jit_calls",)}
        return ln
    assert [comparable(x) for x in got] == \
        [comparable(x) for x in lines["j"]]


def test_concurrent_traced_queries_do_not_interleave(csr300):
    """Two traced queries through the preemptive scheduler: each trace
    matches its solo run's per-level observations exactly."""
    def run(reqs):
        return QueryServer(_port_csr(csr300), page_rows=256,
                           device="cpu").execute_concurrent(
            reqs, quantum_rows=64)

    (solo_a,) = run([QueryRequest("3-path", engine="vlftj", trace=True)])
    (solo_b,) = run([QueryRequest("3-clique", engine="vlftj", trace=True)])
    both = run([QueryRequest("3-path", engine="vlftj", trace=True),
                QueryRequest("3-clique", engine="vlftj", trace=True)])
    pair = {r.request.query_name: r for r in both}
    for solo, res in ((solo_a, pair["3-path"]), (solo_b, pair["3-clique"])):
        assert res.count == solo.count
        assert res.trace is not solo.trace
        assert _levels(res.trace) == _levels(solo.trace)


def test_profiles_in_threads_stay_apart(pair):
    """Profiles activated in two threads at once (the contextvar is per
    thread): each sees exactly its own query's dispatches."""
    _, t_db = pair
    plans = {s: _plans(pair, "vlftj", s)[1] for s in ("3-clique", "4-cycle")}
    solo = {}
    for s, p in plans.items():
        prof = DeviceProfile(s)
        with prof.activate():
            solo[s] = (T.execute_stats(p, t_db)[0], prof.jit["calls"])
    got, barrier = {}, threading.Barrier(2)

    def work(s):
        prof = DeviceProfile(s)
        barrier.wait(timeout=30)
        with prof.activate():
            for _ in range(3):
                c, _ = T.execute_stats(plans[s], t_db)
        got[s] = (c, prof.jit["calls"] // 3, prof.kernels["intersect"]
                  ["calls"] // 3)

    threads = [threading.Thread(target=work, args=(s,)) for s in plans]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    for s in plans:
        assert got[s][:2] == solo[s] and got[s][2] == solo[s][1]


# ---------------------------------------------------------------------------
# the export_trace CLI, check_runtime and python -m repro_torch.analysis
# ---------------------------------------------------------------------------

def test_export_trace_cli_matches_reference(tmp_path, capsys):
    argv = ["--query", "3-path", "--n", "300", "--m", "1200"]
    assert j_export_main(argv + ["--out", str(tmp_path / "j.jsonl")]) == 0
    assert t_export_main(argv + ["--out", str(tmp_path / "t.jsonl"),
                                 "--device", "cpu",
                                 "--metrics", str(tmp_path / "m.json")]) == 0
    got = QueryTrace.from_jsonl(tmp_path / "t.jsonl")
    want = JQueryTrace.from_jsonl(tmp_path / "j.jsonl")
    assert got.summary["count"] == want.summary["count"]
    assert _levels(got) == _levels(want)
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert metrics["profile_jit_calls"] >= 1
    assert "level-step calls" in capsys.readouterr().out


def test_check_runtime_against_a_profile(pair):
    _, tp = _plans(pair, "vlftj", "4-cycle")
    audit = audit_recompilation(tp, T.GraphStats.of(pair[1]))
    prof = DeviceProfile()
    with prof.activate():
        T.execute_stats(tp, pair[1])
    assert check_runtime(audit, prof) is None
    drifted = DeviceProfile()
    drifted.jit["compiles"] = audit.total + 1
    f = check_runtime(audit, drifted, path="p")
    assert (f.rule, f.severity, f.path) == ("V107", "error", "p")
    unbounded = dataclasses.replace(audit, unbounded=("x",))
    assert isinstance(unbounded, RecompileAudit)
    assert check_runtime(unbounded, drifted) is None


@pytest.mark.parametrize("argv", [["--tier1", "--format=json"],
                                  ["--self-test"]])
def test_analysis_main_matches_reference(tmp_path, capsys, argv):
    assert t_analysis_main(argv) == j_analysis_main(argv) == 0
    out = capsys.readouterr().out
    if "--self-test" in argv:
        assert out.count("self-test OK") == 2
        return
    t_doc, j_doc = (json.loads(chunk) for chunk in _json_docs(out))

    def key(doc):
        return [(f["rule"], f["severity"], f["path"], f["line"])
                for f in doc["findings"]]
    assert key(t_doc) == key(j_doc)
    assert t_doc["plans_verified"] == j_doc["plans_verified"]


def _json_docs(text):
    """The two JSON documents the two ``--format=json`` runs printed."""
    dec, i, docs = json.JSONDecoder(), 0, []
    while len(docs) < 2:
        i = text.index("{", i)
        doc, i = dec.raw_decode(text, i)
        docs.append(json.dumps(doc))
    return docs
