"""The port's query server and quantum scheduler (``repro_torch.serve``)
on the CPU against the JAX package's (``repro.serve``), on the same CSR
arrays: counts, rows, pages, ``next_cursor`` continuations, the cursor
registry's eviction, plan-cache counters, the warm graphs' one shared
copy of the edge tensors, the scheduler's quanta,
preemptions, rows expanded and virtual clocks under both policies, the
429 admission and quota cases, and ``PlanSnapshot`` bytes written by one
package and resumed by the other.

Mirrors ``tests/test_scheduler.py`` and the server tests of
``tests/test_enumerate.py``, ``tests/test_planner.py`` and
``tests/test_perf_options.py``; the partitioned (``dist``) route is held
here against the JAX server (``test_partitioned_route_serves``) and in
``tests/test_torch_dist.py``.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (x64 for the reference)
from repro.core import VLFTJ as JVLFTJ
from repro.core import count as j_count
from repro.core import get_query as j_get_query
from repro.graphs import powerlaw_cluster as j_powerlaw_cluster
from repro.serve import PlanSnapshot as JPlanSnapshot
from repro.serve import Preempted as JPreempted
from repro.serve import QuantumBudget as JQuantumBudget
from repro.serve import QuantumScheduler as JQuantumScheduler
from repro.serve import QueryRequest as JQueryRequest
from repro.serve import QueryServer as JQueryServer
from repro.serve import TenantQuota as JTenantQuota

import repro_torch.core as T
from repro_torch.core import engine as t_engine
from repro_torch.graphs import CSRGraph
from repro_torch.obs import MetricsRegistry
from repro_torch.results import ResultCursor
from repro_torch.serve import (AdmissionError, PlanSnapshot, Preempted,
                               QuantumBudget, QuantumScheduler, QueryRequest,
                               QueryServer, TenantQuota)

torch.set_num_threads(1)

TIER1_SHAPES = ["3-clique", "4-clique", "4-cycle", "3-path",
                "2-lollipop", "3-lollipop"]
SCHED_STATS = ("quanta", "preemptions", "restarts", "rows_expanded",
               "vclock_submit", "vclock_done", "policy",
               "quantum_rows_initial", "quantum_rows_final")


def _port_csr(j_csr) -> CSRGraph:
    return CSRGraph(indptr=np.asarray(j_csr.indptr, np.int64),
                    indices=np.asarray(j_csr.indices, np.int64),
                    n_nodes=int(j_csr.n_nodes))


class Twin:
    """One graph served by both packages with the same arguments."""

    def __init__(self, j_csr, **kw):
        self.j = JQueryServer(j_csr, **kw)
        self.t = QueryServer(_port_csr(j_csr), device="cpu", **kw)

    def req(self, *args, **kw):
        return JQueryRequest(*args, **kw), QueryRequest(*args, **kw)

    def gdbs(self, seed: int = 0, selectivity: float | None = None):
        sel = selectivity or self.j.default_selectivity
        return self.j._gdb_for(sel, seed), self.t._gdb_for(sel, seed)


@pytest.fixture(scope="module")
def csr():
    return j_powerlaw_cluster(n=300, m_per_node=4, seed=0)


@pytest.fixture()
def twin(csr):
    return Twin(csr, page_rows=256)


def _same_result(got, want, stats=SCHED_STATS):
    assert got.count == want.count
    assert got.engine == want.engine
    assert {k: got.stats.get(k) for k in stats} == \
        {k: want.stats.get(k) for k in stats}
    if want.rows is None:
        assert got.rows is None
    else:
        assert got.row_vars == tuple(want.row_vars)
        np.testing.assert_array_equal(got.rows, want.rows)
    assert (got.next_cursor is None) == (want.next_cursor is None)


def _run_both(twin, make_reqs, **sched_kw):
    """Run the same requests through each package's scheduler:
    ``[(JAX scheduler, results), (port scheduler, results)]``."""
    out = []
    for pkg, Sched in (("j", JQuantumScheduler), ("t", QuantumScheduler)):
        sched = Sched(getattr(twin, pkg), **sched_kw)
        for req in make_reqs(JQueryRequest if pkg == "j" else QueryRequest):
            sched.submit(req)
        out.append((sched, sched.run()))
    return out


# ---------------------------------------------------------------------------
# suspend/resume parity against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_count_parity_under_preemption(twin, shape):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R(shape, engine="vlftj")], quantum_rows=64)
    _same_result(got, want)
    assert got.stats["quanta"] >= 1 and got.stats["rows_expanded"] > 0
    _, t_gdb = twin.gdbs()
    assert got.count == T.count(T.get_query(shape), t_gdb, engine="vlftj")


@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_rows_parity_under_preemption(twin, shape):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R(shape, engine="vlftj", limit=10**9)],
        quantum_rows=64)
    _same_result(got, want)
    _, t_gdb = twin.gdbs()
    direct = t_engine.enumerate(T.get_query(shape), t_gdb, plan=got.plan,
                                order=got.row_vars)
    assert got.next_cursor is None
    np.testing.assert_array_equal(got.rows, direct.rows)


def test_preemption_actually_happens(twin):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R("3-path", engine="vlftj", limit=10**9)],
        quantum_rows=64)
    _same_result(got, want)
    assert got.stats["preemptions"] > 0
    assert got.stats["quanta"] == got.stats["preemptions"] + 1


def test_limit_completes_early_and_hands_back_cursor(twin):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R("3-path", engine="vlftj", limit=100)],
        quantum_rows=10**9)
    _same_result(got, want)
    assert got.count == 100 and got.rows.shape == (100, 4)
    j_cont = twin.j.execute(JQueryRequest("3-path", limit=10**9,
                                          cursor=want.next_cursor))
    t_cont = twin.t.execute(QueryRequest("3-path", limit=10**9,
                                         cursor=got.next_cursor))
    np.testing.assert_array_equal(t_cont.rows, j_cont.rows)
    _, t_gdb = twin.gdbs()
    direct = t_engine.enumerate(T.get_query("3-path"), t_gdb, plan=got.plan,
                                order=got.row_vars)
    np.testing.assert_array_equal(np.concatenate([got.rows, t_cont.rows]),
                                  direct.rows)


# ---------------------------------------------------------------------------
# the serializable snapshot contract, across the two packages
# ---------------------------------------------------------------------------

def test_snapshot_bytes_roundtrip_and_format():
    args = ("3-path", ("v1", "v2"),
            np.arange(8, dtype=np.int32).reshape(4, 2),
            np.ones(4, dtype=np.int64))
    kw = dict(phase="final", offset=2, partial_total=17, rows_emitted=5)
    snap = PlanSnapshot(*args, **kw)
    wire = snap.to_bytes()
    assert wire == JPlanSnapshot(*args, **kw).to_bytes()
    for back in (PlanSnapshot.from_bytes(wire),
                 JPlanSnapshot.from_bytes(wire)):
        assert back.query_name == "3-path" and back.gao == ("v1", "v2")
        assert back.phase == "final" and back.offset == 2
        assert back.partial_total == 17 and back.rows_emitted == 5
        np.testing.assert_array_equal(back.frontier, snap.frontier)
        np.testing.assert_array_equal(back.mult, snap.mult)
        assert back.start_level == 2 and back.nbytes == snap.nbytes


@pytest.mark.parametrize("shape", ["3-path", "3-lollipop"])
def test_snapshot_resumes_across_packages(twin, shape):
    """Preempt mid-frontier in each package: the snapshots' bytes are
    identical, and each package resumes the other's bytes on a fresh
    executor to the uninterrupted count."""
    j_gdb, t_gdb = twin.gdbs()
    jq, tq = j_get_query(shape), T.get_query(shape)
    jr, tr = twin.req(shape, engine="vlftj")
    j_plan, _ = twin.j._plan_for(jr, j_gdb)
    t_plan, _ = twin.t._plan_for(tr, t_gdb)
    assert t_plan.gao == j_plan.gao
    with pytest.raises(JPreempted) as j_ei:
        JVLFTJ(jq, j_gdb, plan=j_plan.with_level_callback(
            JQuantumBudget(32, shape, j_plan.gao))).count()
    with pytest.raises(Preempted) as t_ei:
        T.VLFTJ(tq, t_gdb, plan=t_plan.with_level_callback(
            QuantumBudget(32, shape, t_plan.gao))).count()
    j_wire = j_ei.value.snapshot.to_bytes()
    t_wire = t_ei.value.snapshot.to_bytes()
    assert t_wire == j_wire
    want = j_count(jq, j_gdb, engine="vlftj")
    snap = PlanSnapshot.from_bytes(j_wire)
    assert T.VLFTJ(tq, t_gdb, plan=t_plan).resume_count(
        snap.frontier, snap.mult) == want
    jsnap = JPlanSnapshot.from_bytes(t_wire)
    assert JVLFTJ(jq, j_gdb, plan=j_plan).resume_count(
        jsnap.frontier, jsnap.mult) == want


def _parked_final(sched, server):
    """Step until the one job parks a final-phase snapshot."""
    while sched.step():
        entry = server._cursors.get("sched-1")
        if entry is not None and entry[0].phase == "final":
            return entry[0]
    raise AssertionError("the job never parked in its final phase")


def test_final_phase_snapshot_swaps_between_packages(twin):
    """A counting job parked in its final phase (windowed tallies): both
    packages park the same bytes, and the port's scheduler finishes the
    job from the JAX package's snapshot to the same count."""
    scheds = {"j": JQuantumScheduler(twin.j, quantum_rows=64),
              "t": QuantumScheduler(twin.t, quantum_rows=64)}
    scheds["j"].submit(JQueryRequest("4-cycle", engine="vlftj"))
    scheds["t"].submit(QueryRequest("4-cycle", engine="vlftj"))
    j_snap = _parked_final(scheds["j"], twin.j)
    t_snap = _parked_final(scheds["t"], twin.t)
    assert t_snap.to_bytes() == j_snap.to_bytes()
    _, label, plan = twin.t._cursors["sched-1"]
    twin.t._cursors["sched-1"] = (
        PlanSnapshot.from_bytes(j_snap.to_bytes()), label, plan)
    (want,) = scheds["j"].run()
    (got,) = scheds["t"].run()
    _same_result(got, want)


def test_resume_rows_from_snapshot_with_skip(twin):
    """The cursor half of the contract: resume from a suspended
    frontier and skip already-delivered rows — continues row-for-row."""
    _, gdb = twin.gdbs()
    q = T.get_query("3-path")
    plan, _ = twin.t._plan_for(QueryRequest("3-path", engine="vlftj",
                                            limit=1), gdb, output="rows")
    cur = ResultCursor(T.VLFTJ(q, gdb, plan=plan), page_rows=128)
    first = cur.take(300)
    assert cur.penultimate is not None
    resumed = ResultCursor(T.VLFTJ(q, gdb, plan=plan), page_rows=128,
                           frontier=cur.penultimate,
                           skip_rows=cur.rows_emitted)
    rest = np.concatenate(list(resumed)) if not cur.exhausted else \
        np.zeros((0, 4), dtype=np.int64)
    direct = T.VLFTJ(q, gdb, plan=plan).enumerate()
    np.testing.assert_array_equal(np.concatenate([first, rest]), direct)
    assert resumed.rows_emitted == direct.shape[0]


# ---------------------------------------------------------------------------
# determinism and fairness: the virtual clocks equal the JAX package's
# ---------------------------------------------------------------------------

def _fair_workload(R):
    # heavy: full-graph samples (selectivity=1) make the enumeration
    # dominate; smalls use the default sparse samples
    return [R("3-path", engine="vlftj", limit=10**9, selectivity=1.0)] + [
        R("3-clique", engine="vlftj", seed=i % 2) for i in range(4)]


def _fair_run(server, Sched, R, policy):
    sched = Sched(server, quantum_rows=2048, policy=policy)
    reqs = _fair_workload(R)
    sched.submit(reqs[0], collect_rows=False)
    for r in reqs[1:]:
        sched.submit(r)
    return sched.run()


@pytest.fixture(scope="module")
def fair_csr():
    # smaller than test_scheduler.py's 300 nodes: the port's plain CPU
    # path pays ~2 ms a final-level call, and the heavy job makes ~2,000
    return j_powerlaw_cluster(n=200, m_per_node=4, seed=0)


@pytest.fixture(scope="module")
def fair(fair_csr):
    """policy -> (JAX package's results, port's results) of the fairness
    workload, each on a fresh server."""
    out = {}
    for policy in ("quantum", "fifo"):
        twin = Twin(fair_csr, page_rows=256)
        out[policy] = (
            _fair_run(twin.j, JQuantumScheduler, JQueryRequest, policy),
            _fair_run(twin.t, QuantumScheduler, QueryRequest, policy))
    return out


def test_quantum_meter_deterministic(fair_csr, fair):
    again = _fair_run(QueryServer(_port_csr(fair_csr), page_rows=256,
                                  device="cpu"),
                      QuantumScheduler, QueryRequest, "quantum")
    runs = [[(r.stats["rows_expanded"], r.stats["vclock_done"],
              r.stats["quanta"], r.stats["preemptions"]) for r in res]
            for res in (fair["quantum"][1], again)]
    assert runs[0] == runs[1]


@pytest.mark.parametrize("policy", ["quantum", "fifo"])
def test_fair_workload_clocks_match_reference(fair, policy):
    want, got = fair[policy]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_result(g, w)


def test_round_robin_beats_fifo_on_small_query_completion(fair):
    outcomes = {}
    for policy in ("quantum", "fifo"):
        res = fair[policy][1]
        heavy, smalls = res[0], res[1:]
        outcomes[policy] = {
            "small_done": [r.stats["vclock_done"] for r in smalls],
            "total": sum(r.stats["rows_expanded"] for r in res),
            "heavy_work": heavy.stats["rows_expanded"]}
    q, f = outcomes["quantum"], outcomes["fifo"]
    assert q["total"] == f["total"]
    assert min(f["small_done"]) > f["heavy_work"]
    assert max(q["small_done"]) * 5 <= max(f["small_done"])


# ---------------------------------------------------------------------------
# quotas / admission control
# ---------------------------------------------------------------------------

def test_max_in_flight_rejects_429(twin):
    for pkg, Sched, R, Quota, Err in (
            ("j", JQuantumScheduler, JQueryRequest, JTenantQuota, None),
            ("t", QuantumScheduler, QueryRequest, TenantQuota,
             AdmissionError)):
        sched = Sched(getattr(twin, pkg),
                      quotas={"t1": Quota(max_in_flight=2)})
        sched.submit(R("3-clique", tenant="t1"))
        sched.submit(R("3-clique", tenant="t1", seed=1))
        with pytest.raises(Exception) as ei:
            sched.submit(R("3-clique", tenant="t1", seed=2))
        assert ei.value.status == 429 and ei.value.tenant == "t1"
        if Err is not None:
            assert isinstance(ei.value, Err)
        sched.submit(R("3-clique", tenant="t2"))
        res = sched.run()
        sched.submit(R("3-clique", tenant="t1", seed=2))
        assert sched.stats["rejected"] == 1
        if pkg == "j":
            want = [r.count for r in res]
    assert [r.count for r in res] == want


def test_frontier_bytes_quota_fails_oversized_park(twin):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R("3-path", engine="vlftj", tenant="t1")],
        quantum_rows=64)
    assert want.engine != "rejected"      # no quota: runs through
    quotas = {"j": {"t1": JTenantQuota(max_frontier_bytes=128)},
              "t": {"t1": TenantQuota(max_frontier_bytes=128)}}
    out = {}
    for pkg, Sched, R in (("j", JQuantumScheduler, JQueryRequest),
                          ("t", QuantumScheduler, QueryRequest)):
        sched = Sched(getattr(twin, pkg), quantum_rows=64,
                      quotas=quotas[pkg])
        sched.submit(R("3-path", engine="vlftj", tenant="t1"))
        (out[pkg],) = sched.run()
    got, want = out["t"], out["j"]
    assert got.engine == want.engine == "rejected"
    assert got.stats["status"] == 429
    assert "max_frontier_bytes" in got.stats["error"]
    assert got.stats["error"] == want.stats["error"]
    assert got.stats["quanta"] == want.stats["quanta"]


def test_frontier_bytes_quota_evicts_oldest_parked(twin):
    out = {}
    for pkg, Sched, R, Quota in (
            ("j", JQuantumScheduler, JQueryRequest, JTenantQuota),
            ("t", QuantumScheduler, QueryRequest, TenantQuota)):
        server = getattr(twin, pkg)
        sched = Sched(server, quantum_rows=64,
                      quotas={"t1": Quota(max_frontier_bytes=200_000)})
        sched.submit(R("3-clique", engine="vlftj", tenant="t1"))
        sched.submit(R("4-cycle", engine="vlftj", tenant="t1", seed=1))
        out[pkg] = (sched.run(), dict(sched.stats), server.cursor_info())
    (got, g_stats, g_info), (want, w_stats, w_info) = out["t"], out["j"]
    for g, w in zip(got, want):
        _same_result(g, w)
    assert g_stats == w_stats and g_info == w_info
    _, gdb1 = twin.gdbs(seed=1)
    assert got[1].count == T.count(T.get_query("4-cycle"), gdb1,
                                   engine="vlftj")


# ---------------------------------------------------------------------------
# registry eviction / restart semantics
# ---------------------------------------------------------------------------

def _flood(server, R):
    for s in range(3):
        server.execute(R("3-clique", engine="vlftj", limit=1, seed=s))


def test_evicted_snapshot_restarts_correctly(csr):
    twin = Twin(csr, page_rows=256, max_open_cursors=2)
    out = {}
    for pkg, Sched, R in (("j", JQuantumScheduler, JQueryRequest),
                          ("t", QuantumScheduler, QueryRequest)):
        server = getattr(twin, pkg)
        sched = Sched(server, quantum_rows=64)
        sched.submit(R("3-path", engine="vlftj"))
        assert sched.step()
        assert "sched-1" in server._cursors
        _flood(server, R)
        assert "sched-1" not in server._cursors
        while sched.step():
            pass
        (out[pkg],) = [j.result for j in sched._jobs]
    _same_result(out["t"], out["j"])
    assert out["t"].stats["restarts"] >= 1


def test_evicted_rows_job_never_duplicates(csr):
    twin = Twin(csr, page_rows=256, max_open_cursors=2)
    out = {}
    for pkg, Sched, R in (("j", JQuantumScheduler, JQueryRequest),
                          ("t", QuantumScheduler, QueryRequest)):
        server = getattr(twin, pkg)
        sched = Sched(server, quantum_rows=300)
        sched.submit(R("3-path", engine="vlftj", limit=10**9))
        job = sched._jobs[0]
        while job.rows_collected == 0 and job.result is None:
            assert sched.step()
        assert job.result is None
        _flood(server, R)
        while sched.step():
            pass
        (out[pkg],) = [j.result for j in sched._jobs]
    _same_result(out["t"], out["j"])
    assert out["t"].stats["restarts"] >= 1
    _, gdb = twin.gdbs()
    direct = t_engine.enumerate(T.get_query("3-path"), gdb,
                                plan=out["t"].plan, order=out["t"].row_vars)
    np.testing.assert_array_equal(out["t"].rows, direct.rows)


def test_mutual_eviction_terminates_via_restart_backoff(csr):
    twin = Twin(csr, page_rows=256, max_open_cursors=1)
    out = {}
    for pkg, Sched, R in (("j", JQuantumScheduler, JQueryRequest),
                          ("t", QuantumScheduler, QueryRequest)):
        sched = Sched(getattr(twin, pkg), quantum_rows=64)
        for s in range(3):
            sched.submit(R("3-clique", engine="vlftj", seed=s))
        for _ in range(400):
            if not sched.step():
                break
        else:
            pytest.fail(f"{pkg}: mutual-eviction livelock")
        out[pkg] = ([j.result for j in sched._jobs], dict(sched.stats))
    assert out["t"][1] == out["j"][1]
    assert out["t"][1]["restarts"] > 0
    for g, w in zip(out["t"][0], out["j"][0]):
        _same_result(g, w)


# ---------------------------------------------------------------------------
# non-preemptible engines, server API, stats surface
# ---------------------------------------------------------------------------

def test_opaque_engine_completes_in_one_quantum(twin):
    (_, (want,)), (_, (got,)) = _run_both(
        twin, lambda R: [R("3-path", engine="yannakakis")], quantum_rows=64)
    _same_result(got, want)
    assert got.stats["quanta"] == 1 and got.stats["preemptions"] == 0


def test_execute_concurrent_positions_and_rejections(twin):
    res = {}
    for pkg, R, Quota in (("j", JQueryRequest, JTenantQuota),
                          ("t", QueryRequest, TenantQuota)):
        reqs = [R("3-clique", engine="vlftj", tenant="t1"),
                R("3-path", engine="vlftj", limit=50, tenant="t1"),
                R("3-clique", tenant="t1", seed=1)]
        res[pkg] = getattr(twin, pkg).execute_concurrent(
            reqs, quantum_rows=256, quotas={"t1": Quota(max_in_flight=2)})
    got, want = res["t"], res["j"]
    assert len(got) == 3
    for g, w in zip(got[:2], want[:2]):
        _same_result(g, w)
    assert got[1].count == 50 and got[1].rows.shape == (50, 4)
    assert got[2].engine == want[2].engine == "rejected"
    assert got[2].stats == want[2].stats


def test_result_stats_surface(twin):
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        server = getattr(twin, pkg)
        r = server.execute(R("3-clique"))
        r1 = server.execute(R("3-path", limit=10))
        r2 = server.execute(R("3-path", limit=10**9, cursor=r1.next_cursor))
        if pkg == "j":
            want = [(x.count, x.stats["plan_cache"], x.stats["cursors"])
                    for x in (r, r1, r2)]
    got = [(x.count, x.stats["plan_cache"], x.stats["cursors"])
           for x in (r, r1, r2)]
    assert got == want
    assert r.stats["cursors"] == {"open": 0, "closed": {}}
    assert r1.stats["cursors"]["open"] == 1
    assert r2.stats["cursors"]["closed"].get("exhausted") == 1


def test_budget_chains_inner_callback(twin):
    _, gdb = twin.gdbs()
    q = T.get_query("3-path")
    plan, _ = twin.t._plan_for(QueryRequest("3-path", engine="vlftj"), gdb)
    calls = []

    def inner(level, frontier, mult):
        calls.append(level)
        return frontier[::-1], mult[::-1]   # pure permutation

    budget = QuantumBudget(None, "3-path", plan.gao, inner=inner)
    ex = T.VLFTJ(q, gdb, plan=plan.with_level_callback(budget))
    assert ex.count() == T.count(q, gdb, engine="vlftj")
    assert calls and budget.total_rows > 0


def test_scheduler_rejects_bad_arguments_and_cursor_requests(twin):
    for Sched, R in ((JQuantumScheduler, JQueryRequest),
                     (QuantumScheduler, QueryRequest)):
        server = twin.j if Sched is JQuantumScheduler else twin.t
        with pytest.raises(ValueError, match="unknown policy"):
            Sched(server, policy="lottery")
        with pytest.raises(ValueError, match="quantum_rows"):
            Sched(server, quantum_rows=0)
        with pytest.raises(ValueError, match="cursor continuations"):
            Sched(server).submit(R("3-path", cursor="cur-1"))


# ---------------------------------------------------------------------------
# the server: pages, cursors, plan cache, routing (test_enumerate.py,
# test_planner.py, test_perf_options.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csr300():
    return j_powerlaw_cluster(300, 4, seed=2)


def test_server_pagination_roundtrip(csr300):
    twin = Twin(csr300, page_rows=64)
    pages = {}
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        srv = getattr(twin, pkg)
        first = srv.execute(R("3-clique", selectivity=8, seed=0,
                              engine="vlftj", limit=50))
        assert first.count == 50 and first.next_cursor is not None
        assert first.plan.output_mode != "count"
        got, tok = [first.rows], first.next_cursor
        while tok is not None:
            nxt = srv.execute(R("3-clique", cursor=tok, limit=50))
            got.append(nxt.rows)
            tok = nxt.next_cursor
        pages[pkg] = got
        assert not srv._cursors
        with pytest.raises(ValueError):
            srv.execute(R("3-clique", cursor="cur-999"))
        again = srv.execute(R("3-clique", selectivity=8, seed=0,
                              engine="vlftj", limit=10))
        assert again.plan_cached
    assert [p.shape for p in pages["t"]] == [p.shape for p in pages["j"]]
    for g, w in zip(pages["t"], pages["j"]):
        np.testing.assert_array_equal(g, w)
    full = t_engine.enumerate(T.get_query("3-clique"), twin.t._gdb_for(8, 0),
                              engine="vlftj", order=first.row_vars,
                              mode="flat")
    np.testing.assert_array_equal(np.concatenate(pages["t"]), full.rows)


def test_server_cursor_registry_is_capped(csr300):
    twin = Twin(csr300, page_rows=8, max_open_cursors=3)
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        srv = getattr(twin, pkg)
        tokens = [srv.execute(R("3-clique", selectivity=8, seed=0,
                                engine="vlftj", limit=8)).next_cursor
                  for _ in range(5)]
        assert len(srv._cursors) == 3
        with pytest.raises(ValueError):
            srv.execute(R("3-clique", cursor=tokens[0]))
        last = srv.execute(R("3-clique", cursor=tokens[-1]))
        assert last.rows.shape[0] == 8
        if pkg == "j":
            want = (tokens, last.rows, srv.cursor_info())
    assert tokens == want[0]
    np.testing.assert_array_equal(last.rows, want[1])
    assert srv.cursor_info() == want[2]


def test_server_distinguishes_evicted_vs_exhausted_cursor(csr300):
    srv = QueryServer(_port_csr(csr300), page_rows=8, max_open_cursors=2,
                      device="cpu")
    tokens = [srv.execute(QueryRequest("3-clique", selectivity=8, seed=0,
                                       engine="vlftj", limit=8)).next_cursor
              for _ in range(3)]
    assert all(t is not None for t in tokens)
    assert list(srv._cursors) == tokens[1:]
    with pytest.raises(ValueError, match="evicted.*restart"):
        srv.execute(QueryRequest("3-clique", cursor=tokens[0]))
    tok = tokens[-1]
    while tok is not None:
        last = tok
        tok = srv.execute(
            QueryRequest("3-clique", cursor=tok, limit=512)).next_cursor
    with pytest.raises(ValueError, match="exhausted.*not restart"):
        srv.execute(QueryRequest("3-clique", cursor=last))
    with pytest.raises(ValueError, match="unknown"):
        srv.execute(QueryRequest("3-clique", cursor="cur-999"))
    assert srv.cursor_info()["closed"] == {"evicted": 1, "exhausted": 1}


def test_execute_many_mixes_counts_rows_and_cursors(csr300):
    twin = Twin(csr300, page_rows=32)
    out = {}
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        srv = getattr(twin, pkg)
        res = srv.execute_many([
            R("3-clique", selectivity=8, seed=0, limit=20),
            R("3-clique", selectivity=8, seed=0, limit=20),
            R("3-clique", selectivity=8, seed=0)])
        cont = srv.execute_many(
            [R("3-clique", cursor=res[0].next_cursor, limit=20)])
        out[pkg] = res + cont
    got, want = out["t"], out["j"]
    assert got[0].rows.shape == (20, 3) and got[1].plan_cached
    assert got[2].rows is None and got[2].count > 0
    assert not np.array_equal(got[3].rows, got[0].rows)
    for g, w in zip(got, want):
        assert (g.count, g.engine, g.plan_cached) == \
            (w.count, w.engine, w.plan_cached)
        if w.rows is not None:
            np.testing.assert_array_equal(g.rows, w.rows)


def test_query_server_plan_cache_counter():
    twin = Twin(j_powerlaw_cluster(200, 3, seed=1))
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        srv = getattr(twin, pkg)
        req = R("3-clique", selectivity=8, seed=0)
        r1, r2 = srv.execute(req), srv.execute(req)
        assert not r1.plan_cached and r2.plan_cached
        assert r1.count == r2.count
        if pkg == "j":
            want = (r1.count, srv.plan_cache_info())
    assert (r1.count, srv.plan_cache_info()) == want
    assert want[1]["misses"] == 1 and want[1]["hits"] >= 1


def test_query_server_execute_many_matches_batch():
    g = j_powerlaw_cluster(200, 3, seed=2)
    names = ["3-clique", "3-path", "3-clique", "2-lollipop", "3-path",
             "3-clique"]
    a, b = Twin(g), Twin(g)
    out = {}
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        reqs = [R(n, selectivity=8, seed=0) for n in names]
        batch = getattr(a, pkg).execute_batch(list(reqs))
        many = getattr(b, pkg).execute_many(list(reqs))
        assert [r.count for r in many] == [r.count for r in batch]
        assert [r.engine for r in many] == [r.engine for r in batch]
        out[pkg] = ([(r.count, r.engine) for r in many],
                    getattr(b, pkg).plan_cache_info())
    assert out["t"] == out["j"]
    assert out["t"][1]["misses"] == 3 and out["t"][1]["hits"] == 3


def test_query_server_routes_and_counts():
    twin = Twin(j_powerlaw_cluster(300, 4, seed=3))
    out = {}
    for pkg, R in (("j", JQueryRequest), ("t", QueryRequest)):
        res = getattr(twin, pkg).execute_batch([
            R("3-clique", selectivity=8, seed=0),
            R("3-path", selectivity=8, seed=0),
            R("2-lollipop", selectivity=8, seed=0)])
        out[pkg] = [(r.engine, r.count) for r in res]
    assert out["t"] == out["j"]
    assert [e for e, _ in out["t"]] == ["vlftj", "yannakakis", "hybrid"]
    # the scalar oracle on the same db (the 2-lollipop's takes seconds in
    # Python, so it is held against the port's vlftj instead)
    gdb = twin.t._gdb_for(8, 0)
    for (_, n), name, engine in zip(
            out["t"], ("3-clique", "3-path", "2-lollipop"),
            ("lftj_ref", "lftj_ref", "vlftj")):
        assert n == T.count(T.get_query(name), gdb, engine=engine)


@pytest.mark.parametrize("engine,shape", [
    ("vlftj", "2-lollipop"), ("yannakakis", "3-path"),
    ("hybrid", "2-lollipop"), ("auto", "3-path")])
def test_server_engine_stats_match_reference(engine, shape):
    """``stats["engine"]`` of a direct count response: the normalized
    dict of ``execute_stats``, equal to the JAX package's but for the
    host wall seconds."""
    twin = Twin(j_powerlaw_cluster(200, 3, seed=1))
    jr, tr = twin.req(shape, engine=engine, selectivity=8)
    want, got = twin.j.execute(jr), twin.t.execute(tr)
    assert (got.count, got.engine) == (want.count, want.engine)

    def strip(d):
        d = dict(d, raw={k: v for k, v in d["raw"].items()
                         if k != "level_wall_s"})
        d["level_wall_s"] = sorted(d["level_wall_s"])
        return d
    assert strip(got.stats["engine"]) == strip(want.stats["engine"])


# ---------------------------------------------------------------------------
# the partitioned route and the device
# ---------------------------------------------------------------------------

def test_partitioned_route_serves(csr300):
    """At or above ``dist_edge_threshold`` both packages run a vlftj
    plan through ``PartitionedJoin`` (label ``vlftj+partitioned``) on
    every entry point that routes there: counts, pages and the pool
    stats equal the JAX server's."""
    twin = Twin(csr300, dist_edge_threshold=1, page_rows=64)
    for shape in TIER1_SHAPES:
        jr, tr = twin.req(shape, engine="vlftj", selectivity=8)
        want, got = twin.j.execute(jr), twin.t.execute(tr)
        assert (got.count, got.engine) == (want.count, want.engine)
        assert got.engine == "vlftj+partitioned"
        jst, tst = twin.j.last_dist_stats, twin.t.last_dist_stats
        for k in ("parts", "part_sizes", "part_counts", "backend"):
            assert tst[k] == jst[k], k
        assert tst["parts"] == 8                      # 4 workers x 2
        assert tst["makespan"] <= tst["total_time"] + 1e-9
        _, t_gdb = twin.gdbs(selectivity=8)
        assert got.count == T.count(T.get_query(shape), t_gdb,
                                    engine="vlftj")
    # pages through the route, and their continuation
    jr, tr = twin.req("3-path", engine="vlftj", limit=100)
    want, got = twin.j.execute(jr), twin.t.execute(tr)
    assert got.engine == want.engine == "vlftj+partitioned"
    assert got.row_vars == tuple(want.row_vars)
    np.testing.assert_array_equal(got.rows, want.rows)
    jr, tr = twin.req("3-path", limit=100, cursor=want.next_cursor)
    tr.cursor = got.next_cursor
    np.testing.assert_array_equal(twin.t.execute(tr).rows,
                                  twin.j.execute(jr).rows)
    # execute_many and the scheduler keep the route; a dist-routed plan
    # runs opaque (not preemptible); other engines are never routed
    res = twin.t.execute_many(
        [QueryRequest("3-clique", engine="vlftj")] * 2)
    assert [r.engine for r in res] == ["vlftj+partitioned"] * 2
    (conc,) = twin.t.execute_concurrent(
        [QueryRequest("3-clique", engine="vlftj")])
    assert (conc.count, conc.engine) == (res[0].count, res[0].engine)
    sched = QuantumScheduler(twin.t, quantum_rows=64)
    sched.submit(QueryRequest("3-clique", engine="vlftj"))
    assert not sched._preemptible(sched._jobs[0])
    res = twin.t.execute(QueryRequest("3-path", engine="yannakakis"))
    assert res.engine == "yannakakis"
    # below the threshold (the default, 4,194,304 directed edges) the
    # same request serves unpartitioned
    plain = QueryServer(_port_csr(csr300), device="cpu")
    assert plain.dist_edge_threshold == 1 << 22
    assert plain.execute(QueryRequest("3-clique", engine="vlftj")).engine \
        == "vlftj"


def test_server_graphs_live_on_its_device(csr300):
    srv = QueryServer(_port_csr(csr300), device="cpu")
    gdb = srv._gdb_for(8, 0)
    assert gdb.device == torch.device("cpu")
    assert gdb.dev("indices").device.type == "cpu"
    assert srv._gdb_for(8, 0) is gdb          # warm: built once


# ---------------------------------------------------------------------------
# warm graphs share the server's edge tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_two_samples_share_the_edge_tensors(twin, shape):
    """Two samples of one server: one copy of ``indptr``, ``indices`` and
    ``src_ids``, a bitmap each, the counts of the JAX server on both,
    and ``server_warm_graphs`` counts the first built, the second
    shared."""
    twin.t.metrics_registry = MetricsRegistry()
    for seed in (0, 1):
        jr, tr = twin.req(shape, selectivity=8, seed=seed)
        want, got = twin.j.execute(jr), twin.t.execute(tr)
        assert (got.count, got.engine) == (want.count, want.engine)
    (_, a), (_, b) = twin.gdbs(0, 8), twin.gdbs(1, 8)
    assert a.edges is b.edges is twin.t._edges
    for key in ("indptr", "indices", "src_ids"):
        assert a.dev(key).data_ptr() == b.dev(key).data_ptr()
    assert a.dev("bitmap:v1").data_ptr() != b.dev("bitmap:v1").data_ptr()
    assert not torch.equal(a.dev("bitmap:v1"), b.dev("bitmap:v1"))
    for gdb in (a, b):
        assert gdb._dev and all(k.startswith("bitmap:") for k in gdb._dev)
    snap = twin.t.metrics()
    assert snap["server_warm_graphs{edges=built}"] == 1
    assert snap["server_warm_graphs{edges=shared}"] == 1


@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_partitioned_route_on_two_samples(csr300, shape):
    """The partitioned route's worker threads read the shared edge
    tensors through each sample's warm graph: the JAX server's counts on
    both samples, and the port's own vlftj on a db that builds its own."""
    twin = Twin(csr300, dist_edge_threshold=1)
    for seed in (0, 1):
        jr, tr = twin.req(shape, engine="vlftj", selectivity=8, seed=seed)
        want, got = twin.j.execute(jr), twin.t.execute(tr)
        assert got.engine == "vlftj+partitioned"
        assert got.count == want.count
        _, t_gdb = twin.gdbs(seed, 8)
        own = T.GraphDB(t_gdb.csr, t_gdb.unary, device="cpu")
        assert got.count == T.count(T.get_query(shape), own,
                                    engine="vlftj")
    assert len(twin.t._dist_joins) == 2


def test_warm_graphs_before_any_engine_call_count_one_build(csr300):
    """Samples taken before any engine call (a pool warmed in set-up, a
    burst of fresh submits): the server still builds one copy of the
    edge tensors, so one warm graph counts ``built``, the rest
    ``shared``."""
    srv = QueryServer(_port_csr(csr300), device="cpu",
                      metrics=MetricsRegistry())
    gdbs = [srv._gdb_for(8, seed) for seed in range(3)]
    assert not srv._edges._dev
    snap = srv.metrics()
    assert snap["server_warm_graphs{edges=built}"] == 1
    assert snap["server_warm_graphs{edges=shared}"] == 2
    for seed in range(3):
        srv.execute(QueryRequest("3-path", selectivity=8, seed=seed))
    assert all(g.dev("indices") is srv._edges.dev("indices") for g in gdbs)
    assert srv.metrics()["server_warm_graphs{edges=built}"] == 1
