"""The port's distributed execution (``repro_torch.dist``) on the CPU
against the JAX package's (``repro.dist``), on the same numpy CSR
arrays: the first-level partition and the straggler re-deal, the
partitioned join's counts, part counts, pages and dead workers on a real
thread pool, ``pick_backend``, the adaptive join's counts, cost-model
makespans and re-deal events, the sharded CSR's layout, accessors,
counts and exchange meters on every tier-1 shape, and the SPMD steps
over ``torch.distributed`` (gloo): at one rank in this process and at
four ranks in spawned processes.

Mirrors ``tests/test_dist_partition.py``, ``tests/test_rebalance.py``,
``tests/test_sharded_csr.py`` and the SPMD case of
``tests/test_multidevice.py``.  The JAX package runs on one CPU device
here, so the four-rank results are held against its one-device counts
and a scatter oracle.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro  # noqa: F401  (x64 for the reference)
from repro.core import GraphDB as JGraphDB
from repro.core import GraphStats as JGraphStats
from repro.core import VLFTJ as JVLFTJ
from repro.core import count as j_count
from repro.core import get_query as j_get_query
from repro.core.plan import executor_geometry
from repro.core.plan import partition_first_level as j_partition_first_level
from repro.core.plan import stripe_partition as j_stripe_partition
from repro.core.planner import plan_query as j_plan_query
from repro.dist.rebalance import AdaptiveJoin as JAdaptiveJoin
from repro.dist.rebalance import FrontierRebalancer as JFrontierRebalancer
from repro.dist.rebalance import cost_skew as j_cost_skew
from repro.dist.rebalance import rebalance_rows as j_rebalance_rows
from repro.dist.rebalance import row_extension_costs as j_row_costs
from repro.dist.sharded_csr import ShardedGraphDB as JShardedGraphDB
from repro.dist.sharded_csr import sharded_count as j_sharded_count
from repro.dist.sharded_join import PartitionedJoin as JPartitionedJoin
from repro.dist.sharded_join import spmd_join_step as j_spmd_join_step
from repro.graphs import node_sample as j_node_sample
from repro.graphs import powerlaw_cluster as j_powerlaw_cluster
from repro.graphs import zipf_graph as j_zipf_graph
from repro.obs import QueryTrace as JQueryTrace
from repro.train.stragglers import StepTimeTracker as JStepTimeTracker
from repro.train.stragglers import reassign_shards as j_reassign_shards

import repro_torch.core as T
from repro_torch.core.plan import partition_first_level, stripe_partition
from repro_torch.dist import (AdaptiveJoin, FrontierRebalancer,
                              PartitionedJoin, ShardedGraphDB, WorkerPool,
                              compressed_psum_leaf, compressed_psum_tree,
                              overlapped_reduce_apply, pick_backend,
                              ring_all_reduce, ring_schedule, sharded_count,
                              spmd_join_step, spmd_sharded_join_step,
                              spmd_spmv_step)
from repro_torch.device import check_group_device
from repro_torch.dist.rebalance import (cost_skew, rebalance_rows,
                                        row_extension_costs)
from repro_torch.dist.sharded_join import _on
from repro_torch.graphs import CSRGraph
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import searchsorted_segments_ref
from repro_torch.obs import QueryTrace
from repro_torch.train import StepTimeTracker, reassign_shards

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TIER1_SHAPES = ("3-clique", "4-clique", "4-cycle", "3-path", "2-lollipop",
                "3-lollipop")
#: how long a spawned rank may take, start-up and teardown included
RANK_TIMEOUT_S = 120


def _port_csr(j_csr) -> CSRGraph:
    return CSRGraph(indptr=np.asarray(j_csr.indptr, np.int64),
                    indices=np.asarray(j_csr.indices, np.int64),
                    n_nodes=int(j_csr.n_nodes))


class Twin:
    """One graph and unary samples as a JAX and a port (CPU) db."""

    def __init__(self, j_csr, unary):
        self.j_csr, self.unary = j_csr, unary
        self.csr = _port_csr(j_csr)
        self.j = JGraphDB(j_csr, unary)
        self.t = T.GraphDB(self.csr, unary, device="cpu")


def _samples(n_nodes: int, selectivity: float) -> dict:
    return {f"v{i}": j_node_sample(n_nodes, selectivity, seed=i)
            for i in range(1, 5)}


@pytest.fixture(scope="module")
def plc():
    g = j_powerlaw_cluster(300, 4, seed=11)
    return Twin(g, _samples(g.n_nodes, 6))


@pytest.fixture(scope="module")
def zipf():
    g = j_zipf_graph(1000, 6000, alpha=1.3, seed=0)
    return Twin(g, _samples(g.n_nodes, 6))


def _tri_kw(gdb, **over) -> dict:
    width, _ = executor_geometry(gdb.max_degree)
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
              width=width, n_iter=gdb.bsearch_iters, needs_degree=False)
    kw.update(over)
    return kw


def _edge_frontier(csr) -> np.ndarray:
    ea = csr.edge_array()
    return ea[ea[:, 0] < ea[:, 1]].astype(np.int32)


# ---------------------------------------------------------------------------
# partition and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items,n_parts", [(97, 8), (3, 8), (0, 4),
                                             (64, 1)])
def test_stripe_partition_matches_reference(n_items, n_parts):
    costs = np.random.default_rng(n_items).pareto(1.5, size=n_items) + 1.0
    got = stripe_partition(costs, n_parts)
    want = j_stripe_partition(costs, n_parts)
    assert len(got) == n_parts
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    if n_items:
        sizes = [len(p) for p in got]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("qname", ["3-clique", "4-cycle", "3-path",
                                   "2-lollipop"])
def test_partition_first_level_matches_reference(plc, qname):
    stats = JGraphStats.of(plc.j)
    j_plan = j_plan_query(j_get_query(qname), stats, engine="vlftj")
    t_plan = T.plan_query(T.get_query(qname), T.GraphStats.of(plc.t),
                          engine="vlftj")
    seeds = np.arange(plc.csr.n_nodes, dtype=np.int32)
    got = partition_first_level(t_plan, seeds, plc.csr.degrees, 8)
    want = j_partition_first_level(j_plan, seeds, plc.j_csr.degrees, 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dead", [set(), {1}, {0, 2}, {3}])
def test_reassign_shards_matches_reference(dead):
    for granularity in (1, 2, 3):
        assert reassign_shards(4, set(dead), granularity) == \
            j_reassign_shards(4, set(dead), granularity)
    with pytest.raises(RuntimeError, match="alive"):
        reassign_shards(2, {0, 1})


def test_step_time_tracker_matches_reference():
    times = [1.0, 1.1, 0.9, 1.05, 1.0, 0.95, 1.02, 1.1, 0.98, 1.0, 5.0,
             1.0, 0.2, 1.01, 9.0]
    t, j = StepTimeTracker(), JStepTimeTracker()
    assert [t.record(x) for x in times] == [j.record(x) for x in times]
    assert t.median == j.median


# ---------------------------------------------------------------------------
# the partitioned join and its pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["3-clique", "4-cycle", "3-path",
                                   "2-lollipop"])
def test_partitioned_count_matches_reference(plc, qname):
    want = JPartitionedJoin(j_get_query(qname), plc.j, n_workers=3,
                            granularity=2, backend="sequential")
    got = PartitionedJoin(T.get_query(qname), plc.t, n_workers=3,
                          granularity=2)
    assert got.count() == want.count() == j_count(
        j_get_query(qname), plc.j, engine="vlftj")
    for k in ("parts", "part_sizes", "part_counts"):
        assert got.stats[k] == want.stats[k], k
    assert got.schedule == want.schedule
    assert got.stats["backend"] == "thread"


def test_partitioned_stats_invariants(plc):
    pj = PartitionedJoin(T.get_query("3-clique"), plc.t, n_workers=4,
                         granularity=3)
    pj.count()
    st = pj.stats
    assert st["parts"] == 12
    assert st["makespan"] <= st["total_time"] + 1e-9
    assert abs(sum(st["worker_time"]) - st["total_time"]) < 1e-9
    assert len(st["part_time"]) == 12 and len(st["part_counts"]) == 12
    assert all(len(v) == 3 for v in pj.schedule.values())
    assert max(st["part_sizes"]) - min(st["part_sizes"]) <= 1
    assert st["wall_time"] > 0


def test_empty_and_sparse_parts_still_exact(plc):
    ref = j_count(j_get_query("3-clique"), plc.j, engine="vlftj")
    pj = PartitionedJoin(T.get_query("3-clique"), plc.t, n_workers=64,
                         granularity=8)
    assert pj.count() == ref
    assert pj.stats["parts"] == 512 and len(pj.stats["worker_time"]) == 64
    assert sum(s == 0 for s in pj.stats["part_sizes"]) > 0
    assert pj.executor.seeded_count(np.empty(0, np.int32),
                                    np.empty(0, np.int64)) == 0


@pytest.mark.parametrize("backend", ["thread", "sequential"])
def test_dead_worker_redeal_matches_reference(plc, backend):
    want = JPartitionedJoin(j_get_query("3-path"), plc.j, n_workers=4,
                            granularity=2, dead={1}, backend="sequential")
    got = PartitionedJoin(T.get_query("3-path"), plc.t, n_workers=4,
                          granularity=2, dead={1}, backend=backend)
    assert got.count() == want.count()
    assert got.schedule == want.schedule
    assert sorted(p for ps in got.schedule.values() for p in ps) == \
        list(range(8))
    assert 1 not in got.schedule and got.stats["worker_time"][1] == 0.0
    assert got.stats["part_counts"] == want.stats["part_counts"]
    assert got.stats["backend"] == backend


def test_thread_pool_equals_sequential_part_for_part(plc):
    for qname in ("3-clique", "3-path"):
        seq = PartitionedJoin(T.get_query(qname), plc.t, n_workers=3,
                              granularity=2, backend="sequential")
        pool = PartitionedJoin(T.get_query(qname), plc.t, n_workers=3,
                               granularity=2, backend="thread")
        assert seq.count() == pool.count()
        assert seq.stats["part_counts"] == pool.stats["part_counts"]
        assert (seq.stats["backend"], pool.stats["backend"]) == \
            ("sequential", "thread")


def test_threaded_launch_counts_equal_sequential(plc, monkeypatch):
    """The launch counter under the partitioned join's threads: a
    searchsorted route that counts a launch per call (as the card's
    wrapper does) gives the same total on four threads as in one."""

    def counted(*args):
        out = searchsorted_segments_ref(*args)
        build.count_launch("searchsorted_segments")
        return out

    monkeypatch.setattr(kops, "searchsorted_segments", counted)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        totals = {}
        for backend in ("sequential", "thread"):
            pj = PartitionedJoin(T.get_query("4-cycle"), plc.t,
                                 n_workers=4, granularity=4,
                                 backend=backend, chunk_rows=64)
            build.reset_launches()
            pj.count()
            totals[backend] = build.LAUNCHES["searchsorted_segments"]
    finally:
        sys.setswitchinterval(old)
        build.reset_launches()
    # the thread run also warms with one seed before the fan-out
    warm = PartitionedJoin(T.get_query("4-cycle"), plc.t, n_workers=4,
                           granularity=4, chunk_rows=64)
    monkeypatch.setattr(kops, "searchsorted_segments", counted)
    build.reset_launches()
    warm._count_part(max(warm.parts, key=lambda p: p.shape[0])[:1])
    extra = build.LAUNCHES["searchsorted_segments"]
    build.reset_launches()
    assert totals["sequential"] > 0
    assert totals["thread"] == totals["sequential"] + extra


def test_count_launch_is_atomic_under_threads():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, per = 16, 2000
    try:
        build.reset_launches()
        threads = [threading.Thread(target=lambda: [
            build.count_launch("intersect_count") for _ in range(per)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert build.LAUNCHES["intersect_count"] == n_threads * per
    finally:
        sys.setswitchinterval(old)
        build.reset_launches()


@pytest.mark.parametrize("qname", ["3-path", "3-clique", "4-cycle"])
def test_partitioned_pages_equal_enumerate_and_reference(plc, qname):
    pj = PartitionedJoin(T.get_query(qname), plc.t, n_workers=3,
                         granularity=2)
    full = pj.enumerate().rows
    want = JPartitionedJoin(j_get_query(qname), plc.j, n_workers=3,
                            granularity=2).enumerate().rows
    np.testing.assert_array_equal(full, want)
    pages = list(pj.pages(page_rows=97))
    assert all(p.shape[0] == 97 for p in pages[:-1])
    np.testing.assert_array_equal(np.concatenate(pages), full)
    np.testing.assert_array_equal(pj.enumerate(limit=150).rows, full[:150])
    ref = T.VLFTJ(T.get_query(qname), plc.t).enumerate()
    np.testing.assert_array_equal(full, ref)


def test_pick_backend_votes_thread_for_any_tensor(plc):
    pj = PartitionedJoin(T.get_query("3-clique"), plc.t, n_workers=2,
                         granularity=2)
    assert pj.count() == j_count(j_get_query("3-clique"), plc.j,
                                 engine="vlftj")
    assert pj.stats["backend"] == "thread"
    assert pick_backend(pj._count_part, pj.parts[0]) == "thread"
    # a CPU tensor pickles, but a spawned worker would re-stage it
    assert pick_backend(math.factorial, torch.zeros(3)) == "thread"
    assert pick_backend(math.factorial, 5) == "process"


def test_worker_pool_process_backend_roundtrip():
    sched = {0: [0, 2], 1: [1, 3]}
    res, ptime, wall, backend = WorkerPool(sched, backend="auto").run(
        math.factorial, [5, 6, 7, 8])
    assert backend == "process"
    assert res == {0: 120, 1: 720, 2: 5040, 3: 40320}
    assert set(ptime) == {0, 1, 2, 3} and wall > 0
    with pytest.raises(ValueError, match="backend"):
        WorkerPool(sched, backend="fleet")


# ---------------------------------------------------------------------------
# mid-join re-balancing
# ---------------------------------------------------------------------------

def test_rebalance_helpers_match_reference(zipf):
    costs = np.random.default_rng(0).pareto(1.2, size=203) + 1.0
    for a, b in zip(rebalance_rows(costs, 8), j_rebalance_rows(costs, 8)):
        np.testing.assert_array_equal(a, b)
    for c in ([], [0.0, 0.0], [3.0, 1.0], costs):
        assert cost_skew(c) == j_cost_skew(c)
    ex = T.VLFTJ(T.get_query("3-clique"), zipf.t)
    jex = JVLFTJ(j_get_query("3-clique"), zipf.j)
    fr = np.array([[0, 1], [5, 900], [7, 7]], dtype=np.int32)
    stats, j_stats = T.GraphStats.of(zipf.t), JGraphStats.of(zipf.j)
    for lv in (1, 2):
        for kw in ({}, {"lane_cost": 64.0}):
            np.testing.assert_array_equal(
                row_extension_costs(fr, ex.plan[lv], zipf.csr.degrees,
                                    **kw),
                j_row_costs(fr, jex.plan[lv], zipf.j_csr.degrees, **kw))
            np.testing.assert_array_equal(
                row_extension_costs(fr, ex.plan[lv], None, stats, **kw),
                j_row_costs(fr, jex.plan[lv], None, j_stats, **kw))


@pytest.mark.parametrize("qname", ["3-clique", "4-cycle", "3-path"])
@pytest.mark.parametrize("rebalance", [False, True])
def test_adaptive_join_matches_reference(zipf, qname, rebalance):
    kw = dict(n_shards=8, threshold=1.2, rebalance=rebalance)
    got = AdaptiveJoin(T.get_query(qname), zipf.t, **kw)
    want = JAdaptiveJoin(j_get_query(qname), zipf.j, **kw)
    assert got.count() == want.count() == j_count(
        j_get_query(qname), zipf.j, engine="vlftj")
    for k in ("cost_makespan", "cost_total", "rebalances", "count",
              "shards", "levels"):
        assert got.stats[k] == want.stats[k], k
    st = got.stats
    assert st["makespan"] <= st["total_time"] + 1e-9
    assert abs(sum(st["shard_time"]) - st["total_time"]) < 1e-9


def test_adaptive_rebalance_beats_static_on_zipf(zipf):
    q = T.get_query("3-path")
    stat = AdaptiveJoin(q, zipf.t, n_shards=8, rebalance=False)
    ada = AdaptiveJoin(q, zipf.t, n_shards=8, threshold=1.2)
    assert stat.count() == ada.count()
    assert ada.stats["rebalances"]
    assert ada.stats["cost_makespan"] <= stat.stats["cost_makespan"]
    ev = ada.stats["rebalances"][0]
    assert ev["skew_after"] <= ev["skew_before"]


def test_adaptive_join_more_shards_than_seeds():
    g = j_zipf_graph(300, 1200, alpha=1.3, seed=5)
    tw = Twin(g, _samples(g.n_nodes, 8))
    ref = j_count(j_get_query("3-path"), tw.j, engine="vlftj")
    for rebalance in (False, True):
        aj = AdaptiveJoin(T.get_query("3-path"), tw.t, n_shards=64,
                          rebalance=rebalance)
        assert sum(p.shape[0] == 0 for p in aj.parts) > 0
        assert aj.count() == ref
        want = JAdaptiveJoin(j_get_query("3-path"), tw.j, n_shards=64,
                             rebalance=rebalance)
        want.count()
        assert aj.stats["cost_makespan"] == want.stats["cost_makespan"]


def test_frontier_rebalancer_is_a_pure_permutation(zipf):
    q = T.get_query("3-path")
    plan = T.plan_query(q, T.GraphStats.of(zipf.t), engine="vlftj")
    reb = FrontierRebalancer(plan, n_shards=8, degrees=zipf.csr.degrees,
                             threshold=1.2)
    cb_plan = plan.with_level_callback(reb)
    assert hash(cb_plan) == hash(plan)
    ref = T.VLFTJ(q, zipf.t, plan=plan).count()
    assert T.VLFTJ(q, zipf.t, plan=cb_plan).count() == ref
    j_plan = j_plan_query(j_get_query("3-path"), JGraphStats.of(zipf.j),
                          engine="vlftj")
    j_reb = JFrontierRebalancer(j_plan, n_shards=8,
                                degrees=zipf.j_csr.degrees, threshold=1.2)
    JVLFTJ(j_get_query("3-path"), zipf.j,
           plan=j_plan.with_level_callback(j_reb)).count()
    assert reb.events and reb.events == j_reb.events
    rows_ref = T.VLFTJ(q, zipf.t, plan=plan).enumerate(limit=500)
    rows_cb = T.VLFTJ(q, zipf.t, plan=cb_plan).enumerate(limit=500)
    np.testing.assert_array_equal(rows_ref, rows_cb)


# ---------------------------------------------------------------------------
# the sharded CSR (host)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_shard_layout_matches_reference(plc, n_shards):
    sg = ShardedGraphDB(plc.csr, n_shards, plc.unary)
    jsg = JShardedGraphDB(plc.j_csr, n_shards, plc.unary)
    np.testing.assert_array_equal(sg.bounds, jsg.bounds)
    for a, b in zip(sg.local_indptr + sg.local_indices,
                    jsg.local_indptr + jsg.local_indices):
        np.testing.assert_array_equal(a, b)
    assert sg.shard_sizes == jsg.shard_sizes
    blk, jblk = sg.device_blocks(), jsg.device_blocks()
    for k in ("indptr", "indices", "bounds"):
        np.testing.assert_array_equal(blk[k], jblk[k])
    v = np.arange(plc.csr.n_nodes)
    np.testing.assert_array_equal(sg.owner_of(v), jsg.owner_of(v))
    r = sg.replicated()
    np.testing.assert_array_equal(r.indptr, plc.csr.indptr)
    np.testing.assert_array_equal(r.indices, plc.csr.indices)
    assert sg.graph_stats() == T.GraphStats.of(plc.t)


def test_sharded_accessors_match_reference(plc):
    sg = ShardedGraphDB(plc.csr, 3)
    jsg = JShardedGraphDB(plc.j_csr, 3)
    v = np.array([0, 7, 150, 299, 42])
    np.testing.assert_array_equal(sg.degrees_of(v), plc.csr.degrees[v])
    for a, b in zip(sg.gather_segments(v), jsg.gather_segments(v)):
        np.testing.assert_array_equal(a, b)
    jsg.degrees_of(v)
    assert sg.exchange == jsg.exchange


@pytest.mark.parametrize("qname", TIER1_SHAPES)
def test_sharded_count_and_exchange_match_reference(plc, qname):
    sg = ShardedGraphDB(plc.csr, 4, plc.unary)
    jsg = JShardedGraphDB(plc.j_csr, 4, plc.unary)
    got = sharded_count(T.get_query(qname), sg)
    assert got == j_sharded_count(j_get_query(qname), jsg) == j_count(
        j_get_query(qname), plc.j, engine="vlftj")
    assert sg.exchange == jsg.exchange and sg.exchange["values"] > 0


@pytest.mark.parametrize("n_shards", [1, 2, 7])
def test_sharded_count_shard_count_invariance(plc, n_shards):
    ref = j_count(j_get_query("4-cycle"), plc.j, engine="vlftj")
    assert sharded_count(T.get_query("4-cycle"), ShardedGraphDB(
        plc.csr, n_shards, plc.unary)) == ref


def test_traced_sharded_count_exchange_events_match_reference(plc):
    tr, jtr = QueryTrace("4-cycle", (), "sharded"), \
        JQueryTrace("4-cycle", (), "sharded")
    with tr.activate():
        sharded_count(T.get_query("4-cycle"),
                      ShardedGraphDB(plc.csr, 4, plc.unary))
    with jtr.activate():
        j_sharded_count(j_get_query("4-cycle"),
                        JShardedGraphDB(plc.j_csr, 4, plc.unary))
    got = [{k: v for k, v in e.items() if k != "t"}
           for e in tr.events_named("exchange")]
    want = [{k: v for k, v in e.items() if k != "t"}
            for e in jtr.events_named("exchange")]
    assert got and got == want
    assert tr.levels == jtr.levels


# ---------------------------------------------------------------------------
# SPMD steps at one rank (gloo, this process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo1(tmp_path_factory):
    store = tmp_path_factory.mktemp("gloo1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1, timeout=timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def tri():
    """Triangle level inputs on a graph the JAX test uses: the port's
    db, the (a < b) edge frontier, level keywords, the JAX count."""
    g = j_powerlaw_cluster(256, 4, seed=0)
    tw = Twin(g, {})
    fr = _edge_frontier(tw.csr)
    ref = JVLFTJ(j_get_query("3-clique"), tw.j).count()
    return tw, fr, _tri_kw(tw.t), ref


def test_spmd_join_step_one_rank(gloo1, tri):
    tw, fr, kw, ref = tri
    db = tw.t
    step = spmd_join_step(gloo1, kw, device="cpu")
    assert step.n_shards == 1
    ones = np.ones(len(fr), np.int64)
    total = step(db.dev("indptr"), db.dev("indices"), fr, ones)
    assert total.dtype == torch.int64 and int(total) == ref
    # tensors, and a width whose row chunk (1024) cuts the frontier:
    # the lanes past a row's degree count nothing
    wide = dict(kw, width=1 << 12, n_iter=13)
    assert executor_geometry(0, width=wide["width"])[1] < len(fr)
    assert int(spmd_join_step(gloo1, wide, device="cpu")(
        db.dev("indptr"), db.dev("indices"), torch.from_numpy(fr),
        torch.from_numpy(ones))) == ref
    # the JAX step on its one device, with the degree check on too
    import jax
    mesh = jax.make_mesh((1,), ("data",))
    deg_kw = dict(kw, needs_degree=True)
    assert int(spmd_join_step(gloo1, deg_kw, device="cpu")(
        db.dev("indptr"), db.dev("indices"), fr, ones)) == int(
            j_spmd_join_step(mesh, deg_kw)(
                tw.j.dev("indptr"), tw.j.dev("indices"), fr, ones))


def test_spmd_join_step_applies_rebalancer_callback(gloo1, zipf):
    q = T.get_query("3-clique")
    plan = T.plan_query(q, T.GraphStats.of(zipf.t), engine="vlftj")
    ex = T.VLFTJ(q, zipf.t, plan=plan)
    fr = np.asarray(ex._run(count_only=False, max_levels=2), np.int32)
    lp = ex.plan[2]
    kw = _tri_kw(zipf.t, probe_cols=lp.edge_sources, lower_cols=lp.lower,
                 upper_cols=lp.upper, needs_degree=lp.needs_degree)
    mult = np.ones(fr.shape[0], np.int64)
    args = (zipf.t.dev("indptr"), zipf.t.dev("indices"), fr, mult)
    plain = int(spmd_join_step(gloo1, kw, device="cpu")(*args))
    reb = FrontierRebalancer(plan, n_shards=8, degrees=zipf.csr.degrees,
                             threshold=1.01)
    got = int(spmd_join_step(gloo1, kw, plan=plan.with_level_callback(reb),
                             device="cpu")(*args))
    assert got == plain == j_count(j_get_query("3-clique"), zipf.j,
                                   engine="vlftj")
    assert reb.events and reb.events[0]["rows"] == fr.shape[0]


def test_spmd_spmv_step_one_rank(gloo1, tri):
    tw = tri[0]
    sid = tw.t.dev("src_ids")
    c = torch.arange(tw.csr.n_nodes, dtype=torch.int64)
    y = spmd_spmv_step(gloo1, tw.csr.n_nodes, device="cpu")(
        tw.t.dev("indices"), sid, c)
    oracle = np.zeros(tw.csr.n_nodes, np.int64)
    np.add.at(oracle, sid.numpy(), c.numpy()[tw.csr.indices])
    np.testing.assert_array_equal(y.numpy(), oracle)


@pytest.mark.parametrize("needs_degree", [False, True])
def test_spmd_sharded_join_step_one_rank(gloo1, tri, needs_degree):
    tw, fr, kw, ref = tri
    # the wide tile makes the row chunk (1024) cut the frontier
    kw = dict(kw, needs_degree=needs_degree, width=1 << 12, n_iter=13)
    ones = np.ones(len(fr), np.int64)
    step = spmd_sharded_join_step(gloo1, kw, ShardedGraphDB(tw.csr, 1),
                                  device="cpu")
    want = int(spmd_join_step(gloo1, kw, device="cpu")(
        tw.t.dev("indptr"), tw.t.dev("indices"), fr, ones))
    assert step(fr, ones) == want
    if not needs_degree:
        assert want == ref


#: the JAX package's sharded-CSR counts of the triangle level at tile
#: widths below the graph's max degree (85 and 35): its step searches
#: the whole sentinel-padded tile, so a segment longer than the tile is
#: cut at it
SHARDED_NARROW = {((400, 5, 1), 8): 56, ((400, 5, 1), 32): 680,
                  ((400, 5, 1), 64): 1003, ((400, 5, 1), 128): 1070,
                  ((100, 3, 0), 8): 41}


@pytest.mark.parametrize("graph,width", sorted(SHARDED_NARROW),
                         ids=[f"plc{g[0]}-w{w}" for g, w in
                              sorted(SHARDED_NARROW)])
@pytest.mark.parametrize("needs_degree", [False, True])
def test_spmd_sharded_join_step_width_below_degree(gloo1, graph, width,
                                                   needs_degree):
    """A check segment longer than the tile width is searched within its
    own row's tile, as the JAX step searches it, not into the next
    row's tile."""
    import jax
    from repro.dist.sharded_csr import \
        spmd_sharded_join_step as j_sharded_step
    g = j_powerlaw_cluster(graph[0], graph[1], seed=graph[2])
    csr = _port_csr(g)
    fr = _edge_frontier(csr)
    ones = np.ones(len(fr), np.int64)
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
              width=width, n_iter=int(math.ceil(math.log2(width))) + 1,
              needs_degree=needs_degree)
    want = int(j_sharded_step(jax.make_mesh((1,), ("data",)), kw,
                              JShardedGraphDB(g, 1))(fr, ones))
    got = spmd_sharded_join_step(gloo1, kw, ShardedGraphDB(csr, 1),
                                 device="cpu")(fr, ones)
    assert got == want == SHARDED_NARROW[(graph, width)]


@pytest.mark.parametrize("extra", [[5, 121], [5, -1], [-2, 7]],
                         ids=lambda e: f"{e[0]},{e[1]}")
@pytest.mark.parametrize("unroll", [False, True])
def test_spmd_join_step_takes_what_the_jax_step_takes(gloo1, extra, unroll):
    """A frontier row with an id outside the graph (JAX clamps the
    gather, the port clamps it the same way) and the JAX package's
    ``unroll`` keyword in the level keywords: the same count as the JAX
    step, 314 on this graph for the row ``[5, 121]`` as without it."""
    import jax
    g = j_powerlaw_cluster(120, 4, seed=2)
    csr = _port_csr(g)
    fr = np.concatenate([_edge_frontier(csr),
                         np.asarray([extra], np.int32)])
    ones = np.ones(len(fr), np.int64)
    db = T.GraphDB(csr, {}, device="cpu")
    kw = _tri_kw(db, unroll=unroll)
    got = int(spmd_join_step(gloo1, kw, device="cpu")(
        db.dev("indptr"), db.dev("indices"), fr, ones))
    jdb = JGraphDB(g, {})
    want = int(j_spmd_join_step(jax.make_mesh((1,), ("data",)), kw)(
        jdb.dev("indptr"), jdb.dev("indices"), fr, ones))
    assert got == want
    if extra == [5, 121]:
        assert got == 314


def test_spmd_steps_refuse_wrong_inputs(gloo1, tri, monkeypatch):
    tw, fr, kw, _ = tri
    with pytest.raises(ValueError, match="sharded 2 ways"):
        spmd_sharded_join_step(gloo1, kw, ShardedGraphDB(tw.csr, 2),
                               device="cpu")
    with pytest.raises(ValueError, match="one"):
        spmd_sharded_join_step((gloo1, gloo1), kw,
                               ShardedGraphDB(tw.csr, 1), device="cpu")
    with pytest.raises(ValueError, match="unary"):
        spmd_sharded_join_step(gloo1, dict(kw, n_unary=1),
                               ShardedGraphDB(tw.csr, 1), device="cpu")
    with pytest.raises(ValueError, match="rank"):
        spmd_spmv_step(gloo1, 4, device="cpu")(
            np.zeros(3, np.int64), np.zeros(2, np.int64), np.ones(4))
    with pytest.raises(ValueError, match="meta"):
        _on(torch.zeros(3, device="meta"), torch.device("cpu"),
            torch.int32, "frontier")
    # a CPU tensor under a NCCL group, and a CUDA one under gloo
    check_group_device(gloo1, torch.device("cpu"), "x")
    with pytest.raises(ValueError, match="nccl"):
        check_group_device(gloo1, torch.device("cuda"), "x")
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="gloo"):
        spmd_join_step(gloo1, kw, device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        ring_all_reduce(torch.zeros(4), gloo1)


def test_collectives_one_rank(gloo1):
    x = torch.randn(8, 5, generator=torch.Generator().manual_seed(0))
    assert ring_schedule(gloo1) == (1, [(0, 0)])
    assert torch.equal(ring_all_reduce(x, gloo1), x)
    r, err = compressed_psum_leaf(x, torch.zeros_like(x), gloo1)
    scale = float(x.abs().max()) / 127
    assert float((r - x).abs().max()) <= scale / 2 + 1e-7
    torch.testing.assert_close(r + err, x, rtol=0, atol=1e-6)
    tree_r, tree_e = compressed_psum_tree(
        {"a": x, "b": [x[:2], x[2:]]},
        {"a": torch.zeros_like(x), "b": [torch.zeros(2, 5),
                                         torch.zeros(6, 5)]}, gloo1)
    assert torch.equal(tree_r["a"], r) and len(tree_e["b"]) == 2
    g = x.clone()
    out = overlapped_reduce_apply(g, x, gloo1, lambda p, gr: p - 0.5 * gr,
                                  n_chunks=3)
    torch.testing.assert_close(out, 0.5 * x)
    assert torch.equal(g, x)


# ---------------------------------------------------------------------------
# SPMD steps at four ranks (gloo, spawned processes)
# ---------------------------------------------------------------------------

RANK_SCRIPT = """
import json, sys
from datetime import timedelta
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, timeout=timedelta(seconds=60))
import repro_torch.core as T
from repro_torch.core.plan import executor_geometry
from repro_torch.dist import (FrontierRebalancer, ShardedGraphDB,
                              compressed_psum_leaf, overlapped_reduce_apply,
                              ring_all_reduce, spmd_join_step,
                              spmd_sharded_join_step, spmd_spmv_step)
from repro_torch.graphs import powerlaw_cluster, zipf_graph
out = {}
g = powerlaw_cluster(256, 4, seed=0)
db = T.GraphDB(g, {}, device="cpu")
ea = g.edge_array()
fr = ea[ea[:, 0] < ea[:, 1]].astype(np.int32)
if fr.shape[0] % world == 0:
    fr = fr[:-1]              # not a rank multiple: the step pads
ones = np.ones(fr.shape[0], np.int64)
width, _ = executor_geometry(db.max_degree)
kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
          width=width, n_iter=db.bsearch_iters, needs_degree=False)
args = (db.dev("indptr"), db.dev("indices"), fr, ones)
out["rows"] = int(fr.shape[0])
out["join"] = int(spmd_join_step(None, kw, device="cpu")(*args))
deg_kw = dict(kw, needs_degree=True)
out["join_deg"] = int(spmd_join_step(None, deg_kw, device="cpu")(*args))
sg = ShardedGraphDB(g, world)
out["ring"] = spmd_sharded_join_step(None, kw, sg, device="cpu")(fr, ones)
out["ring_deg"] = spmd_sharded_join_step(None, deg_kw, sg,
                                         device="cpu")(fr, ones)
try:
    spmd_sharded_join_step(None, kw, ShardedGraphDB(g, world + 1),
                           device="cpu")
    out["mismatch"] = "accepted"
except ValueError as e:
    out["mismatch"] = str(e)
e = (g.n_edges // world) * world
c = torch.arange(g.n_nodes, dtype=torch.int64)
y = spmd_spmv_step(None, g.n_nodes, device="cpu")(
    db.dev("indices")[:e], db.dev("src_ids")[:e], c)
out["spmv"] = y.tolist()
out["spmv_edges"] = e
zg = zipf_graph(1000, 6000, alpha=1.3, seed=0)
zdb = T.GraphDB(zg, {}, device="cpu")
q = T.get_query("3-clique")
plan = T.plan_query(q, T.GraphStats.of(zdb), engine="vlftj")
zfr = np.asarray(T.VLFTJ(q, zdb, plan=plan)._run(count_only=False,
                                                 max_levels=2), np.int32)
zw, _ = executor_geometry(zdb.max_degree)
lp = plan.levels[2]
zkw = dict(kw, width=zw, n_iter=zdb.bsearch_iters,
           probe_cols=lp.edge_sources, lower_cols=lp.lower,
           upper_cols=lp.upper, needs_degree=lp.needs_degree)
reb = FrontierRebalancer(plan, n_shards=world, degrees=zg.degrees,
                         threshold=1.01)
zargs = (zdb.dev("indptr"), zdb.dev("indices"), zfr,
         np.ones(zfr.shape[0], np.int64))
out["zipf_plain"] = int(spmd_join_step(None, zkw, device="cpu")(*zargs))
out["zipf_rebalanced"] = int(spmd_join_step(
    None, zkw, plan=plan.with_level_callback(reb), device="cpu")(*zargs))
out["zipf_events"] = len(reb.events)
x = torch.randn(9, 5, generator=torch.Generator().manual_seed(rank))
out["allreduce"] = ring_all_reduce(x).tolist()
r, err = compressed_psum_leaf(x, torch.zeros_like(x))
r2, _ = compressed_psum_leaf(torch.zeros_like(x), err)
out["compressed"] = [r.tolist(), (r + r2).tolist()]
out["overlap"] = overlapped_reduce_apply(
    x, torch.zeros_like(x), None, lambda p, gr: p + gr, n_chunks=3).tolist()
dist.barrier()
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def _spawn_ranks(world: int, store: Path) -> list[dict]:
    """Run ``RANK_SCRIPT`` as ``world`` spawned processes; each joins
    within ``RANK_TIMEOUT_S`` or the test fails (no hang)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_SCRIPT), str(r),
         str(world), str(store)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            assert line, out[-2000:] + err[-2000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return _spawn_ranks(4, tmp_path_factory.mktemp("gloo4") / "store")


@pytest.fixture(scope="module")
def ref4(tri, zipf):
    """The JAX package's one-device counts for the four-rank script."""
    import jax
    tw, fr, kw, _ = tri
    fr = fr[:-1] if fr.shape[0] % 4 == 0 else fr
    ones = np.ones(fr.shape[0], np.int64)
    mesh = jax.make_mesh((1,), ("data",))
    args = (tw.j.dev("indptr"), tw.j.dev("indices"), fr, ones)
    return {"rows": int(fr.shape[0]),
            "join": int(j_spmd_join_step(mesh, kw)(*args)),
            "join_deg": int(j_spmd_join_step(
                mesh, dict(kw, needs_degree=True))(*args)),
            "clique": JVLFTJ(j_get_query("3-clique"), tw.j).count(),
            "zipf_clique": j_count(j_get_query("3-clique"),
                                   JGraphDB(zipf.j_csr, {}), engine="vlftj"),
            "tw": tw}


def test_four_ranks_agree(ranks4):
    assert len(ranks4) == 4
    for k in ("rows", "join", "join_deg", "ring", "ring_deg", "spmv",
              "zipf_plain", "zipf_rebalanced", "allreduce", "compressed",
              "overlap"):
        assert all(r[k] == ranks4[0][k] for r in ranks4), k


def test_four_ranks_spmd_join_step_matches_reference(ranks4, ref4):
    r = ranks4[0]
    assert r["rows"] == ref4["rows"]
    assert r["join"] == ref4["join"]
    assert r["join_deg"] == ref4["join_deg"]
    if ref4["rows"] == len(_edge_frontier(ref4["tw"].csr)):
        assert r["join"] == ref4["clique"]


def test_four_ranks_sharded_ring_matches_reference(ranks4, ref4):
    for r in ranks4:
        assert r["ring"] == ref4["join"]
        assert r["ring_deg"] == ref4["join_deg"]
        assert "sharded 5 ways" in r["mismatch"]


def test_four_ranks_rebalanced_step_matches_reference(ranks4, ref4):
    for r in ranks4:
        assert r["zipf_plain"] == r["zipf_rebalanced"] == \
            ref4["zipf_clique"]
        assert r["zipf_events"] >= 1


def test_four_ranks_spmv_matches_scatter_oracle(ranks4, ref4):
    csr = ref4["tw"].csr
    e = ranks4[0]["spmv_edges"]
    sid = np.repeat(np.arange(csr.n_nodes), csr.degrees)[:e]
    oracle = np.zeros(csr.n_nodes, np.int64)
    np.add.at(oracle, sid, np.arange(csr.n_nodes)[csr.indices[:e]])
    for r in ranks4:
        np.testing.assert_array_equal(np.asarray(r["spmv"]), oracle)


def test_four_ranks_collectives(ranks4):
    xs = [torch.randn(9, 5, generator=torch.Generator().manual_seed(r))
          for r in range(4)]
    total = torch.stack(xs).sum(0)
    mean = total / 4
    scale = max(float(x.abs().max()) for x in xs) / 127
    for r in ranks4:
        torch.testing.assert_close(torch.tensor(r["allreduce"]), total,
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(torch.tensor(r["overlap"]), total,
                                   rtol=0, atol=1e-5)
        one, two = (torch.tensor(v) for v in r["compressed"])
        assert float((one - mean).abs().max()) <= scale
        # error feedback: the second round recovers the residue
        assert float((two - mean).abs().max()) <= \
            float((one - mean).abs().max()) + 1e-6
