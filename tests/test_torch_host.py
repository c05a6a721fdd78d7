"""Host layer of the PyTorch port vs the JAX package, exactly.

The port keeps its own copies of the numpy/scipy modules (graphs, query
IR, planner).  The same seed must give identical graphs, samples,
renumberings and bitset layouts, and the same stats must give the same
plan fields, in both packages.
"""
import dataclasses

import numpy as np
import pytest

import repro  # noqa: F401  (x64 for the reference)
from repro.analysis.__main__ import STATS_PROFILES, TIER1_SHAPES
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import PAPER_QUERIES as J_PAPER_QUERIES
from repro.core.query import get_query as j_get_query
from repro.core.yannakakis import NotTreeShaped as JNotTreeShaped
from repro.graphs import generators as j_gen
from repro.graphs import layout as j_layout
from repro.graphs.sampling import node_sample as j_node_sample

import repro_torch  # noqa: F401
from repro_torch.core import GraphStats, get_query, plan_query
from repro_torch.core.yannakakis import NotTreeShaped
from repro_torch.graphs import generators as t_gen
from repro_torch.graphs import layout as t_layout
from repro_torch.graphs.sampling import node_sample

GENERATORS = [
    ("erdos_renyi", dict(n=300, m=900, seed=3)),
    ("barabasi_albert", dict(n=200, m_per_node=4, seed=1)),
    ("powerlaw_cluster", dict(n=250, m_per_node=3, tri_p=0.5, seed=2)),
    ("zipf_graph", dict(n=300, m=2400, alpha=2.0, seed=0)),
]


def _same_csr(a, b):
    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generators_match(name, kw):
    _same_csr(getattr(j_gen, name)(**kw), getattr(t_gen, name)(**kw))


@pytest.mark.parametrize("dataset", ["ca-GrQc", "p2p-Gnutella04",
                                     "soc-Slashdot0811"])
def test_snap_like_matches(dataset):
    assert t_gen.SNAP_LIKE == j_gen.SNAP_LIKE
    _same_csr(j_gen.make_snap_like(dataset, seed=0, scale=0.01),
              t_gen.make_snap_like(dataset, seed=0, scale=0.01))


@pytest.mark.parametrize("n,sel,seed", [(500, 4.0, 0), (77, 8.0, 18),
                                        (3, 1000.0, 5)])
def test_node_sample_matches(n, sel, seed):
    np.testing.assert_array_equal(j_node_sample(n, sel, seed=seed),
                                  node_sample(n, sel, seed=seed))


@pytest.mark.parametrize("kw", [{}, dict(min_degree=8),
                                dict(word_budget=40), dict(max_hubs=5)])
def test_renumber_and_layout_match(kw):
    g_j = j_gen.zipf_graph(300, 2400, alpha=2.0, seed=0)
    g_t = t_gen.zipf_graph(300, 2400, alpha=2.0, seed=0)
    order_j, inv_j = j_layout.degree_sort_permutation(g_j)
    order_t, inv_t = t_layout.degree_sort_permutation(g_t)
    np.testing.assert_array_equal(order_j, order_t)
    np.testing.assert_array_equal(inv_j, inv_t)
    r_j = j_layout.renumber_csr(g_j, inv_j)
    r_t = t_layout.renumber_csr(g_t, inv_t)
    _same_csr(r_j, r_t)
    lay_j = j_layout.HybridLayout.build(r_j, **kw)
    lay_t = t_layout.HybridLayout.build(r_t, **kw)
    assert (lay_j.n_nodes, lay_j.n_hubs, lay_j.n_words, lay_j.min_degree) \
        == (lay_t.n_nodes, lay_t.n_hubs, lay_t.n_words, lay_t.min_degree)
    np.testing.assert_array_equal(lay_j.words, lay_t.words)
    np.testing.assert_array_equal(lay_j.rep_tags(), lay_t.rep_tags())
    rows = np.array([[0, 5], [7, 299]])
    np.testing.assert_array_equal(j_layout.map_rows_back(rows, order_j),
                                  t_layout.map_rows_back(rows, order_t))


def _fields(plan):
    return dict(engine=plan.engine, gao=plan.gao,
                levels=[dataclasses.astuple(lp) for lp in plan.levels],
                level_layouts=plan.level_layouts,
                level_est_rows=plan.level_est_rows, root=plan.root,
                est_cost=plan.est_cost, agm_log2=plan.agm_log2,
                fingerprint=plan.stats_fingerprint,
                decomposition=None if plan.decomposition is None else (
                    str(plan.decomposition.tree_query),
                    str(plan.decomposition.core_query),
                    plan.decomposition.attachment,
                    plan.decomposition.core_gao))


@pytest.mark.parametrize("profile", sorted(STATS_PROFILES))
@pytest.mark.parametrize("shape", TIER1_SHAPES)
@pytest.mark.parametrize("engine", ["auto", "vlftj", "yannakakis", "hybrid"])
def test_plan_query_matches(engine, shape, profile):
    j_stats = STATS_PROFILES[profile]
    t_stats = GraphStats(**dataclasses.asdict(j_stats))
    assert t_stats.fingerprint() == j_stats.fingerprint()
    try:
        j_plan = j_plan_query(j_get_query(shape), j_stats, engine=engine)
    except JNotTreeShaped:
        with pytest.raises(NotTreeShaped):
            plan_query(get_query(shape), t_stats, engine=engine)
        return
    t_plan = plan_query(get_query(shape), t_stats, engine=engine)
    assert _fields(t_plan) == _fields(j_plan)


@pytest.mark.parametrize("shape", sorted(J_PAPER_QUERIES))
def test_hybrid_decomposition_matches_reference(shape):
    """``core.hybrid.HybridDecomposition``, the JAX package's view over
    ``decompose_hybrid``: the same applicability, tree and core queries,
    attachment variable and core variables; and ``vlftj.compile_plan``
    is ``compile_levels`` under its older name."""
    from repro.core.hybrid import HybridDecomposition as JDecomposition
    from repro.core.vlftj import compile_plan as j_compile_plan

    from repro_torch.core.hybrid import HybridDecomposition
    from repro_torch.core.plan import compile_levels
    from repro_torch.core.vlftj import compile_plan
    want = JDecomposition(j_get_query(shape))
    got = HybridDecomposition(get_query(shape))
    assert got.applicable == want.applicable
    if want.applicable:
        assert (str(got.tree_query), str(got.core_query), got.attachment,
                got.core_vars) == (str(want.tree_query),
                                   str(want.core_query), want.attachment,
                                   want.core_vars)
    assert compile_plan is compile_levels
    gao = tuple(get_query(shape).variables)
    assert [dataclasses.astuple(lv) for lv in compile_plan(
        get_query(shape), gao)] == [dataclasses.astuple(lv) for lv in
                                    j_compile_plan(j_get_query(shape), gao)]
