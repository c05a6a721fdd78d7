"""The port's host oracles (``lftj_ref``, ``minesweeper_ref``, ``binary``),
its relation layer and the rest of its host surface against the JAX
package, on the same numpy inputs: counts, ``stats`` dicts and enumerated
rows exactly.

The graphs are a ``conftest.make_gdb`` graph as a plain db and a Zipf
graph as a hybrid (renumbered, hub-bitset) db, built as in
``tests/test_torch_engine.py`` but smaller: the scalar oracles walk every
output tuple in Python, and on the engine tests' Zipf db the 2-tree alone
takes minutes in ``minesweeper_ref``.  Both go to the port through
``repro_torch.convert.gdb_from_arrays`` with ``device="cpu"``.
"""
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st
from conftest import make_gdb

import repro  # noqa: F401  (x64 for the reference)
from repro.core import GraphDB as JGraphDB
from repro.core import HybridGraphDB as JHybridGraphDB
from repro.core import engine as j_engine
from repro.core.binary_join import JoinBlowup as JJoinBlowup
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import PAPER_QUERIES
from repro.core.query import get_query as j_get_query
from repro.graphs import load_edgelist as j_load_edgelist
from repro.graphs import node_sample, zipf_graph
from repro.graphs import save_edgelist as j_save_edgelist
from repro.graphs.csr import triangle_count_csr as j_triangle_count_csr

import repro_torch.core as T
from repro_torch.convert import gdb_from_arrays
from repro_torch.core import engine as t_engine
from repro_torch.core.minesweeper_ref import (CDS, STAR, Constraint,
                                              IntervalList, _chain_bottom,
                                              _generalizes)
from repro_torch.core.relation import NEG_INF, POS_INF
from repro_torch.graphs import CSRGraph, load_edgelist, save_edgelist
from repro_torch.graphs.csr import triangle_count_csr

torch.set_num_threads(1)

ORACLES = ("lftj_ref", "minesweeper_ref", "binary")
QUERIES = tuple(PAPER_QUERIES)
KINDS = ("plain", "hybrid")


def _plain_pair():
    j = make_gdb(30, 2, seed=0)
    t = gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary, device="cpu")
    return j, t


def _hybrid_pair():
    z = zipf_graph(120, 500, alpha=2.0, seed=0)
    unary = {f"v{i}": node_sample(z.n_nodes, 10.0, seed=17 * i + 1)
             for i in range(1, 5)}
    j = JHybridGraphDB.build(z, unary)
    t = gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary,
                        layout_words=j.layout.words, order=j.order,
                        min_degree=j.layout.min_degree, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def dbs():
    """kind -> (reference db, port db) over the same arrays."""
    pairs = {"plain": _plain_pair(), "hybrid": _hybrid_pair()}
    assert pairs["hybrid"][1].n_hubs > 0
    return pairs


def _plans(kind, shape, engine, dbs):
    j_db, t_db = dbs[kind]
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine=engine)
    t_plan = T.plan_query(T.get_query(shape), T.GraphStats.of(t_db),
                          engine=engine)
    assert (t_plan.gao, t_plan.engine) == (j_plan.gao, j_plan.engine)
    return j_plan, t_plan


# ---------------------------------------------------------------------------
# the oracles: counts, stats and rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ORACLES)
@pytest.mark.parametrize("shape", QUERIES)
def test_oracle_count_and_stats_match(kind, engine, shape, dbs):
    j_db, t_db = dbs[kind]
    j_plan, t_plan = _plans(kind, shape, engine, dbs)
    j_eng = j_engine.make_engine(j_plan, j_db)
    t_eng = T.make_engine(t_plan, t_db)
    want = j_eng.count()
    assert t_eng.count() == want
    assert t_eng.stats == j_eng.stats
    assert T.count(T.get_query(shape), t_db, engine=engine) == want
    assert T.count(T.get_query(shape), t_db, engine="vlftj") == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ORACLES)
@pytest.mark.parametrize("shape", QUERIES)
def test_oracle_rows_match(kind, engine, shape, dbs):
    """Engine-level rows (GAO columns) and the entry point's rows (query
    columns), in full and with a limit, row for row."""
    j_db, t_db = dbs[kind]
    j_plan, t_plan = _plans(kind, shape, engine, dbs)
    j_eng = j_engine.make_engine(j_plan, j_db)
    t_eng = T.make_engine(t_plan, t_db)
    want = j_eng.enumerate()
    got = t_eng.enumerate()
    assert t_eng.output_vars == j_eng.output_vars
    assert got.dtype == np.int64 and got.shape[1] == len(t_plan.gao)
    np.testing.assert_array_equal(got, want)
    limit = max(1, want.shape[0] // 3)
    np.testing.assert_array_equal(
        T.make_engine(t_plan, t_db).enumerate(limit=limit), want[:limit])
    j_res = j_engine.enumerate(j_get_query(shape), j_db, engine=engine,
                               limit=limit)
    t_res = t_engine.enumerate(T.get_query(shape), t_db, engine=engine,
                               limit=limit)
    assert type(t_res).__name__ == type(j_res).__name__
    assert t_res.vars == tuple(j_get_query(shape).variables)
    np.testing.assert_array_equal(t_res.expand(), j_res.expand())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,cap", [("4-path", 100), ("2-tree", 1000),
                                       ("3-lollipop", 50), ("4-cycle", 20)])
def test_join_blowup_same_rows_at_same_cap(kind, shape, cap, dbs):
    j_db, t_db = dbs[kind]
    with pytest.raises(JJoinBlowup) as j_err:
        j_engine.count(j_get_query(shape), j_db, engine="binary", cap=cap)
    with pytest.raises(T.JoinBlowup) as t_err:
        T.count(T.get_query(shape), t_db, engine="binary", cap=cap)
    assert (t_err.value.rows, t_err.value.cap) == (j_err.value.rows, cap)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("flags", [dict(skip_probes=False),
                                   dict(use_skeleton=False)],
                         ids=lambda f: next(iter(f)))
@pytest.mark.parametrize("shape", ["3-clique", "4-cycle", "3-path",
                                   "2-lollipop"])
def test_minesweeper_idea_flags_pass_through(kind, flags, shape, dbs):
    """``make_engine`` forwards ``**kw`` to ``Minesweeper``: with Idea 4
    or Idea 7 switched off, both packages count alike and probe alike."""
    j_db, t_db = dbs[kind]
    j_plan, t_plan = _plans(kind, shape, "minesweeper_ref", dbs)
    j_eng = j_engine.make_engine(j_plan, j_db, **flags)
    t_eng = T.make_engine(t_plan, t_db, **flags)
    assert t_eng.count() == j_eng.count()
    assert t_eng.stats == j_eng.stats


# ---------------------------------------------------------------------------
# relation layer (the cases of tests/test_relation.py on the port)
# ---------------------------------------------------------------------------

def test_relation_dedup_and_sort():
    r = T.Relation(np.array([[3, 1], [1, 2], [3, 1], [1, 1]]))
    np.testing.assert_array_equal(
        r.data, np.array([[1, 1], [1, 2], [3, 1]]))


def test_relation_child_range_and_contains():
    r = T.Relation(np.array([[1, 5], [1, 7], [2, 3], [4, 0]]))
    lo, hi = r.child_range(0, len(r), 0, 1)
    assert (lo, hi) == (0, 2)
    assert r.contains((1, 7))
    assert not r.contains((1, 6))
    assert not r.contains((3, 0))


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 50), min_size=1, max_size=40),
       st.integers(0, 55))
def test_relation_gap_around_oracle(values, probe):
    from repro.core import Relation as JRelation
    arr = np.array(sorted(set(values)))
    r = T.Relation(arr)
    l, rgt = r.gap_around(0, len(r), 0, probe)
    assert (l, rgt) == JRelation(arr).gap_around(0, len(r), 0, probe)
    if probe in set(arr.tolist()):
        assert (l, rgt) == (probe, probe)
    else:
        lows = arr[arr < probe]
        highs = arr[arr > probe]
        assert l == (int(lows.max()) if lows.size else NEG_INF)
        assert rgt == (int(highs.min()) if highs.size else POS_INF)


def test_database_index_cache():
    r = T.Relation(np.array([[1, 5], [2, 3]]), "edge")
    db = T.Database({"edge": r})
    a = db.indexed("edge", (1, 0))
    b = db.indexed("edge", (1, 0))
    assert a is b
    assert db.indexed("edge", (0, 1)) is r
    np.testing.assert_array_equal(a.data, np.array([[3, 2], [5, 1]]))
    assert db.sizes() == {"edge": 2} and db.domain_size == 6


@pytest.mark.parametrize("kind", KINDS)
def test_relation_constructors_match(kind, dbs):
    from repro.core import Relation as JRelation
    j_db, _ = dbs[kind]
    src, dst = j_db.csr.edge_array().T
    for sym in (True, False):
        for loops in (True, False):
            a = T.Relation.from_edges(src, dst, symmetrize=sym,
                                      drop_loops=loops)
            b = JRelation.from_edges(src, dst, symmetrize=sym,
                                     drop_loops=loops)
            np.testing.assert_array_equal(a.data, b.data)
    ids = j_db.unary["v1"]
    np.testing.assert_array_equal(T.Relation.from_set(ids).data,
                                  JRelation.from_set(ids).data)
    np.testing.assert_array_equal(
        T.Relation(np.stack([src, dst], 1)).reorder((1, 0)).data,
        JRelation(np.stack([src, dst], 1)).reorder((1, 0)).data)


# ---------------------------------------------------------------------------
# CDS internals (the cases of tests/test_minesweeper_cds.py on the port)
# ---------------------------------------------------------------------------

def test_interval_merge_open_semantics():
    il = IntervalList()
    il.insert(1, 10)
    il.insert(10, 20)     # touching open intervals: 10 stays free
    assert il.next_free(5) == 10
    assert il.next_free(10) == 10
    assert il.next_free(11) == 20
    il.insert(9, 11)      # now 10 is covered -> all merge
    assert il.ivs == [(1, 20)]
    assert il.next_free(5) == 20


def test_interval_empty_inserts_ignored():
    il = IntervalList()
    il.insert(5, 6)   # open (5,6) contains no integer
    assert il.ivs == []


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 60), st.integers(0, 60)),
                min_size=1, max_size=25),
       st.integers(0, 70))
def test_interval_list_matches_naive_and_reference(pairs, probe):
    from repro.core.minesweeper_ref import IntervalList as JIntervalList
    il, jl = IntervalList(), JIntervalList()
    covered = set()
    for a, b in pairs:
        l, r = min(a, b), max(a, b)
        il.insert(l, r)
        jl.insert(l, r)
        covered |= set(range(l + 1, r))
    assert il.ivs == jl.ivs
    for (a1, b1), (a2, b2) in zip(il.ivs, il.ivs[1:]):
        assert b1 <= a2
    expect = probe
    while expect in covered:
        expect += 1
    assert il.next_free(probe) == expect == jl.next_free(probe)


def test_constraint_matching():
    c = Constraint((STAR, 7), 2, 3, 9)
    assert c.matches((0, 7, 5))
    assert not c.matches((0, 7, 3))   # open endpoint
    assert not c.matches((0, 8, 5))   # pattern mismatch
    assert c.pattern_matches((0, 7, 99))


def test_cds_insert_prunes_children():
    cds = CDS(3)
    cds.insert(Constraint((5,), 1, 2, 9))        # creates node (5)
    cds.insert(Constraint((5, 4), 2, 0, 3))      # child 4 inside (2,9)!
    node5 = cds.root.children[5]
    cds.insert(Constraint((5,), 1, 3, 8))        # prunes child 4
    assert 4 not in node5.children


def test_chain_bottom_detection():
    cds = CDS(3)
    cds.insert(Constraint((STAR,), 1, 0, 5))
    cds.insert(Constraint((7,), 1, 2, 9))
    g = cds.generalizing((7,))
    assert _chain_bottom(g) is not None  # (7,) specializes (*,)
    cds2 = CDS(3)
    cds2.insert(Constraint((7, STAR), 2, 0, 5))
    cds2.insert(Constraint((STAR, 3), 2, 2, 9))
    g2 = cds2.generalizing((7, 3))
    assert len(g2) == 2
    assert _chain_bottom(g2) is None  # incomparable: no sound cache spot


def test_generalizes():
    assert _generalizes((STAR, STAR), (1, 2))
    assert _generalizes((1, STAR), (1, 2))
    assert not _generalizes((1, 3), (1, 2))


# ---------------------------------------------------------------------------
# round trips of the host surface
# ---------------------------------------------------------------------------

def _same_database(a, b):
    assert sorted(a.relations) == sorted(b.relations)
    for name in a.relations:
        np.testing.assert_array_equal(a.relations[name].data,
                                      b.relations[name].data)
        assert a.relations[name].name == b.relations[name].name


@pytest.mark.parametrize("kind", KINDS)
def test_to_database_matches(kind, dbs):
    j_db, t_db = dbs[kind]
    _same_database(t_db.to_database(), j_db.to_database())


@pytest.mark.parametrize("kind", KINDS)
def test_from_database_matches(kind, dbs):
    j_db, t_db = dbs[kind]
    t_back = T.GraphDB.from_database(t_db.to_database(), device="cpu")
    j_back = JGraphDB.from_database(j_db.to_database())
    assert t_back.device.type == "cpu"
    assert t_back.n_nodes == j_back.n_nodes
    np.testing.assert_array_equal(t_back.csr.indptr, j_back.csr.indptr)
    np.testing.assert_array_equal(t_back.csr.indices, j_back.csr.indices)
    assert sorted(t_back.unary) == sorted(j_back.unary)
    for k in t_back.unary:
        np.testing.assert_array_equal(t_back.unary[k], j_back.unary[k])


@pytest.mark.parametrize("renumber", [True, False])
def test_hybrid_from_gdb_matches(renumber, dbs):
    j_db, t_db = dbs["plain"]
    j_h = JHybridGraphDB.from_gdb(j_db, renumber=renumber, min_degree=4)
    t_h = T.HybridGraphDB.from_gdb(t_db, renumber=renumber, min_degree=4)
    assert t_h.device == t_db.device
    assert t_h.n_hubs == j_h.n_hubs > 0
    np.testing.assert_array_equal(t_h.order, j_h.order)
    np.testing.assert_array_equal(t_h.new_of_old, j_h.new_of_old)
    np.testing.assert_array_equal(t_h.layout.words, j_h.layout.words)
    np.testing.assert_array_equal(t_h.csr.indices, j_h.csr.indices)
    np.testing.assert_array_equal(
        t_h.dev("bitset_words").numpy().view(np.uint32),
        np.asarray(j_h.dev("bitset_words")))


@pytest.mark.parametrize("kind", KINDS)
def test_csr_to_relation_and_triangles_match(kind, dbs):
    j_db, t_db = dbs[kind]
    a, b = t_db.csr.to_relation(), j_db.csr.to_relation()
    np.testing.assert_array_equal(a.data, b.data)
    assert a.name == b.name == "edge"
    assert triangle_count_csr(t_db.csr) == j_triangle_count_csr(j_db.csr)
    # the 3-clique's a<b<c chain counts each triangle once
    assert triangle_count_csr(t_db.csr) == T.count(
        T.parse("edge(a, b), edge(b, c), edge(a, c), a<b, b<c"), t_db)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("symmetrize", [True, False])
def test_edgelist_round_trip_across_packages(writer, symmetrize, dbs,
                                             tmp_path):
    j_db, t_db = dbs["plain"]
    path = str(tmp_path / "g.txt")
    if writer == "port":
        save_edgelist(t_db.csr, path)
        got = j_load_edgelist(path, symmetrize=symmetrize)
        want = load_edgelist(path, symmetrize=symmetrize)
    else:
        j_save_edgelist(j_db.csr, path)
        got = load_edgelist(path, symmetrize=symmetrize)
        want = j_load_edgelist(path, symmetrize=symmetrize)
    assert isinstance(want if writer == "port" else got, CSRGraph)
    for g in (got, want):
        assert g.n_nodes == j_db.csr.n_nodes
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    if symmetrize:
        np.testing.assert_array_equal(got.indices, j_db.csr.indices)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn,shape", [("vlftj_count", "4-cycle"),
                                      ("yannakakis_count", "3-path"),
                                      ("hybrid_count", "2-lollipop"),
                                      ("lftj_count", "4-clique"),
                                      ("minesweeper_count", "1-tree"),
                                      ("binary_join_count", "2-comb")])
def test_count_helpers_match(kind, fn, shape, dbs):
    import repro.core as J
    j_db, t_db = dbs[kind]
    if fn in ("lftj_count", "minesweeper_count", "binary_join_count"):
        j_arg, t_arg = j_db.to_database(), t_db.to_database()
    else:
        j_arg, t_arg = j_db, t_db
    want = getattr(J, fn)(j_get_query(shape), j_arg)
    assert getattr(T, fn)(T.get_query(shape), t_arg) == want
