"""The port's engines on the CPU vs the JAX package, on the same data and
the same plans: counts, per-level frontier sizes, interior frontiers and
suspend/resume, exactly.

Both packages get the graphs as numpy arrays: a ``conftest.make_gdb``
graph as a plain db and the Zipf graph of ``tests/test_layout.py`` as a
hybrid (renumbered, hub-bitset) db, fed to the port through
``repro_torch.convert.gdb_from_arrays`` with ``device="cpu"``.
"""
import numpy as np
import pytest
import torch
from conftest import make_gdb

import repro  # noqa: F401  (x64 for the reference)
from repro.core import HybridGraphDB as JHybridGraphDB
from repro.core import engine as j_engine
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import get_query as j_get_query
from repro.core.vlftj import VLFTJ as JVLFTJ
from repro.core.yannakakis import NotTreeShaped as JNotTreeShaped
from repro.graphs import node_sample, zipf_graph

import repro_torch.core as T
from repro_torch.convert import gdb_from_arrays, plan_from_fields
from repro_torch.graphs import CSRGraph

# the port's CPU tensors here are small: one intra-op thread per test
# process keeps parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

SHAPES = ("3-clique", "4-clique", "4-cycle", "3-path", "2-lollipop",
          "3-lollipop")
CYCLIC = ("3-clique", "4-clique", "4-cycle")
ENGINES = ("auto", "vlftj", "yannakakis", "hybrid")
# a narrow executor, so the small graphs still run several chunks,
# partial pow2-padded chunks and more than one bitset/bsearch group
EXEC_KW = dict(chunk_rows=64, elem_budget=1 << 12)


def _plain_pair():
    j = make_gdb(60, 3, seed=0)
    t = gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary, device="cpu")
    return j, t


def _hybrid_pair():
    z = zipf_graph(300, 2400, alpha=2.0, seed=0)
    unary = {f"v{i}": node_sample(z.n_nodes, 6.0, seed=17 * i + 1)
             for i in range(1, 5)}
    j = JHybridGraphDB.build(z, unary)
    t = gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary,
                        layout_words=j.layout.words, order=j.order,
                        min_degree=j.layout.min_degree, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def dbs():
    """kind -> (reference db, port db) over the same arrays."""
    return {"plain": _plain_pair(), "hybrid": _hybrid_pair()}


def _port_plan(j_plan):
    d = j_plan.decomposition
    return plan_from_fields(
        str(j_plan.query), j_plan.engine, j_plan.gao,
        level_layouts=j_plan.level_layouts, root=j_plan.root,
        decomposition=None if d is None else (
            str(d.tree_query), str(d.core_query), d.attachment, d.core_gao))


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
def test_gdb_from_arrays_carries_the_db(kind, dbs):
    j, t = dbs[kind]
    assert T.GraphStats.of(t).fingerprint() == \
        JGraphStats.of(j).fingerprint()
    for key in ("indptr", "indices", "src_ids", "bitmap:v1"):
        np.testing.assert_array_equal(t.dev(key).numpy(),
                                      np.asarray(j.dev(key)))
    if kind == "hybrid":
        np.testing.assert_array_equal(
            t.dev("bitset_words").numpy().view(np.uint32),
            np.asarray(j.dev("bitset_words")))
        np.testing.assert_array_equal(t.dev("rep_tag").numpy(),
                                      np.asarray(j.dev("rep_tag")))
        np.testing.assert_array_equal(t.new_of_old, j.new_of_old)


def test_port_builds_the_same_hybrid_db(dbs):
    """The port's own ``HybridGraphDB.build`` renumbers, remaps and packs
    exactly as the reference's does."""
    j, carried = dbs["hybrid"]
    z = zipf_graph(300, 2400, alpha=2.0, seed=0)
    unary = {f"v{i}": node_sample(z.n_nodes, 6.0, seed=17 * i + 1)
             for i in range(1, 5)}
    t = T.HybridGraphDB.build(
        CSRGraph(z.indptr, z.indices, z.n_nodes), unary, device="cpu")
    np.testing.assert_array_equal(t.order, j.order)
    for key in ("indptr", "indices", "bitset_words", "rep_tag",
                "bitmap:v3"):
        assert torch.equal(t.dev(key), carried.dev(key)), key
    assert T.GraphStats.of(t) == T.GraphStats.of(carried)


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES)
def test_count_and_level_rows_match(shape, engine, kind, dbs):
    j_db, t_db = dbs[kind]
    stats = JGraphStats.of(j_db)
    try:
        j_plan = j_plan_query(j_get_query(shape), stats, engine=engine)
    except JNotTreeShaped:
        with pytest.raises(T.NotTreeShaped):
            T.count(T.get_query(shape), t_db, engine=engine)
        return
    # the port plans identically on its own, and runs the same plan
    t_plan = T.plan_query(T.get_query(shape), T.GraphStats.of(t_db),
                          engine=engine)
    carried = _port_plan(j_plan)
    for field in ("engine", "gao", "level_layouts", "levels", "root",
                  "decomposition"):
        assert getattr(t_plan, field) == getattr(carried, field), field
    j_eng = j_engine.make_engine(j_plan, j_db)
    t_eng = T.make_engine(_port_plan(j_plan), t_db)
    want = j_eng.count()
    assert t_eng.count() == want
    assert T.count(T.get_query(shape), t_db, engine=engine) == want
    assert t_eng.stats["level_rows"] == j_eng.stats["level_rows"]
    if j_plan.engine != "yannakakis":
        for key in ("chunks", "candidates", "rows_expanded", "bitset_rows",
                    "level_paths"):
            assert t_eng.stats[key] == j_eng.stats[key], key


@pytest.mark.parametrize("shape", CYCLIC + ("2-lollipop",))
def test_bitset_path_taken_on_hybrid_db(shape, dbs):
    j_db, t_db = dbs["hybrid"]
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine="vlftj")
    j_eng = JVLFTJ(j_plan.query, j_db, plan=j_plan, **EXEC_KW)
    t_eng = T.VLFTJ(T.get_query(shape), t_db, plan=_port_plan(j_plan),
                    **EXEC_KW)
    assert t_eng.count() == j_eng.count()
    assert j_eng.stats["bitset_rows"] > 0
    assert t_eng.stats["bitset_rows"] == j_eng.stats["bitset_rows"]
    paths = t_eng.stats["level_paths"]
    assert any("bitset" in p and "bsearch" in p for p in paths.values())


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("shape", CYCLIC)
def test_advance_frontiers_match(shape, kind, dbs):
    j_db, t_db = dbs[kind]
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine="vlftj")
    j_eng = JVLFTJ(j_plan.query, j_db, plan=j_plan, **EXEC_KW)
    t_eng = T.VLFTJ(T.get_query(shape), t_db, plan=_port_plan(j_plan),
                    **EXEC_KW)
    for k in range(1, len(j_plan.gao) + 1):
        want = j_eng.advance(max_levels=k)
        got = t_eng.advance(max_levels=k)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_eng.enumerate(limit=50),
                                  j_eng.enumerate(limit=50))


class _Suspend(Exception):
    def __init__(self, level, frontier, mult):
        super().__init__(level)
        self.state = (level, frontier.copy(), mult.copy())


def _suspend_at(level):
    def cb(lv, frontier, mult):
        if lv == level:
            raise _Suspend(lv, frontier, mult)
    return cb


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("shape,level", [("3-clique", 1), ("4-clique", 1),
                                         ("4-clique", 2), ("4-cycle", 2)])
def test_resume_count_after_suspend(shape, level, kind, dbs):
    j_db, t_db = dbs[kind]
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine="vlftj")
    t_plan = _port_plan(j_plan)
    want = T.VLFTJ(t_plan.query, t_db, plan=t_plan, **EXEC_KW).count()
    states = []
    for eng in (JVLFTJ(j_plan.query, j_db,
                       plan=j_plan.with_level_callback(_suspend_at(level)),
                       **EXEC_KW),
                T.VLFTJ(t_plan.query, t_db,
                        plan=t_plan.with_level_callback(_suspend_at(level)),
                        **EXEC_KW)):
        with pytest.raises(_Suspend) as exc:
            eng.count()
        states.append(exc.value.state)
    (_, jf, jm), (lv, tf, tm) = states
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm, jm)
    resumed = T.VLFTJ(t_plan.query, t_db, plan=t_plan, **EXEC_KW)
    assert resumed.resume_count(tf, tm, start_level=lv + 1) == want
    assert want == j_engine.count(j_plan.query, j_db, engine="vlftj",
                                  verify=False)


def test_seeded_count_matches(dbs):
    j_db, t_db = dbs["plain"]
    seeds = np.arange(0, 60, 3, dtype=np.int32)
    mult = np.arange(1, seeds.shape[0] + 1, dtype=np.int64)
    j_plan = j_plan_query(j_get_query("3-clique"), JGraphStats.of(j_db),
                          engine="vlftj")
    want = JVLFTJ(j_plan.query, j_db, plan=j_plan).seeded_count(seeds, mult)
    got = T.VLFTJ(T.get_query("3-clique"), t_db,
                  plan=_port_plan(j_plan)).seeded_count(seeds, mult)
    assert got == want


def test_unported_modes_raise(dbs):
    """What still waits: the host oracles, and plan verification
    (``verify=True``) for every entry point."""
    from repro_torch.core import engine as t_engine
    _, t_db = dbs["plain"]
    q = T.get_query("3-clique")
    for engine in ("lftj_ref", "minesweeper_ref", "binary"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.count(q, t_db, engine=engine)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_engine.enumerate(q, t_db, engine=engine)
    for entry in (T.count, t_engine.enumerate, t_engine.stream):
        with pytest.raises(NotImplementedError, match="ROADMAP.*verify"):
            entry(q, t_db, verify=True)
