"""The port's enumeration (``repro_torch.results`` and the engines'
``enumerate``/``stream``) on the CPU vs the JAX package: rows, columns,
factorized tries, cursor pages and cursor stats, exactly.

Same graphs as ``tests/test_torch_engine.py``; the tail-buffer bound and
the dense final level follow ``tests/test_enumerate.py``.
"""
import numpy as np
import pytest
from conftest import make_gdb
from test_torch_engine import (CYCLIC, EXEC_KW, SHAPES, _hybrid_pair,
                               _plain_pair, _port_plan)

import repro  # noqa: F401  (x64 for the reference)
from repro.core import engine as j_engine
from repro.core import parse as j_parse
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import get_query as j_get_query
from repro.core.vlftj import VLFTJ as JVLFTJ
from repro.core.yannakakis import CountingYannakakis as JCountingYannakakis
from repro.core.yannakakis import NotTreeShaped as JNotTreeShaped
from repro.results import ResultCursor as JResultCursor

import repro_torch.core as T
from repro_torch.convert import gdb_from_arrays
from repro_torch.core import engine as t_engine
from repro_torch.results import (FactorizedResult, ResultCursor, ResultSet,
                                 lex_sorted, segment_expand)

ENGINES = ("auto", "vlftj", "yannakakis", "hybrid")
CURSOR_STATS = ("pages", "rows", "chunks", "count_chunks",
                "peak_buffer_rows", "frontier_rows")


@pytest.fixture(scope="module")
def dbs():
    return {"plain": _plain_pair(), "hybrid": _hybrid_pair()}


def _levels_equal(got, want):
    assert got.vars == want.vars
    assert len(got.levels) == len(want.levels)
    for g, w in zip(got.levels, want.levels):
        np.testing.assert_array_equal(g.values, w.values)
        np.testing.assert_array_equal(g.parent, w.parent)
        assert g.values.dtype == np.int64 and g.parent.dtype == np.int64


def check_enumerate_parity(shape: str, engine: str, j_db, t_db) -> None:
    """Flat rows of one engine, both packages on one db, with and
    without a custom column order and a limit."""
    jq, tq = j_get_query(shape), T.get_query(shape)
    try:
        want = j_engine.enumerate(jq, j_db, engine=engine, mode="flat",
                                  verify=False)
    except JNotTreeShaped:
        with pytest.raises(T.NotTreeShaped):
            t_engine.enumerate(tq, t_db, engine=engine, mode="flat")
        return
    got = t_engine.enumerate(tq, t_db, engine=engine, mode="flat")
    assert isinstance(got, ResultSet)
    assert got.vars == want.vars
    assert got.rows.dtype == np.int64
    np.testing.assert_array_equal(got.rows, want.rows)
    assert got.count() == T.count(tq, t_db, engine=engine)
    # limit truncates after the ordering, and a custom column order
    order = tuple(reversed(jq.variables))
    want = j_engine.enumerate(jq, j_db, engine=engine, mode="flat",
                              order=order, limit=5, verify=False)
    got = t_engine.enumerate(tq, t_db, engine=engine, mode="flat",
                             order=order, limit=5)
    np.testing.assert_array_equal(got.rows, want.rows)


def check_factorized_parity(shape: str, j_db, t_db) -> None:
    """The native vectorized-LFTJ trie (penultimate frontier + final-level
    extension segments) and the trie of flat rows, level by level."""
    jq, tq = j_get_query(shape), T.get_query(shape)
    gao = j_plan_query(jq, JGraphStats.of(j_db), engine="vlftj").gao
    for engine, order in (("vlftj", gao), ("auto", None)):
        want = j_engine.enumerate(jq, j_db, engine=engine, order=order,
                                  mode="factorized", verify=False)
        got = t_engine.enumerate(tq, t_db, engine=engine, order=order,
                                 mode="factorized")
        assert isinstance(got, FactorizedResult)
        _levels_equal(got, want)
        np.testing.assert_array_equal(got.expand(), want.expand())
        np.testing.assert_array_equal(got.project(got.vars[:2]).rows,
                                      want.project(want.vars[:2]).rows)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", SHAPES)
def test_enumerate_rows_match(shape, engine, dbs):
    """On the plain db; ``tests/test_torch_results_hybrid.py`` runs the
    same cases on the Zipf hybrid db, in parallel under ``pytest -n``."""
    check_enumerate_parity(shape, engine, *dbs["plain"])


@pytest.mark.parametrize("shape", SHAPES)
def test_factorized_matches(shape, dbs):
    check_factorized_parity(shape, *dbs["plain"])


def _pages(cur):
    pages = list(cur)
    k = len(cur.vars)
    return np.concatenate(pages) if pages else np.zeros((0, k), np.int64)


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stream_matches(shape, kind, dbs):
    """Default planning: vlftj plans stream by final-level re-entry,
    the others page materialized rows."""
    j_db, t_db = dbs[kind]
    want = j_engine.stream(j_get_query(shape), j_db, page_rows=16,
                           verify=False, **EXEC_KW)
    got = t_engine.stream(T.get_query(shape), t_db, page_rows=16, **EXEC_KW)
    assert got.vars == want.vars
    np.testing.assert_array_equal(_pages(got), _pages(want))
    for key in CURSOR_STATS:
        assert got.stats[key] == want.stats[key], key


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("mode_kw", [dict(check_mode="tile", tile_width=512),
                                     dict(check_mode="tile", tile_width=8),
                                     dict(check_mode="auto", tile_width=16),
                                     dict(check_mode="bsearch2",
                                          summary_stride=4)],
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
@pytest.mark.parametrize("shape", CYCLIC)
def test_stream_in_check_modes_matches(shape, mode_kw, kind, dbs):
    """The final level re-entered in the executor's mode (``auto`` runs
    it as ``bsearch``), page for page, with the executor's stats."""
    j_db, t_db = dbs[kind]
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine="vlftj")
    j_ex = JVLFTJ(j_plan.query, j_db, plan=j_plan, **EXEC_KW, **mode_kw)
    t_ex = T.VLFTJ(T.get_query(shape), t_db, plan=_port_plan(j_plan),
                   **EXEC_KW, **mode_kw)
    want = JResultCursor(j_ex, page_rows=24)
    got = ResultCursor(t_ex, page_rows=24)
    np.testing.assert_array_equal(_pages(got), _pages(want))
    for key in CURSOR_STATS:
        assert got.stats[key] == want.stats[key], key
    for key in ("ll_calls", "tile_rows", "bsearch_rows", "bitset_rows",
                "level_rows", "level_paths"):
        assert t_ex.stats[key] == j_ex.stats[key], key
    assert t_ex.stats["ll_calls"] > 0 and t_ex.stats["ll_compiles"] == 0


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("check_mode", ["bsearch", "tile", "bsearch2"])
def test_last_level_matches(check_mode, kind, dbs):
    j_db, t_db = dbs[kind]
    j_plan = j_plan_query(j_get_query("4-clique"), JGraphStats.of(j_db),
                          engine="vlftj")
    kw = dict(check_mode=check_mode, tile_width=64)
    j_ex = JVLFTJ(j_plan.query, j_db, plan=j_plan, **kw)
    t_ex = T.VLFTJ(T.get_query("4-clique"), t_db, plan=_port_plan(j_plan),
                   **kw)
    penult = j_ex.advance(max_levels=3).astype(np.int32)
    np.testing.assert_array_equal(t_ex.advance(max_levels=3), penult)
    valid = np.arange(penult.shape[0]) % 5 != 0
    want_c = j_ex.last_level_counts(penult, valid)
    got_c = t_ex.last_level_counts(penult, valid)
    assert got_c.dtype == np.int64
    np.testing.assert_array_equal(got_c, want_c)
    for got, want in zip(t_ex.last_level_extensions(penult, valid),
                         j_ex.last_level_extensions(penult, valid)):
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert t_ex.stats["ll_calls"] == j_ex.stats["ll_calls"] == 2
    empty = np.zeros((0, 3), np.int32)
    assert t_ex.last_level_counts(empty).shape == (0,)


def _make_pair(n, m, seed):
    j = make_gdb(n, m, seed=seed)
    return j, gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary,
                              device="cpu")


def test_cursor_pages_concatenate_and_stay_bounded():
    """``tests/test_enumerate.py``'s tail-buffer bound on the port: one
    page plus one expansion chunk, with the reference's pages."""
    j_db, t_db = _make_pair(200, 4, 2)
    q = T.get_query("3-path")                     # large fanout output
    page = 256
    cur = t_engine.stream(q, t_db, engine="vlftj", page_rows=page)
    pages = list(cur)
    assert all(p.shape[0] == page for p in pages[:-1])
    assert 0 < pages[-1].shape[0] <= page
    rows = np.concatenate(pages)
    ex = T.VLFTJ(q, t_db)
    full = t_engine.enumerate(q, t_db, engine="vlftj", order=cur.vars,
                              mode="flat").rows
    assert full.shape[0] > 4 * page               # paging is non-trivial
    np.testing.assert_array_equal(rows, full)
    assert cur.stats["peak_buffer_rows"] <= page + max(ex.width, page)
    assert cur.stats["chunks"] > 1
    want = j_engine.stream(j_get_query("3-path"), j_db, engine="vlftj",
                           page_rows=page, verify=False)
    np.testing.assert_array_equal(rows, _pages(want))
    assert cur.stats == want.stats


def test_cursor_bounded_on_dense_final_level():
    """A final level with no bound edge neighbor streams row by row, its
    extension runs sliced to the page size."""
    j_db, t_db = _make_pair(200, 4, 2)
    text = "edge(a,b), v1(c)"
    page = 64
    cur = ResultCursor(T.VLFTJ(T.parse(text, "x"), t_db,
                               gao=("a", "b", "c")), page_rows=page)
    rows = _pages(cur)
    want = JResultCursor(JVLFTJ(j_parse(text, "x"), j_db,
                                gao=("a", "b", "c")), page_rows=page)
    np.testing.assert_array_equal(rows, _pages(want))
    assert rows.shape[0] > 10 * page
    assert cur.stats["peak_buffer_rows"] <= 2 * page
    assert cur.stats == want.stats


def test_cursor_resumes_from_frontier_and_skip(dbs):
    """Snapshot resume: a new cursor from the first one's penultimate
    frontier, skipping the rows already served, continues exactly."""
    _, t_db = dbs["plain"]
    q = T.get_query("4-cycle")
    cur = ResultCursor(T.VLFTJ(q, t_db, **EXEC_KW), page_rows=10)
    first = cur.take(17)
    rest = ResultCursor(T.VLFTJ(q, t_db, **EXEC_KW), page_rows=10,
                        frontier=cur.penultimate.astype(np.int32),
                        skip_rows=cur.rows_emitted)
    full = t_engine.enumerate(q, t_db, engine="vlftj", order=cur.vars,
                              mode="flat").rows
    np.testing.assert_array_equal(np.concatenate([first, _pages(rest)]),
                                  full)
    assert rest.rows_emitted == full.shape[0]
    # seeds pre-bind the first GAO variable
    seeds = np.unique(full[:, 0])[:3]
    seeded = _pages(ResultCursor(T.VLFTJ(q, t_db), seeds=seeds,
                                 page_rows=7))
    np.testing.assert_array_equal(seeded, full[np.isin(full[:, 0], seeds)])


def test_cursor_take_exhaustion_and_wrapped_sources():
    rows = lex_sorted(np.random.default_rng(0).integers(0, 9, (23, 3)))
    cur = ResultCursor.from_rows(("a", "b", "c"), rows, page_rows=5)
    assert cur.take(3).shape == (3, 3)
    np.testing.assert_array_equal(np.concatenate([rows[:3], _pages(cur)]),
                                  rows)
    assert cur.exhausted and cur.next_page() is None
    assert cur.take().shape == (0, 3)
    blocks = ResultCursor.from_blocks(("a", "b", "c"), [rows[:4], rows[4:]],
                                      page_rows=6)
    np.testing.assert_array_equal(_pages(blocks), rows)
    with pytest.raises(ValueError):
        ResultCursor(None, page_rows=0)
    out = segment_expand(np.array([[1, 2], [3, 4]]), np.array([2, 1]),
                         np.array([7, 8, 9]))
    np.testing.assert_array_equal(out, [[1, 2, 7], [1, 2, 8], [3, 4, 9]])


@pytest.mark.parametrize("shape", ["3-path", "1-tree", "2-comb"])
def test_semijoin_reduce_matches(shape, dbs):
    j_db, t_db = dbs["plain"]
    want = JCountingYannakakis(j_get_query(shape), j_db).semijoin_reduce()
    t_eng = T.CountingYannakakis(T.get_query(shape), t_db)
    got = t_eng.semijoin_reduce()
    assert set(got) == set(want)
    for v in want:
        np.testing.assert_array_equal(got[v], np.asarray(want[v]))
    assert t_eng.gao == JCountingYannakakis(j_get_query(shape), j_db).gao


def test_result_set_project_and_reorder(dbs):
    j_db, t_db = dbs["plain"]
    want = j_engine.enumerate(j_get_query("4-cycle"), j_db, engine="vlftj",
                              mode="flat", verify=False)
    got = t_engine.enumerate(T.get_query("4-cycle"), t_db, engine="vlftj",
                             mode="flat")
    for vars_ in (("a", "c"), ("d", "b")):
        np.testing.assert_array_equal(got.project(vars_).rows,
                                      want.project(vars_).rows)
    order = ("d", "c", "b", "a")
    np.testing.assert_array_equal(got.reorder(order).rows,
                                  want.reorder(order).rows)
    fr = FactorizedResult.from_rows(got.vars, got.rows)
    assert fr.count() == got.count() and fr.nbytes > 0
    np.testing.assert_array_equal(fr.expand(), got.rows)
