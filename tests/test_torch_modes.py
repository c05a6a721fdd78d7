"""The port's VLFTJ check modes ``tile``, ``auto`` and ``bsearch2`` on the
CPU vs the JAX package, on the same data and plans: counts and the
per-level and per-path stats, exactly.

The engine settings are those of ``tests/test_perf_options.py``; the
graphs are the plain and Zipf-hybrid dbs of ``tests/test_torch_engine.py``
(fed to the port through ``repro_torch.convert.gdb_from_arrays``).  Where
``tile_width`` is below a check segment's length, both packages truncate
the same way, so parity holds there too.
"""
import numpy as np
import pytest
from test_torch_engine import (EXEC_KW, SHAPES, _hybrid_pair, _plain_pair,
                               _port_plan)

import repro  # noqa: F401  (x64 for the reference)
from repro.core import engine as j_engine
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import get_query as j_get_query
from repro.core.vlftj import VLFTJ as JVLFTJ

import repro_torch.core as T

MODES = [
    dict(rotate_checks=True),
    dict(check_mode="auto", tile_width=64),
    dict(check_mode="tile", tile_width=512),
    dict(check_mode="bsearch2", rotate_checks=True),
    dict(check_mode="bsearch2", summary_stride=32),
]
STAT_KEYS = ("level_rows", "level_paths", "tile_rows", "bsearch_rows",
             "bitset_rows", "chunks", "candidates", "rows_expanded",
             "frontier_peak")


@pytest.fixture(scope="module")
def dbs():
    return {"plain": _plain_pair(), "hybrid": _hybrid_pair()}


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
def test_summary_arrays_match(kind, dbs):
    j, t = dbs[kind]
    for stride in (1, 7, 32, 128):
        got = t.dev(f"summary:{stride}")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j.dev(f"summary:{stride}")))
        assert str(got.dtype) == "torch.int32"


def mode_id(kw: dict) -> str:
    return "-".join(f"{k}={v}" for k, v in kw.items())


def check_mode_parity(shape: str, kw: dict, j_db, t_db) -> None:
    """One shape in one engine setting, both packages on one db."""
    j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                          engine="vlftj")
    j_eng = JVLFTJ(j_plan.query, j_db, plan=j_plan, **EXEC_KW, **kw)
    t_eng = T.VLFTJ(T.get_query(shape), t_db, plan=_port_plan(j_plan),
                    **EXEC_KW, **kw)
    assert t_eng.count() == j_eng.count()
    for key in STAT_KEYS:
        assert t_eng.stats[key] == j_eng.stats[key], key
    if kw.get("check_mode") == "bsearch2":
        assert (t_eng.n_iter1, t_eng.n_iter2) == (j_eng.n_iter1,
                                                  j_eng.n_iter2)


@pytest.mark.parametrize("kw", MODES, ids=mode_id)
@pytest.mark.parametrize("shape", SHAPES)
def test_mode_counts_and_stats_match(shape, kw, dbs):
    """On the plain db; ``tests/test_torch_modes_hybrid.py`` runs the
    same cases on the Zipf hybrid db (a file of its own, so the two
    halves run in parallel under ``pytest -n``)."""
    check_mode_parity(shape, kw, *dbs["plain"])


def test_auto_splits_rows_both_ways(dbs):
    """On the Zipf db, ``auto`` at width 64 sends rows down both paths
    (and hub rows down the bitset path), as the reference does."""
    j_db, t_db = dbs["hybrid"]
    j_plan = j_plan_query(j_get_query("4-clique"), JGraphStats.of(j_db),
                          engine="vlftj")
    t_eng = T.VLFTJ(T.get_query("4-clique"), t_db, plan=_port_plan(j_plan),
                    check_mode="auto", tile_width=64, **EXEC_KW)
    t_eng.count()
    assert t_eng.stats["tile_rows"] > 0 and t_eng.stats["bsearch_rows"] > 0
    assert t_eng.stats["bitset_rows"] > 0
    paths = set().union(*t_eng.stats["level_paths"].values())
    assert paths == {"tile", "bsearch", "bitset"}


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("check_mode", ["auto", "tile", "bsearch2"])
def test_engine_count_passes_check_mode_through(check_mode, kind, dbs):
    """``count(q, db, check_mode=...)`` reaches the VLFTJ core of every
    engine the planner picks (the cyclic shapes and the lollipops), with
    the reference's counts."""
    j_db, t_db = dbs[kind]
    for shape in SHAPES:
        want = j_engine.count(j_get_query(shape), j_db, engine="auto",
                              verify=False, check_mode=check_mode,
                              tile_width=32)
        got = T.count(T.get_query(shape), t_db, engine="auto",
                      check_mode=check_mode, tile_width=32)
        assert got == want, shape


def test_unknown_check_mode_raises(dbs):
    _, t_db = dbs["plain"]
    with pytest.raises(ValueError, match="check_mode"):
        T.VLFTJ(T.get_query("3-clique"), t_db, check_mode="bitset")
