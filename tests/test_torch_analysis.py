"""The port's static plan verifier (``repro_torch.analysis``) against the
JAX package's: the same findings, rule for rule, on the same plans.

Findings are compared as ``(rule, severity, path, line)`` lists (and by
message, but for V107, whose wording names the port's specializations
instead of XLA compiles).  The plans: the planner's output for every
tier-1 shape and engine on a plain and a hybrid db (those of
``tests/test_torch_engine.py``), and each malformed plan that
``tests/test_analysis.py`` derives from its ``good_plan``, built on the
port's side with ``convert.plan_from_fields``.  The device-array rules
(V108, V110) run on a ``meta`` tensor, the non-CPU device a CPU-only
torch can make.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from conftest import make_gdb

import repro  # noqa: F401  (x64 for the reference)
from repro.analysis import audit_recompilation as j_audit
from repro.analysis import verify_for_execution as j_verify_for_execution
from repro.analysis import verify_plan as j_verify_plan
from repro.analysis.__main__ import STATS_PROFILES, TIER1_SHAPES
from repro.analysis.recompile import chunk_shape_count as j_chunk_shape_count
from repro.core import HybridGraphDB as JHybridGraphDB
from repro.core.plan import GraphStats as JGraphStats
from repro.core.planner import plan_query as j_plan_query
from repro.core.query import get_query as j_get_query
from repro.graphs import node_sample, powerlaw_cluster, zipf_graph

import repro_torch.core as T
from repro_torch.analysis import (DEFAULT_RECOMPILE_BUDGET, Finding,
                                  FindingReport, PlanVerificationError,
                                  audit_recompilation,
                                  filters_quotient_automorphism,
                                  verify_for_execution, verify_plan,
                                  verify_snapshot)
from repro_torch.analysis.recompile import chunk_shape_count
from repro_torch.analysis.verifier import _VERIFY_CACHE
from repro_torch.convert import gdb_from_arrays, plan_from_fields
from repro_torch.core import engine as t_engine
from repro_torch.graphs import powerlaw_cluster as t_powerlaw_cluster

torch.set_num_threads(1)

ENGINES = ("auto", "vlftj", "yannakakis", "hybrid", "lftj_ref",
           "minesweeper_ref", "binary")
KINDS = ("plain", "hybrid")
EXEC_KW = dict(chunk_rows=64, elem_budget=1 << 12)


def _port_stats(j_stats) -> T.GraphStats:
    return T.GraphStats(**dataclasses.asdict(j_stats))


def _port_plan(j_plan):
    """The port's copy of a reference plan: its fields through
    ``plan_from_fields``, then the planner's annotations."""
    d = j_plan.decomposition
    t = plan_from_fields(
        str(j_plan.query), j_plan.engine, j_plan.gao,
        level_layouts=j_plan.level_layouts, root=j_plan.root,
        decomposition=None if d is None else (
            str(d.tree_query), str(d.core_query), d.attachment, d.core_gao))
    return dataclasses.replace(
        t, est_cost=j_plan.est_cost, level_costs=j_plan.level_costs,
        level_est_rows=j_plan.level_est_rows, agm_log2=j_plan.agm_log2,
        stats_fingerprint=j_plan.stats_fingerprint,
        output_mode=j_plan.output_mode)


def _key(findings):
    return [(f.rule, f.severity, f.path, f.line) for f in findings]


def _same_findings(got, want):
    assert _key(got) == _key(want)
    for g, w in zip(got, want):
        if g.rule != "V107":
            assert (g.message, g.hint) == (w.message, w.hint)


def errors_of(findings):
    return sorted({f.rule for f in findings if f.severity == "error"})


@pytest.fixture(scope="module")
def dbs():
    """kind -> (reference db, port db) over the same arrays."""
    j = make_gdb(60, 3, seed=0)
    plain = (j, gdb_from_arrays(j.csr.indptr, j.csr.indices, j.unary,
                                device="cpu"))
    z = zipf_graph(300, 2400, alpha=2.0, seed=0)
    unary = {f"v{i}": node_sample(z.n_nodes, 6.0, seed=17 * i + 1)
             for i in range(1, 5)}
    h = JHybridGraphDB.build(z, unary)
    hybrid = (h, gdb_from_arrays(h.csr.indptr, h.csr.indices, h.unary,
                                 layout_words=h.layout.words, order=h.order,
                                 min_degree=h.layout.min_degree,
                                 device="cpu"))
    return {"plain": plain, "hybrid": hybrid}


# ---------------------------------------------------------------------------
# planner output: every tier-1 shape and engine on both dbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_tier1_findings_match(kind, engine, shape, dbs):
    j_db, t_db = dbs[kind]
    try:
        j_plan = j_plan_query(j_get_query(shape), JGraphStats.of(j_db),
                              engine=engine)
    except Exception as e:          # the engine cannot run this shape
        with pytest.raises(Exception) as t_err:
            T.plan_query(T.get_query(shape), T.GraphStats.of(t_db),
                         engine=engine)
        assert type(t_err.value).__name__ == type(e).__name__
        assert str(t_err.value) == str(e)
        return
    t_plan = T.plan_query(T.get_query(shape), T.GraphStats.of(t_db),
                          engine=engine)
    assert t_plan.describe() == j_plan.describe()
    _same_findings(verify_plan(t_plan, gdb=t_db),
                   j_verify_plan(j_plan, gdb=j_db))
    want = j_verify_for_execution(j_plan, j_db)
    got = verify_for_execution(t_plan, t_db)
    _same_findings(got, want)
    assert errors_of(got) == []
    assert verify_for_execution(t_plan, t_db) == got     # memoized
    a, b = (audit_recompilation(t_plan, T.GraphStats.of(t_db)),
            j_audit(j_plan, JGraphStats.of(j_db)))
    assert (a.per_level, a.final_level, a.spmd, a.total, a.chunk_shapes,
            a.unbounded) == (b.per_level, b.final_level, b.spmd, b.total,
                             b.chunk_shapes, b.unbounded)


@pytest.mark.parametrize("profile", sorted(STATS_PROFILES))
@pytest.mark.parametrize("shape", TIER1_SHAPES)
def test_static_profile_findings_and_audit_match(profile, shape):
    """The JAX package's CI stats profiles, every candidate plan: the same
    findings and the same census (also across 4 devices and with
    caller-controlled paging)."""
    j_stats = STATS_PROFILES[profile]
    t_stats = _port_stats(j_stats)
    assert t_stats.fingerprint() == j_stats.fingerprint()
    for engine in ENGINES:
        try:
            j_plan = j_plan_query(j_get_query(shape), j_stats, engine=engine)
        except Exception:
            continue
        t_plan = T.plan_query(T.get_query(shape), t_stats, engine=engine)
        _same_findings(verify_plan(t_plan, t_stats),
                       j_verify_plan(j_plan, j_stats))
        for kw in (dict(), dict(n_devices=4), dict(paging_configs=None),
                   dict(chunk_rows=1000, budget=16)):
            a = audit_recompilation(t_plan, t_stats, **kw)
            b = j_audit(j_plan, j_stats, **kw)
            assert (a.per_level, a.final_level, a.spmd, a.total,
                    a.chunk_shapes, len(a.unbounded), a.within_budget) == (
                b.per_level, b.final_level, b.spmd, b.total,
                b.chunk_shapes, len(b.unbounded), b.within_budget)
            _same_findings(a.findings(), b.findings())


def test_chunk_shape_count_matches():
    for rows in list(range(0, 70)) + [127, 128, 129, 1000, 4096, 8192,
                                      8193, 12288, 1 << 20]:
        assert chunk_shape_count(rows) == j_chunk_shape_count(rows)
    assert chunk_shape_count(8192) == 11
    assert DEFAULT_RECOMPILE_BUDGET == 1024


# ---------------------------------------------------------------------------
# the malformed plans of tests/test_analysis.py, on both sides
# ---------------------------------------------------------------------------

def _mutations(k):
    """name -> (plan fields to replace, stats fields to replace, stats
    profile, verify_plan kwargs); a callable field maps the plan to the
    value."""
    return {
        "uncovered-gao-variable": (
            dict(gao=lambda p: p.gao[:-1], levels=lambda p: p.levels),
            {}, "hybrid", {}),
        "repeated-gao-variable": (
            dict(gao=lambda p: (p.gao[0],) * 3, levels=lambda p: p.levels),
            {}, "hybrid", {}),
        "bitset-level-without-layout": (
            dict(level_layouts=("bitset",) * k), {}, "array", {}),
        "wrong-bitset-words": (
            dict(level_layouts=("mixed",) * k), dict(bitset_words=1),
            "hybrid", {}),
        "nonfinite-estimate": (
            dict(level_est_rows=(float("nan"),) * k), {}, "hybrid", {}),
        "growth-after-empty-frontier": (
            dict(level_est_rows=(0.0,) + (5.0,) * (k - 1)), {}, "hybrid",
            {}),
        "int32-overflowing-graph": (
            {}, dict(n_nodes=2 ** 31), "hybrid", {}),
        "over-budget-recompilation": (
            {}, {}, "hybrid", dict(recompile_budget=1)),
        "unbounded-paging": (
            {}, {}, "hybrid", dict(paging_configs=None)),
        "hand-edited-levels": (
            dict(levels=lambda p: tuple(reversed(p.levels))), {}, "hybrid",
            {}),
        "unknown-output-mode": (
            dict(output_mode="tuples", levels=lambda p: p.levels), {},
            "hybrid", {}),
        "wrong-arity-callback": (
            dict(level_callback=lambda p: (lambda: None)), {}, "hybrid",
            {}),
        "good": ({}, {}, "hybrid", {}),
    }


def _apply(plan, fields):
    return dataclasses.replace(plan, **{
        k: v(plan) if callable(v) else v for k, v in fields.items()})


@pytest.mark.parametrize("name", sorted(_mutations(3)))
def test_malformed_plan_findings_match(name):
    j_good = j_plan_query(j_get_query("3-clique"), STATS_PROFILES["hybrid"],
                          engine="vlftj")
    t_good = _port_plan(j_good)
    assert t_good.levels and len(t_good.levels) == len(j_good.levels)
    fields, stats_kw, profile, kw = _mutations(len(j_good.gao))[name]
    j_stats = dataclasses.replace(STATS_PROFILES[profile], **stats_kw)
    t_stats = _port_stats(j_stats)
    want = j_verify_plan(_apply(j_good, fields), j_stats, **kw)
    got = verify_plan(_apply(t_good, fields), t_stats, **kw)
    _same_findings(got, want)
    if name == "good":
        assert errors_of(got) == []
    else:
        assert errors_of(got), name


def test_foreign_yannakakis_root_matches():
    j_plan = j_plan_query(j_get_query("3-path"), STATS_PROFILES["array"],
                          engine="yannakakis")
    t_stats = _port_stats(STATS_PROFILES["array"])
    want = j_verify_plan(dataclasses.replace(j_plan, root="zz"),
                         STATS_PROFILES["array"])
    got = verify_plan(dataclasses.replace(_port_plan(j_plan), root="zz"),
                      t_stats)
    _same_findings(got, want)
    assert "V102" in errors_of(got)


# ---------------------------------------------------------------------------
# the device-array rules (V108, V110) on a meta tensor
# ---------------------------------------------------------------------------

def _pinning_callback(obj):
    def cb(level, frontier, mult):
        assert obj is not None
        return None
    return cb


@pytest.mark.parametrize("captured,flagged", [
    (lambda: torch.zeros(3, device="meta"), True),
    (lambda: torch.zeros(3), False),
    (lambda: np.zeros(3), False)], ids=["meta", "cpu-tensor", "numpy"])
def test_v108_flags_device_tensors_only(captured, flagged):
    good = T.plan_query(T.get_query("3-clique"),
                        _port_stats(STATS_PROFILES["hybrid"]),
                        engine="vlftj")
    stats = _port_stats(STATS_PROFILES["hybrid"])
    closure = good.with_level_callback(_pinning_callback(captured()))
    holder = types.SimpleNamespace(buf=captured())
    holder.cb = types.MethodType(lambda self, level, frontier, mult: None,
                                 holder)
    method = good.with_level_callback(holder.cb)
    for plan, name in ((closure, "obj"), (method, "self.buf")):
        found = [f for f in verify_plan(plan, stats) if f.rule == "V108"]
        if flagged:
            assert errors_of(found) == ["V108"]
            assert name in found[0].message and "pins" in found[0].message
        else:
            assert found == []


def _snap(**kw):
    base = dict(frontier=np.zeros((3, 2), np.int32),
                mult=np.ones(3, np.int64), level=1)
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("field", ["frontier", "mult"])
def test_v110_flags_device_tensors_only(field):
    meta = verify_snapshot(_snap(**{field: torch.zeros(3, device="meta")}))
    assert [f.rule for f in meta] == ["V110"]
    assert "device array" in meta[0].message and "torch" in meta[0].message
    assert verify_snapshot(_snap(**{field: torch.zeros(3)})) == []
    assert verify_snapshot(_snap()) == []


def test_v110_other_cases_match_the_reference():
    from repro.analysis import verify_snapshot as j_verify_snapshot
    for snap in (_snap(mult=None), _snap(level=-1), _snap(level=1.5),
                 _snap(frontier=np.array([object()], dtype=object))):
        _same_findings(verify_snapshot(snap), j_verify_snapshot(snap))


# ---------------------------------------------------------------------------
# enforcement: count / enumerate / stream
# ---------------------------------------------------------------------------

def _bad_plans(t_db):
    q = T.get_query("3-clique")
    plan = T.plan_query(q, T.GraphStats.of(t_db), engine="vlftj")
    meta = torch.zeros(3, device="meta")
    return q, plan, {
        "V108": plan.with_level_callback(_pinning_callback(meta)),
        "V101": dataclasses.replace(plan, gao=(plan.gao[0],) * 3,
                                    levels=plan.levels)}


@pytest.mark.parametrize("rule", ["V108", "V101"])
@pytest.mark.parametrize("entry", ["count", "enumerate", "stream"])
def test_entry_points_reject_bad_plans(rule, entry, dbs):
    _, t_db = dbs["plain"]
    q, _, bad = _bad_plans(t_db)
    fn = getattr(t_engine, entry)
    with pytest.raises(PlanVerificationError) as err:
        fn(q, t_db, plan=bad[rule], **EXEC_KW)
    assert rule in {f.rule for f in err.value.findings}
    assert all(isinstance(f, Finding) and f.severity == "error"
               for f in err.value.findings)


def test_verify_false_bypasses(dbs):
    """The V108 plan's callback is harmless when it runs: with
    ``verify=False`` every entry point executes it and agrees with the
    good plan."""
    _, t_db = dbs["plain"]
    q, plan, bad = _bad_plans(t_db)
    bad = bad["V108"]
    want = t_engine.count(q, t_db, plan=plan, **EXEC_KW)
    assert t_engine.count(q, t_db, plan=bad, verify=False, **EXEC_KW) == want
    rows = t_engine.enumerate(q, t_db, plan=plan, mode="flat",
                              **EXEC_KW).rows
    np.testing.assert_array_equal(
        t_engine.enumerate(q, t_db, plan=bad, mode="flat", verify=False,
                           **EXEC_KW).rows, rows)
    pages = list(t_engine.stream(q, t_db, plan=bad, verify=False,
                                 page_rows=64, **EXEC_KW))
    assert sum(p.shape[0] for p in pages) == want == rows.shape[0]


@pytest.mark.parametrize("kind", KINDS)
def test_verification_builds_no_device_tensor(kind, dbs):
    """Verification reads host arrays only: on a fresh db, planning and
    verifying every tier-1 shape builds none of its device tensors."""
    _, t_db = dbs[kind]
    fresh = gdb_from_arrays(
        t_db.csr.indptr, t_db.csr.indices, t_db.unary,
        layout_words=None if kind == "plain" else t_db.layout.words,
        order=getattr(t_db, "order", None),
        min_degree=None if kind == "plain" else t_db.layout.min_degree,
        device="cpu")
    for shape in TIER1_SHAPES:
        plan = T.plan_query(T.get_query(shape), T.GraphStats.of(fresh),
                            engine="auto")
        assert errors_of(verify_for_execution(plan, fresh)) == []
    assert fresh._dev == {}


def test_verify_for_execution_memoizes(dbs):
    _, t_db = dbs["hybrid"]
    plan = T.plan_query(T.get_query("4-cycle"), T.GraphStats.of(t_db),
                        engine="vlftj")
    first = verify_for_execution(plan, t_db)
    assert any(k[0] == plan for k in _VERIFY_CACHE)
    assert verify_for_execution(plan, t_db) == first
    # a callback attached after the fact reuses the memo and is checked
    pinned = plan.with_level_callback(
        _pinning_callback(torch.zeros(1, device="meta")))
    with pytest.raises(PlanVerificationError):
        verify_for_execution(pinned, t_db)


# ---------------------------------------------------------------------------
# V106: the renumbering caveat
# ---------------------------------------------------------------------------

def test_renumbering_caveat_warns_same_db_errors_cross_db():
    csr = t_powerlaw_cluster(n=120, m_per_node=3, seed=3)
    j_csr = powerlaw_cluster(n=120, m_per_node=3, seed=3)
    np.testing.assert_array_equal(csr.indices, j_csr.indices)
    unary = {"v1": np.arange(0, 120, 7)}
    hdb = T.HybridGraphDB.build(csr, unary, device="cpu")
    j_hdb = JHybridGraphDB.build(j_csr, unary)
    stats, j_stats = T.GraphStats.of(hdb), JGraphStats.of(j_hdb)
    plan = T.plan_query(T.get_query("4-cycle"), stats, engine="vlftj")
    j_plan = j_plan_query(j_get_query("4-cycle"), j_stats, engine="vlftj")
    same = verify_plan(plan, stats, hdb)
    _same_findings(same, j_verify_plan(j_plan, j_stats, j_hdb))
    assert "V106" not in errors_of(same)
    assert any(f.rule == "V106" and f.severity == "warning" for f in same)
    stale = verify_plan(dataclasses.replace(plan, stats_fingerprint="f" * 16),
                        stats, hdb)
    _same_findings(stale, j_verify_plan(
        dataclasses.replace(j_plan, stats_fingerprint="f" * 16), j_stats,
        j_hdb))
    assert "V106" in errors_of(stale)
    flat = T.HybridGraphDB.build(csr, unary, renumber=False, device="cpu")
    assert not any(f.rule == "V106" for f in
                   verify_plan(plan, T.GraphStats.of(flat), flat))
    # the count goes through: a warning never raises
    assert T.count(T.get_query("4-cycle"), hdb, plan=plan) == T.count(
        T.get_query("4-cycle"), hdb, plan=plan, verify=False)


def test_filters_quotient_automorphism_classification():
    from repro.analysis import filters_quotient_automorphism as j_fqa
    from repro.core.query import PAPER_QUERIES
    for shape in PAPER_QUERIES:
        assert filters_quotient_automorphism(T.get_query(shape)) == \
            j_fqa(j_get_query(shape))
    assert filters_quotient_automorphism(T.get_query("4-clique"))
    assert not filters_quotient_automorphism(T.get_query("4-cycle"))


def test_report_json_and_gate():
    import json
    rep = FindingReport([
        Finding("V101", "error", "p", 1, "boom"),
        Finding("V103", "warning", "p", 2, "meh", hint="h")])
    assert not rep.gate_passes
    doc = json.loads(rep.to_json(job="t"))
    assert doc["n_findings"] == 2 and doc["n_errors"] == 1
    assert doc["gate"] == "fail" and doc["job"] == "t"
    assert FindingReport([rep.findings[1]]).gate_passes
    with pytest.raises(ValueError):
        Finding("V101", "fatal", "p", 0, "m")
