"""Static plan verifier: abstract interpretation over a frozen
:class:`~repro_torch.core.plan.JoinPlan` before any device dispatch.

The port's copy of ``repro.analysis.verifier``: the same rules, the same
findings on the same plans.  The one device-dependent test is what counts
as a device array (V108, V110): a ``torch.Tensor`` off the CPU.

EmptyHeaded gets plan trustworthiness from a compile-time GHD/layout
checker; this is our equivalent for the ``plan -> execute`` split.  The
verifier never touches graph *data* — it interprets the plan against
:class:`~repro_torch.core.plan.GraphStats` (and, when available, the executing
``GraphDB``'s layout metadata), so verification is as cacheable as
planning itself.

Rule catalog (ids are stable; the JAX package's ``docs/ANALYSIS.md`` is
the reference):

=====  ====================================================================
V101   GAO covers the query variables exactly; vectorized levels past the
       first are bound by >= 1 edge or unary constraint
V102   plan internals align: compiled ``levels`` match
       ``compile_levels(query, gao)``; annotation tuples
       (``level_layouts``/``level_est_rows``/``level_costs``) have per-
       level arity; hybrid decomposition / yannakakis root well-formed
V103   dense-scan levels (no incident constraint at bind time) — warning
V104   frontier dtype/shape propagation: int32 id space, finite
       non-negative cardinality estimates
V105   layout consistency: bitset/mixed levels require hub metadata, and
       the plan's stats must agree with the executing db's
       ``HybridLayout`` (``bitset_words``/``n_hubs``)
V106   renumbering-invariance: non-quotient order filters on a
       renumbered db are an error when the plan's stats fingerprint is
       stale (cross-db reuse); a warning on the same db (documented
       caveat in ``HybridGraphDB``)
V107   specialization budget (``analysis.recompile``)
V108   ``level_callback`` protocol conformance: callable with the
       ``(level, frontier, mult)`` arity, no device arrays captured —
       a callback closing over device state cannot be snapshotted by
       ``PlanSnapshot`` and pins device buffers across suspends
V109   ``output_mode`` semantics
V110   ``PlanSnapshot`` conformance (``verify_snapshot``): host arrays
       only, pickle-free serializability
=====  ====================================================================

Only **error**-severity findings reject a plan; warnings/notes surface
through ``explain_analyze``.  Enforcement entry point:
:func:`verify_for_execution` (memoized, raised by ``engine.count`` /
``enumerate`` / ``stream`` / the query server under ``verify=True``).
"""
from __future__ import annotations

import inspect
import weakref
from collections import OrderedDict
from itertools import combinations

import numpy as np
import torch

from ..core.plan import GraphStats, JoinPlan, compile_levels
from ..core.query import Query
from .findings import Finding, PlanVerificationError
from .recompile import DEFAULT_RECOMPILE_BUDGET, audit_recompilation

_INT32_MAX = 2 ** 31 - 1
_OUTPUT_MODES = ("count", "flat", "factorized")
_LAYOUTS = ("array", "bitset", "mixed")
_VECTOR_ENGINES = ("vlftj", "lftj_ref")


def _plan_path(plan: JoinPlan) -> str:
    return f"plan:{plan.query.name}/{plan.engine}"


def filters_quotient_automorphism(query: Query) -> bool:
    """True iff every ``LessThan`` filter breaks a query automorphism.

    A filter ``u < v`` quotients an automorphism when swapping ``u`` and
    ``v`` maps the atom set to itself (binary atoms compared as
    ``(rel, {vars})`` — the benchmark ``edge`` relation is loaded
    symmetric).  Then each filter halves a genuine output symmetry and
    the count is invariant under any vertex renumbering (the clique
    chains, 2-lollipop's ``d<e``).  A filter between non-interchangeable
    variables (4-cycle's ``a<b``: ``a`` and ``b`` have different
    neighborhoods in the atom set) merely *slices* the id space, so the
    count depends on the numbering — the ``HybridGraphDB`` caveat.
    """
    if not query.filters:
        return True
    atom_set = {(a.rel, frozenset(a.vars)) if a.arity == 2
                else (a.rel, a.vars) for a in query.atoms}
    for f in query.filters:
        swap = {f.left: f.right, f.right: f.left}
        mapped = {(rel, frozenset(swap.get(v, v) for v in vs))
                  if isinstance(vs, frozenset)
                  else (rel, tuple(swap.get(v, v) for v in vs))
                  for rel, vs in atom_set}
        if mapped != atom_set:
            return False
    # the filters must also compose: chains like a<b<c<d quotient the
    # full symmetric group only if every *pair* of chained variables is
    # interchangeable (transpositions generate the group)
    chained = {v for f in query.filters for v in (f.left, f.right)}
    for u, v in combinations(sorted(chained), 2):
        swap = {u: v, v: u}
        mapped = {(rel, frozenset(swap.get(x, x) for x in vs))
                  if isinstance(vs, frozenset)
                  else (rel, tuple(swap.get(x, x) for x in vs))
                  for rel, vs in atom_set}
        if mapped != atom_set:
            return False
    return True


def _is_device_array(obj) -> bool:
    return isinstance(obj, torch.Tensor) and obj.device.type != "cpu"


def _captured_device_arrays(fn) -> list[str]:
    """Names through which ``fn`` closes over device tensors."""
    hits: list[str] = []
    closure = getattr(fn, "__closure__", None) or ()
    names = getattr(getattr(fn, "__code__", None), "co_freevars", ())
    for name, cell in zip(names, closure):
        try:
            val = cell.cell_contents
        except ValueError:
            continue
        if _is_device_array(val):
            hits.append(name)
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        for attr, val in list(getattr(self_obj, "__dict__", {}).items()):
            if _is_device_array(val):
                hits.append(f"self.{attr}")
    return hits


# ---------------------------------------------------------------------------
# rule passes (each appends Findings; none raises)
# ---------------------------------------------------------------------------

def _check_gao(plan: JoinPlan, out: list[Finding]) -> None:
    path = _plan_path(plan)
    qvars = set(plan.query.variables)
    gao = plan.gao
    if plan.engine == "hybrid" and plan.decomposition is not None:
        # a hybrid plan's GAO is the *core* GAO; the tree half binds by
        # message passing.  Coverage = core vars here, tree ∪ core = the
        # full query (checked now), decomposition shape = V102.
        d = plan.decomposition
        union = set(d.tree_query.variables) | set(d.core_query.variables)
        if union != qvars:
            out.append(Finding(
                "V101", "error", path, 0,
                f"hybrid tree/core split covers {sorted(union)} but the "
                f"query binds {sorted(qvars)}",
                "every query variable must land in the tree or the "
                "core subquery"))
        qvars = set(d.core_query.variables)
    if len(set(gao)) != len(gao):
        out.append(Finding("V101", "error", path, 0,
                           f"GAO {gao} repeats a variable",
                           "a GAO is a permutation of the query variables"))
        return
    missing = qvars - set(gao)
    extra = set(gao) - qvars
    if missing:
        out.append(Finding("V101", "error", path, 0,
                           f"GAO {gao} does not cover query variable(s) "
                           f"{sorted(missing)}",
                           "every query variable binds at exactly one "
                           "GAO level"))
    if extra:
        out.append(Finding("V101", "error", path, 0,
                           f"GAO {gao} binds non-query variable(s) "
                           f"{sorted(extra)}",
                           "drop variables the query never mentions"))
    if missing or extra:
        return
    if plan.engine in _VECTOR_ENGINES and plan.levels:
        for i, lp in enumerate(plan.levels):
            if i == 0:
                continue
            if not lp.edge_sources and not lp.unary and not lp.needs_degree:
                out.append(Finding(
                    "V101", "error", path, i + 1,
                    f"level {i} ({lp.var!r}) is bound by no edge or unary "
                    f"atom — a cross-product scan the vectorized executor "
                    f"does not implement",
                    "reorder the GAO so every level is adjacent to an "
                    "earlier one, or route to an engine with cross-"
                    "product support"))


def _check_alignment(plan: JoinPlan, out: list[Finding]) -> None:
    path = _plan_path(plan)
    k = len(plan.gao)
    if plan.engine in _VECTOR_ENGINES:
        if len(plan.levels) != k:
            out.append(Finding(
                "V102", "error", path, 0,
                f"{len(plan.levels)} compiled level(s) for a {k}-level "
                f"GAO", "levels must be compile_levels(query, gao)"))
        else:
            try:
                expect = compile_levels(plan.query, plan.gao)
            except (ValueError, KeyError):
                expect = None   # V101 territory (uncovered vars)
            if expect is not None and tuple(plan.levels) != expect:
                drift = [i for i, (a, b) in
                         enumerate(zip(plan.levels, expect)) if a != b]
                out.append(Finding(
                    "V102", "error", path, (drift[0] + 1) if drift else 0,
                    f"compiled levels disagree with compile_levels("
                    f"query, gao) at level(s) {drift}",
                    "never hand-edit plan.levels; rebuild via "
                    "dataclasses.replace on (query, gao)"))
    for name, tup in (("level_layouts", plan.level_layouts),
                      ("level_est_rows", plan.level_est_rows),
                      ("level_costs", plan.level_costs)):
        if tup and len(tup) != k:
            out.append(Finding(
                "V102", "error", path, 0,
                f"{name} has {len(tup)} entries for a {k}-level GAO",
                f"{name} is per-GAO-level (or empty)"))
    for i, m in enumerate(plan.level_layouts):
        if m not in _LAYOUTS:
            out.append(Finding(
                "V102", "error", path, i + 1,
                f"unknown level layout {m!r}", f"options: {_LAYOUTS}"))
    if plan.engine == "hybrid":
        d = plan.decomposition
        if d is None:
            # legitimate: HybridJoin falls back to a whole-query VLFTJ
            # when the query has no tree/core split (hybrid.py) — but it
            # needs a GAO to do it
            if not plan.gao:
                out.append(Finding(
                    "V102", "error", path, 0,
                    "hybrid plan with neither a tree/core decomposition "
                    "nor a fallback GAO",
                    "build hybrid plans through planner.plan_query"))
        elif d.attachment not in d.core_gao \
                or set(d.core_gao) != set(d.core_query.variables):
            out.append(Finding(
                "V102", "error", path, 0,
                f"hybrid core GAO {d.core_gao} / attachment "
                f"{d.attachment!r} inconsistent with the core query "
                f"variables {d.core_query.variables}",
                "attachment must be a core variable and core_gao a "
                "permutation of the core query's variables"))
    if plan.engine == "yannakakis" and plan.root is not None \
            and plan.root not in plan.query.variables:
        out.append(Finding(
            "V102", "error", path, 0,
            f"yannakakis root {plan.root!r} is not a query variable",
            "root must name a join-tree vertex variable"))


def _check_dense_levels(plan: JoinPlan, out: list[Finding]) -> None:
    if plan.engine not in _VECTOR_ENGINES:
        return
    path = _plan_path(plan)
    for i, lp in enumerate(plan.levels):
        if i > 0 and not lp.edge_sources and lp.unary:
            out.append(Finding(
                "V103", "warning", path, i + 1,
                f"level {i} ({lp.var!r}) binds by unary scan only — the "
                f"frontier crosses with the full unary set",
                "prefer a GAO binding each variable adjacent to an "
                "earlier one"))
        if i == 0 and not lp.unary and not lp.needs_degree \
                and not lp.edge_sources:
            out.append(Finding(
                "V103", "note", path, 1,
                f"seed level ({lp.var!r}) scans the full vertex domain",
                "harmless on small graphs; a unary anchor shrinks it"))


def _check_frontier_flow(plan: JoinPlan, stats: GraphStats | None,
                         out: list[Finding]) -> None:
    path = _plan_path(plan)
    if stats is not None and stats.n_nodes > _INT32_MAX:
        out.append(Finding(
            "V104", "error", path, 0,
            f"graph has {stats.n_nodes} nodes but frontiers / CSR "
            f"indices are int32",
            "shard the graph below 2^31 nodes per device"))
    est = plan.level_est_rows
    if est and len(est) == len(plan.gao):
        for i, r in enumerate(est):
            if not np.isfinite(r) or r < 0:
                out.append(Finding(
                    "V104", "error", path, i + 1,
                    f"level {i} cardinality estimate is {r!r}",
                    "estimates must be finite and non-negative — "
                    "re-plan against current GraphStats"))
        # abstract width propagation: frontier at level i is
        # (rows_i, i+1) int32; a widths inversion (rows collapsing to 0
        # then growing) is impossible under conjunctive semantics.  The
        # cost model floors estimates with sub-row epsilons on sparse
        # inputs, so only a *material* (>= 1 row) reappearance fires.
        for i in range(1, len(est)):
            if est[i - 1] == 0 and est[i] >= 1:
                out.append(Finding(
                    "V104", "error", path, i + 1,
                    f"estimated frontier grows {est[i - 1]} -> {est[i]} "
                    f"across level {i}: rows cannot reappear after an "
                    f"empty frontier",
                    "the estimate tuple is inconsistent; re-plan"))


def _check_layouts(plan: JoinPlan, stats: GraphStats | None, gdb,
                   out: list[Finding]) -> None:
    path = _plan_path(plan)
    wants_bitset = [i for i, m in enumerate(plan.level_layouts)
                    if m in ("bitset", "mixed")]
    if not wants_bitset:
        return
    if stats is not None and (stats.n_hubs <= 0 or stats.bitset_words <= 0):
        out.append(Finding(
            "V105", "error", path, wants_bitset[0] + 1,
            f"level(s) {wants_bitset} want a bitset layout but the graph "
            f"stats carry no hub metadata (n_hubs={stats.n_hubs if stats else 0}, "
            f"bitset_words={stats.bitset_words if stats else 0})",
            "plan against GraphStats.of(a HybridGraphDB), or force "
            "array layouts"))
        return
    layout = getattr(gdb, "layout", None) if gdb is not None else None
    if gdb is not None and layout is None:
        out.append(Finding(
            "V105", "error", path, wants_bitset[0] + 1,
            f"level(s) {wants_bitset} want a bitset layout but the "
            f"executing db carries no HybridLayout",
            "execute on the HybridGraphDB the plan was costed for"))
        return
    if layout is not None and stats is not None:
        if int(layout.n_words) != stats.bitset_words \
                or int(layout.n_hubs) != stats.n_hubs:
            out.append(Finding(
                "V105", "error", path, wants_bitset[0] + 1,
                f"plan stats say n_hubs={stats.n_hubs}/"
                f"bitset_words={stats.bitset_words} but the executing "
                f"layout has n_hubs={int(layout.n_hubs)}/"
                f"n_words={int(layout.n_words)}",
                "the plan was costed against a different layout; "
                "re-plan (stats fingerprints must match)"))
    if stats is not None and stats.n_hubs > 0 \
            and stats.bitset_words * 32 < stats.n_nodes:
        out.append(Finding(
            "V105", "error", path, 0,
            f"bitset rows span {stats.bitset_words * 32} vertex slots "
            f"< {stats.n_nodes} nodes — membership tests would read "
            f"out of range",
            "bitset_words must be ceil(n_nodes / 32)"))
    # a bitset level the executor cannot use (needs >= 2 bound edge
    # endpoints to intersect against) silently falls back to arrays
    for i in wants_bitset:
        if i < len(plan.levels) and len(plan.levels[i].edge_sources) < 2:
            out.append(Finding(
                "V105", "warning", path, i + 1,
                f"level {i} is marked {plan.level_layouts[i]!r} but has "
                f"{len(plan.levels[i].edge_sources)} bound edge "
                f"source(s) — the executor needs >= 2 to intersect "
                f"bitsets and will fall back to arrays",
                "cosmetic: the planner should mark such levels 'array'"))


def _is_renumbered(gdb) -> bool:
    """True when the db's id space is a non-identity permutation of the
    loaded one (``HybridGraphDB.build(renumber=False)`` keeps ``order``
    as the identity, which is *not* renumbered)."""
    order = getattr(gdb, "order", None)
    if order is None:
        return False
    order = np.asarray(order)
    return bool((order != np.arange(order.shape[0])).any())


def _check_renumbering(plan: JoinPlan, stats: GraphStats | None, gdb,
                       out: list[Finding]) -> None:
    if not plan.query.filters or gdb is None:
        return
    if not _is_renumbered(gdb):
        return
    if filters_quotient_automorphism(plan.query):
        return                                  # counts invariant: safe
    path = _plan_path(plan)
    current = stats.fingerprint() if stats is not None else ""
    if plan.stats_fingerprint and current \
            and plan.stats_fingerprint != current:
        out.append(Finding(
            "V106", "error", path, 0,
            "plan with non-automorphism order filters (id-slicing, e.g. "
            "a 4-cycle chain) was costed against a different graph but "
            "is executing on a renumbered db — counts are not "
            "renumbering-invariant, so this cross-db reuse is unsound",
            "re-plan against GraphStats.of(this db), or build the db "
            "with renumber=False"))
    else:
        out.append(Finding(
            "V106", "warning", path, 0,
            "non-automorphism order filters evaluate in the renumbered "
            "id space on this HybridGraphDB — counts are only "
            "comparable between engines on this same db",
            "see the HybridGraphDB caveat; renumber=False restores "
            "original-id semantics"))


def _check_callback(plan: JoinPlan, out: list[Finding]) -> None:
    cb = plan.level_callback
    if cb is None:
        return
    path = _plan_path(plan)
    if not callable(cb):
        out.append(Finding(
            "V108", "error", path, 0,
            f"level_callback of type {type(cb).__name__} is not callable",
            "the protocol is callback(level, frontier, mult)"))
        return
    try:
        sig = inspect.signature(cb)
    except (TypeError, ValueError):
        sig = None
    if sig is not None:
        try:
            sig.bind(0, None, None)
        except TypeError:
            out.append(Finding(
                "V108", "error", path, 0,
                f"level_callback{sig} cannot accept the (level, "
                f"frontier, mult) protocol arguments",
                "accept three positional arguments (or *args)"))
    captured = _captured_device_arrays(cb)
    if captured:
        out.append(Finding(
            "V108", "error", path, 0,
            f"level_callback captures device array(s) via "
            f"{captured} — unserializable into a PlanSnapshot and pins "
            f"device buffers across suspend/resume",
            "close over host numpy copies (.cpu().numpy()) instead"))


def _check_output_mode(plan: JoinPlan, out: list[Finding]) -> None:
    path = _plan_path(plan)
    if plan.output_mode not in _OUTPUT_MODES:
        out.append(Finding(
            "V109", "error", path, 0,
            f"unknown output_mode {plan.output_mode!r}",
            f"options: {_OUTPUT_MODES}"))


def verify_snapshot(snapshot, path: str = "snapshot") -> list[Finding]:
    """V110: a suspended plan's state must be host-resident and
    pickle-free serializable (``PlanSnapshot.to_bytes`` uses a json
    header + ``np.save(allow_pickle=False)``)."""
    out: list[Finding] = []
    frontier = getattr(snapshot, "frontier", None)
    mult = getattr(snapshot, "mult", None)
    for name, arr in (("frontier", frontier), ("mult", mult)):
        if arr is None:
            out.append(Finding(
                "V110", "error", path, 0,
                f"snapshot has no {name} array",
                "suspend at a level boundary with (frontier, mult)"))
        elif _is_device_array(arr):
            out.append(Finding(
                "V110", "error", path, 0,
                f"snapshot {name} is a device array "
                f"({type(arr).__module__}.{type(arr).__name__})",
                "copy state to host numpy (.cpu().numpy()) before "
                "snapshotting — snapshots must not pin device buffers"))
        elif isinstance(arr, np.ndarray) and arr.dtype == object:
            out.append(Finding(
                "V110", "error", path, 0,
                f"snapshot {name} has dtype=object — cannot serialize "
                f"with allow_pickle=False",
                "snapshots carry numeric dtypes only"))
    level = getattr(snapshot, "level", None)
    if level is not None and (not isinstance(level, (int, np.integer))
                              or level < 0):
        out.append(Finding(
            "V110", "error", path, 0,
            f"snapshot level {level!r} is not a non-negative int",
            "record the next GAO level to run"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_plan(plan: JoinPlan, stats: GraphStats | None = None,
                gdb=None, *,
                recompile_budget: int = DEFAULT_RECOMPILE_BUDGET,
                n_devices: int = 1,
                paging_configs: int | None = 2) -> list[Finding]:
    """Run every verifier rule over ``plan``; returns all findings.

    ``stats`` defaults to ``GraphStats.of(gdb)`` when a db is given.
    Pure host-side interpretation — never dispatches device work.
    """
    if stats is None and gdb is not None:
        stats = GraphStats.of(gdb)
    out: list[Finding] = []
    _check_gao(plan, out)
    _check_alignment(plan, out)
    _check_dense_levels(plan, out)
    _check_frontier_flow(plan, stats, out)
    _check_layouts(plan, stats, gdb, out)
    _check_renumbering(plan, stats, gdb, out)
    _check_callback(plan, out)
    _check_output_mode(plan, out)
    audit = audit_recompilation(plan, stats, budget=recompile_budget,
                                n_devices=n_devices,
                                paging_configs=paging_configs)
    out.extend(audit.findings(_plan_path(plan)))
    return out


# verification is a pure function of (plan, stats fingerprint) apart
# from the callback (mutable, compare=False) — memoize the structural
# part so the per-request cost in the serving path is a dict lookup.
_VERIFY_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_VERIFY_CACHE_CAP = 256
# GraphStats per db identity; (weakref, stats) guards id() reuse
_STATS_CACHE: dict[int, tuple] = {}


def _stats_of(gdb) -> tuple[GraphStats, bool]:
    """Memoized ``(GraphStats.of(gdb), renumbered?)`` per db identity.

    ``GraphDB`` is an unhashable dataclass (eq without frozen), so the
    memo keys on ``id()`` with a stored weakref guarding against id
    reuse after collection."""
    key = id(gdb)
    hit = _STATS_CACHE.get(key)
    if hit is not None and hit[0]() is gdb:
        return hit[1], hit[2]
    stats = GraphStats.of(gdb)
    renum = _is_renumbered(gdb)
    if len(_STATS_CACHE) > 64:
        _STATS_CACHE.clear()
    try:
        ref = weakref.ref(gdb)
    except TypeError:
        def ref(g=gdb):
            return g
    _STATS_CACHE[key] = (ref, stats, renum)
    return stats, renum


def verify_for_execution(plan: JoinPlan, gdb,
                         recompile_budget: int = DEFAULT_RECOMPILE_BUDGET
                         ) -> list[Finding]:
    """Enforcement wrapper used by ``engine`` / the query server.

    Returns the findings (for surfacing) and raises
    :class:`PlanVerificationError` on any error-severity finding.
    Structural results are memoized on ``(plan, stats fingerprint,
    renumbered?, budget)``; the callback rule (the one non-hashable
    field) re-runs each call.
    """
    stats, renumbered = _stats_of(gdb)
    key = (plan, stats.fingerprint(), renumbered,
           getattr(gdb, "layout", None) is not None, recompile_budget)
    try:
        cached = _VERIFY_CACHE.get(key)
    except TypeError:           # unhashable query payloads: skip memo
        cached = None
        key = None
    if cached is None:
        base = plan if plan.level_callback is None \
            else plan.with_level_callback(None)
        cached = tuple(verify_plan(base, stats, gdb,
                                   recompile_budget=recompile_budget))
        if key is not None:
            _VERIFY_CACHE[key] = cached
            while len(_VERIFY_CACHE) > _VERIFY_CACHE_CAP:
                _VERIFY_CACHE.popitem(last=False)
    findings = list(cached)
    if plan.level_callback is not None:
        _check_callback(plan, findings)
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise PlanVerificationError(errors)
    return findings
