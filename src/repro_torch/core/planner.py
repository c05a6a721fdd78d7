"""Cost-based query planner: ``(Query, GraphStats) -> JoinPlan``.

This is the other half of the plan/execute split (see ``core/plan.py``).
It absorbs the planning logic that used to be fused into the engines'
constructors — ``engine.pick_engine``'s heuristic routing, ``gao.choose_gao``,
``vlftj.compile_plan``, the hybrid tree/core bridge decomposition, and
Yannakakis' tree-shape check — and replaces the first-heuristic-hit GAO
choice with cost-based selection among enumerated candidates:

  * **GAO candidates**: all NEOs for β-acyclic queries (capped), plus
    greedy connected-expansion orders from every start variable, plus the
    legacy heuristic pick — each costed with a System-R-flavoured
    independence model over :class:`GraphStats`.
  * **Engine candidates** (``engine="auto"``): counting Yannakakis when
    the query is a filter-free β-acyclic forest, the hybrid tree/core
    split when the bridge decomposition applies, and vectorized LFTJ
    always; the cheapest estimated plan wins.
  * **Cost annotations**: every plan carries its per-level estimates and
    the AGM bound, so ``bench_planner.py`` can correlate the model's
    ranking against measured runtimes.

Plans are pure functions of ``(query structure, stats fingerprint)``, so
:class:`PlanCache` memoizes them LRU-style; ``serve.QueryServer`` uses it
to serve repeated pattern shapes without re-planning.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import replace
from itertools import permutations

from .agm import fractional_edge_cover
from .gao import _cyclic_heuristic_order, choose_gao
from .hypergraph import Hypergraph, all_neos, is_beta_acyclic
from .plan import (GraphStats, HybridPlan, JoinPlan, compile_levels,
                   executor_geometry)
from .query import Atom, Query

# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def choose_level_layouts(query: Query, gao: tuple[str, ...],
                         stats: GraphStats) -> tuple[str, ...]:
    """Per-GAO-level adjacency representation for the hybrid layout.

    A level benefits from bitsets only where membership *checks* happen:
    it has >= 2 bound edge sources (the probe source pays gathers either
    way — candidate expansion needs the sorted array).  There the check
    against a hub vertex is one word-gather + bit-test instead of
    ``log2(deg)`` binary-search rounds, so with any hubs present the
    bitset path is picked for the hub-tagged rows: ``'bitset'`` when the
    adjacency mass is almost entirely hub-owned (the executor still
    falls back row-wise), ``'mixed'`` otherwise, ``'array'`` when the
    stats carry no layout.  Deterministic in ``(query, gao, stats)`` —
    the same inputs the cost model prices, so plans stay cacheable.
    """
    levels = compile_levels(query, gao)
    out = []
    for lp in levels:
        if stats.n_hubs == 0 or len(lp.edge_sources) < 2:
            out.append("array")
        elif stats.hub_edge_fraction >= 0.95:
            out.append("bitset")
        else:
            out.append("mixed")
    return tuple(out)


def _cost_model(query: Query, gao: tuple[str, ...], stats: GraphStats,
                seed_frontier: float | None = None,
                ) -> tuple[float, tuple[float, ...], tuple[float, ...]]:
    """Shared survivor model: ``(total_cost, level_costs, frontiers)``
    where ``frontiers[i]`` estimates the frontier size *after* level i
    (``frontiers[-1]`` is the estimated output cardinality)."""
    levels = compile_levels(query, gao)
    layouts = choose_level_layouts(query, gao, stats)
    n = max(1, stats.n_nodes)
    logd = math.log2(max(2, stats.max_degree))
    # the executor's padding defaults (shared with VLFTJ.__init__)
    width, chunk_rows = executor_geometry(stats.max_degree)
    frontier = 1.0
    costs: list[float] = []
    frontiers: list[float] = []
    for i, lp in enumerate(levels):
        sel_unary = 1.0
        for u in lp.unary:
            sel_unary *= stats.unary_selectivity(u)
        if i == 0:
            frontier = n * sel_unary if seed_frontier is None \
                else seed_frontier
            costs.append(float(n))          # bitmap-filtered domain scan
            frontiers.append(frontier)
            continue
        # per-row survivor rate: the one survivor model, shared with the
        # dist layer's re-balance pricing (estimate_extension_degree)
        survive = estimate_extension_degree(lp, stats)
        if lp.edge_sources:
            extra_checks = max(0, len(lp.edge_sources) - 1)
            # per-check gather rounds: binary search pays ~log2(d); a
            # hub-tagged check source pays one bitset word-gather.  The
            # hub fraction of adjacency mass approximates how often a
            # bound frontier vertex is a hub.
            check_rounds = logd
            if layouts[i] in ("bitset", "mixed"):
                hf = stats.hub_edge_fraction
                check_rounds = hf * 1.0 + (1.0 - hf) * logd
            padded = math.ceil(frontier / chunk_rows) * chunk_rows * width
            work = padded * (1.0 + extra_checks * check_rounds)
        else:
            # no bound edge neighbor: host cross product with the domain
            work = frontier * n * sel_unary
        costs.append(max(work, 1.0))
        frontier = max(frontier * survive, 1e-6)
        frontiers.append(frontier)
    return sum(costs), tuple(costs), tuple(frontiers)


def estimate_vlftj_cost(query: Query, gao: tuple[str, ...],
                        stats: GraphStats,
                        seed_frontier: float | None = None,
                        ) -> tuple[float, tuple[float, ...]]:
    """Estimated work (VPU lanes touched) of a vectorized-LFTJ run.

    The executor pads every frontier chunk to ``chunk_rows`` rows of
    ``width`` candidate lanes (``width`` = pow2ceil(max degree)), so a
    level's cost is the *padded* element count — lanes execute whether
    or not they hold live candidates — times one log-degree membership
    check per extra bound edge source.  Survivor counts use the
    independence model: ``d/n`` per membership check, ``|u|/n`` per
    unary predicate, ``1/2`` per inequality filter.
    """
    total, costs, _ = _cost_model(query, gao, stats, seed_frontier)
    return total, costs


def estimate_emission(query: Query, gao: tuple[str, ...],
                      stats: GraphStats) -> tuple[float, float]:
    """Estimated materialization cells for ``(flat, factorized)`` output.

    Flat emission stores ``est_out × k`` int64 cells; the trie-factorized
    form stores two cells (value, parent) per trie node, and the per-level
    node counts are exactly the frontier estimates the survivor model
    already tracks.  The planner records the cheaper mode in
    ``JoinPlan.output_mode`` for enumeration plans."""
    _, _, frontiers = _cost_model(query, gao, stats)
    out = frontiers[-1]
    flat = out * len(gao)
    fact = 2.0 * sum(frontiers)
    return flat, fact


def estimate_extension_degree(lp, stats: GraphStats) -> float:
    """Expected per-row extension fanout of one GAO level.

    The survivor model's per-level multiplier, factored out for the
    distributed layer: a frontier shard's cost is (rows × this), and
    ``repro.dist.rebalance`` compares shards on exactly that product when
    deciding whether a mid-join re-deal is worth a shuffle.  Rows whose
    probe vertex is known use the true adjacency length instead
    (``rebalance.row_extension_costs``); this estimate is the fallback
    when only :class:`GraphStats` is available."""
    n = max(1, stats.n_nodes)
    d = max(1.0, stats.avg_degree)
    sel_unary = 1.0
    for u in lp.unary:
        sel_unary *= stats.unary_selectivity(u)
    sel_ineq = 0.5 ** (len(lp.lower) + len(lp.upper))
    if lp.edge_sources:
        extra = max(0, len(lp.edge_sources) - 1)
        return max(d * ((d / n) ** extra) * sel_unary * sel_ineq, 1e-6)
    return max(n * sel_unary * sel_ineq, 1e-6)


def estimate_yannakakis_cost(query: Query, stats: GraphStats) -> float:
    """One SpMV per distinct variable-graph edge + one mask per unary."""
    var_edges = {frozenset(a.vars) for a in query.atoms
                 if a.arity == 2 and a.vars[0] != a.vars[1]}
    n_unary = sum(1 for a in query.atoms if a.arity == 1)
    return (len(var_edges) * max(1, stats.n_edges)
            + n_unary * max(1, stats.n_nodes))


# ---------------------------------------------------------------------------
# hybrid tree/core decomposition (absorbed from hybrid.HybridDecomposition)
# ---------------------------------------------------------------------------

def _var_edges(query: Query) -> list[tuple[str, str]]:
    out = []
    seen = set()
    for a in query.atoms:
        if a.arity == 2 and a.vars[0] != a.vars[1]:
            key = frozenset(a.vars)
            if key not in seen:
                seen.add(key)
                out.append((a.vars[0], a.vars[1]))
    return out


def _bridges(vertices, edges) -> set[frozenset]:
    """Bridges via DFS low-link (tiny graphs)."""
    adj: dict[str, list[str]] = {v: [] for v in vertices}
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    disc: dict[str, int] = {}
    low: dict[str, int] = {}
    bridges: set[frozenset] = set()
    timer = [0]

    def dfs(u: str, parent: str | None):
        disc[u] = low[u] = timer[0]
        timer[0] += 1
        skipped_parent_edge = False
        for w in adj[u]:
            if w == parent and not skipped_parent_edge:
                skipped_parent_edge = True
                continue
            if w in disc:
                low[u] = min(low[u], disc[w])
            else:
                dfs(w, u)
                low[u] = min(low[u], low[w])
                if low[w] > disc[u]:
                    bridges.add(frozenset((u, w)))

    for v in vertices:
        if v not in disc:
            dfs(v, None)
    return bridges


def decompose_hybrid(query: Query) -> HybridPlan | None:
    """Tree/core split for §4.12 lollipop-shaped queries, or None.

    Supported shape: one cyclic core, trees hanging off a single
    attachment variable, filters confined to one side, no filters in the
    tree part (counting message passing cannot apply ``<``).
    """
    edges = _var_edges(query)
    if not edges:
        return None
    bridges = _bridges(query.variables, edges)
    core_edges = [e for e in edges if frozenset(e) not in bridges]
    if not core_edges or len(core_edges) == len(edges):
        return None  # fully acyclic or fully cyclic: no hybrid split
    core_vars = sorted({v for e in core_edges for v in e})
    # attachment vars: core vars incident to a bridge
    attach = sorted({v for e in bridges for v in e if v in core_vars})
    if len(attach) != 1:
        return None
    attachment = attach[0]
    core_set = set(core_vars)
    tree_vars = [v for v in query.variables
                 if v not in core_set or v == attachment]
    tree_set = set(tree_vars)
    # filters must stay within one side
    for f in query.filters:
        inside_core = f.left in core_set and f.right in core_set
        inside_tree = f.left in tree_set and f.right in tree_set
        if not (inside_core or inside_tree):
            return None
    tree_atoms: list[Atom] = []
    core_atoms: list[Atom] = []
    for a in query.atoms:
        if a.arity == 1:
            (tree_atoms if a.vars[0] in tree_set else core_atoms).append(a)
        elif frozenset(a.vars) in bridges:
            tree_atoms.append(a)
        else:
            core_atoms.append(a)
    tree_filters = [f for f in query.filters
                    if f.left in tree_set and f.right in tree_set]
    core_filters = [f for f in query.filters
                    if f.left in core_set and f.right in core_set]
    if tree_filters:
        return None  # counting message passing cannot apply < filters
    tree_query = Query(tuple(tree_atoms), (), f"{query.name}-tree")
    core_query = Query(tuple(core_atoms), tuple(core_filters),
                       f"{query.name}-core")
    rest = _cyclic_heuristic_order(core_query)
    core_gao = (attachment,) + tuple(v for v in rest if v != attachment)
    return HybridPlan(tree_query, core_query, attachment, core_gao)


# ---------------------------------------------------------------------------
# GAO candidate enumeration
# ---------------------------------------------------------------------------

_EXHAUSTIVE_VARS = 5     # full permutation search up to this many variables
_NEO_CAP = 64            # NEO candidates considered for β-acyclic queries


def candidate_gaos(query: Query, limit: int = 160) -> list[tuple[str, ...]]:
    """Candidate GAOs: NEOs (acyclic), exhaustive permutations (tiny),
    greedy connected expansions from every start, legacy heuristic pick."""
    hg = Hypergraph.of(query)
    cands: "OrderedDict[tuple[str, ...], None]" = OrderedDict()
    cands[choose_gao(query)] = None          # legacy pick always considered
    if is_beta_acyclic(hg):
        for neo in all_neos(hg, limit=_NEO_CAP):
            cands[neo] = None
    if query.num_vars <= _EXHAUSTIVE_VARS:
        for perm in permutations(query.variables):
            cands[perm] = None
    else:
        # greedy connected expansion from each start variable
        adj = {v: set() for v in query.variables}
        for a in query.atoms:
            if a.arity == 2:
                u, w = a.vars
                if u != w:
                    adj[u].add(w)
                    adj[w].add(u)
        degree = {v: sum(v in a.vars for a in query.atoms)
                  for v in query.variables}
        for start in query.variables:
            order = [start]
            remaining = set(query.variables) - {start}
            while remaining:
                bound = set(order)
                nxt = max(sorted(remaining),
                          key=lambda v: (len(adj[v] & bound), degree[v]))
                order.append(nxt)
                remaining.remove(nxt)
            cands[tuple(order)] = None
    return list(cands)[:limit]


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

def _safe_estimate(query: Query, gao: tuple[str, ...], stats: GraphStats
                   ) -> tuple[float, tuple[float, ...], tuple[float, ...]]:
    """Cost estimate ``(total, level_costs, level_frontiers)``,
    tolerating non-graph atoms the model cannot price."""
    try:
        return _cost_model(query, gao, stats)
    except ValueError:
        return math.inf, (), ()


def _agm_log2(query: Query, stats: GraphStats) -> float | None:
    try:
        _, log2_bound = fractional_edge_cover(
            query, stats.relation_sizes(query))
        return log2_bound
    except Exception:  # pragma: no cover - LP failure is environmental
        return None


def _plan_vlftj(query: Query, stats: GraphStats,
                gao: tuple[str, ...] | None = None,
                engine: str = "vlftj") -> JoinPlan:
    # the AGM LP is an annotation, not a decision input — skip it when the
    # caller pins the GAO (plan-free engine wrappers on hot paths)
    agm = None
    if gao is None:
        best, best_cost = choose_gao(query), math.inf
        best_levels, best_fronts = (), ()
        for cand in candidate_gaos(query):
            cost, levels, fronts = _safe_estimate(query, cand, stats)
            if cost < best_cost:
                best, best_cost = cand, cost
                best_levels, best_fronts = levels, fronts
        gao, est_cost = best, best_cost
        level_costs, level_fronts = best_levels, best_fronts
        agm = _agm_log2(query, stats)
    else:
        gao = tuple(gao)
        est_cost, level_costs, level_fronts = _safe_estimate(
            query, gao, stats)
    try:
        layouts = choose_level_layouts(query, gao, stats)
    except ValueError:
        layouts = ()        # non-graph atoms: executor stays array-only
    return JoinPlan(query=query, engine=engine, gao=gao,
                    est_cost=est_cost, level_costs=level_costs,
                    level_est_rows=level_fronts,
                    agm_log2=agm, level_layouts=layouts,
                    stats_fingerprint=stats.fingerprint())


def _plan_yannakakis(query: Query, stats: GraphStats,
                     root: str | None = None) -> JoinPlan | None:
    if query.filters or not is_beta_acyclic(Hypergraph.of(query)):
        return None
    # forest check (variable_tree raises NotTreeShaped on cyclic shapes)
    from .yannakakis import NotTreeShaped, variable_tree
    try:
        variable_tree(query)
    except NotTreeShaped:
        return None
    return JoinPlan(query=query, engine="yannakakis",
                    gao=choose_gao(query),
                    root=root or query.variables[0],
                    est_cost=estimate_yannakakis_cost(query, stats),
                    agm_log2=_agm_log2(query, stats),
                    stats_fingerprint=stats.fingerprint())


def _plan_hybrid(query: Query, stats: GraphStats) -> JoinPlan | None:
    hp = decompose_hybrid(query)
    if hp is None:
        return None
    tree_cost = estimate_yannakakis_cost(hp.tree_query, stats)
    # seeded core: the tree pass leaves ≈ sel-filtered attachment values
    seed = max(1.0, stats.n_nodes * 0.5)
    core_cost, level_costs, level_fronts = _cost_model(
        hp.core_query, hp.core_gao, stats, seed_frontier=seed)
    return JoinPlan(query=query, engine="hybrid", gao=hp.core_gao,
                    decomposition=hp,
                    est_cost=tree_cost + core_cost,
                    level_costs=level_costs,
                    level_est_rows=level_fronts,
                    agm_log2=_agm_log2(query, stats),
                    level_layouts=choose_level_layouts(
                        hp.core_query, hp.core_gao, stats),
                    stats_fingerprint=stats.fingerprint())


def candidate_plans(query: Query, stats: GraphStats) -> list[JoinPlan]:
    """All auto-routable plans for a query, unsorted."""
    out: list[JoinPlan] = []
    yp = _plan_yannakakis(query, stats)
    if yp is not None:
        out.append(yp)
    hp = _plan_hybrid(query, stats)
    if hp is not None:
        out.append(hp)
    out.append(_plan_vlftj(query, stats))
    return out


def _with_output_mode(plan: JoinPlan, stats: GraphStats,
                      output: str) -> JoinPlan:
    """Stamp the emission mode onto an enumeration plan.

    ``output='rows'`` costs flat-vs-factorized emission when the plan's
    GAO covers every variable (the trie form needs a total column
    order); the message-passing engines always emit flat."""
    if output == "count":
        return plan
    mode = "flat"
    if plan.engine not in ("yannakakis", "hybrid") \
            and set(plan.gao) == set(plan.query.variables):
        try:
            flat, fact = estimate_emission(plan.query, plan.gao, stats)
            if fact < flat:
                mode = "factorized"
        except ValueError:
            pass  # non-graph atoms: the model cannot price emission
    return replace(plan, output_mode=mode)


def plan_query(query: Query, stats: GraphStats, engine: str = "auto",
               gao: tuple[str, ...] | None = None,
               output: str = "count") -> JoinPlan:
    """Build the physical plan for ``query`` against ``stats``.

    ``engine="auto"`` picks the cheapest of the candidate plans;
    an explicit engine name forces that physical operator (the reference
    engines — ``lftj_ref``, ``minesweeper_ref``, ``binary`` — are only
    reachable this way).  ``output='rows'`` builds an enumeration plan:
    the result carries ``output_mode`` ('flat' or 'factorized', costed
    by :func:`estimate_emission`) instead of the default 'count'.
    """
    if output not in ("count", "rows"):
        raise ValueError(f"unknown output {output!r}; "
                         "options: ('count', 'rows')")
    if output == "rows":
        plan = plan_query(query, stats, engine=engine, gao=gao)
        return _with_output_mode(plan, stats, output)
    if engine in ("auto", "yannakakis") and gao is not None:
        # neither auto routing nor message passing honors a pinned
        # attribute order — reject rather than silently ignore it
        raise ValueError(
            f"gao= is not supported with engine={engine!r}; pin a "
            "GAO-driven engine (vlftj/lftj_ref/minesweeper_ref/binary)")
    if engine == "auto":
        return min(candidate_plans(query, stats),
                   key=lambda p: p.est_cost)
    if engine == "vlftj":
        return _plan_vlftj(query, stats, gao=gao)
    if engine == "yannakakis":
        p = _plan_yannakakis(query, stats)
        if p is None:
            from .yannakakis import NotTreeShaped
            raise NotTreeShaped(
                f"{query.name}: not a filter-free β-acyclic forest")
        return p
    if engine == "hybrid":
        p = _plan_hybrid(query, stats)
        if p is not None:
            if gao is not None:
                raise ValueError("gao= is not supported when the hybrid "
                                 "decomposition applies (the core GAO is "
                                 "attachment-pinned)")
            return p
        # unsupported shape: hybrid degrades to plain vectorized LFTJ
        return _plan_vlftj(query, stats, gao=gao, engine="hybrid")
    if engine in ("lftj_ref", "binary"):
        return _plan_vlftj(query, stats, gao=gao, engine=engine)
    if engine == "minesweeper_ref":
        # Minesweeper's GAO must be a NEO when one exists (Prop. 4.2)
        ms_gao = tuple(gao) if gao is not None else choose_gao(query)
        est, levels, fronts = _safe_estimate(query, ms_gao, stats)
        return JoinPlan(query=query, engine="minesweeper_ref", gao=ms_gao,
                        est_cost=est, level_costs=levels,
                        level_est_rows=fronts,
                        agm_log2=None if gao is not None
                        else _agm_log2(query, stats),
                        stats_fingerprint=stats.fingerprint())
    raise ValueError(f"unknown engine {engine!r}")


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

class PlanCache:
    """LRU cache of :class:`JoinPlan`, keyed by query *structure*
    (atoms + filters, display name ignored), requested engine, the
    requested output ('count' vs 'rows' — enumeration plans carry an
    emission mode), and the graph-stats fingerprint — so a stats change
    invalidates entries."""

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._entries: "OrderedDict[tuple, JoinPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(query: Query, stats: GraphStats, engine: str = "auto",
            output: str = "count") -> tuple:
        return (query.atoms, query.filters, engine, output,
                stats.fingerprint())

    def get(self, query: Query, stats: GraphStats,
            engine: str = "auto", output: str = "count") -> JoinPlan | None:
        k = self.key(query, stats, engine, output)
        plan = self._entries.get(k)
        if plan is not None:
            self.hits += 1
            self._entries.move_to_end(k)
        return plan

    def get_or_plan(self, query: Query, stats: GraphStats,
                    engine: str = "auto",
                    output: str = "count") -> JoinPlan:
        plan = self.get(query, stats, engine, output)
        if plan is None:
            self.misses += 1
            plan = plan_query(query, stats, engine=engine, output=output)
            self._entries[self.key(query, stats, engine, output)] = plan
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return plan

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0
