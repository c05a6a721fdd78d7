"""Physical query-plan IR: the frozen, hashable contract between planner
and engines.

The paper's thesis is that one relational engine covers graph workloads;
EmptyHeaded-style systems push that further by *compiling* a logical plan
once and executing it many times.  This module is the plan half of that
split: a :class:`JoinPlan` captures every decision the engines used to
re-derive at construction time — engine choice, global attribute order
(GAO), per-level constraint sets, hybrid tree/core decomposition,
Yannakakis root — plus cost annotations (AGM bound, per-level estimates)
so plans can be ranked, cached, and shipped to executors.

Everything here is a frozen dataclass built from tuples, so plans are
hashable and usable directly as cache keys.  ``core.planner`` builds
plans; the engines in ``core.*`` execute them.  The port's copy of
``repro.core.plan``, so both packages plan identically.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field

from .query import Query


def pow2ceil(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def executor_geometry(max_degree: int, chunk_rows: int = 8192,
                      elem_budget: int = 1 << 22,
                      width: int | None = None) -> tuple[int, int]:
    """(width, chunk_rows) padding geometry of the vectorized executor.

    Single source of truth shared by ``VLFTJ.__init__`` and the planner's
    cost model — a level's true work is the padded element count, so the
    two must price the same geometry.
    """
    width = width or max(8, pow2ceil(max_degree))
    chunk = max(64, min(chunk_rows, pow2ceil(elem_budget // width)))
    return width, chunk


@dataclass(frozen=True)
class LevelPlan:
    """Static per-level constraint sets (indices into frontier columns).

    One entry per GAO level; consumed by the vectorized LFTJ kernels (the
    fields are the static arguments of ``vlftj._expand_level``).
    """

    var: str
    edge_sources: tuple[int, ...]   # frontier cols adjacent via edge atoms
    unary: tuple[str, ...]          # unary relation names constraining var
    lower: tuple[int, ...]          # filters: cand > frontier[:, j]
    upper: tuple[int, ...]          # filters: cand < frontier[:, j]
    needs_degree: bool              # var also appears with later-bound vars


def compile_levels(query: Query, gao: tuple[str, ...]
                   ) -> tuple[LevelPlan, ...]:
    """Compile a query + GAO into per-level constraint sets."""
    pos = {v: i for i, v in enumerate(gao)}
    plans = []
    for level, var in enumerate(gao):
        edge_sources: list[int] = []
        unary: list[str] = []
        needs_degree = False
        for a in query.atoms:
            if var not in a.vars:
                continue
            if a.arity == 1:
                unary.append(a.rel)
            elif a.arity == 2:
                other = a.vars[0] if a.vars[1] == var else a.vars[1]
                if other == var:
                    continue  # self-loop atom edge(v,v); not benchmarked
                if pos[other] < level:
                    edge_sources.append(pos[other])
                else:
                    needs_degree = True
            else:
                raise ValueError("vectorized engine supports graph queries "
                                 "(unary/binary atoms) only")
        lower = [pos[f.left] for f in query.filters
                 if f.right == var and pos[f.left] < level]
        upper = [pos[f.right] for f in query.filters
                 if f.left == var and pos[f.right] < level]
        plans.append(LevelPlan(var, tuple(sorted(set(edge_sources))),
                               tuple(unary), tuple(lower), tuple(upper),
                               needs_degree))
    return tuple(plans)


@dataclass(frozen=True)
class HybridPlan:
    """Tree/core split for the hybrid engine (§4.12 lollipop algorithm)."""

    tree_query: Query
    core_query: Query
    attachment: str
    core_gao: tuple[str, ...]


@dataclass(frozen=True)
class GraphStats:
    """Summary statistics of a :class:`GraphDB` used for cost estimation.

    The planner only ever sees these — never the data — so a plan is a
    pure function of ``(query, stats)`` and can be cached across requests
    that share a stats fingerprint.
    """

    n_nodes: int
    n_edges: int
    max_degree: int
    avg_degree: float
    unary_sizes: tuple[tuple[str, int], ...]  # sorted (name, |set|)
    # hybrid-layout summary (zero on array-only GraphDBs): hub count,
    # degree threshold, fraction of directed edges incident to a hub
    # source (the probability a frontier's bound vertex is bitset-tagged),
    # and the bitset row width in uint32 words
    n_hubs: int = 0
    hub_degree_threshold: int = 0
    hub_edge_fraction: float = 0.0
    bitset_words: int = 0

    @classmethod
    def of(cls, gdb) -> "GraphStats":
        csr = gdb.csr
        n = max(1, csr.n_nodes)
        n_edges = int(csr.indices.shape[0])
        layout = getattr(gdb, "layout", None)
        n_hubs = int(layout.n_hubs) if layout is not None else 0
        hub_frac = 0.0
        if n_hubs:
            hub_frac = float(csr.degrees[:n_hubs].sum()) / max(1, n_edges)
        return cls(
            n_nodes=csr.n_nodes,
            n_edges=n_edges,
            max_degree=int(csr.max_degree),
            avg_degree=n_edges / n,
            unary_sizes=tuple(sorted(
                (name, int(len(ids))) for name, ids in gdb.unary.items())),
            n_hubs=n_hubs,
            hub_degree_threshold=(int(layout.min_degree)
                                  if n_hubs else 0),
            hub_edge_fraction=round(hub_frac, 6),
            bitset_words=int(layout.n_words) if n_hubs else 0,
        )

    def unary_selectivity(self, name: str) -> float:
        """|unary set| / n_nodes, defaulting to 1.0 for unknown names."""
        n = max(1, self.n_nodes)
        for u, size in self.unary_sizes:
            if u == name:
                return min(1.0, size / n)
        return 1.0

    def relation_sizes(self, query: Query) -> dict[str, int]:
        """Relation-name -> cardinality map for the AGM bound."""
        sizes: dict[str, int] = {}
        for name, size in self.unary_sizes:
            sizes[name] = size
        for a in query.atoms:
            if a.rel not in sizes:
                sizes[a.rel] = self.n_edges if a.arity == 2 else self.n_nodes
        return sizes

    def fingerprint(self) -> str:
        """Stable short digest — the plan-cache invalidation token.

        Includes the layout summary, so the same graph with and without
        a hybrid bitset layout plans (and caches) separately."""
        payload = repr((self.n_nodes, self.n_edges, self.max_degree,
                        round(self.avg_degree, 6), self.unary_sizes,
                        self.n_hubs, self.hub_degree_threshold,
                        round(self.hub_edge_fraction, 6),
                        self.bitset_words))
        return hashlib.sha1(payload.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class JoinPlan:
    """A complete physical plan: what to run, in what order, at what cost.

    ``engine`` is the physical operator ('vlftj', 'yannakakis', 'hybrid',
    'lftj_ref', 'minesweeper_ref', 'binary'); ``gao`` the global attribute
    order; ``levels`` the compiled per-level constraints (vectorized-LFTJ
    family); ``decomposition`` the hybrid tree/core split; ``root`` the
    Yannakakis message-passing root.  ``est_cost`` / ``level_costs`` are
    the planner's estimates and ``agm_log2`` the log2 AGM bound — the
    annotations ``benchmarks/bench_planner.py`` correlates against actual
    runtimes.  ``stats_fingerprint`` records the GraphStats the plan was
    costed against.

    ``output_mode`` is what the plan *emits*: ``'count'`` (the default —
    Idea-8 tallies, nothing materialized), ``'flat'`` (int64 tuples) or
    ``'factorized'`` (a trie-compressed
    :class:`~repro.results.FactorizedResult`).  For enumeration plans the
    planner costs flat-vs-factorized emission
    (``planner.estimate_emission``) and records the cheaper mode here.

    ``level_callback`` is the adaptive-execution hook — the *level
    boundary protocol*:

    * the executing engine calls ``callback(level, frontier, mult)`` at
      every interior GAO level boundary, i.e. after level ``level``'s
      frontier is built and before level ``level + 1`` runs.  ``frontier``
      is the ``(rows, level + 1)`` int32 array of partial bindings and
      ``mult`` the ``(rows,)`` int64 multiplicities;
    * the callback may return ``None`` (continue unchanged) or a
      replacement ``(frontier, mult)`` pair — e.g. a row permutation
      that re-deals skewed frontiers across shards
      (``repro.dist.rebalance.FrontierRebalancer``);
    * the callback may also *raise* to suspend execution: the serving
      layer's quantum budget
      (:class:`repro.serve.scheduler.QuantumBudget`) raises
      :class:`~repro.serve.scheduler.Preempted` carrying a
      :class:`~repro.serve.scheduler.PlanSnapshot` of exactly the
      ``(frontier, mult, next level)`` state, which
      ``VLFTJ._run(start_level=)`` / :meth:`VLFTJ.advance` can resume
      loss-free (row-for-row parity with uninterrupted execution).

    The field is excluded from equality/hashing — a plan with a callback
    attached still hits the same
    :class:`~repro.core.planner.PlanCache` entry.  Attach one with
    :meth:`with_level_callback`.
    """

    query: Query
    engine: str
    gao: tuple[str, ...]
    levels: tuple[LevelPlan, ...] = ()
    decomposition: HybridPlan | None = None
    root: str | None = None
    est_cost: float = 0.0
    level_costs: tuple[float, ...] = ()
    #: planner-estimated frontier cardinality after each GAO level binds
    #: (one entry per level; empty when the engine has no level model).
    #: The "est" side of per-level Q-error in ``repro.obs.explain``.
    level_est_rows: tuple[float, ...] = ()
    agm_log2: float | None = None
    stats_fingerprint: str = ""
    output_mode: str = "count"
    #: per-GAO-level adjacency representation chosen by the planner
    #: ('array' | 'bitset' | 'mixed'), one entry per level; empty means
    #: array-only.  'bitset' = nearly all membership checks expected on
    #: hub (bitset-tagged) vertices, 'mixed' = the executor buckets rows
    #: by the tags at runtime.  A tuple of strings, so plans stay
    #: frozen/hashable.
    level_layouts: tuple[str, ...] = ()
    level_callback: object = field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.engine in ("vlftj", "lftj_ref") and not self.levels \
                and self.gao:
            try:
                object.__setattr__(
                    self, "levels", compile_levels(self.query, self.gao))
            except ValueError:
                pass  # non-graph atoms: the executing engine decides

    def with_level_callback(self, callback) -> "JoinPlan":
        """A copy of this plan with ``level_callback`` replaced.

        Because the callback is excluded from equality/hashing, the copy
        keys the same :class:`~repro.core.planner.PlanCache` entry as the
        original — cached plans can be instrumented per-request (budget
        accounting, rebalancing) without cache misses.
        """
        import dataclasses
        return dataclasses.replace(self, level_callback=callback)

    @property
    def agm_bound(self) -> float:
        if self.agm_log2 is None:
            return math.inf
        return 2.0 ** self.agm_log2

    def describe(self) -> str:
        """One-line human-readable summary (for logs / benchmarks)."""
        parts = [f"{self.query.name} -> {self.engine}",
                 f"gao={''.join(self.gao)}"]
        if self.decomposition is not None:
            parts.append(f"core={''.join(self.decomposition.core_gao)}"
                         f"@{self.decomposition.attachment}")
        if self.root is not None:
            parts.append(f"root={self.root}")
        if self.output_mode != "count":
            parts.append(f"out={self.output_mode}")
        if any(m != "array" for m in self.level_layouts):
            parts.append("layout=" + ",".join(
                m[0] for m in self.level_layouts))
        parts.append(f"cost~2^{math.log2(max(self.est_cost, 1.0)):.1f}")
        return " ".join(parts)
