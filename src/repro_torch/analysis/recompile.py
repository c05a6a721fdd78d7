"""Static specialization-census auditor (rule ``V107``).

The port's counterpart of ``repro.analysis.recompile``.  The JAX package
compiles one XLA executable per distinct ``(static args, input shapes)``
cache key; the port has no JIT, but its executor keeps the same shape
discipline, and each distinct (padded row shape × check mode ×
``count_only``) combination is one specialization the executor may
request: one set of kernel launch geometries and, on the card, one set
of allocator block sizes.  An executor whose shape space is unbounded
requests a new geometry per call.  The executors bound their shape
spaces deliberately:

* **interior levels** (``VLFTJ._run``) pad partial chunks to the next
  power of two with a floor of 8, so per check mode the level step sees
  at most ``log2(chunk_rows / 8) + 1`` distinct row counts;
* the **final level** (``VLFTJ._final_level_call``, by ``(frontier
  rows, count_only)``) sees the fixed counting window (``chunk_rows``
  rows), one expansion cap per paging configuration (``ResultCursor``
  pads chunks to ``min(chunk_rows, page_rows)``), and the dense final
  level's single-row probe;
* **spmd** execution pads frontier rows to a multiple of the shard count
  before the pow2 chunking, which adds no post-padding shapes but runs
  each specialization once per device.

This module re-derives that arithmetic from the *plan*, before any
device work: :func:`audit_recompilation` enumerates the distinct
specializations a plan can generate and fails it (finding ``V107``)
when the count is unbounded or exceeds ``budget``.  The numbers are the
JAX package's, key for key, so ``V107`` fires on the same plans in both
packages.  The cross-check of the static total against an observed run
(``check_runtime`` in the JAX package) waits for the port's device
profile (``obs/``).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core.plan import GraphStats, JoinPlan, executor_geometry
from .findings import Finding

#: default cap on statically-enumerated specialization keys per plan.  A
#: 7-level vlftj plan with mixed layouts lands around 4e2 keys; only a
#: pathological geometry (or an unbounded paging dimension) crosses this.
DEFAULT_RECOMPILE_BUDGET = 1024

#: interior-level kernel variants the executor may bucket rows into:
#: tile-probe and bsearch-probe always; +1 bitset-probe when the level's
#: layout is 'bitset' or 'mixed'.
_BASE_MODES = 2


@dataclass(frozen=True)
class RecompileAudit:
    """Statically-enumerated specialization census of one plan.

    ``per_level`` holds ``(label, keys)`` per GAO level (vectorized
    engines only), ``final_level`` the final-level keys,
    ``spmd`` the per-device replication surcharge, ``total`` their sum.
    ``unbounded`` lists reasons the key space has no static bound (any
    entry ⇒ the audit fails regardless of ``budget``).
    """

    engine: str
    per_level: tuple[tuple[str, int], ...]
    final_level: int
    spmd: int
    total: int
    budget: int
    chunk_shapes: int
    unbounded: tuple[str, ...] = ()

    @property
    def within_budget(self) -> bool:
        return not self.unbounded and self.total <= self.budget

    def findings(self, path: str = "plan") -> list[Finding]:
        out = []
        for reason in self.unbounded:
            out.append(Finding(
                rule="V107", severity="error", path=path, line=0,
                message=f"unbounded specialization key space: {reason}",
                hint="bound every shape dimension (pow2 chunk padding, "
                     "fixed paging configs) before execution"))
        if not self.unbounded and self.total > self.budget:
            out.append(Finding(
                rule="V107", severity="error", path=path, line=0,
                message=f"plan can generate {self.total} distinct "
                        f"specialization keys > budget {self.budget}",
                hint="shrink chunk_rows / level count, or raise "
                     "recompile_budget if the cost is intended"))
        return out


def chunk_shape_count(chunk_rows: int) -> int:
    """Distinct post-padding row counts one static-arg combo can see.

    ``VLFTJ._run`` pads a partial chunk of ``r`` rows to
    ``min(chunk_rows, max(8, pow2ceil(r)))`` — the reachable set is
    ``{8, 16, ..., pow2 <= chunk_rows} ∪ {chunk_rows}``.
    """
    if chunk_rows <= 8:
        return 1
    n = (chunk_rows // 8).bit_length()      # pow2 rungs from 8 up
    if chunk_rows & (chunk_rows - 1):       # non-pow2 cap adds itself
        n += 1
    return n


def audit_recompilation(plan: JoinPlan, stats: GraphStats | None = None,
                        *, chunk_rows: int = 8192,
                        elem_budget: int = 1 << 22,
                        n_devices: int = 1,
                        paging_configs: int | None = 2,
                        budget: int = DEFAULT_RECOMPILE_BUDGET
                        ) -> RecompileAudit:
    """Enumerate the distinct specialization keys ``plan`` can hit.

    ``paging_configs`` is the number of distinct ``page_rows`` values the
    caller will stream with (each adds one final-level expansion cap);
    pass ``None`` to declare it caller-controlled per request, which
    makes the key space **unbounded** and fails the audit.
    The count deliberately over-approximates (every modeled key is
    *reachable*, not necessarily reached), so it upper-bounds what a
    run can request.
    """
    unbounded: list[str] = []
    if plan.engine in ("lftj_ref", "minesweeper_ref", "binary"):
        # host-side reference engines: no device specialization at all
        return RecompileAudit(plan.engine, (), 0, 0, 0, budget, 0)

    if stats is not None:
        _, chunk = executor_geometry(stats.max_degree, chunk_rows,
                                     elem_budget)
    else:
        chunk = chunk_rows
    if chunk < 1:
        unbounded.append(f"chunk_rows={chunk} (< 1: no chunking bound)")
        chunk = 1
    shapes = chunk_shape_count(chunk)

    per_level: list[tuple[str, int]] = []
    final = 0
    if plan.engine in ("vlftj", "hybrid"):
        levels = plan.levels
        gao = plan.gao
        if plan.engine == "hybrid" and plan.decomposition is not None:
            # the seeded core LFTJ is the device side of a hybrid plan;
            # the tree half is SpMV-shaped (counted below with
            # yannakakis arithmetic)
            from ..core.plan import compile_levels
            gao = plan.decomposition.core_gao
            try:
                levels = compile_levels(plan.decomposition.core_query, gao)
            except ValueError:
                levels = ()
        layouts = plan.level_layouts or ("array",) * len(gao)
        for i in range(max(0, len(gao) - 1)):
            modes = _BASE_MODES
            if i < len(layouts) and layouts[i] in ("bitset", "mixed"):
                modes += 1
            # static-arg combos (probe modes) x padded row shapes x
            # count_only specialization of the shared expand kernel
            keys = modes * shapes * 2
            label = gao[i] if i < len(gao) else f"level{i}"
            per_level.append((label, keys))
        if gao:
            # final level (VLFTJ._final_level_call): keyed on
            # (frontier rows, count_only).  Rows come from the counting
            # window (chunk), one expansion cap per paging config, and
            # the dense final level's single-row probes.
            if paging_configs is None:
                unbounded.append(
                    "paging_configs=None: every distinct page_rows adds "
                    "a final-level key")
                caps = 0
            else:
                caps = max(0, int(paging_configs))
            final = 2 * (2 + caps)
    if plan.engine in ("yannakakis", "hybrid"):
        # SpMV tree passes: shapes fixed by the graph (n_nodes), one
        # up+down pair per tree edge, bounded by the variable
        # count.  Small constant per level; never near the budget.
        n_vars = len(plan.query.variables)
        per_level.append(("spmv-tree", 2 * max(1, n_vars)))

    per_level_total = sum(k for _, k in per_level)
    spmd = 0
    if n_devices > 1:
        # sharded execution pads rows to a multiple of n_devices *before*
        # pow2 chunking, so it adds no new post-padding shapes — but
        # each device runs its own specialization of every key.
        spmd = (per_level_total + final) * (n_devices - 1)
    total = per_level_total + final + spmd
    return RecompileAudit(plan.engine, tuple(per_level), final, spmd,
                          total, budget, shapes, tuple(unbounded))

