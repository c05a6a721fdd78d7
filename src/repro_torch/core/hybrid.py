"""Hybrid engine (§4.12) in PyTorch — the port of ``repro.core.hybrid``:
message passing on the acyclic part, vectorized LFTJ on the cyclic core
(the paper's lollipop algorithm).

The tree hanging off the core's attachment variable is folded into a
per-node multiplicity vector by counting message passing; the core is
then joined by the VLFTJ seeded with those multiplicities.  The split
itself is a planning decision (``core.planner.decompose_hybrid``).
"""
from __future__ import annotations

import numpy as np

from .device_graph import GraphDB
from .plan import GraphStats, JoinPlan
from .query import Query
from .vlftj import VLFTJ
from .yannakakis import CountingYannakakis


class HybridJoin:
    """Tree counts × seeded core LFTJ (the paper's hybrid algorithm)."""

    def __init__(self, query: Query, gdb: GraphDB,
                 plan: JoinPlan | None = None, **vlftj_kw):
        if plan is None:
            from .planner import plan_query
            plan = plan_query(query, GraphStats.of(gdb), engine="hybrid")
        self.query = query
        self.gdb = gdb
        self.join_plan = plan
        self.vlftj_kw = vlftj_kw
        # the core (or fallback) executor plan, built once so repeated
        # executions of one hybrid plan never re-enter the planner; the
        # hybrid plan's gao IS the core gao, so its per-level layout
        # choices carry over
        d = plan.decomposition
        if d is not None:
            self._core_plan = JoinPlan(query=d.core_query, engine="vlftj",
                                       gao=d.core_gao,
                                       level_layouts=plan.level_layouts)
        elif plan.gao:
            self._core_plan = JoinPlan(query=query, engine="vlftj",
                                       gao=plan.gao,
                                       level_layouts=plan.level_layouts)
        else:
            self._core_plan = None
        # the tree pass's SpMV count plus the core executor's per-level
        # stats, merged after count() runs
        self.stats: dict = {"spmvs": 0, "rows_expanded": 0,
                            "level_rows": {}}

    def _absorb_core_stats(self, engine: VLFTJ) -> None:
        tree_rows = self.stats.get("rows_expanded", 0)
        self.stats.update(engine.stats)
        self.stats["rows_expanded"] = (
            tree_rows + engine.stats.get("rows_expanded", 0))

    def count(self) -> int:
        d = self.join_plan.decomposition
        if d is None:
            engine = VLFTJ(self.query, self.gdb, plan=self._core_plan,
                           **self.vlftj_kw)
            out = engine.count()
            self._absorb_core_stats(engine)
            return out
        # 1) tree part -> multiplicity vector at the attachment variable
        cy = CountingYannakakis(d.tree_query, self.gdb, root=d.attachment)
        msg = cy.message_to_root(d.attachment).cpu().numpy()
        if cy._cross_factor != 1:  # disconnected tree pieces: cross factor
            msg = msg * cy._cross_factor
        self.stats["spmvs"] = cy.stats.get("spmvs", 0)
        self.stats["rows_expanded"] = cy.stats.get("rows_expanded", 0)
        seeds = np.flatnonzero(msg > 0).astype(np.int32)
        if seeds.size == 0:
            return 0
        # 2) core part: GAO = attachment first, then cyclic heuristic
        engine = VLFTJ(d.core_query, self.gdb, plan=self._core_plan,
                       **self.vlftj_kw)
        out = engine.seeded_count(seeds, msg[seeds])
        self._absorb_core_stats(engine)
        return out

    def enumerate(self, limit: int | None = None) -> np.ndarray:
        """Full-binding enumeration: int64 tuples, columns in
        ``self.output_vars`` (core GAO first, then tree variables), rows
        lex-sorted; ``limit`` truncates after the ordering.  The tree
        part is expanded backward behind each core attachment value —
        see ``repro_torch.results.backward.hybrid_rows``."""
        from ..results.backward import hybrid_rows
        rows, _ = hybrid_rows(self)
        if rows.shape[0] > 1:
            rows = rows[np.lexsort(rows.T[::-1])]
        return rows if limit is None else rows[:limit]

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate`."""
        d = self.join_plan.decomposition
        if d is None:
            return (self._core_plan.gao if self._core_plan is not None
                    else tuple(self.query.variables))
        return d.core_gao + tuple(v for v in d.tree_query.variables
                                  if v != d.attachment)


def hybrid_count(query: Query, gdb: GraphDB, **kw) -> int:
    return HybridJoin(query, gdb, **kw).count()
