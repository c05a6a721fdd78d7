"""EXPLAIN ANALYZE: run a plan, render est-vs-observed per GAO level (a
copy of ``repro.obs.explain`` over the port's engines).

``explain_analyze(query, gdb)`` plans the query (or takes a prebuilt
plan), executes it under a fresh :class:`~repro_torch.obs.trace.QueryTrace`,
and returns an :class:`ExplainResult` whose :meth:`~ExplainResult.render`
prints the plan tree with each level annotated by the planner's
estimated frontier cardinality, the observed one, and their Q-error —
the feedback channel the ROADMAP's adaptive re-planning item consumes::

    3-clique -> vlftj  count=1612  wall=0.12s
    L0 a  est=1000      obs=1000      q=1.00
    L1 b  est=12000     obs=11402     q=1.05   [bsearch=11402]
    L2 c  est=1430      obs=1612      q=1.13   [tile=9000, bsearch=2402]
    max q-error 1.13

All numbers come from the engine's host-side ``stats`` dict and the
plan's cost annotations — EXPLAIN ANALYZE costs one normal execution,
no extra device work.  The plan runs where ``gdb`` lives.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..core.engine import execute_stats
from ..core.plan import GraphStats, JoinPlan
from ..core.planner import plan_query
from ..core.query import Query
from .trace import QueryTrace


@dataclass
class ExplainResult:
    """The outcome of one ``explain_analyze`` run.

    ``verification`` carries the static plan verifier's findings
    (:class:`repro_torch.analysis.Finding`) — EXPLAIN ANALYZE *surfaces* them
    (including errors, rendered under the plan tree) rather than
    raising, so a rejected plan can still be inspected.
    """

    plan: JoinPlan
    count: int
    trace: QueryTrace
    engine_stats: dict = field(default_factory=dict)
    verification: list = field(default_factory=list)

    @property
    def levels(self) -> list[dict]:
        """Per-level records (GAO order): ``level``, ``var``,
        ``est_rows``, ``obs_rows``, ``q_error``, ``kernel``, …"""
        return [self.trace.levels[lv] for lv in sorted(self.trace.levels)]

    @property
    def max_q_error(self) -> float:
        return self.trace.max_q_error

    @staticmethod
    def _fmt(x) -> str:
        if x is None:
            return "?"
        x = float(x)
        if x == int(x) and abs(x) < 1e15:
            return str(int(x))
        return f"{x:.3g}"

    def render(self) -> str:
        """The annotated plan tree as printable text."""
        lines = [f"{self.plan.describe()}  count={self.count}  "
                 f"wall={self.trace.summary.get('wall_s', 0.0):.3f}s"]
        for rec in self.levels:
            lv = rec["level"]
            var = rec.get("var") or "?"
            q = rec.get("q_error")
            qs = ("q=inf" if q is not None and math.isinf(q)
                  else f"q={q:.2f}" if q is not None else "q=?")
            line = (f"  L{lv} {var:<3} est={self._fmt(rec.get('est_rows')):<10}"
                    f" obs={self._fmt(rec.get('obs_rows')):<10} {qs}")
            kern = rec.get("kernel")
            if kern:
                inner = ", ".join(f"{k}={v}" for k, v in sorted(kern.items()))
                line += f"   [{inner}]"
            lines.append(line)
        mq = self.max_q_error
        lines.append("  max q-error " +
                     ("inf" if math.isinf(mq) else f"{mq:.2f}"))
        for f in self.verification:
            lines.append(f"  verify: {f.severity} [{f.rule}] {f.message}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()


def explain_analyze(query: Query, gdb, engine: str = "auto",
                    plan: JoinPlan | None = None, **kw) -> ExplainResult:
    """Plan (unless ``plan`` is given), execute under a fresh trace, and
    return the annotated :class:`ExplainResult`.  ``engine`` and extra
    keyword arguments pass through to planning/execution exactly as in
    :func:`repro_torch.core.engine.count`."""
    if plan is None:
        plan = plan_query(query, GraphStats.of(gdb), engine=engine)
    # surface static verification through the result instead of raising:
    # EXPLAIN exists to inspect plans, including ones the executor would
    # reject (engine.count's verify=True path raises on the same errors)
    from ..analysis import PlanVerificationError, verify_for_execution
    try:
        findings = verify_for_execution(plan, gdb)
    except PlanVerificationError as e:
        findings = e.findings
    trace = QueryTrace(query.name, plan.gao, plan.engine)
    with trace.activate():
        count, stats = execute_stats(plan, gdb, **kw)
    return ExplainResult(plan=plan, count=count, trace=trace,
                         engine_stats=stats, verification=list(findings))
