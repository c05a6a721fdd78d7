"""Join-engine API of the port: ``plan → execute``.

``count(query, gdb, engine=...)`` plans the query with the cost-based
planner (``core/planner.py``, the reference's, copied) and dispatches the
plan to a device engine:

  * ``vlftj``      — vectorized worst-case-optimal join
  * ``yannakakis`` — vectorized counting Yannakakis (β-acyclic)
  * ``hybrid``     — tree message passing + seeded core LFTJ
  * ``auto``       — the cheapest estimated plan among those three

The host oracles ``lftj_ref``, ``minesweeper_ref`` and ``binary`` are
planned like the reference plans them but not executed yet.  Every
engine runs on ``gdb.device``.
"""
from __future__ import annotations

from .device_graph import GraphDB
from .hybrid import HybridJoin
from .hypergraph import Hypergraph, is_beta_acyclic
from .plan import GraphStats, JoinPlan
from .planner import PlanCache, decompose_hybrid, plan_query
from .query import Query
from .vlftj import VLFTJ
from .yannakakis import CountingYannakakis

ENGINES = ("lftj_ref", "minesweeper_ref", "binary", "vlftj", "yannakakis",
           "hybrid", "auto")
_HOST_ORACLES = ("lftj_ref", "minesweeper_ref", "binary")


def pick_engine(query: Query, stats: GraphStats | None = None) -> str:
    """Engine routing.  With ``stats`` the choice is cost-based (cheapest
    candidate plan); without, the paper's structural summary heuristic."""
    if stats is not None:
        return plan_query(query, stats, engine="auto").engine
    if is_beta_acyclic(Hypergraph.of(query)) and not query.filters:
        return "yannakakis"
    if decompose_hybrid(query) is not None:
        return "hybrid"
    return "vlftj"


def make_engine(plan: JoinPlan, gdb: GraphDB, **kw):
    """Construct a plan's physical operator instance; every instance
    carries a ``stats`` dict."""
    engine = plan.engine
    query = plan.query
    if engine == "vlftj":
        return VLFTJ(query, gdb, plan=plan, **kw)
    if engine == "yannakakis":
        return CountingYannakakis(query, gdb, plan=plan)
    if engine == "hybrid":
        return HybridJoin(query, gdb, plan=plan, **kw)
    if engine in _HOST_ORACLES:
        raise NotImplementedError(
            f"engine {engine!r} waits for ROADMAP.md open item 'host "
            "oracles and relation.py'")
    raise ValueError(f"unknown engine {engine!r}; options: {ENGINES}")


def execute(plan: JoinPlan, gdb: GraphDB, **kw) -> int:
    """Run a compiled plan against a graph and return the count."""
    return make_engine(plan, gdb, **kw).count()


def execute_stats(plan: JoinPlan, gdb: GraphDB, **kw) -> tuple[int, dict]:
    """Run a plan and return ``(count, engine stats)``; the stats dict is
    the engine's own (``level_rows``, ``bitset_rows``, ...)."""
    eng = make_engine(plan, gdb, **kw)
    return eng.count(), eng.stats


def _resolve_plan(query: Query, gdb: GraphDB, engine: str,
                  plan: JoinPlan | None, cache: PlanCache | None,
                  gao: tuple[str, ...] | None) -> JoinPlan:
    if plan is None:
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; options: {ENGINES}")
        stats = GraphStats.of(gdb)
        if gao is not None:
            # a pinned GAO bypasses the cache (keys don't carry the GAO)
            return plan_query(query, stats, engine=engine, gao=gao)
        if cache is not None:
            return cache.get_or_plan(query, stats, engine)
        return plan_query(query, stats, engine=engine)
    if (plan.query.atoms, plan.query.filters) != (query.atoms,
                                                  query.filters):
        raise ValueError(f"plan was built for {plan.query.name!r}, "
                         f"not {query.name!r}")
    if engine != "auto" and plan.engine != engine:
        raise ValueError(f"plan uses engine {plan.engine!r} but "
                         f"engine={engine!r} was requested")
    if gao is not None and tuple(gao) != plan.gao:
        raise ValueError("both plan= and a conflicting gao= given")
    return plan


def count(query: Query, gdb: GraphDB, engine: str = "auto",
          plan: JoinPlan | None = None, cache: PlanCache | None = None,
          gao: tuple[str, ...] | None = None, **kw) -> int:
    """Count the query's matches in ``gdb`` (exact, int64 arithmetic).

    Plans with ``engine`` (``plan=`` skips planning, ``cache=`` memoizes
    plans) and runs the plan on ``gdb.device``; ``kw`` goes to the VLFTJ
    executor (``chunk_rows``, ``elem_budget``, ``width``, ...)."""
    plan = _resolve_plan(query, gdb, engine, plan, cache, gao)
    return execute(plan, gdb, **kw)
