"""Join-engine API of the port: ``plan → execute``.

``count(query, gdb, engine=...)`` plans the query with the cost-based
planner (``core/planner.py``, the reference's, copied) and dispatches the
plan to a device engine:

  * ``vlftj``      — vectorized worst-case-optimal join
  * ``yannakakis`` — vectorized counting Yannakakis (β-acyclic)
  * ``hybrid``     — tree message passing + seeded core LFTJ
  * ``auto``       — the cheapest estimated plan among those three

Beyond counting, :func:`enumerate` materializes the output tuples (a
flat :class:`~repro_torch.results.ResultSet` or a trie-compressed
:class:`~repro_torch.results.FactorizedResult`) and :func:`stream`
returns a bounded-memory page cursor; both plan with ``output='rows'``.

The host oracles ``lftj_ref``, ``minesweeper_ref`` and ``binary`` are
planned like the reference plans them but not executed yet.  Every
engine runs on ``gdb.device``.

``verify=`` (static plan verification, on by default in the JAX
package) waits for the port of ``analysis/``: ``count``, ``enumerate``
and ``stream`` take ``verify=False`` by default and raise
``NotImplementedError`` for ``verify=True``.
"""
from __future__ import annotations

import numpy as np

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
                  gao: tuple[str, ...] | None, output: str = "count",
                  verify: bool = False) -> JoinPlan:
    """Shared plan resolution for ``count``/``enumerate``/``stream``."""
    if verify:
        raise NotImplementedError(
            "verify=True waits for ROADMAP.md open item 'verify=/analysis/'")
    if plan is None:
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; options: {ENGINES}")
        stats = GraphStats.of(gdb)
        if gao is not None:
            # a pinned GAO bypasses the cache (keys don't carry the GAO)
            return plan_query(query, stats, engine=engine, gao=gao,
                              output=output)
        if cache is not None:
            return cache.get_or_plan(query, stats, engine, output=output)
        return plan_query(query, stats, engine=engine, output=output)
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
          gao: tuple[str, ...] | None = None, verify: bool = False,
          **kw) -> int:
    """Count the query's matches in ``gdb`` (exact, int64 arithmetic).

    Plans with ``engine`` (``plan=`` skips planning, ``cache=`` memoizes
    plans) and runs the plan on ``gdb.device``; ``kw`` goes to the VLFTJ
    executor (``chunk_rows``, ``elem_budget``, ``width``,
    ``check_mode``, ``tile_width``, ...)."""
    plan = _resolve_plan(query, gdb, engine, plan, cache, gao,
                         verify=verify)
    return execute(plan, gdb, **kw)


def _engine_rows(plan: JoinPlan, gdb: GraphDB, limit: int | None = None,
                 **kw) -> tuple[np.ndarray, tuple[str, ...]]:
    """Run a plan's engine enumeration: ``(rows, columns)``.  Every
    engine's ``enumerate(limit=)`` follows one contract (int64, columns =
    its ``output_vars``, lex row order, limit truncates after ordering),
    so the limit pushes down uniformly."""
    eng = make_engine(plan, gdb, **kw)
    return eng.enumerate(limit=limit), eng.output_vars


def enumerate(query: Query, gdb: GraphDB, engine: str = "auto",
              limit: int | None = None,
              order: tuple[str, ...] | None = None,
              plan: JoinPlan | None = None, cache: PlanCache | None = None,
              gao: tuple[str, ...] | None = None,
              mode: str | None = None, verify: bool = False, **kw):
    """Enumerate output tuples through the same planner path as ``count``.

    Returns a :class:`~repro_torch.results.ResultSet` (flat, the default)
    or a :class:`~repro_torch.results.FactorizedResult`
    (``mode='factorized'``, or when the resolved plan's costed
    ``output_mode`` says so).  Columns follow ``order`` (default:
    ``query.variables``, engine-independent, so any two engines agree
    row for row); rows are int64 and lexicographically sorted; ``limit``
    truncates after the ordering.
    """
    from ..results import FactorizedResult, ResultSet
    plan = _resolve_plan(query, gdb, engine, plan, cache, gao,
                         output="rows", verify=verify)
    target = tuple(order) if order is not None else query.variables
    if set(target) != set(query.variables):
        raise ValueError(f"order {target} does not cover the query "
                         f"variables {query.variables}")
    mode = mode or (plan.output_mode if plan.output_mode != "count"
                    else "flat")
    if mode not in ("flat", "factorized"):
        raise ValueError(f"unknown mode {mode!r}; "
                         "options: ('flat', 'factorized')")
    if (mode == "factorized" and plan.engine == "vlftj"
            and target == plan.gao and limit is None):
        # native path: trie-compress the penultimate frontier and keep
        # the final level's extensions as leaf segments, so the flat
        # cross-product is never materialized
        from ..results.factorize import factorize_vlftj
        return factorize_vlftj(VLFTJ(query, gdb, plan=plan, **kw))
    push = limit if target == plan.gao else None
    rows, cols = _engine_rows(plan, gdb, limit=push, **kw)
    if cols != target:
        rows = rows[:, [cols.index(v) for v in target]]
        if rows.shape[0] > 1:
            rows = rows[np.lexsort(rows.T[::-1])]
    if limit is not None:
        rows = rows[:limit]
    if mode == "factorized":
        return FactorizedResult.from_rows(target, rows, sort=False)
    return ResultSet(target, rows)


def stream(query: Query, gdb: GraphDB, engine: str = "auto",
           page_rows: int = 1024, plan: JoinPlan | None = None,
           cache: PlanCache | None = None, verify: bool = False, **kw):
    """A :class:`~repro_torch.results.ResultCursor` over the query's
    output.  Vectorized-LFTJ plans stream with bounded memory (the final
    level is re-entered per frontier chunk, with the executor's check
    mode); other engines materialize once and page the rows.  Columns
    are the cursor's ``vars`` (the executing engine's output order)."""
    from ..results import ResultCursor
    plan = _resolve_plan(query, gdb, engine, plan, cache, None,
                         output="rows", verify=verify)
    if plan.engine == "vlftj":
        return ResultCursor(VLFTJ(query, gdb, plan=plan, **kw),
                            page_rows=page_rows)
    rows, cols = _engine_rows(plan, gdb, **kw)
    return ResultCursor.from_rows(cols, rows, page_rows=page_rows)
