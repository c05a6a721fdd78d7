"""Join-engine API of the port: ``plan → execute``.

``count(query, gdb, engine=...)`` plans the query with the cost-based
planner (``core/planner.py``, the reference's, copied) and dispatches the
plan to its physical operator:

  * ``lftj_ref``        — faithful scalar LeapFrog TrieJoin (host oracle)
  * ``minesweeper_ref`` — faithful Minesweeper with its CDS (host oracle)
  * ``binary``          — Selinger-style pairwise baseline (host numpy)
  * ``vlftj``           — vectorized worst-case-optimal join
  * ``yannakakis``      — vectorized counting Yannakakis (β-acyclic)
  * ``hybrid``          — tree message passing + seeded core LFTJ
  * ``auto``            — the cheapest estimated plan among the candidates

Beyond counting, :func:`enumerate` materializes the output tuples (a
flat :class:`~repro_torch.results.ResultSet` or a trie-compressed
:class:`~repro_torch.results.FactorizedResult`) and :func:`stream`
returns a bounded-memory page cursor; both plan with ``output='rows'``.

The three device engines run on ``gdb.device``; the host oracles run on
``gdb.to_database()``, built from the host CSR, so a db on the card
copies nothing back for them.

Every ``count``, ``enumerate`` and ``stream`` verifies its resolved plan
first (``verify=True``, as in the JAX package): static verification
(:func:`repro_torch.analysis.verify_for_execution`) reads the plan and
host-side statistics only, launches no kernel, and raises
:class:`repro_torch.analysis.PlanVerificationError` on an error-severity
finding.  ``verify=False`` skips it.
"""
from __future__ import annotations

import numpy as np

from .binary_join import BinaryJoin
from .device_graph import GraphDB
from .hybrid import HybridJoin
from .hypergraph import Hypergraph, is_beta_acyclic
from .lftj_ref import LFTJ
from .minesweeper_ref import Minesweeper
from .plan import GraphStats, JoinPlan
from .planner import PlanCache, decompose_hybrid, plan_query
from .query import Query
from .vlftj import VLFTJ
from .yannakakis import CountingYannakakis

ENGINES = ("lftj_ref", "minesweeper_ref", "binary", "vlftj", "yannakakis",
           "hybrid", "auto")


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
    if engine == "lftj_ref":
        return LFTJ(query, gdb.to_database(), plan=plan)
    if engine == "minesweeper_ref":
        return Minesweeper(query, gdb.to_database(), plan=plan, **kw)
    if engine == "binary":
        return BinaryJoin(query, gdb.to_database(), plan=plan, **kw)
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
                  verify: bool = True) -> JoinPlan:
    """Shared plan resolution for ``count``/``enumerate``/``stream``.

    With ``verify`` (the default) the resolved plan — planner-produced
    or caller-supplied — passes static verification
    (:func:`repro_torch.analysis.verify_for_execution`) before any
    device dispatch; error-severity findings raise
    :class:`repro_torch.analysis.PlanVerificationError`.  Verification is
    memoized on ``(plan, stats fingerprint)``, so a repeated plan costs a
    dict lookup.
    """
    if plan is None:
        if engine not in ENGINES:
            raise ValueError(
                f"unknown engine {engine!r}; options: {ENGINES}")
        stats = GraphStats.of(gdb)
        if gao is not None:
            # a pinned GAO bypasses the cache (keys don't carry the GAO)
            plan = plan_query(query, stats, engine=engine, gao=gao,
                              output=output)
        elif cache is not None:
            plan = cache.get_or_plan(query, stats, engine, output=output)
        else:
            plan = plan_query(query, stats, engine=engine, output=output)
    else:
        if (plan.query.atoms, plan.query.filters) != (query.atoms,
                                                      query.filters):
            raise ValueError(
                f"plan was built for {plan.query.name!r}, "
                f"not {query.name!r}")
        if engine != "auto" and plan.engine != engine:
            raise ValueError(f"plan uses engine {plan.engine!r} but "
                             f"engine={engine!r} was requested")
        if gao is not None and tuple(gao) != plan.gao:
            raise ValueError("both plan= and a conflicting gao= given")
    if verify:
        from ..analysis import verify_for_execution
        verify_for_execution(plan, gdb)
    return plan


def count(query: Query, gdb: GraphDB, engine: str = "auto",
          plan: JoinPlan | None = None, cache: PlanCache | None = None,
          gao: tuple[str, ...] | None = None, verify: bool = True,
          **kw) -> int:
    """Count the query's matches in ``gdb`` (exact, int64 arithmetic).

    Plans with ``engine`` (``plan=`` skips planning, ``cache=`` memoizes
    plans), verifies the plan unless ``verify=False``, and runs it;
    ``kw`` goes to the executor (for VLFTJ ``chunk_rows``,
    ``elem_budget``, ``width``, ``check_mode``, ``tile_width``, ...; for
    ``binary`` ``cap``; for ``minesweeper_ref`` its idea flags)."""
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
              mode: str | None = None, verify: bool = True, **kw):
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
           cache: PlanCache | None = None, verify: bool = True, **kw):
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
