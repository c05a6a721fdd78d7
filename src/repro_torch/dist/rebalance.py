"""Mid-join frontier re-balancing — handling the skew that static deals miss
(the port of ``repro.dist.rebalance``: host numpy over the port's
``VLFTJ._run``, whose level steps run where the graph lives).

The static first-level deal
(:func:`repro_torch.core.plan.partition_first_level`) balances *seed*
cost, but worst-case-optimal joins meet their skew later:
a power-law hub discovered at level 2 multiplies every frontier row that
reaches it, and whichever shard owns those rows becomes the makespan
(Skew Strikes Back, Ngo/Ré/Rudra 2013 — worst-case optimality is won or
lost exactly here).  This module makes the deal *adaptive*:

* :func:`row_extension_costs` prices each frontier row for the next GAO
  level — the true min-degree probe adjacency length when node degrees
  are at hand, else the :class:`~repro_torch.core.plan.GraphStats`
  expectation (``planner.estimate_extension_degree``);
* :func:`rebalance_rows` re-deals rows across shards with the same
  boustrophedon deal the first-level partitioner uses
  (:func:`~repro_torch.core.plan.stripe_partition`), but keyed on
  *next-level* cost instead of seed degree;
* :class:`FrontierRebalancer` packages that as a
  ``JoinPlan.level_callback``: at each level boundary it measures
  per-shard cost over the contiguous row blocks an SPMD row-sharding
  assigns to ranks, and past ``threshold`` (max/mean shard cost)
  reorders the frontier so the blocks balance;
* :class:`AdaptiveJoin` is the host-level, level-synchronous driver:
  every shard advances one GAO level per round behind a barrier, and at
  each boundary skewed frontiers are re-dealt before the next round —
  ``stats`` reports the static-vs-adaptive makespan the benchmark and
  the Zipf tests compare.
"""
from __future__ import annotations

import time

import numpy as np

from ..core.device_graph import GraphDB
from ..core.plan import (GraphStats, JoinPlan, LevelPlan,
                         partition_first_level, stripe_partition)
from ..core.planner import estimate_extension_degree
from ..core.query import Query
from ..core.vlftj import VLFTJ


def row_extension_costs(frontier: np.ndarray, lp: LevelPlan,
                        degrees: np.ndarray | None = None,
                        stats: GraphStats | None = None,
                        lane_cost: float = 0.0) -> np.ndarray:
    """Per-row cost of expanding ``frontier`` through level ``lp``.

    The vectorized kernel probes the *minimum-degree* bound neighbor, so
    a row's data-dependent work is that adjacency length — its expansion
    fanout (+1 for the fixed per-row work).  ``lane_cost`` adds the
    executor's *padded* per-row constant: the vectorized engine charges
    every frontier row a full ``width``-lane candidate tile whether or
    not the lanes hold live candidates, so a shard's wall-clock level
    cost is ``rows × (width + fanout)``, not ``rows × fanout`` —
    re-balancing with the executor's own width makes the re-deal track
    what the hardware actually bills.  Without degrees, falls back to
    the GraphStats expectation; without either, rows are uniform.
    """
    n = frontier.shape[0]
    if lp is None or not lp.edge_sources:
        if lp is not None and stats is not None:
            return np.full(n, lane_cost + estimate_extension_degree(
                lp, stats))
        return np.full(n, lane_cost + 1.0)
    if degrees is not None:
        deg = np.asarray(degrees)[frontier[:, list(lp.edge_sources)]]
        return lane_cost + 1.0 + deg.min(axis=1).astype(np.float64)
    if stats is not None:
        return np.full(n, lane_cost + estimate_extension_degree(lp, stats))
    return np.full(n, lane_cost + 1.0)


def cost_skew(costs) -> float:
    """max/mean shard-cost ratio — 1.0 is perfect balance."""
    costs = np.asarray(costs, dtype=np.float64)
    if costs.size == 0:
        return 1.0
    mean = costs.mean()
    if mean <= 0:
        return 1.0
    return float(costs.max() / mean)


def rebalance_rows(row_costs: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Snake-deal row indices into ``n_shards`` cost-balanced groups.

    Same deal as the static first-level partitioner — sorted by cost
    descending, dealt boustrophedon — applied to *frontier rows* instead
    of seed values, so it can run again at any level boundary."""
    return stripe_partition(row_costs, n_shards)


class FrontierRebalancer:
    """``JoinPlan.level_callback`` that re-deals skewed SPMD frontiers.

    An SPMD row-sharding (``dist.spmd_join_step``) assigns contiguous
    equal row blocks to ranks; this callback measures each block's
    next-level cost at every level boundary and, past ``threshold``
    (max/mean), returns the frontier permuted by the snake deal so the
    blocks balance.  A pure permutation — no rows added or dropped — so
    it is safe under counting *and* enumeration.  ``events`` records
    ``(level, skew_before, skew_after, rows)`` per triggered re-deal.
    """

    def __init__(self, plan: JoinPlan, n_shards: int,
                 degrees: np.ndarray | None = None,
                 stats: GraphStats | None = None,
                 threshold: float = 1.5, lane_cost: float = 0.0):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.plan = plan
        self.n_shards = n_shards
        self.degrees = None if degrees is None else np.asarray(degrees)
        self.stats = stats
        self.threshold = threshold
        self.lane_cost = lane_cost
        self.events: list[dict] = []

    def _block_costs(self, row_costs: np.ndarray) -> np.ndarray:
        blocks = np.array_split(row_costs, self.n_shards)
        return np.array([b.sum() for b in blocks])

    def __call__(self, level: int, frontier: np.ndarray,
                 mult: np.ndarray):
        nxt = level + 1
        if nxt >= len(self.plan.levels) or frontier.shape[0] < self.n_shards:
            return None
        costs = row_extension_costs(frontier, self.plan.levels[nxt],
                                    self.degrees, self.stats,
                                    lane_cost=self.lane_cost)
        before = cost_skew(self._block_costs(costs))
        if before <= self.threshold:
            return None
        order = np.concatenate(rebalance_rows(costs, self.n_shards))
        after = cost_skew(self._block_costs(costs[order]))
        self.events.append({"level": level, "skew_before": before,
                            "skew_after": after,
                            "rows": int(frontier.shape[0])})
        return frontier[order], mult[order]


class AdaptiveJoin:
    """Level-synchronous sharded WCOJ with mid-join frontier re-deals.

    ``n_shards`` frontiers advance one GAO level per round behind a
    barrier (the schedule a bulk-synchronous worker fleet runs); between
    rounds, per-shard cost of the *next* level is measured and, past
    ``threshold`` skew, all frontier rows are re-dealt with the snake
    deal.  ``rebalance=False`` freezes the static first-level deal — the
    baseline the Zipf benchmark compares against.

    ``stats`` after :meth:`count`:

    * ``shards`` / ``levels`` — geometry;
    * ``shard_time`` — per-shard summed level seconds;
    * ``makespan`` — sum over levels of the slowest shard's level time
      (the barrier wall-clock a real fleet would see);
    * ``total_time`` — summed shard time (single-worker equivalent);
    * ``cost_makespan`` / ``cost_total`` — same two aggregates in the
      deterministic cost-model units (rows × estimated extension
      degree), immune to timer noise — the quantity the tests assert on,
      and equal to the JAX package's (the width is the executor's own);
    * ``rebalances`` — one event per triggered re-deal
      (level, skew before/after, rows moved).
    """

    def __init__(self, query: Query, gdb: GraphDB, n_shards: int = 4,
                 threshold: float = 1.5, rebalance: bool = True,
                 plan: JoinPlan | None = None, **vlftj_kw):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.executor = VLFTJ(query, gdb, plan=plan, **vlftj_kw)
        self.query = query
        self.gdb = gdb
        self.n_shards = n_shards
        self.threshold = threshold
        self.rebalance = rebalance
        seeds = self.executor._domain_values(self.executor.plan[0])
        self.parts = [p.astype(np.int32) for p in partition_first_level(
            self.executor.join_plan, seeds, gdb.csr.degrees, n_shards)]
        self.stats: dict = {"shards": n_shards,
                            "levels": len(self.executor.plan) - 1,
                            "rebalance": rebalance,
                            "threshold": threshold}

    def count(self) -> int:
        ex = self.executor
        k = len(ex.plan)
        degrees = self.gdb.csr.degrees
        lane = float(ex.width)     # the padded per-row lane constant
        frontiers = [p[:, None] for p in self.parts]
        shard_time = np.zeros(self.n_shards)
        makespan = total_time = 0.0
        cost_makespan = cost_total = 0.0
        events: list[dict] = []
        total = 0
        if k == 1:
            total = sum(int(f.shape[0]) for f in frontiers)
        for level in range(1, k):
            lp = ex.plan[level]
            last = level == k - 1
            costs = np.array(
                [row_extension_costs(f, lp, degrees, lane_cost=lane).sum()
                 for f in frontiers])
            cost_makespan += float(costs.max(initial=0.0))
            cost_total += float(costs.sum())
            level_t = np.zeros(self.n_shards)
            for s, f in enumerate(frontiers):
                if f.shape[0] == 0:
                    # keep emptied shards at the current level's width so
                    # later-level cost pricing never indexes a column the
                    # (empty) frontier doesn't have
                    if not last:
                        frontiers[s] = np.zeros((0, level + 1), np.int32)
                    continue
                t0 = time.perf_counter()
                if last:
                    total += int(ex._run(count_only=True, frontier=f,
                                         start_level=level, max_levels=k))
                else:
                    frontiers[s] = np.asarray(
                        ex._run(count_only=False, frontier=f,
                                start_level=level, max_levels=level + 1),
                        dtype=np.int32)
                level_t[s] = time.perf_counter() - t0
            shard_time += level_t
            makespan += float(level_t.max(initial=0.0))
            total_time += float(level_t.sum())
            if last or not self.rebalance:
                continue
            # level boundary: price the NEXT level per shard; re-deal on
            # skew (the static deal can never fix this — its seeds are
            # long since expanded away)
            nxt = ex.plan[level + 1]
            next_costs = [row_extension_costs(f, nxt, degrees,
                                              lane_cost=lane)
                          for f in frontiers]
            before = cost_skew([c.sum() for c in next_costs])
            if before <= self.threshold:
                continue
            all_rows = np.concatenate(
                [f for f in frontiers if f.shape[0]], axis=0)
            all_costs = np.concatenate(
                [c for c in next_costs if c.shape[0]])
            deal = rebalance_rows(all_costs, self.n_shards)
            frontiers = [all_rows[idx] for idx in deal]
            after = cost_skew([all_costs[idx].sum() for idx in deal])
            events.append({"level": level, "skew_before": before,
                           "skew_after": after,
                           "rows": int(all_rows.shape[0])})
        self.stats.update({
            "shard_time": shard_time.tolist(),
            "makespan": makespan,
            "total_time": total_time,
            "cost_makespan": cost_makespan,
            "cost_total": cost_total,
            "rebalances": events,
            "count": int(total),
        })
        return int(total)


def adaptive_count(query: Query, gdb: GraphDB, n_shards: int = 4,
                   **kw) -> int:
    return AdaptiveJoin(query, gdb, n_shards=n_shards, **kw).count()
