"""Selinger-style pairwise-join baseline (the "old dog" without new tricks).

Greedy cost-based join ordering over estimated cardinalities + materialized
sort-merge pairwise joins — the strategy of conventional engines (Postgres /
MonetDB in the paper).  On cyclic graph patterns any pairwise plan must
materialize an intermediate that can be ``Ω(√N)``-factor larger than the
output (§1), which is exactly what the cyclic-query benchmarks demonstrate:
this engine hits its intermediate cap (the analogue of the paper's
timeouts, rendered "-" in Tables 6/7) where the WCOJ engines cruise.

Vectorized in numpy; intermediates are dense integer tuple tables.  The
port's copy of ``repro.core.binary_join``: the same join order, the same
``JoinBlowup`` rows at the same cap.
"""
from __future__ import annotations

import numpy as np

from .query import Query
from .relation import Database


class JoinBlowup(RuntimeError):
    """Raised when a materialized intermediate exceeds the cap."""

    def __init__(self, rows: int, cap: int):
        super().__init__(
            f"pairwise-join intermediate blowup: {rows} rows > cap {cap}")
        self.rows = rows
        self.cap = cap


def _exclusive_cumsum(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    np.cumsum(x[:-1], out=out[1:])
    return out


def _group_index(sorted_keys: np.ndarray):
    """(unique_keys, start, count) over a sorted 1-D key array."""
    if sorted_keys.size == 0:
        return sorted_keys[:0], np.zeros(0, np.int64), np.zeros(0, np.int64)
    change = np.empty(sorted_keys.shape[0], dtype=bool)
    change[0] = True
    change[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = np.flatnonzero(change).astype(np.int64)
    count = np.diff(np.append(start, sorted_keys.shape[0])).astype(np.int64)
    return sorted_keys[start], start, count


def _pack_key(data: np.ndarray, cols: list[int]) -> np.ndarray:
    """Pack selected columns into a single int64 key (stride encoding)."""
    if len(cols) == 1:
        return data[:, cols[0]].astype(np.int64)
    maxes = [int(data[:, c].max()) + 1 if data.shape[0] else 1 for c in cols]
    stride = 1
    for m in maxes:
        stride *= m
    if stride >= 2 ** 62:
        raise ValueError("key packing overflow")
    key = np.zeros(data.shape[0], dtype=np.int64)
    for c, m in zip(cols, maxes):
        key = key * m + data[:, c].astype(np.int64)
    return key


class _Intermediate:
    def __init__(self, vars_: tuple[str, ...], data: np.ndarray):
        self.vars = vars_
        self.data = data  # (rows, len(vars)) int64

    def __len__(self):
        return int(self.data.shape[0])


def _merge_join(left: _Intermediate, right: _Intermediate,
                cap: int) -> _Intermediate:
    shared = [v for v in left.vars if v in right.vars]
    lcols = [left.vars.index(v) for v in shared]
    rcols = [right.vars.index(v) for v in shared]
    if not shared:
        rows = len(left) * len(right)
        if rows > cap:
            raise JoinBlowup(rows, cap)
        li = np.repeat(np.arange(len(left)), len(right))
        ri = np.tile(np.arange(len(right)), len(left))
    else:
        # joint packing must use shared maxima so keys are comparable
        both_max = []
        for v in shared:
            lm = int(left.data[:, left.vars.index(v)].max()) if len(left) else 0
            rm = int(right.data[:, right.vars.index(v)].max()) if len(right) else 0
            both_max.append(max(lm, rm) + 1)

        def pack(data, cols):
            key = np.zeros(data.shape[0], dtype=np.int64)
            for c, m in zip(cols, both_max):
                key = key * m + data[:, c].astype(np.int64)
            return key

        lk = pack(left.data, lcols)
        rk = pack(right.data, rcols)
        lo = np.argsort(lk, kind="stable")
        ro = np.argsort(rk, kind="stable")
        lks, rks = lk[lo], rk[ro]
        luk, lstart, lcount = _group_index(lks)
        ruk, rstart, rcount = _group_index(rks)
        common, li_idx, ri_idx = np.intersect1d(
            luk, ruk, assume_unique=True, return_indices=True)
        ca, cb = lcount[li_idx], rcount[ri_idx]
        sizes = ca * cb
        rows = int(sizes.sum())
        if rows > cap:
            raise JoinBlowup(rows, cap)
        key_of_out = np.repeat(np.arange(common.shape[0]), sizes)
        within = (np.arange(rows)
                  - np.repeat(_exclusive_cumsum(sizes), sizes))
        cb_out = cb[key_of_out]
        li = lo[lstart[li_idx][key_of_out] + within // cb_out]
        ri = ro[rstart[ri_idx][key_of_out] + within % cb_out]
    new_vars = left.vars + tuple(v for v in right.vars if v not in left.vars)
    rkeep = [right.vars.index(v) for v in right.vars if v not in left.vars]
    data = np.concatenate(
        [left.data[li], right.data[ri][:, rkeep]], axis=1)
    return _Intermediate(new_vars, data)


def _apply_filters(inter: _Intermediate, query: Query,
                   applied: set) -> _Intermediate:
    for f in query.filters:
        if f in applied:
            continue
        if f.left in inter.vars and f.right in inter.vars:
            li, ri = inter.vars.index(f.left), inter.vars.index(f.right)
            keep = inter.data[:, li] < inter.data[:, ri]
            inter = _Intermediate(inter.vars, inter.data[keep])
            applied.add(f)
    return inter


class BinaryJoin:
    """Greedy Selinger-lite planner + materialized sort-merge execution."""

    def __init__(self, query: Query, db: Database,
                 cap: int = 50_000_000,
                 plan: "JoinPlan | None" = None):
        self.query = query
        self.db = db
        self.cap = cap
        # the pairwise baseline orders joins greedily at runtime; the plan
        # is carried for introspection/uniform dispatch only
        self.join_plan = plan
        # max_intermediate/joins are native; rows_expanded / level_rows
        # source the unified schema (ENGINE_STATS_SOURCE_KEYS): each
        # pairwise join feeds the current intermediate's rows into the
        # merge, and level_rows records the intermediate after each join
        self.stats = {"max_intermediate": 0, "joins": 0,
                      "rows_expanded": 0, "level_rows": {}}

    def _estimate(self, inter_size: int, inter_vars, atom, rel_len: int,
                  distincts) -> float:
        shared = [v for v in atom.vars if v in inter_vars]
        if not shared:
            return float(inter_size) * rel_len
        sel = 1.0
        for v in shared:
            sel /= max(1, distincts.get((atom.rel, v), 1))
        return float(inter_size) * rel_len * sel

    def run(self) -> _Intermediate:
        q, db = self.query, self.db
        # per-(relation, var) distinct counts for the cost model
        distincts: dict[tuple[str, str], int] = {}
        for a in q.atoms:
            rel = db.relations[a.rel]
            for i, v in enumerate(a.vars):
                d = int(np.unique(rel.data[:, i]).shape[0]) if len(rel) else 1
                key = (a.rel, v)
                distincts[key] = max(distincts.get(key, 1), d)

        remaining = list(range(len(q.atoms)))
        # start from the smallest atom (unary samples usually)
        start = min(remaining, key=lambda ai: len(db.relations[q.atoms[ai].rel]))
        a0 = q.atoms[start]
        inter = _Intermediate(a0.vars, db.relations[a0.rel].data.copy())
        remaining.remove(start)
        applied: set = set()
        inter = _apply_filters(inter, q, applied)
        while remaining:
            # prefer connected atoms; greedy min estimated output
            connected = [ai for ai in remaining
                         if any(v in inter.vars for v in q.atoms[ai].vars)]
            pool = connected or remaining
            best = min(pool, key=lambda ai: self._estimate(
                len(inter), inter.vars, q.atoms[ai],
                len(db.relations[q.atoms[ai].rel]), distincts))
            atom = q.atoms[best]
            rel = db.relations[atom.rel]
            right = _Intermediate(atom.vars, rel.data)
            self.stats["rows_expanded"] += len(inter)
            inter = _merge_join(inter, right, self.cap)
            self.stats["joins"] += 1
            self.stats["max_intermediate"] = max(
                self.stats["max_intermediate"], len(inter))
            self.stats["level_rows"][self.stats["joins"]] = len(inter)
            inter = _apply_filters(inter, q, applied)
            remaining.remove(best)
        return inter

    def count(self) -> int:
        return len(self.run())

    def enumerate(self, limit: int | None = None) -> np.ndarray:
        """Output tuples: int64, columns in GAO order
        (``self.output_vars`` — the plan's GAO), rows sorted
        lexicographically; ``limit`` truncates after the ordering (the
        shared engine contract, ``repro_torch.results``)."""
        inter = self.run()
        cols = [inter.vars.index(v) for v in self.output_vars]
        data = inter.data[:, cols].astype(np.int64)
        if data.shape[0] > 1:
            data = data[np.lexsort(data.T[::-1])]
        return data if limit is None else data[:limit]

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate`: the plan's GAO when it
        covers every variable, else the legacy heuristic order."""
        plan = self.join_plan
        if plan is not None and set(plan.gao) == set(self.query.variables):
            return plan.gao
        from .gao import choose_gao
        return choose_gao(self.query)


def binary_join_count(query: Query, db: Database,
                      cap: int = 50_000_000) -> int:
    return BinaryJoin(query, db, cap).count()
