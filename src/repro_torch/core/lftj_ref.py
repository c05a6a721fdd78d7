"""Faithful LeapFrog TrieJoin (Algorithm 1 + [Veldhuizen'14] iterators).

This is the paper-faithful reference: variables are bound one at a time in
GAO order; at each level the participating relations' candidate value lists
are intersected by *leapfrogging* — round-robin ``seek_lub`` jumps that skip
large swaths of tuples that cannot produce output.  Runtime is
``Õ(N + AGM(Q))`` [Veldhuizen'14].

Scalar and host-only: this is the correctness oracle and the baseline the
vectorized engine (``core/vlftj.py``) is validated against.  The port's
copy of ``repro.core.lftj_ref``: the same leapfrog, the same ``stats``.
"""
from __future__ import annotations

import numpy as np

from .gao import choose_gao
from .plan import JoinPlan
from .query import Query
from .relation import Database, Relation, POS_INF


class _TrieIter:
    """Leapfrog trie iterator over one GAO-consistent sorted-array index."""

    def __init__(self, rel: Relation):
        self.rel = rel
        # stack of [lo, hi) ranges; level = len(stack) - 1 is current column
        self.ranges: list[tuple[int, int]] = [rel.root_range()]

    @property
    def level(self) -> int:
        return len(self.ranges) - 1

    def open_(self, value: int) -> bool:
        lo, hi = self.ranges[-1]
        lo2, hi2 = self.rel.child_range(lo, hi, self.level, value)
        if lo2 >= hi2:
            return False
        self.ranges.append((lo2, hi2))
        return True

    def up(self) -> None:
        self.ranges.pop()

    def seek_lub(self, value: int) -> int:
        """Smallest indexed value >= ``value`` at the current level
        (``POS_INF`` if exhausted)."""
        lo, hi = self.ranges[-1]
        pos = self.rel.seek_lub(lo, hi, self.level, value)
        if pos >= hi:
            return POS_INF
        return int(self.rel.data[pos, self.level])


class LFTJ:
    """Paper-faithful LeapFrog TrieJoin over a :class:`Database`."""

    def __init__(self, query: Query, db: Database,
                 gao: tuple[str, ...] | None = None,
                 plan: JoinPlan | None = None):
        self.query = query
        self.db = db
        self.join_plan = plan
        if gao is None:
            gao = plan.gao if plan is not None else choose_gao(query)
        self.gao = tuple(gao)
        self.var_pos = {v: i for i, v in enumerate(self.gao)}
        # GAO-consistent index per atom: columns sorted by GAO position.
        self.atom_perm = []
        self.atom_gao_levels = []  # GAO position of each index column
        for a in query.atoms:
            perm = tuple(sorted(range(a.arity),
                                key=lambda i: self.var_pos[a.vars[i]]))
            self.atom_perm.append(perm)
            self.atom_gao_levels.append(
                tuple(self.var_pos[a.vars[i]] for i in perm))
        # For each GAO level: (atom_idx, column_level_within_atom)
        self.level_atoms: list[list[tuple[int, int]]] = [
            [] for _ in self.gao]
        for ai, levels in enumerate(self.atom_gao_levels):
            for col, gpos in enumerate(levels):
                self.level_atoms[gpos].append((ai, col))
        # Inequality filters indexed by the *later* GAO variable.
        self.lower_of: list[list[int]] = [[] for _ in self.gao]  # v > t[j]
        self.upper_of: list[list[int]] = [[] for _ in self.gao]  # v < t[j]
        for f in query.filters:
            li, ri = self.var_pos[f.left], self.var_pos[f.right]
            if li < ri:
                self.lower_of[ri].append(li)   # right var bound later
            else:
                self.upper_of[li].append(ri)   # left var bound later
        # unified stats namespace (docs/OBSERVABILITY.md): seeks counts
        # leapfrog seek_lub rounds, rows_expanded the bindings descended
        # into, level_rows the per-GAO-level binding tallies (the "obs"
        # side of Q-error) — plain host integer adds in the recursion.
        self.stats = {"seeks": 0, "rows_expanded": 0,
                      "level_rows": {}}

    # ------------------------------------------------------------------
    def run(self, emit=None) -> int:
        """Count all output tuples; call ``emit(tuple)`` per result if given."""
        iters = [_TrieIter(self.db.indexed(a.rel, self.atom_perm[ai]))
                 for ai, a in enumerate(self.query.atoms)]
        binding = [0] * len(self.gao)
        return self._join(0, iters, binding, emit)

    def _join(self, level: int, iters, binding, emit) -> int:
        if level == len(self.gao):
            if emit is not None:
                emit(tuple(binding))
            return 1
        parts = self.level_atoms[level]
        lv_rows = self.stats["level_rows"]
        lower = 0
        for j in self.lower_of[level]:
            lower = max(lower, binding[j] + 1)
        upper = POS_INF
        for j in self.upper_of[level]:
            upper = min(upper, binding[j])
        count = 0
        # Leapfrog: round-robin seek_lub until all participating iterators
        # agree on a value (the multiway intersection).
        value = lower
        while True:
            agreed = True
            for ai, _col in parts:
                self.stats["seeks"] += 1
                nxt = iters[ai].seek_lub(value)
                if nxt != value:
                    value = nxt
                    agreed = False
                    break
            if value >= upper or value >= POS_INF:
                break
            if not agreed:
                continue
            # all agree on `value`: descend
            opened = []
            ok = True
            for ai, _col in parts:
                if iters[ai].open_(value):
                    opened.append(ai)
                else:  # pragma: no cover - agreed value always opens
                    ok = False
                    break
            if ok:
                binding[level] = value
                self.stats["rows_expanded"] += 1
                lv_rows[level] = lv_rows.get(level, 0) + 1
                count += self._join(level + 1, iters, binding, emit)
            for ai in opened:
                iters[ai].up()
            value += 1
        return count

    def count(self) -> int:
        return self.run()

    def enumerate(self, limit: int | None = None) -> np.ndarray:
        """Output tuples: int64, columns in GAO order
        (``self.output_vars``), rows in lexicographic order.

        ``limit`` truncates *after* the deterministic ordering — the
        shared engine contract (``repro_torch.results``).  The leapfrog visits
        each level's values ascending, so emission order *is* the
        lexicographic order and early termination at ``limit`` rows
        coincides with post-sort truncation (tested in
        ``tests/test_enumerate.py``); it also matches
        ``ResultCursor.take(limit)`` over the vectorized engine."""
        if limit is not None and limit <= 0:
            return np.zeros((0, len(self.gao)), dtype=np.int64)
        out: list[tuple[int, ...]] = []

        def emit(t):
            out.append(t)
            if limit is not None and len(out) >= limit:
                raise _Done

        try:
            self.run(emit)
        except _Done:
            pass
        arr = np.array(out, dtype=np.int64)
        return arr.reshape(-1, len(self.gao))

    @property
    def output_vars(self) -> tuple[str, ...]:
        """Column order of :meth:`enumerate` (the GAO)."""
        return self.gao


class _Done(Exception):
    pass


def lftj_count(query: Query, db: Database,
               gao: tuple[str, ...] | None = None) -> int:
    return LFTJ(query, db, gao).count()
