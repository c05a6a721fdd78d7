"""Result representations: flat tuples and factorized (trie) form (the
port's copy of ``repro.results.result_set``, host numpy only).

The paper's pitch is that a WCOJ-powered RDBMS keeps the *relational*
interface — queries return tuples, not just counts.  EmptyHeaded-style
engines go one step further and emit results in compressed/factorized
form: the output of a join along a GAO is naturally a trie (shared
prefixes = union nodes, path concatenation = product nodes), and keeping
it factorized avoids materializing the cross-products the final levels
would otherwise flatten.

Two concrete representations share one small API
(``count`` / ``expand`` / ``project`` / ``nbytes``):

* :class:`ResultSet` — flat ``(n, k)`` int64 rows, columns named by
  ``vars``, rows in lexicographic order.  The canonical exchange format
  every engine's ``enumerate()`` agrees on.
* :class:`FactorizedResult` — one :class:`FLevel` per GAO position: a
  union of values per parent entry (``values[i]`` extends
  ``parent[i]``-th entry of the previous level).  Leaves are output
  tuples, so ``count()`` is O(1); ``expand()`` walks parent chains with
  vectorized gathers and returns the flat rows in lex order; a
  GAO-prefix ``project()`` is a trie truncation (already deduplicated,
  no expansion).  Storage is 2 cells per trie node versus ``k`` cells
  per flat row — the per-level union/product compression.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def lex_sorted(rows: np.ndarray) -> np.ndarray:
    """Rows sorted lexicographically by columns left-to-right."""
    rows = np.asarray(rows)
    if rows.shape[0] <= 1:
        return rows
    return rows[np.lexsort(rows.T[::-1])]


def _dedup_sorted(rows: np.ndarray) -> np.ndarray:
    """Distinct rows of a lex-sorted array."""
    if rows.shape[0] <= 1:
        return rows
    keep = np.empty(rows.shape[0], dtype=bool)
    keep[0] = True
    keep[1:] = (rows[1:] != rows[:-1]).any(axis=1)
    return rows[keep]


@dataclass(frozen=True)
class ResultSet:
    """Flat join output: ``rows`` (n, len(vars)) int64, lex-sorted."""

    vars: tuple[str, ...]
    rows: np.ndarray

    @classmethod
    def from_rows(cls, vars_: tuple[str, ...], rows: np.ndarray,
                  sort: bool = True) -> "ResultSet":
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, len(vars_))
        return cls(tuple(vars_), lex_sorted(rows) if sort else rows)

    def count(self) -> int:
        return int(self.rows.shape[0])

    def __len__(self) -> int:
        return self.count()

    def expand(self) -> np.ndarray:
        """Flat rows (already flat — API parity with FactorizedResult)."""
        return self.rows

    def project(self, vars_: tuple[str, ...]) -> "ResultSet":
        """Distinct sub-tuples over ``vars_`` (lex-sorted)."""
        cols = [self.vars.index(v) for v in vars_]
        return ResultSet(tuple(vars_),
                         _dedup_sorted(lex_sorted(self.rows[:, cols])))

    def reorder(self, vars_: tuple[str, ...]) -> "ResultSet":
        """Same tuples with columns permuted to ``vars_`` and re-sorted."""
        if tuple(vars_) == self.vars:
            return self
        if set(vars_) != set(self.vars):
            raise ValueError(f"cannot reorder {self.vars} to {vars_}")
        cols = [self.vars.index(v) for v in vars_]
        return ResultSet(tuple(vars_), lex_sorted(self.rows[:, cols]))

    @property
    def nbytes(self) -> int:
        return int(self.rows.nbytes)


@dataclass(frozen=True)
class FLevel:
    """One trie level: ``values[i]`` extends entry ``parent[i]`` of the
    previous level (level 0 parents are all zero and unused)."""

    values: np.ndarray  # (n_i,) int64
    parent: np.ndarray  # (n_i,) int64


@dataclass(frozen=True)
class FactorizedResult:
    """Trie-factorized join output along a GAO.

    The EmptyHeaded-style compressed representation: level ``j`` holds
    the distinct bindings of ``vars[j]`` *per parent path*, each entry
    pointing at its parent in level ``j-1`` (:class:`FLevel`).  A
    high-fanout join whose flat output is ``count() × k`` int64 cells
    stores only the union-node arrays — ``nbytes`` vs a flat
    ``ResultSet`` is the compression ratio.

    Attributes:
        vars: column order — always the plan's GAO (trie order *is*
            lex order, so ``expand()`` needs no sort).
        levels: one :class:`FLevel` per variable; ``levels[-1].values``
            has exactly ``count()`` entries (one leaf per tuple).

    Construction: ``results.factorize_vlftj(executor)`` builds the trie
    natively from the penultimate frontier + final-level extension
    segments without materializing the flat cross-product;
    :meth:`from_rows` trie-compresses any engine's flat rows.  The
    planner costs flat-vs-factorized emission and stamps the cheaper
    mode into ``JoinPlan.output_mode``, which ``core.engine.enumerate``
    honours.

    Example::

        fr = engine.enumerate(q, gdb, mode="factorized")
        fr.count()                  # O(1), no expansion
        fr.project(fr.vars[:2])     # GAO-prefix: trie truncation
        rows = fr.expand()          # flat (count, k) lex-ordered rows
    """

    vars: tuple[str, ...]
    levels: tuple[FLevel, ...]

    @classmethod
    def from_rows(cls, vars_: tuple[str, ...], rows: np.ndarray,
                  sort: bool = True) -> "FactorizedResult":
        """Trie-compress flat rows (any engine's output qualifies)."""
        k = len(vars_)
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, k)
        if sort:
            rows = lex_sorted(rows)
        n = rows.shape[0]
        levels: list[FLevel] = []
        change = np.zeros(n, dtype=bool)
        prev_idx = np.zeros(n, dtype=np.int64)
        for j in range(k):
            cj = np.empty(n, dtype=bool)
            if n:
                cj[0] = True
                cj[1:] = rows[1:, j] != rows[:-1, j]
            change = cj if j == 0 else (change | cj)
            sel = np.flatnonzero(change)
            parent = (prev_idx[sel] if j
                      else np.zeros(sel.shape[0], dtype=np.int64))
            levels.append(FLevel(rows[sel, j].copy(), parent))
            prev_idx = np.cumsum(change) - 1
        return cls(tuple(vars_), tuple(levels))

    def count(self) -> int:
        """Output cardinality — one leaf per tuple, so O(1)."""
        return int(self.levels[-1].values.shape[0])

    def __len__(self) -> int:
        return self.count()

    def _chain(self, level: int) -> np.ndarray:
        """Expand levels[0..level] by walking parent chains upward."""
        m = self.levels[level].values.shape[0]
        out = np.empty((m, level + 1), dtype=np.int64)
        idx = np.arange(m)
        for j in range(level, -1, -1):
            lvl = self.levels[j]
            out[:, j] = lvl.values[idx]
            idx = lvl.parent[idx]
        return out

    def expand(self) -> np.ndarray:
        """Flat (count, k) rows in lex order (trie order is lex order)."""
        return self._chain(len(self.levels) - 1)

    def project(self, vars_: tuple[str, ...]) -> ResultSet:
        """Distinct sub-tuples; a GAO-prefix projection is a trie
        truncation — no expansion, already deduplicated."""
        vars_ = tuple(vars_)
        if vars_ == self.vars[: len(vars_)]:
            return ResultSet(vars_, self._chain(len(vars_) - 1))
        cols = [self.vars.index(v) for v in vars_]
        return ResultSet(vars_,
                         _dedup_sorted(lex_sorted(self.expand()[:, cols])))

    @property
    def nbytes(self) -> int:
        return int(sum(lv.values.nbytes + lv.parent.nbytes
                       for lv in self.levels))
