"""Sorted-array trie relations — the index layout of the host oracles.

The port's copy of ``repro.core.relation`` (numpy only; the port imports
nothing of ``repro``).

The paper assumes every relation is indexed by a search tree consistent with
the GAO (§4.1).  A pointer-based trie/B-tree does not map onto a vector
device, so the index here is an *immutable sorted tuple table*: rows sorted
lexicographically in a given attribute order.  Level-``k`` trie nodes are
contiguous row ranges; ``seek``/``seek_lub``/``seek_glb`` are binary
searches (``np.searchsorted``) restricted to the parent range.  Reordering
an index for a different GAO is a sort — the analogue of the paper's
requirement that each relation have a GAO-consistent index.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _lex_sort_rows(data: np.ndarray) -> np.ndarray:
    if data.size == 0:
        return data
    order = np.lexsort(tuple(data[:, c] for c in range(data.shape[1] - 1, -1, -1)))
    return data[order]


class Relation:
    """An immutable relation of int64 tuples, sorted lexicographically."""

    def __init__(self, data: np.ndarray, name: str = "R"):
        data = np.asarray(data, dtype=np.int64)
        if data.ndim == 1:
            data = data[:, None]
        data = _lex_sort_rows(data)
        if data.shape[0]:
            keep = np.ones(data.shape[0], dtype=bool)
            keep[1:] = np.any(data[1:] != data[:-1], axis=1)
            data = data[keep]
        self.data = data
        self.name = name

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   symmetrize: bool = True, drop_loops: bool = True,
                   name: str = "edge") -> "Relation":
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if drop_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        return cls(np.stack([src, dst], axis=1), name)

    @classmethod
    def from_set(cls, values, name: str = "V") -> "Relation":
        return cls(np.asarray(sorted(set(np.asarray(values).tolist()))), name)

    # -- basics --------------------------------------------------------------
    @property
    def arity(self) -> int:
        return self.data.shape[1]

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def reorder(self, perm: tuple[int, ...], name: str | None = None
                ) -> "Relation":
        """Index under a different attribute order (a re-sort)."""
        return Relation(self.data[:, list(perm)], name or self.name)

    # -- trie navigation (range = [lo, hi) of rows, level = column) ----------
    def root_range(self) -> tuple[int, int]:
        return 0, len(self)

    def child_range(self, lo: int, hi: int, level: int, value: int
                    ) -> tuple[int, int]:
        """Rows in [lo,hi) whose column ``level`` equals ``value``."""
        col = self.data[lo:hi, level]
        l = int(np.searchsorted(col, value, side="left"))
        r = int(np.searchsorted(col, value, side="right"))
        return lo + l, lo + r

    def seek_lub(self, lo: int, hi: int, level: int, value: int) -> int:
        """Least row index in [lo,hi) with column ``level`` >= value
        (= the paper's ``seek_lub``); returns ``hi`` if none."""
        col = self.data[lo:hi, level]
        return lo + int(np.searchsorted(col, value, side="left"))

    def gap_around(self, lo: int, hi: int, level: int, value: int
                   ) -> tuple[int, int]:
        """Open interval (l, r) of column-``level`` values within [lo,hi)
        containing ``value`` but no indexed value — Minesweeper's maximal
        per-attribute gap (Idea 3).  Uses -inf/+inf sentinels as the paper
        does; here ``-2**62`` / ``2**62``."""
        col = self.data[lo:hi, level]
        i = int(np.searchsorted(col, value, side="left"))
        j = int(np.searchsorted(col, value, side="right"))
        if i != j:  # value present -> no gap at this level
            return (value, value)
        left = int(col[i - 1]) if i > 0 else NEG_INF
        right = int(col[i]) if i < col.shape[0] else POS_INF
        return (left, right)

    def contains(self, tup) -> bool:
        lo, hi = 0, len(self)
        for level, v in enumerate(tup):
            lo, hi = self.child_range(lo, hi, level, int(v))
            if lo >= hi:
                return False
        return True

    def distinct(self, lo: int, hi: int, level: int) -> np.ndarray:
        """Distinct values of column ``level`` within [lo, hi)."""
        return np.unique(self.data[lo:hi, level])


NEG_INF = -(2 ** 62)
POS_INF = 2 ** 62


@dataclass
class Database:
    """Named relations + per-(relation, attribute-order) index cache."""

    relations: dict[str, Relation]

    def __post_init__(self):
        self._index_cache: dict[tuple[str, tuple[int, ...]], Relation] = {}

    def sizes(self) -> dict[str, int]:
        return {k: len(v) for k, v in self.relations.items()}

    def indexed(self, rel_name: str, perm: tuple[int, ...]) -> Relation:
        """Relation re-indexed under column permutation ``perm`` (cached)."""
        key = (rel_name, tuple(perm))
        if key not in self._index_cache:
            base = self.relations[rel_name]
            if tuple(perm) == tuple(range(base.arity)):
                self._index_cache[key] = base
            else:
                self._index_cache[key] = base.reorder(perm)
        return self._index_cache[key]

    @property
    def domain_size(self) -> int:
        m = 0
        for r in self.relations.values():
            if len(r):
                m = max(m, int(r.data.max()) + 1)
        return m
