"""CSR adjacency — the sorted-array trie for the binary ``edge`` relation.

The port's copy of ``repro.graphs.csr`` (the port imports nothing of
``repro``).

The first trie level is the dense ``indptr`` over node ids; the second level
is the per-node sorted neighbor list.  This is the index layout every engine
(reference and vectorized) and every GNN in the model zoo shares.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray   # (n+1,) int64
    indices: np.ndarray  # (m,) int64, sorted within each row
    n_nodes: int
    # cached np.diff(indptr) — every consumer (sampling, stats, vlftj
    # bucketing, layout building) reads degrees repeatedly
    _degrees: np.ndarray | None = field(default=None, repr=False,
                                        compare=False)

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: int | None = None, symmetrize: bool = True,
                   drop_loops: bool = True) -> "CSRGraph":
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        if symmetrize:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
        if drop_loops:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        if n_nodes is None:
            n_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        # sort by (src, dst), dedup
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if src.size:
            keep = np.empty(src.shape[0], dtype=bool)
            keep[0] = True
            keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
            src, dst = src[keep], dst[keep]
        indptr = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=dst, n_nodes=n_nodes)

    # -- basic stats ---------------------------------------------------------
    @property
    def n_edges(self) -> int:
        """Directed edge count (2x undirected count when symmetrized)."""
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        """Per-node degree, computed once and cached (treat as
        read-only; shared by sampling, stats, and layout builders)."""
        if self._degrees is None:
            self._degrees = degrees_from_indptr(self.indptr)
        return self._degrees

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max(initial=0))

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    # -- conversions ---------------------------------------------------------
    def edge_array(self) -> np.ndarray:
        """(m, 2) sorted edge tuple table (the Relation layout)."""
        src = np.repeat(np.arange(self.n_nodes, dtype=np.int64),
                        self.degrees)
        return np.stack([src, self.indices], axis=1)

    def to_relation(self, name: str = "edge"):
        from ..core.relation import Relation
        r = Relation.__new__(Relation)
        r.data = self.edge_array()
        r.name = name
        return r

    def padded_neighbors(self, pad_to: int | None = None,
                         fill: int = -1) -> tuple[np.ndarray, np.ndarray]:
        """Dense (n, max_deg) neighbor matrix + mask (GNN/vec-join tiles)."""
        d = self.degrees
        width = int(pad_to if pad_to is not None else self.max_degree)
        out = np.full((self.n_nodes, width), fill, dtype=np.int64)
        mask = np.zeros((self.n_nodes, width), dtype=bool)
        cols = np.arange(width)
        valid = cols[None, :] < np.minimum(d[:, None], width)
        flat = np.clip(self.indptr[:-1, None] + cols[None, :], 0,
                       max(0, self.indices.shape[0] - 1))
        if self.indices.shape[0]:
            out[valid] = self.indices[flat[valid]]
        mask[valid] = True
        return out, mask


def degrees_from_indptr(indptr: np.ndarray) -> np.ndarray:
    """Degrees of a CSR row-pointer array — the one place the
    ``np.diff(indptr)`` idiom lives (``CSRGraph.degrees`` caches it;
    raw-indptr holders like the sharded CSR call it directly)."""
    return np.diff(indptr)


def triangle_count_csr(g: CSRGraph) -> int:
    """Host oracle: number of triangles via sorted-neighbor intersection."""
    total = 0
    ind, ptr = g.indices, g.indptr
    for u in range(g.n_nodes):
        nu = ind[ptr[u]:ptr[u + 1]]
        nu = nu[nu > u]
        for v in nu:
            nv = ind[ptr[v]:ptr[v + 1]]
            nv = nv[nv > v]
            total += np.intersect1d(nu, nv, assume_unique=True).shape[0]
    return int(total)
