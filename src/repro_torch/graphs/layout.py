"""Degree-adaptive adjacency layouts: renumbering + hybrid bitset packing.

EmptyHeaded's order-of-magnitude wins come from choosing the *physical
representation of each neighborhood* by density: a hub's neighbor set is
cheaper as a dense bitset (membership = one word gather + bit test,
intersection = AND + popcount over ``n_nodes/32`` words) than as a sorted
array (membership = ``log2(deg)`` gather rounds).  "Old Techniques for New
Join Algorithms" adds the enabling trick: renumber vertices by descending
degree so every hub lands in a small contiguous id prefix — the hub test
becomes ``id < n_hubs``, the bitset table is a dense ``(n_hubs, n_words)``
matrix, and Zipf-distributed adjacency mass concentrates in the low ids.

This module is the layout half of that stack:

* :func:`degree_sort_permutation` / :func:`renumber_csr` — the stable
  degree-descending renumbering pass (permutation + inverse; query results
  map back with :func:`map_rows_back`);
* :class:`HybridLayout` — packs every neighborhood above a degree/density
  threshold into fixed-width uint32 bitset rows (word-aligned over the
  full node domain) while the CSR sorted arrays stay authoritative for
  enumeration and probe expansion.

``core.device_graph.HybridGraphDB`` wires the layout into the engines;
``kernels/intersect_bitset.py`` holds the matching Pallas kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csr import CSRGraph

#: default layout thresholds (see HybridLayout.build).  The degree floor
#: is where the bitset membership test (2 gathers) overtakes binary
#: search (log2(deg)+1 gather rounds) — empirically degree ~2 on the
#: vectorized check path, so the floor is low and *memory* is what
#: adapts: the density rule (a bitset row costs n/32 words regardless
#: of degree) and word_budget keep sparse neighborhoods as arrays on
#: large graphs, and degree sorting means the budget always keeps the
#: heaviest hubs.
DEF_MIN_DEGREE = 2
DEF_DENSITY = 1.0 / 1024.0
DEF_WORD_BUDGET = 1 << 24   # max uint32 words across all bitset rows


# ---------------------------------------------------------------------------
# degree-sorted renumbering
# ---------------------------------------------------------------------------

def degree_sort_permutation(csr: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    """Stable degree-descending permutation of the vertex ids.

    Returns ``(order, inv)`` with ``order[new_id] = old_id`` (ties broken
    by ascending old id, so the pass is deterministic and stable) and
    ``inv[old_id] = new_id`` — the inverse permutation used to map query
    results back to the original id space.
    """
    n = csr.n_nodes
    order = np.lexsort((np.arange(n), -csr.degrees))
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)
    return order, inv


def renumber_csr(csr: CSRGraph, inv: np.ndarray) -> CSRGraph:
    """Apply an old→new vertex relabeling to a CSR graph.

    The edge set is identical up to relabeling; neighbor lists come back
    sorted in the *new* id space (hubs first under a degree-sort ``inv``).
    """
    ea = csr.edge_array()
    inv = np.asarray(inv, dtype=np.int64)
    return CSRGraph.from_edges(inv[ea[:, 0]], inv[ea[:, 1]],
                               n_nodes=csr.n_nodes, symmetrize=False,
                               drop_loops=False)


def map_rows_back(rows: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Map result rows from renumbered ids back to original ids
    (``order`` as returned by :func:`degree_sort_permutation`)."""
    rows = np.asarray(rows)
    if rows.size == 0:
        return rows.astype(np.int64)
    return np.asarray(order, dtype=np.int64)[rows]


# ---------------------------------------------------------------------------
# hybrid bitset layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HybridLayout:
    """Bitset rows for the hub id prefix of a degree-renumbered CSR.

    ``words[h, w]`` holds bits ``32*w .. 32*w+31`` of hub ``h``'s
    neighborhood characteristic vector over the full (word-padded) node
    domain: bit ``v & 31`` of ``words[h, v >> 5]`` is set iff edge
    ``(h, v)`` exists.  Hubs are exactly the vertices ``0 .. n_hubs-1``
    (degree sorting makes the dense prefix and the degree threshold
    coincide); everything else keeps only its sorted CSR array.
    """

    n_nodes: int
    n_hubs: int
    n_words: int            # uint32 words per bitset row
    min_degree: int         # effective degree threshold actually applied
    words: np.ndarray       # (n_hubs, n_words) uint32

    @classmethod
    def build(cls, csr: CSRGraph, min_degree: int = DEF_MIN_DEGREE,
              density: float = DEF_DENSITY,
              word_budget: int = DEF_WORD_BUDGET,
              max_hubs: int | None = None) -> "HybridLayout":
        """Pack every sufficiently dense neighborhood into a bitset row.

        A vertex is a hub when ``degree >= max(min_degree,
        density * n_nodes)`` — the density form is EmptyHeaded's layout
        rule (a bitset AND touches ``n/32`` words, so it beats the sorted
        array once the array would pay comparable gathers), the absolute
        floor keeps tiny graphs from bitsetting everything.  Only the
        maximal *prefix* of vertices passing the threshold is packed
        (on a degree-renumbered graph that is every qualifying vertex;
        on an unsorted graph the layout degrades gracefully to fewer or
        zero hubs instead of mis-tagging).  ``word_budget`` caps total
        bitset memory.
        """
        n = csr.n_nodes
        deg = csr.degrees
        n_words = max(1, (n + 31) // 32)
        thr = max(int(min_degree), int(np.ceil(density * n)), 1)
        qualifies = deg >= thr
        # maximal qualifying prefix (== all qualifying ids when renumbered)
        k = int(np.argmin(qualifies)) if not qualifies.all() else n
        k = min(k, max(0, word_budget // n_words))
        if max_hubs is not None:
            k = min(k, int(max_hubs))
        words = np.zeros((k, n_words), dtype=np.uint32)
        if k:
            end = int(csr.indptr[k])
            rows = np.repeat(np.arange(k), deg[:k])
            cols = csr.indices[:end]
            np.bitwise_or.at(words, (rows, cols >> 5),
                             (np.uint32(1) << (cols & 31).astype(np.uint32)))
        return cls(n_nodes=n, n_hubs=k, n_words=n_words, min_degree=thr,
                   words=words)

    def rep_tags(self) -> np.ndarray:
        """Per-vertex representation tag: bitset row index for hubs,
        ``-1`` for array-only vertices (int32, device-shippable)."""
        tag = np.full(self.n_nodes, -1, dtype=np.int32)
        tag[:self.n_hubs] = np.arange(self.n_hubs, dtype=np.int32)
        return tag

    def neighbors_from_bits(self, h: int) -> np.ndarray:
        """Decode hub ``h``'s bitset row back to a sorted id array
        (test oracle for the packer)."""
        bits = np.unpackbits(self.words[h].view(np.uint8), bitorder="little")
        return np.flatnonzero(bits[:self.n_nodes]).astype(np.int64)
