"""Node samples (the paper's selectivity predicates) + k-hop neighbor
sampling (the `minibatch_lg` GNN substrate).

The port's copy of ``repro.graphs.sampling`` (numpy only): the same seed
gives the same ids and the same hops.

The paper samples node predicates ``v1, v2, ...`` with probability ``1/s``
(s = "selectivity"; s=10 keeps ~10%).  The neighbor sampler implements
GraphSAGE-style fanout sampling over the CSR trie: per hop, each frontier
node draws ``fanout`` neighbors (with replacement — vectorizable and
standard); outputs are padded dense arrays + masks, ready to feed a GNN
step with static shapes.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph


def node_sample(n_nodes: int, selectivity: float, seed: int = 0,
                ) -> np.ndarray:
    """Sorted node ids, each kept with probability 1/selectivity."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_nodes) < (1.0 / selectivity)
    ids = np.flatnonzero(keep).astype(np.int64)
    if ids.size == 0:
        ids = rng.integers(0, n_nodes, size=1).astype(np.int64)
    return ids


class NeighborSampler:
    """k-hop fanout sampler producing padded (layered) blocks."""

    def __init__(self, g: CSRGraph, fanouts: tuple[int, ...],
                 seed: int = 0):
        self.g = g
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, batch_nodes: np.ndarray):
        """Returns a list of hops; each hop is a dict with
        ``src`` (frontier), ``nbr`` (frontier_size, fanout) sampled
        neighbor ids, and ``mask`` marking real (non-padded) samples.
        The next hop's frontier is the flattened unique neighbors.
        """
        g = self.g
        frontier = np.asarray(batch_nodes, dtype=np.int64)
        hops = []
        all_deg = g.degrees          # cached on the CSRGraph
        for fanout in self.fanouts:
            deg = all_deg[frontier]
            # with-replacement draws: offset = floor(u * deg)
            u = self.rng.random((frontier.shape[0], fanout))
            off = np.floor(u * np.maximum(deg, 1)[:, None]).astype(np.int64)
            flat = g.indptr[frontier][:, None] + off
            flat = np.clip(flat, 0, max(0, g.indices.shape[0] - 1))
            nbr = g.indices[flat] if g.indices.shape[0] else np.zeros_like(flat)
            mask = (deg > 0)[:, None] & np.ones_like(nbr, dtype=bool)
            hops.append({"src": frontier, "nbr": nbr, "mask": mask})
            frontier = np.unique(nbr[mask])
            if frontier.size == 0:
                frontier = np.zeros(1, dtype=np.int64)
        return hops
