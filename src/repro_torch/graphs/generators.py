"""Synthetic graph generators approximating the paper's SNAP datasets.

The real SNAP collection is not available offline; these generators produce
graphs with matching (nodes, edges) scale and heavy-tailed degree
distributions.  ``SNAP_LIKE`` mirrors Table (§5.1)'s datasets so benchmarks
can be keyed by the paper's dataset names.
"""
from __future__ import annotations

import numpy as np

from .csr import CSRGraph


def erdos_renyi(n: int, m: int, seed: int = 0) -> CSRGraph:
    """G(n, m): m undirected edges sampled uniformly (w/ dedup)."""
    rng = np.random.default_rng(seed)
    # oversample to survive dedup/loop-dropping
    k = int(m * 1.3) + 16
    src = rng.integers(0, n, size=k)
    dst = rng.integers(0, n, size=k)
    keep = src != dst
    src, dst = src[keep][:m], dst[keep][:m]
    return CSRGraph.from_edges(src, dst, n_nodes=n)


def barabasi_albert(n: int, m_per_node: int, seed: int = 0) -> CSRGraph:
    """Preferential attachment (vectorized repeated-node trick)."""
    rng = np.random.default_rng(seed)
    m = m_per_node
    targets = list(range(m))
    repeated: list[int] = []
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m, n):
        src_l.extend([v] * m)
        dst_l.extend(targets)
        repeated.extend(targets)
        repeated.extend([v] * m)
        # next targets: preferential sample from `repeated`
        idx = rng.integers(0, len(repeated), size=3 * m)
        uniq = list(dict.fromkeys(int(repeated[i]) for i in idx))[:m]
        while len(uniq) < m:  # pragma: no cover - tiny graphs
            c = int(rng.integers(0, v + 1))
            if c not in uniq:
                uniq.append(c)
        targets = uniq
    return CSRGraph.from_edges(np.array(src_l), np.array(dst_l), n_nodes=n)


def powerlaw_cluster(n: int, m_per_node: int, tri_p: float = 0.5,
                     seed: int = 0) -> CSRGraph:
    """BA + triangle-closing step (Holme–Kim), denser in triangles —
    matches social graphs (facebook/epinions) better than plain BA."""
    rng = np.random.default_rng(seed)
    g = barabasi_albert(n, m_per_node, seed)
    # close random wedges with probability tri_p
    deg = g.degrees
    cand = np.flatnonzero(deg >= 2)
    extra_src, extra_dst = [], []
    n_close = int(tri_p * n)
    if cand.size:
        for u in rng.choice(cand, size=min(n_close, cand.size),
                            replace=False):
            nb = g.neighbors(int(u))
            if nb.shape[0] >= 2:
                i, j = rng.choice(nb.shape[0], size=2, replace=False)
                extra_src.append(int(nb[i]))
                extra_dst.append(int(nb[j]))
    if extra_src:
        ea = g.edge_array()
        src = np.concatenate([ea[:, 0], np.array(extra_src)])
        dst = np.concatenate([ea[:, 1], np.array(extra_dst)])
        return CSRGraph.from_edges(src, dst, n_nodes=n, symmetrize=True)
    return g


def zipf_graph(n: int, m: int, alpha: float = 1.4,
               seed: int = 0) -> CSRGraph:
    """Edges whose endpoints follow a Zipf popularity law — a handful of
    hubs own most of the adjacency mass.  The skew workload for the
    distributed layer: a static seed deal balances fine, but frontier
    rows that *reach* a hub mid-join explode on whichever shard holds
    them (``dist/rebalance.py``)."""
    rng = np.random.default_rng(seed)
    weights = np.arange(1, n + 1, dtype=np.float64) ** -alpha
    p = weights / weights.sum()
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    keep = src != dst
    return CSRGraph.from_edges(src[keep], dst[keep], n_nodes=n)


#: name -> (generator, kwargs) scaled like the paper's SNAP datasets.
#: Edge counts are undirected, as in §5.1's table.
SNAP_LIKE: dict[str, dict] = {
    # small/benchmark-friendly scales (full paper sizes possible but slow on
    # the CPU container; the generators take n/m directly for scaling runs)
    "ca-GrQc":          dict(kind="plc", n=5_242, m_per_node=5),
    "p2p-Gnutella04":   dict(kind="er", n=10_876, m=39_994),
    "wiki-Vote":        dict(kind="plc", n=7_115, m_per_node=14),
    "ego-Facebook":     dict(kind="plc", n=4_039, m_per_node=21),
    "ca-CondMat":       dict(kind="plc", n=23_133, m_per_node=8),
    "p2p-Gnutella31":   dict(kind="er", n=62_586, m=147_892),
    "email-Enron":      dict(kind="plc", n=36_692, m_per_node=10),
    "loc-Brightkite":   dict(kind="plc", n=58_228, m_per_node=7),
    "soc-Epinions1":    dict(kind="plc", n=75_879, m_per_node=6),
    "soc-Slashdot0811": dict(kind="plc", n=77_360, m_per_node=11),
}


def make_snap_like(name: str, seed: int = 0, scale: float = 1.0) -> CSRGraph:
    spec = dict(SNAP_LIKE[name])
    kind = spec.pop("kind")
    if "n" in spec:
        spec["n"] = max(8, int(spec["n"] * scale))
    if "m" in spec:
        spec["m"] = max(8, int(spec["m"] * scale))
    if kind == "er":
        return erdos_renyi(seed=seed, **spec)
    if kind == "plc":
        return powerlaw_cluster(seed=seed, **spec)
    raise ValueError(kind)
