"""The benchmark's frozen graph generator and node samples.

The configuration names the generator and its parameters; the graph is
made from the run's seed.  This is the benchmark's own copy: the program
under test is handed the arrays it makes and never generates its own,
and the plain reference reads the same arrays.

* ``chung_lu`` — a Chung–Lu power-law graph made on the device in a few
  vectorized calls, with exactly the configuration's number of distinct
  undirected edges.
* ``node_sample`` — a node's membership in a unary sample, as the query
  server derives it from a request's ``(selectivity, seed)``.

Every graph comes back as a symmetric CSR without self loops or repeated
edges: ``indptr`` (n + 1,) and ``indices`` (2 * edges,) int64 numpy
arrays, each row's neighbours ascending.
"""
from __future__ import annotations

import numpy as np
import torch


def chung_lu_weights(n: int, mean_degree: float, exponent: float,
                     degree_cap: float, device) -> torch.Tensor:
    """Expected degrees ``w_i ∝ (i + 1) ** (-1 / (exponent - 1))``,
    capped at ``degree_cap`` and scaled to ``mean_degree`` (float64)."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    w = (i + 1.0) ** (-1.0 / (exponent - 1.0))
    for _ in range(8):          # the cap takes mass; rescale until it holds
        w = w * (mean_degree * n / w.sum())
        w = torch.clamp(w, max=degree_cap)
    return w


def chung_lu(n: int, n_edges: int, exponent: float, degree_cap: float,
             seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """Exactly ``n_edges`` distinct undirected edges without self loops,
    whose endpoints are drawn by expected degree (mean ``2 n_edges / n``)
    and whose node ids are shuffled; symmetrized to ``2 * n_edges`` CSR
    entries.  Pairs are drawn until that many distinct ones remain, and
    the surplus of the last draw is dropped uniformly.  All on
    ``device`` with one generator seeded by ``seed``."""
    if n_edges > n * (n - 1) // 2:
        raise ValueError(f"{n_edges} edges do not fit {n} nodes")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    w = chung_lu_weights(n, 2.0 * n_edges / n, exponent, degree_cap, device)
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    del w
    perm = torch.randperm(n, generator=gen, device=device)

    def endpoints(k: int) -> torch.Tensor:
        r = torch.rand(k, generator=gen, dtype=torch.float64, device=device)
        return perm[torch.searchsorted(cdf, r).clamp_(max=n - 1)]

    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < n_edges:
        need = n_edges - keys.numel()
        draw = need + need // 64 + 1024     # loops and repeats are rare
        u, v = endpoints(draw), endpoints(draw)
        keep = u != v
        lo = torch.minimum(u, v)[keep]
        hi = torch.maximum(u, v)[keep]
        del u, v, keep
        keys = torch.unique(torch.cat([keys, lo * n + hi]), sorted=True)
        del lo, hi
    if keys.numel() > n_edges:
        pick = torch.randperm(keys.numel(), generator=gen, device=device)
        keys = keys[torch.sort(pick[:n_edges]).values]
        del pick
    lo = torch.div(keys, n, rounding_mode="floor")
    hi = keys - lo * n
    del keys
    both = torch.sort(torch.cat([lo * n + hi, hi * n + lo])).values
    del lo, hi
    src = torch.div(both, n, rounding_mode="floor")
    deg = torch.bincount(src, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(deg, 0, out=indptr[1:])
    indices = both - src * n
    return indptr.cpu().numpy(), indices.cpu().numpy()


def make_graph(spec: dict, seed: int, device) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's graph (its ``graph`` entry) for ``seed``."""
    kind = spec["generator"]
    if kind == "chung_lu":
        return chung_lu(spec["n_nodes"], spec["n_edges"], spec["exponent"],
                        spec["degree_cap"], seed, device)
    raise ValueError(f"unknown generator {kind!r}")


def node_sample(n: int, selectivity: float, seed: int) -> np.ndarray:
    """Sorted node ids, each kept with probability ``1 / selectivity``."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(rng.random(n) < 1.0 / selectivity).astype(np.int64)
    if ids.size == 0:
        ids = rng.integers(0, n, size=1).astype(np.int64)
    return ids


def request_samples(n: int, selectivity: float,
                    seed: int) -> dict[str, np.ndarray]:
    """The unary samples ``v1``–``v4`` of a request with this sample
    seed, as the query server derives them (``seed * 7 + i``)."""
    return {f"v{i}": node_sample(n, selectivity, seed * 7 + i)
            for i in range(1, 5)}
