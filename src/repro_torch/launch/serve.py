"""Serving launcher — the paper's workload as a long-running service.

    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 20000 --requests 50

Loads (or generates) a graph, starts the QueryServer, and drives a mixed
batch of pattern queries, printing per-engine latency percentiles — the
operational analogue of Tables 6/7.  ``--edgelist`` serves a real SNAP
file.  The port of ``repro.launch.serve``: the same requests for a seed
(:func:`draw_requests`), served on ``--device`` (``cuda`` by default; it
raises without a card, ``cpu`` runs the plain path).
"""
from __future__ import annotations

import argparse

import numpy as np

from ..graphs import load_edgelist, powerlaw_cluster
from ..serve import QueryRequest, QueryServer

MIX = ["3-clique", "4-cycle", "3-path", "4-path", "1-tree", "2-comb",
       "2-lollipop"]


def draw_requests(n: int, seed: int) -> list[QueryRequest]:
    """``n`` requests drawn from ``MIX`` by numpy's generator for
    ``seed``, in the JAX launcher's order of draws: a pattern, a
    selectivity of 8 or 80 and a sample seed in [0, 3) a request."""
    rng = np.random.default_rng(seed)
    return [QueryRequest(str(rng.choice(MIX)),
                         selectivity=float(rng.choice([8, 80])),
                         seed=int(rng.integers(3)))
            for _ in range(n)]


def percentiles(results) -> dict:
    """Per engine label, sorted by label: the request count and the
    p50/p99 latency in ms (the JAX launcher's order statistics)."""
    by_engine: dict[str, list[float]] = {}
    for r in results:
        by_engine.setdefault(r.engine, []).append(r.latency_s)
    out = {}
    for eng, lats in sorted(by_engine.items()):
        lats.sort()
        out[eng] = dict(
            n=len(lats), p50_ms=lats[len(lats) // 2] * 1e3,
            p99_ms=lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edgelist", default=None)
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--m-per-node", type=int, default=6)
    ap.add_argument("--requests", type=int, default=50)
    ap.add_argument("--selectivity", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.edgelist:
        g = load_edgelist(args.edgelist)
    else:
        g = powerlaw_cluster(args.nodes, args.m_per_node, seed=args.seed)
    server = QueryServer(g, default_selectivity=args.selectivity,
                         device=args.device)
    print(f"graph: {g.n_nodes:,} nodes / {g.n_edges // 2:,} edges "
          f"on {server.device}")
    results = server.execute_batch(draw_requests(args.requests, args.seed))

    table = percentiles(results)
    total = sum(r.latency_s for r in results)
    print(f"\n{len(results)} requests, {total:.2f}s engine time")
    for eng, row in table.items():
        print(f"  {eng:12s} n={row['n']:3d} p50={row['p50_ms']:8.1f}ms "
              f"p99={row['p99_ms']:8.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
