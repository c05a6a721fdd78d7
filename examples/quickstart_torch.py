"""Quickstart on the PyTorch/CUDA port: worst-case-optimal graph-pattern
counting in 20 lines (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counts run on the card (``--device cuda``, the default) or, when
asked, on the CPU's plain path.
"""
import argparse

from repro_torch.core import (BinaryJoin, GraphDB, agm_bound, count,
                              get_query, pick_engine)
from repro_torch.graphs import node_sample, powerlaw_cluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=2000)
    args = ap.parse_args(argv)

    # 1) a graph (SNAP-style power-law synthetic; use graphs.load_edgelist
    #    for a real SNAP file) + two node samples at selectivity 10
    g = powerlaw_cluster(n=args.nodes, m_per_node=5, seed=0)
    gdb = GraphDB(g, {
        "v1": node_sample(g.n_nodes, 10, seed=1),
        "v2": node_sample(g.n_nodes, 10, seed=2),
    }, device=args.device)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges // 2} edges on "
          f"{gdb.device}")

    # 2) count patterns with the engine of your choice (auto = Table 6/7
    #    winners: LFTJ for cyclic, the Minesweeper analogue for acyclic)
    for qname in ["3-clique", "4-clique", "3-path", "2-comb"]:
        q = get_query(qname)
        c = count(q, gdb, engine="auto")
        bound = agm_bound(q, gdb.to_database().sizes())
        print(f"{qname:9s} -> {c:>12,} matches "
              f"(engine={pick_engine(q):10s} AGM bound={bound:.3g})")

    # 3) the same counts from the Selinger-style pairwise baseline — watch
    #    the intermediate blow up on the cyclic patterns
    bj = BinaryJoin(get_query("3-clique"), gdb.to_database())
    print("pairwise 3-clique:", bj.count(),
          f"(max intermediate {bj.stats['max_intermediate']:,} rows — "
          "the asymptotic gap the paper closes)")


if __name__ == "__main__":
    main()
