"""End-to-end script on the PyTorch/CUDA port: batched + preemptive
graph-pattern query serving (the port of ``examples/serve_queries.py``).

The paper's workload as a service: a resident graph, clients submitting
pattern queries with per-request samples, the engine router picking the
Table-6/7 winner per query shape.  Part 2 shows the preemptive
scheduler: the same mixed light/heavy load under FIFO vs quantum
round-robin, with per-tenant admission control.

    PYTHONPATH=src python examples/serve_queries_torch.py [--device cpu]

The server runs on the card (``--device cuda``, the default) or, when
asked, on the CPU's plain path.
"""
import argparse
import time

import numpy as np

from repro_torch.graphs import powerlaw_cluster
from repro_torch.serve import (AdmissionError, QuantumScheduler,
                               QueryRequest, QueryServer, TenantQuota)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--requests", type=int, default=24)
    args = ap.parse_args(argv)

    g = powerlaw_cluster(n=args.nodes, m_per_node=6, seed=0)
    server = QueryServer(g, device=args.device)
    print(f"serving graph: {g.n_nodes} nodes, {g.n_edges // 2} edges on "
          f"{server.device}\n")

    requests = []
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        qname = rng.choice(["3-clique", "4-cycle", "3-path", "2-comb",
                            "1-tree", "2-lollipop"])
        requests.append(QueryRequest(str(qname),
                                     selectivity=float(rng.choice([8, 80])),
                                     seed=int(rng.integers(3))))

    t0 = time.time()
    results = server.execute_many(requests)   # plan-grouped batches
    wall = time.time() - t0

    by_engine: dict = {}
    for r in results:
        by_engine.setdefault(r.engine, []).append(r.latency_s)
        print(f"  {r.request.query_name:11s} "
              f"sel={r.request.selectivity:4.0f} -> {r.count:>12,}  "
              f"[{r.engine:10s} {r.latency_s*1e3:7.1f} ms]")

    print(f"\n{len(results)} requests in {wall:.2f}s "
          f"({len(results)/wall:.1f} qps)  plan cache: "
          f"{server.plan_cache_info()}")
    for eng, lats in sorted(by_engine.items()):
        lats = sorted(lats)
        p50 = lats[len(lats) // 2] * 1e3
        print(f"  {eng:10s}: n={len(lats)} p50={p50:.1f}ms "
              f"max={max(lats)*1e3:.1f}ms")

    # -- part 2: preemptive scheduling under mixed light/heavy load ------
    # One heavy full-graph 3-path enumeration racing six small counts.
    # FIFO (run-to-completion, the batch behaviour above) starves the
    # smalls; the quantum policy round-robins slices of `quantum_rows`
    # expanded rows, so every small finishes within a few quanta.
    print("\n--- preemptive scheduling: 1 heavy enumeration vs 6 smalls ---")

    def mixed_load(policy: str):
        sched = QuantumScheduler(server, quantum_rows=8192, policy=policy)
        sched.submit(QueryRequest("3-path", engine="vlftj", limit=10**9,
                                  selectivity=2.0), collect_rows=False)
        for i in range(6):
            sched.submit(QueryRequest("3-clique", engine="vlftj",
                                      seed=i % 3))
        return sched.run()

    for policy in ("fifo", "quantum"):
        results = mixed_load(policy)
        heavy, smalls = results[0], results[1:]
        done = [r.stats["vclock_done"] - r.stats["vclock_submit"]
                for r in smalls]
        print(f"  {policy:7s}: heavy rows_expanded="
              f"{heavy.stats['rows_expanded']:,} "
              f"quanta={heavy.stats['quanta']} | small completion "
              f"(rows-expanded clock) p50={sorted(done)[len(done)//2]:,} "
              f"max={max(done):,}")

    # -- part 3: per-tenant quotas (429-style admission control) ---------
    print("\n--- admission control: tenant 'b' capped at 2 in flight ---")
    sched = QuantumScheduler(server, quantum_rows=8192,
                             quotas={"b": TenantQuota(max_in_flight=2)})
    for i in range(4):
        try:
            tok = sched.submit(QueryRequest("3-clique", tenant="b", seed=i))
            print(f"  submit #{i}: admitted as {tok}")
        except AdmissionError as e:
            print(f"  submit #{i}: HTTP {e.status} — {e}")
    sched.run()


if __name__ == "__main__":
    main()
