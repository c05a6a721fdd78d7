"""Export a JSONL query trace of the port (the counterpart of
``repro.obs.export_trace``).

Runs one paper query (default: the 3-path) on a small synthetic
Zipf-degree graph under EXPLAIN ANALYZE, on the card unless ``--device
cpu`` is given, verifies count parity against an untraced run of the
same plan, and writes the trace as JSONL::

    PYTHONPATH=src python -m repro_torch.obs.export_trace \\
        --query 3-path --out trace_3path.jsonl [--device cpu]

The artifact lets CI diff per-level est-vs-observed cardinalities (and
kernel-path mix) across commits; the line schema is documented in
``docs/OBSERVABILITY.md``.

``--metrics PATH`` additionally runs the query under an active
:class:`DeviceProfile`, publishes it into the process
:class:`MetricsRegistry`, and dumps the flattened registry snapshot as
JSON — the companion metrics artifact (library-build and kernel
histograms, dispatch counters, peak-live-bytes gauge).
"""
from __future__ import annotations

import argparse
import json
import sys

from ..core import GraphDB, execute, get_query
from ..graphs import node_sample
from ..graphs.generators import zipf_graph
from .explain import explain_analyze
from .metrics import get_registry
from .profile import DeviceProfile


def trace_gdb(n: int = 2000, m: int = 8000, seed: int = 0,
              selectivity: float = 8.0, device: str = "cuda") -> GraphDB:
    """The small Zipf-skewed graph the trace artifact is produced on."""
    g = zipf_graph(n, m, seed=seed)
    unary = {f"v{i}": node_sample(g.n_nodes, selectivity, seed=17 * i + 1)
             for i in range(1, 5)}
    return GraphDB(g, unary, device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--query", default="3-path",
                    help="paper query name (default: 3-path)")
    ap.add_argument("--engine", default="vlftj",
                    help="physical engine (default: vlftj — the "
                         "level-structured executor, so the trace "
                         "carries per-level est/obs cardinalities)")
    ap.add_argument("--out", default="trace.jsonl",
                    help="JSONL output path")
    ap.add_argument("--n", type=int, default=2000, help="graph nodes")
    ap.add_argument("--m", type=int, default=8000, help="graph edges")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the graph and the engine run (default: "
                         "cuda; cpu runs the plain PyTorch path)")
    ap.add_argument("--metrics", default=None,
                    help="also profile the run and dump the process "
                         "MetricsRegistry snapshot as JSON here")
    args = ap.parse_args(argv)

    gdb = trace_gdb(args.n, args.m, seed=args.seed, device=args.device)
    query = get_query(args.query)
    prof = DeviceProfile(args.query, args.engine) if args.metrics else None
    if prof is not None:
        with prof.activate():
            res = explain_analyze(query, gdb, engine=args.engine)
    else:
        res = explain_analyze(query, gdb, engine=args.engine)
    untraced = execute(res.plan, gdb)
    if untraced != res.count:
        print(f"PARITY FAILURE: traced={res.count} untraced={untraced}",
              file=sys.stderr)
        return 1
    if prof is not None:
        prof.publish(trace=res.trace, registry=get_registry())
        with open(args.metrics, "w") as fh:
            json.dump(get_registry().snapshot(), fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
    res.trace.to_jsonl(args.out)
    print(res.render())
    print(f"trace ({len(res.trace.levels)} levels, "
          f"{len(res.trace.events)} events) -> {args.out}")
    if prof is not None:
        print(f"profile ({prof.jit['calls']} level-step calls, "
              f"{prof.memory['peak_live_bytes']} peak live bytes) "
              f"-> {args.metrics}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
