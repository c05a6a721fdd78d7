"""Verify the port's planner output for every tier-1 query shape (a copy
of ``repro.analysis.__main__``).

Verification is a pure function of ``(plan, GraphStats)`` — no graph
data, no device — so this job plans each tier-1 shape against two
synthetic stats profiles (array-only and hybrid-with-bitsets), runs the
static verifier + recompilation auditor over every candidate plan the
planner can produce, and emits one JSON findings document
(the :class:`repro_torch.analysis.FindingReport` schema, the JAX
package's artifact shape).

Exit status is the gate: 0 iff no error-severity finding.
``--self-test`` mirrors ``tools/bench_compare.py``: seed malformed
plans, require the verifier to reject every one of them *and* accept
the clean planner output — proving the gate can fire before trusting
that it didn't.

Usage::

    python -m repro_torch.analysis --tier1 [--format=json] [--out F.json]
    python -m repro_torch.analysis --self-test
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..core.plan import GraphStats
from ..core.planner import candidate_plans, plan_query
from ..core.query import get_query
from .findings import FindingReport
from .verifier import verify_plan

#: the six tier-1 query shapes of the paper's benchmark (§5.1) that the
#: acceptance gate verifies planner output for.
TIER1_SHAPES = ("3-clique", "4-clique", "4-cycle", "3-path",
                "2-lollipop", "3-lollipop")

#: synthetic stats profiles: verification never reads graph data, so CI
#: exercises both the array-only and the hybrid/bitset planning paths
#: without building a graph.
_N = 10_000
STATS_PROFILES = {
    "array": GraphStats(
        n_nodes=_N, n_edges=200_000, max_degree=500, avg_degree=20.0,
        unary_sizes=(("v1", 1_000), ("v2", 1_000))),
    "hybrid": GraphStats(
        n_nodes=_N, n_edges=200_000, max_degree=500, avg_degree=20.0,
        unary_sizes=(("v1", 1_000), ("v2", 1_000)),
        n_hubs=128, hub_degree_threshold=64, hub_edge_fraction=0.97,
        bitset_words=(_N + 31) // 32),
}


def tier1_plans(output: str = "count"):
    """Yield ``(label, plan, stats)`` for every planner-produced plan
    across the tier-1 shapes and both stats profiles."""
    for shape in TIER1_SHAPES:
        q = get_query(shape)
        for profile, stats in STATS_PROFILES.items():
            plans = {p.engine: p for p in candidate_plans(q, stats)}
            plans["auto"] = plan_query(q, stats, engine="auto",
                                       output=output)
            for tag, plan in plans.items():
                yield f"{shape}/{profile}/{tag}", plan, stats


def run_tier1(report: FindingReport) -> int:
    n_plans = 0
    for label, plan, stats in tier1_plans():
        n_plans += 1
        for f in verify_plan(plan, stats):
            report.findings.append(dataclasses.replace(
                f, path=f"{label}:{f.path}"))
    return n_plans


def self_test() -> int:
    """Seed malformed plans; the verifier must reject each — and accept
    the clean planner output (a gate that always fires is as useless as
    one that never does)."""
    q = get_query("3-clique")
    stats = STATS_PROFILES["hybrid"]
    good = plan_query(q, stats, engine="vlftj")
    seeds = {
        # V101: GAO drops a query variable
        "uncovered-var": dataclasses.replace(good, gao=good.gao[:-1],
                                             levels=good.levels),
        # V105: bitset level against hub-free stats
        "bitset-no-layout": (dataclasses.replace(
            good, level_layouts=("bitset",) * len(good.gao)),
            STATS_PROFILES["array"]),
        # V107: recompile budget of 0 keys
        "over-budget": good,
    }
    failures = []
    for name, seed in seeds.items():
        seed_stats = stats
        kw = {}
        if isinstance(seed, tuple):
            seed, seed_stats = seed
        if name == "over-budget":
            kw["recompile_budget"] = 1
        errs = [f for f in verify_plan(seed, seed_stats, **kw)
                if f.severity == "error"]
        if not errs:
            failures.append(f"seeded {name} plan was NOT rejected")
        else:
            print(f"self-test: {name} rejected by "
                  f"{sorted({f.rule for f in errs})}")
    clean = [f for f in verify_plan(good, stats) if f.severity == "error"]
    if clean:
        failures.append(f"clean planner output rejected: {clean}")
    for msg in failures:
        print(f"self-test FAILED: {msg}", file=sys.stderr)
    if not failures:
        print("self-test OK: all seeded plans rejected; clean plan passes")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--tier1", action="store_true",
                    help="verify planner output for the six tier-1 "
                         "query shapes (default action)")
    ap.add_argument("--self-test", action="store_true",
                    help="seed malformed plans and require rejection")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--out", default=None,
                    help="write the JSON findings document here")
    args = ap.parse_args(argv)
    if args.self_test:
        return self_test()
    report = FindingReport()
    n_plans = run_tier1(report)
    doc = report.to_json(job="verify-tier1", shapes=list(TIER1_SHAPES),
                         plans_verified=n_plans)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(doc + "\n")
    if args.format == "json":
        print(doc)
    else:
        for f in report.findings:
            print(f.format())
        print(f"verify-tier1: {n_plans} plans, "
              f"{len(report.findings)} finding(s), "
              f"{len(report.errors())} error(s)")
    return 0 if report.gate_passes else 1


if __name__ == "__main__":
    raise SystemExit(main())
