"""The control of the comparison that decides ``correct``, put in the
program's place: the plain reference computed in float32, the precision
below the configuration's exact int64 counts.  The comparison has to
reject it in every cell.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

runs the cell's window once a seed (as ``run.py`` does, all in one
process), then judges both the program's answers and the control's
against the int64 reference, and prints one JSON line a seed with both
sets of checks.  The benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(
            bench, args.workload, seed, args.seconds, False,
            time.perf_counter(), control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "attempted": result["attempted"],
                          "program": checks, "control": result["control"],
                          "rejected": {
                              name: any(c["value"] > c["limit"]
                                        for c in checks.values())
                              for name, checks in
                              result["control"].items()}}),
              flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
