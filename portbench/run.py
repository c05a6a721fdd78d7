"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many NVIDIA cards as
the cell asks for.  The last line of standard output is the result: one
JSON object with ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``busy_s``/``window_s``, and a
``breakdown``) and, last, ``checks``: each number compared with the
plain reference beside its limit, which also end standard error.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones.

Exits 2 without enough cards or without the program, and 3 if the
process holds JAX or the JAX package once the window has closed.  The
program builds its kernels at a fixed path inside the checkout
(``build/repro_torch_kernels/``), so only a cell's first run there
compiles.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program (src/repro_torch) is not under {ROOT}",
              file=sys.stderr)
        return 2
    import torch

    from portbench import harness
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run_cell(bench, args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      T_START)
    return harness.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
