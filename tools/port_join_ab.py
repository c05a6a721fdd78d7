"""Wall time of the PyTorch port's join main path, for one source tree.

    python3 tools/port_join_ab.py --src DIR [--label NAME]

Runs the package ``repro_torch`` found under ``DIR`` (``src`` of this
checkout by default, or of another checkout, such as an unpacked parent
commit) on one CUDA device, with the measuring code of this checkout's
``chip_smoke.py``: the ``soc-Slashdot0811``-like graph at full scale as
a plain and a hybrid db; ``searchsorted_segments`` at the main path's
chunk (device time from ``torch.profiler``, and CUDA events over
back-to-back wrapper calls); the main path (``count`` of the six tier-1
shapes on both dbs, ``bsearch`` mode), its wall and launches; then the
plain db's 4-cycle count unprofiled ``--reps`` times and once profiled.
Prints one JSON line per measurement and a summary line last.  To
compare two trees, run it once per tree in alternating order in one
session on one card (parent, change, change, parent): host-bound walls
differ between machines far more than between two runs on one.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to run")
    ap.add_argument("--label", default="", help="name printed with results")
    ap.add_argument("--reps", type=int, default=3,
                    help="unprofiled 4-cycle counts")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("port_join_ab: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"port_join_ab: no repro_torch package under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch.core as T
    from repro_torch.kernels import build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"label": args.label, "src": str(src), "card": smi}
    t0 = time.perf_counter()
    build.library()
    out["nvcc_s"] = time.perf_counter() - t0
    _, db, hdb = cs.bench_gdb(T, 1.0, "cuda")

    # the searchsorted kernel at the chip_smoke.py kernel line's chunk
    cand, check, _ = cs.level_inputs(db, np.random.default_rng(cs.SEED), 2048,
                                     hubs_only=False)
    indptr = db.csr.indptr
    dev = db.device
    values = db.dev("indices")
    q = torch.from_numpy(cand).to(dev)
    lo = torch.from_numpy(indptr[check][:, None].astype(np.int32)).to(dev)
    hi = torch.from_numpy(indptr[check + 1][:, None].astype(np.int32)).to(dev)

    def search():
        return ops.searchsorted_segments(values, lo, hi, q, db.bsearch_iters)

    out["searchsorted_ms"] = cs.device_ms(search, 50,
                                          "searchsorted_segments_kernel")
    out["searchsorted_event_ms"] = cs.cuda_ms(search, 50)

    t0 = time.perf_counter()
    counts, launches = cs.main_path(T, {"plain": db, "hybrid": hdb})
    out["main_path_s"] = time.perf_counter() - t0
    out["main_path_launches"] = launches
    out["counts"] = {f"{d}/{s}": n for (d, s), n in counts.items()}

    query = T.get_query("4-cycle")
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        T.count(query, db)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["count_4cycle_walls_s"] = walls
    cs.profile_count(T, db, "4-cycle")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
