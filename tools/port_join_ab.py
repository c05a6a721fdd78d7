"""Parent against change: the PyTorch port's kernel and path times, for
one source tree.

    python3 tools/port_join_ab.py --src DIR [--label NAME] [--parts LIST]

Runs the package ``repro_torch`` found under ``DIR`` (``src`` of this
checkout by default, or of another checkout, such as an unpacked parent
commit) on one CUDA device, with the measuring code of this checkout's
``chip_smoke.py``.  The parts (``--parts``, all by default):

* ``search``: ``searchsorted_segments`` at the main path's chunk
  (device time from ``torch.profiler``, and CUDA events over
  back-to-back wrapper calls);
* ``main``: the main path (``count`` of the six tier-1 shapes on both
  dbs, ``bsearch`` mode), its wall and launches;
* ``cycle4``: the plain db's 4-cycle count in ``bsearch`` mode
  unprofiled ``--reps`` times and once profiled;
* ``tile``: ``tile_member_mask`` at the chip_smoke kernel line's chunk,
  every lane, and with ``lane_len`` = the probe degrees where the tree's
  mask takes it;
* ``auto``: the plain db's 4-cycle count in ``check_mode="auto"``
  (tile width 512) ``--reps`` times and once profiled, with the check
  kernels' device times;
* ``bitset``: ``bitset_member_mask`` at the chip_smoke kernel line's
  hub chunk, every lane and with ``lane_len`` = the probe degrees where
  the tree's mask takes it, and ``bitset_member_count`` there; then the
  hybrid db's 4-cycle count (``bsearch`` mode, its all-hub rows on the
  bitset mask) ``--reps`` times and once profiled;
* ``flash``: ``ops.flash_attention`` at stablelm-3b's and chatglm3-6b's
  prefill shapes in bf16, at stablelm-3b's with an off-grid head dim of
  72 in bf16, and at the f32 path shape (chatglm3-6b's heads in f32), the
  device time of the kernel the tree routes each to;
* ``flash_bwd``: the mma route's flash backward at chip_smoke.py's two
  ``kernel flash_attention_bwd`` shapes (float32 at the f32 path shape,
  bf16 at D 72 with stablelm-3b's heads), through its
  ``flash_bwd_mma_line`` (a tree whose mma forward saves the lse):
  the kernels' device time, each kernel's apart, and the errors;
* ``lm``: stablelm-3b at full width and depth in bf16, seeded weights,
  one 4 x 2048 prefill timed after a warm-up, and one profiled;
* ``outer``: ``ops.segment_outer`` at the chip_smoke.py segment-outer
  line's shape (MACE's widths: 131,072 nodes, 6,621,401 edges, C 128,
  M 9), uniform and powerlaw dst, in float32 and bf16, the device time of
  the tree's kernels for one call (a tree whose wrapper refuses bf16
  reports the refusal); then chip_smoke.py's large-gap case (2^17 edges
  on 1,024 of 131,072 nodes, so 130,048 zero rows) in float32;
* ``serve``: the query server (``QueryServer(g, device="cuda")``) on the
  same graph, ``execute_many`` of the six tier-1 shapes at both of
  chip_smoke.py's serve selectivities twice (the second pass all
  plan-cache hits): each round's wall and each request's latency.

The graph parts use the ``soc-Slashdot0811``-like graph at full scale as
a plain and a hybrid db.  Prints one JSON line per measurement and a
summary line last.  To compare two trees, run it once per tree in
alternating order on one card, one process after another (parent,
change, change, parent): host-bound walls differ between machines far
more than between two runs on one.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PARTS = ("search", "main", "cycle4", "tile", "auto", "bitset", "flash",
         "flash_bwd", "lm", "outer", "serve")
#: the kernel function each flash route launches, by route name
FLASH_KERNELS = {"tc": "flash_attention_tc_kernel",
                 "mma": "flash_attention_mma_kernel",
                 "simt": "flash_attention_kernel"}


def walls(fn, reps: int) -> list:
    import torch
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package to run")
    ap.add_argument("--label", default="", help="name printed with results")
    ap.add_argument("--reps", type=int, default=3,
                    help="unprofiled 4-cycle counts")
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma list of {', '.join(PARTS)}")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {', '.join(PARTS)}")
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

    if set(parts) & {"search", "main", "cycle4", "tile", "auto", "bitset",
                     "serve"}:
        g, db, hdb = cs.bench_gdb(T, 1.0, "cuda")
        indptr = db.csr.indptr
        dev = db.device
        values = db.dev("indices")

    def chunk(seed: int, max_degree=None):
        cand, check, deg = cs.level_inputs(
            db, np.random.default_rng(seed), 2048, hubs_only=False,
            max_degree=max_degree)
        return (torch.from_numpy(cand).to(dev),
                torch.from_numpy(indptr[check][:, None].astype(np.int32)
                                 ).to(dev),
                torch.from_numpy(indptr[check + 1][:, None].astype(np.int32)
                                 ).to(dev),
                torch.from_numpy(deg).to(dev))

    if "search" in parts:
        # the searchsorted kernel at the chip_smoke.py kernel line's chunk
        q, lo, hi, _ = chunk(cs.SEED)

        def search():
            return ops.searchsorted_segments(values, lo, hi, q,
                                             db.bsearch_iters)

        out["searchsorted_ms"] = cs.device_ms(search, 50,
                                              "searchsorted_segments_kernel")
        out["searchsorted_event_ms"] = cs.cuda_ms(search, 50)

    if "main" in parts:
        t0 = time.perf_counter()
        counts, launches = cs.main_path(T, {"plain": db, "hybrid": hdb})
        out["main_path_s"] = time.perf_counter() - t0
        out["main_path_launches"] = launches
        out["counts"] = {f"{d}/{s}": n for (d, s), n in counts.items()}

    query = T.get_query("4-cycle")
    if "cycle4" in parts:
        out["count_4cycle_walls_s"] = walls(lambda: T.count(query, db),
                                            args.reps)
        cs.profile_count(T, db, "4-cycle")

    if "tile" in parts:
        # the tile mask at the chip_smoke.py kernel line's chunk (the rows
        # check_mode="auto" sends down the tile path)
        q, lo, hi, lanes = chunk(cs.SEED + 1, cs.TILE_WIDTH)
        cw = cs.TILE_WIDTH
        out["tile_all_lanes_ms"] = cs.device_ms(
            lambda: ops.tile_member_mask(values, lo, hi, q, cw), 50,
            "tile_member_mask_kernel")
        if "lane_len" in inspect.signature(ops.tile_member_mask).parameters:
            out["tile_lane_len_ms"] = cs.device_ms(
                lambda: ops.tile_member_mask(values, lo, hi, q, cw, lanes),
                50, "tile_member_mask_kernel")

    if "auto" in parts:
        kw = dict(check_mode="auto", tile_width=cs.TILE_WIDTH)
        out["count_4cycle_auto_walls_s"] = walls(
            lambda: T.count(query, db, **kw), args.reps)
        cs.profile_count(T, db, "4-cycle", **kw)

    if "bitset" in parts:
        out.update(bitset_parts(cs, T, db, hdb, args.reps))

    if "flash" in parts:
        out.update(flash_shapes(cs))

    if "flash_bwd" in parts:
        for dt in cs.FLASH_BWD_MMA_SHAPES:
            line = cs.flash_bwd_mma_line(dt)
            out[f"flash_bwd {dt}"] = {k: line[k] for k in (
                "ms", "by_kernel", "dq_dk_dv_rel_err", "bound_ms",
                "library_ms", "forward_digest")}

    if "lm" in parts:
        out.update(stablelm_prefill(cs))

    if "outer" in parts:
        out.update(outer_shapes(cs))

    if "serve" in parts:
        out.update(serve_rounds(cs, g))

    print(json.dumps(out), flush=True)
    return 0


def serve_rounds(cs, g) -> dict:
    """Two rounds of ``execute_many`` of the six shapes at both serve
    selectivities on one server: each round's wall and, by request,
    ``shape@selectivity`` -> latency."""
    from repro_torch.serve import QueryRequest, QueryServer
    server = QueryServer(g, device="cuda")
    reqs = [QueryRequest(shape, selectivity=sel, seed=0)
            for sel in cs.SERVE_SELECTIVITIES for shape in cs.SHAPES]
    out = {}
    for rnd in (1, 2):
        t0 = time.perf_counter()
        results = server.execute_many(reqs)
        out[f"serve_round{rnd}_wall_s"] = time.perf_counter() - t0
        out[f"serve_round{rnd}_latency_s"] = {
            f"{r.request.query_name}@{r.request.selectivity:g}": r.latency_s
            for r in results}
    return out


def bitset_parts(cs, T, db, hdb, reps: int) -> dict:
    """The bitset kernels at the chip_smoke.py kernel line's hub chunk
    (the same rows: the searchsorted chunk is drawn first from the same
    seed), then the hybrid db's 4-cycle count walls and profile."""
    import torch
    from repro_torch.kernels import ops
    dev = hdb.device
    rng = np.random.default_rng(cs.SEED)
    cs.level_inputs(db, rng, 2048, hubs_only=False)
    cand, check, deg = cs.level_inputs(hdb, rng, 2048, hubs_only=True)
    words = hdb.dev("bitset_words")
    row = hdb.dev("rep_tag")[torch.from_numpy(check).to(dev)]
    q = torch.from_numpy(cand).to(dev)
    lanes = torch.from_numpy(deg).to(dev)
    out = {"bitset_mask_all_lanes_ms": cs.device_ms(
        lambda: ops.bitset_member_mask(words, row, q), 50,
        "bitset_member_mask_kernel")}
    if "lane_len" in inspect.signature(ops.bitset_member_mask).parameters:
        out["bitset_mask_lane_len_ms"] = cs.device_ms(
            lambda: ops.bitset_member_mask(words, row, q, lanes), 50,
            "bitset_member_mask_kernel")
    wrows = words[row.long()].contiguous()
    out["bitset_count_ms"] = cs.device_ms(
        lambda: ops.bitset_member_count(wrows, q, lanes), 50,
        "bitset_member_count_kernel")
    query = T.get_query("4-cycle")
    out["count_4cycle_hybrid_walls_s"] = walls(lambda: T.count(query, hdb),
                                               reps)
    cs.profile_count(T, hdb, "4-cycle", db_name="hybrid")
    return out


def flash_shapes(cs) -> dict:
    """Device time of the tree's flash route, causal, on (B, T, H, D)
    tensors seen as (B, H, T, D), as prefill passes them: in bf16 at
    chatglm3-6b's prefill shape (B 4, 32 query and 2 KV heads of 128,
    T 2048), at stablelm-3b's (32 query and 32 KV heads of 80) and at
    stablelm-3b's with heads of 72; then in f32 at chatglm3-6b's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import route
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    out = {}
    for name, hq, hkv, d, dtype in (
            ("chatglm", 32, 2, 128, torch.bfloat16),
            ("stablelm", 32, 32, 80, torch.bfloat16),
            ("stablelm_d72", 32, 32, 72, torch.bfloat16),
            ("chatglm_f32", 32, 2, 128, torch.float32)):
        q, k, v = (torch.randn((cs.LM_BATCH, cs.LM_PROMPT, h, d),
                               generator=g, device="cuda"
                               ).to(dtype).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        path = route(q.device, q.dtype, d)
        out[f"flash_{name}_route"] = path
        out[f"flash_{name}_ms"] = cs.device_ms(
            lambda: ops.flash_attention(q, k, v), 20 if path == "tc" else 5,
            FLASH_KERNELS[path])
        del q, k, v
    return out


def outer_shapes(cs) -> dict:
    """Device time of the tree's segment-outer kernels for one call of
    ``ops.segment_outer`` at the chip_smoke.py line's shape, on uniform
    and powerlaw dst (the same draws as that line), in float32 and bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_outer import block_tile_starts
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    n = cs.OUTER_NODES
    e_real = round(n * cs.OUTER_DEGREE)
    e = -(-e_real // cs.OUTER_TE) * cs.OUTER_TE
    msg = torch.randn((e, cs.OUTER_C), generator=g, device="cuda")
    basis = torch.randn((e, cs.OUTER_M), generator=g, device="cuda")
    msg[e_real:] = 0
    basis[e_real:] = 0
    out = {}
    for dist in ("uniform", "powerlaw"):
        dst, _ = cs.outer_dst(g, dist, n, e_real, e)
        bt, n_tiles = block_tile_starts(dst.cpu().numpy(), n, cs.OUTER_BN,
                                        cs.OUTER_TE)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            mm, bb = msg.to(dtype), basis.to(dtype)

            def call():
                return ops.segment_outer(mm, bb, dst, bt, n, n_tiles,
                                         cs.OUTER_BN, cs.OUTER_TE)

            key = f"outer_{dist}_{name}_ms"
            try:
                call()
            except ValueError as err:  # a tree that takes float32 only
                out[key] = f"refused: {err}"
                continue
            out[key] = cs.device_ms(call, 5, *cs.OUTER_KERNELS)
            del mm, bb
    del msg, basis
    e, hot = 1 << 17, 1024
    dst = torch.sort(torch.randint(0, hot, (e,), generator=g,
                                   device="cuda")).values.int()
    mm = torch.randn((e, cs.OUTER_C), generator=g, device="cuda")
    bb = torch.randn((e, cs.OUTER_M), generator=g, device="cuda")
    bt, n_tiles = block_tile_starts(dst.cpu().numpy(), n, cs.OUTER_BN,
                                    cs.OUTER_TE)
    out["outer_gap_f32_ms"] = cs.device_ms(
        lambda: ops.segment_outer(mm, bb, dst, bt, n, n_tiles, cs.OUTER_BN,
                                  cs.OUTER_TE), 5, *cs.OUTER_KERNELS)
    del mm, bb, dst
    torch.cuda.empty_cache()
    return out


def stablelm_prefill(cs) -> dict:
    """stablelm-3b at full width and depth in bf16: one 4 x 2048 prefill
    after a warm-up, timed to ``synchronize``, its flash launches, and one
    prefill profiled (``chip_smoke.gpu_profile``)."""
    import torch
    from repro_torch.configs import STABLELM_3B as cfg
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = tfm.init_params(cfg, g, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (cs.LM_BATCH, cs.LM_PROMPT),
                           generator=g, device="cuda")
    ml = cs.LM_PROMPT + cs.LM_DECODE
    tfm.prefill(params, tokens[:, :128], cfg, max_len=ml)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    tfm.prefill(params, tokens, cfg, max_len=ml)
    torch.cuda.synchronize()
    out = {"stablelm_prefill_s": time.perf_counter() - t0,
           "stablelm_prefill_launches": {
               k: n for k, n in build.LAUNCHES.items() if n}}
    prof = cs.gpu_profile(lambda: tfm.prefill(params, tokens, cfg,
                                              max_len=ml),
                          f"prefill {cfg.name} {cs.LM_BATCH}x{cs.LM_PROMPT}")
    print(json.dumps(prof), flush=True)
    out["stablelm_prefill_profiled"] = {
        k: prof[k] for k in ("wall_s", "device_busy_s", "idle_share",
                             "device_s", "share")}
    del params
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
