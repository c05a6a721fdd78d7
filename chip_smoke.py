"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,join,lm]

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes
(exact equality for the join kernels; 2e-2 for bf16 and 2e-5 for f32
flash attention, 2e-4 for the segment outer product) and times both,
with the one PyTorch call that computes the same function where there
is one (``torch.searchsorted``, ``scaled_dot_product_attention``).  A
kernel's ``ms`` is its device time from ``torch.profiler``; ``event_ms``
is the CUDA-event time of back-to-back wrapper calls, host dispatch
included.  The searchsorted kernel is also held exactly on the inputs
that leave its shared-memory path (a segment past its staging capacity,
lo > hi, bounds outside [0, M], per-lane bounds, narrow widths).  The
tile mask and the bitset mask are timed in both their contracts, every
lane and ``lane_len`` (the live lanes the level step passes), and held
exactly on their own edge cases.  Flash attention has two kernels,
routed by dtype and head dim: bf16 with D a multiple of 16 up to 128 on
wgmma (``flash_attention_tc``: chatglm3-6b's and stablelm-3b's prefill
shapes, the mma.sync kernel and SDPA on the same tensors, and a bf16
sweep over D 16-128, GQA groups, causal offsets, short and ragged
streams and strided views) and the rest on mma.sync
(``flash_attention_mma``: f32 in 3xTF32 at the path shape and the f32
sweep, bf16 at D 72, 40 and 8 at stablelm-3b's shape, and a sweep of
off-grid head dims in both dtypes, strided and offset views among
them).  The two lines count the ``HGMMA`` and ``HMMA`` instructions in
the built library's SASS where ``cuobjdump`` exists.  The segment outer
product runs at MACE's widths (131,072 nodes, 6,621,401 edges, C 128,
M 9) on uniform and powerlaw destinations, in float32 and bf16 (each
held at 2e-4 on the same tensors: bf16 products round alike), two calls
bit-identical, its time the sum of its three kernels (the pass over
edge ranges, the merge of partial rows, the zero rows of edgeless
nodes), beside its pre-redesign time; then on its edge cases (one node,
one edge per node, empty nodes, hubs on range boundaries, E = te, all
padding, wide and narrow C and M in f32, bf16 and f16, mixed types, and
130,048 edgeless nodes among 131,072, timed beside its bound).
Then it drives the port's paths on the
``soc-Slashdot0811``-like graph (77,360 nodes, 1,778,854 directed edges)
as a plain ``GraphDB`` and as a ``HybridGraphDB``, each path with the
kernels' launch counters set to 0 just before it and read just after:

* ``count`` with ``engine="auto"`` for the six tier-1 graph patterns in
  the default ``bsearch`` check mode, on both dbs;
* the same twelve counts with ``check_mode="auto"`` (``tile_width``
  512), which must equal them and send rows down both the tile and the
  binary-search path; then the plain 4-cycle in ``bsearch`` and
  ``auto`` in turns, and its ``auto`` count profiled (the plain
  4-cycle's ``bsearch`` count and the hybrid one's, with its bitset
  launches, are profiled after the main path);
* the 3-clique, 4-clique and 4-cycle in ``check_mode="tile"`` (width
  2048, above the max degree) and ``"bsearch2"`` on the plain db;
* ``stream`` of those three in ``tile`` mode, every row checked on the
  host with numpy alone, and the factorized 3-clique;
* ``oracles``: Tables 6 and 7 of the JAX package's benchmarks rebuilt
  with the port (``make_snap_like`` graphs at scale 0.25 and 0.15, unary
  samples at selectivity 8 and 80), every count made with the default
  ``verify=True`` and held to its record in ``BENCH_baseline.json``: the
  cyclic shapes with ``vlftj`` and ``hybrid`` on the card and ``binary``
  on the host (cap 20,000,000), the acyclic ones with ``yannakakis`` and
  ``vlftj`` on the card and ``binary`` (whose two 4-path blowups must
  give the recorded rows), the 2-tree with ``yannakakis`` alone; the
  scalar oracles ``lftj_ref`` and ``minesweeper_ref`` count the cyclic
  shapes on ca-GrQc to the records (in a child process that runs beside
  the card paths, on the host CSR), and the 3-clique's rows from
  ``lftj_ref``, ``minesweeper_ref``, ``binary`` and ``vlftj`` on the
  card are identical arrays; then the plan verifier on the six shapes'
  ``auto`` plans on both full-scale dbs (no error, no launch, its cold
  and memoized times) and a plan whose GAO repeats a variable, which
  ``count`` must reject with V101 before any launch;
* chatglm3-6b and stablelm-3b served at full width and depth in bf16
  (``lm serve``): 4 requests of 2048 prompt tokens, prefill (one launch
  of the wgmma flash kernel a layer, 28 and 32, none of the mma.sync
  one) and 32 greedy decode steps, then one prefill profiled;
  and each at full width with 2 layers in f32 (``lm parity``, on the
  mma.sync flash kernel) the card's prefill and decode logits against
  the port's CPU path (1e-3) and decode against ``forward`` over the
  concatenated stream (2e-4).

The counts are checked against counts made on the host with scipy and
numpy alone (the cliques, 3-path and lollipops), across the two dbs
where the filters are renumbering invariant, and 3-path and the
2-lollipop against ``engine="vlftj"``.  At 5% scale every shape but the
3-lollipop is enumerated on the card and on the port's plain CPU path,
and the arrays must be identical (the 3-lollipop's 725,940,260 rows are
too many to materialize; its counts are compared instead).  Any failure
raises and exits non-zero.

Needs one CUDA device and the rest of the repository; it imports nothing
of JAX.  Prints one JSON line per shape and path, a ``kernels`` JSON
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset (the
kernels against their plain versions, the join paths, the LM paths, or
``oracles``, the last part of the join paths alone) and then prints
neither the ``kernels`` line nor the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SHAPES = ("3-clique", "4-clique", "4-cycle", "3-path", "2-lollipop",
          "3-lollipop")
CYCLIC = ("3-clique", "4-clique", "4-cycle")
#: the cyclic patterns as their edges and ``<`` filters (variable pairs),
#: for checking streamed rows on the host
PATTERNS = {"3-clique": ("ab ac bc", "ab bc"),
            "4-clique": ("ab ac ad bc bd cd", "ab bc cd"),
            "4-cycle": ("ab bc cd da", "ab bc cd")}
DATASET, SEED, SELECTIVITY = "soc-Slashdot0811", 0, 8.0
SMALL_SCALE = 0.05
#: shapes enumerated at SMALL_SCALE (the 3-lollipop's output is too big)
ENUM_SHAPES = SHAPES[:-1]
#: check_mode="auto"'s tile width on the main path, and the tile width of
#: the tile-only runs (at least the max degree, 1,577, so nothing is cut)
TILE_WIDTH, FULL_TILE_WIDTH = 512, 2048
INT32_MAX = 2 ** 31 - 1
#: H100 SXM peaks.  HBM bytes/s from NVIDIA's data sheet.  The data sheet
#: gives no int32 rate: its 67 TFLOP/s fp32 is 132 SMs x 128 FMA lanes x
#: 2 FLOP x 1.98 GHz, and the CUDA C++ Programming Guide's arithmetic
#: throughput table gives compute capability 9.0 64 results per clock
#: per SM for 32-bit integer add, compare, min/max, shift and logic
#: (against 128 for fp32), so int32 ops peak at 67e12 / 4 per second.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
#: floating-point peaks from the same data sheet: dense bf16 and TF32 on
#: the tensor cores, and float32 on the CUDA cores
PEAK_FLOPS_S = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
#: the LM phases: chatglm3-6b and stablelm-3b served at full width and
#: depth (4 requests of 2048 prompt tokens, 32 greedy decode steps), and
#: their f32 parity checks at full width and 2 layers (card against the
#: port's CPU path)
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
PARITY_LAYERS, PARITY_PROMPT, PARITY_STEPS = 2, 256, 4
#: the decode-vs-forward check's prompt: forward then runs over 125..127
#: tokens, lengths the flash kernel takes (the Pallas kernel's contract
#: asks T % min(128, T) == 0, so 257..259 are refused)
PARITY_FORWARD_PROMPT = 124
#: the segment-outer line at MACE's widths (d_hidden 128, l_max 2 -> 9
#: basis functions) on 131,072 nodes at ogb_products' mean directed degree
#: (123,718,280 / 2,449,029), in node blocks of 8 and edge tiles of 128
OUTER_NODES, OUTER_C, OUTER_M, OUTER_BN, OUTER_TE = 131072, 128, 9, 8, 128
OUTER_DEGREE = 123718280 / 2449029


#: the flash kernel's time at the path shape before its redesign, measured
#: by this script with CUDA events on an NVIDIA H100 80GB HBM3 at 700 W
#: (the PERF.md kernel table), printed beside this run's as ``previous_ms``
PREVIOUS_FLASH_MS = 8.725
#: the tile mask's device time at its line's chunk (every lane) before its
#: redesign, by this script on an NVIDIA H100 80GB HBM3 at 700 W (the
#: PERF.md kernel table), printed beside this run's as ``previous_ms``
PREVIOUS_TILE_MS = 0.0315
#: the bitset kernels' device times at their lines' chunk before their
#: redesign (the mask every lane, and the count form), and the CUDA-core
#: flash kernel's before the mma.sync design (f32 at the path shape, bf16
#: at stablelm-3b's prefill shape), all by this script on an NVIDIA H100
#: 80GB HBM3 at 700 W (the PERF.md kernel table), printed as
#: ``previous_ms``
PREVIOUS_BITSET_MASK_MS = 0.0194
PREVIOUS_BITSET_COUNT_MS = 0.0053
PREVIOUS_SIMT_F32_MS = 8.832
PREVIOUS_SIMT_BF16_MS = 5.330
#: the segment outer product's device time before its redesign (f32 at
#: MACE's widths, uniform and powerlaw dst), by this script on an NVIDIA
#: H100 80GB HBM3 at 700 W (the PERF.md kernel table), printed as
#: ``previous_ms``
PREVIOUS_OUTER_MS = {"uniform": 8.265, "powerlaw": 128.2}
#: the segment outer product's kernel functions: the pass over the edge
#: ranges, the merge of partial rows and the zero rows of edgeless nodes
OUTER_KERNELS = ("segment_outer_kernel", "segment_outer_merge_kernel",
                 "segment_outer_gap_kernel")


#: what a run drives, in order: the kernels against their plain versions,
#: the join paths, the LM paths
PHASES = ("kernels", "join", "lm")
#: the join path's kernel functions, reported by name in count profiles
PORT_JOIN_KERNELS = ("searchsorted_segments_kernel", "tile_member_mask_kernel",
                     "bitset_member_mask_kernel")


#: the ``oracles`` phase: Tables 6 and 7 of the JAX package's benchmarks
#: (``benchmarks/bench_cyclic.py`` and ``bench_acyclic.py``, quick mode)
#: rebuilt with the port, their counts held against the records of
#: ``BENCH_baseline.json``; ``binary`` gives up past ``BINARY_CAP`` rows
BASELINE = "BENCH_baseline.json"
T6_DATASETS = ("ca-GrQc", "wiki-Vote", "ego-Facebook", "p2p-Gnutella04")
T6_SCALE = 0.25
T7_DATASETS = ("ca-GrQc", "wiki-Vote")
T7_SHAPES = ("3-path", "4-path", "1-tree", "2-comb")
T7_SCALE, T7_SELECTIVITIES = 0.15, (8, 80)
BINARY_CAP = 20_000_000
#: the scalar oracles' graph (Table 6's ca-GrQc) and the engines whose
#: 3-clique enumerations must be identical
ORACLE_DATASET = "ca-GrQc"
ENUM_ENGINES = ("lftj_ref", "minesweeper_ref", "binary", "vlftj")


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def bench_gdb(T, scale: float, device: str):
    """The benchmark graph with unary samples as the JAX package's
    ``benchmarks/common.py`` ``bench_gdb`` makes them, as a plain and a
    hybrid db."""
    from repro_torch.graphs import make_snap_like, node_sample
    g = make_snap_like(DATASET, seed=SEED, scale=scale)
    unary = {f"v{i}": node_sample(g.n_nodes, SELECTIVITY, seed=17 * i + 1)
             for i in range(1, 5)}
    return g, T.GraphDB(g, unary, device=device), \
        T.HybridGraphDB.build(g, unary, device=device)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(e) -> float:
    """Device time of a ``torch.profiler`` event, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def device_ms(fn, reps: int, kernel: str, *more: str) -> float:
    """Device time of one launch of the CUDA kernel named ``kernel`` (its
    function name in ``csrc/``), from ``torch.profiler`` over ``reps``
    calls of ``fn``: the kernel's own time, averaged over the launches
    the profiler recorded, without the host's dispatch between launches
    that ``cuda_ms`` includes when a call's host work outlasts its kernel.
    The kernels named in ``more`` (launched with it, as a second pass)
    add their time to it.  Fails if the profiler records no launch of
    ``kernel``, twice."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def named(e, names):
        return any(f"::{k}(" in e.key or f"::{k}<" in e.key for k in names)

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        n = sum(e.count for e in events if named(e, (kernel,)))
        if n:
            return sum(device_us(e) for e in events
                       if named(e, (kernel, *more))) / 1e3 / n
    raise SmokeFailure(f"the profiler recorded no launch of {kernel}")


def level_inputs(db, rng, rows: int, hubs_only: bool,
                 max_degree: int | None = None):
    """One level-step chunk as the engine builds it: ``rows`` random
    directed edges (x, y); candidates are the shorter endpoint's segment
    padded to the executor width, checked against the other endpoint.
    ``max_degree`` keeps the edges whose endpoints both have at most that
    degree: the rows ``check_mode="auto"`` sends down the tile path."""
    csr = db.csr
    src = np.repeat(np.arange(csr.n_nodes), csr.degrees)
    eids = np.arange(csr.indices.shape[0])
    if hubs_only:
        eids = eids[(src < db.n_hubs) & (csr.indices < db.n_hubs)]
    if max_degree is not None:
        eids = eids[(csr.degrees[src[eids]] <= max_degree)
                    & (csr.degrees[csr.indices[eids]] <= max_degree)]
    e = rng.choice(eids, size=rows, replace=False)
    x, y = src[e], csr.indices[e]
    swap = csr.degrees[y] < csr.degrees[x]
    probe, check = np.where(swap, y, x), np.where(swap, x, y)
    width = max(8, 1 << (csr.max_degree - 1).bit_length())
    idx = csr.indptr[probe][:, None] + np.arange(width)[None, :]
    cand = csr.indices[np.clip(idx, 0, csr.indices.shape[0] - 1)]
    return (cand.astype(np.int32), check,
            csr.degrees[probe].astype(np.int32))


def search_work(values, lo, hi, q, n_iter: int) -> tuple[int, int]:
    """What one searchsorted launch needs on these inputs: the number of
    distinct positions of ``values`` read by its active rounds (l < h)
    and its final probes (pos < hi), and the active rounds summed over
    lanes.  Inactive rounds change nothing, so they are not counted."""
    import torch
    m = values.shape[0]
    h0 = hi.long().expand(q.shape)
    l, h = lo.long().expand(q.shape).clone(), h0.clone()
    touched = torch.zeros(m, dtype=torch.bool, device=q.device)
    rounds = 0
    for _ in range(n_iter):
        active = l < h
        mid = (l + h) >> 1
        touched[mid[active]] = True
        right = active & (values[mid.clamp(0, m - 1)] < q)
        l = torch.where(right, mid + 1, l)
        h = torch.where(active & ~right, mid, h)
        rounds += int(active.sum())
    touched[l[l < h0]] = True
    return int(touched.sum()), rounds


def distinct_words(n_words: int, row, cand) -> int:
    """Distinct bitset words that lanes ``cand`` of rows ``row`` read
    (``row`` broadcast against ``cand``)."""
    import torch
    key = row.long() * n_words + (cand >> 5).long()
    return int(torch.unique(key).numel())


def lower_bound_rounds(seg, n, q, lane_ok) -> int:
    """Rounds of the ``while (l < h)`` lower-bound loop that the
    intersect.cu kernels run on these inputs, summed over the lanes where
    ``lane_ok``: each lane searches ``q`` in the first ``n[r]`` values of
    its row of ``seg``."""
    import torch
    h = n.long()[:, None].expand(q.shape).clone()
    l = torch.zeros_like(h)
    rounds = 0
    while True:
        active = (l < h) & lane_ok
        k = int(active.sum())
        if k == 0:
            return rounds
        rounds += k
        mid = (l + h) >> 1
        right = active & (seg.gather(1, mid.clamp(0, seg.shape[1] - 1)) < q)
        l = torch.where(right, mid + 1, l)
        h = torch.where(active & ~right, mid, h)


def halving_rounds(n, live) -> int:
    """Rounds of the fixed-step lower bound that the tile mask runs,
    summed over the searched lanes: ceil(log2 n[r]) for each of the
    ``live[r]`` lanes of a row that stages n[r] >= 1 values."""
    k = (n.long() - 1).clamp(min=0)
    steps = k.new_zeros(k.shape)
    while bool((k > 0).any()):
        steps += (k > 0).long()
        k = k >> 1
    return int((steps * live.long().clamp(min=0)).sum())


def bound(k: dict) -> dict:
    """The larger of bytes over the HBM rate and the operations over their
    peak rate — int32 ops (``ops``) at the int32 rate, or floating-point
    operations (``flops``) at the peak of their type (``flops_type``) —
    and which of the two it is.  The peaks used are printed with it."""
    t_bytes = k["bytes"] / PEAK_BYTES_S
    if "flops" in k:
        k["peak_flops_s"] = PEAK_FLOPS_S[k["flops_type"]]
        t_ops = k["flops"] / k["peak_flops_s"]
    else:
        k["peak_int32_ops_s"] = PEAK_INT32_OPS_S
        t_ops = k["ops"] / PEAK_INT32_OPS_S
    k["peak_bytes_s"] = PEAK_BYTES_S
    k["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


def searchsorted_edges(values, lo, hi, q, n_iter: int) -> dict:
    """``searchsorted_segments`` exactly against its plain version on the
    inputs that leave the shared-memory path: a segment longer than the
    kernel's staging capacity (8,192 values), also with too few rounds to
    finish; lo > hi; lo < 0 and hi > M; per-lane (R, W) bounds; narrow
    widths, where a block holds several rows (and the rows' segments
    together overflow the capacity).  Returns the found count per case."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = q.device
    g = torch.Generator(device=dev).manual_seed(SEED)
    m = values.shape[0]
    n_long = 20000
    long_v = torch.sort(torch.randint(0, 1 << 20, (n_long,), generator=g,
                                      device=dev)).values.int()
    q_long = torch.randint(0, 1 << 20, (16, 512), generator=g, device=dev,
                           dtype=torch.int32)
    z = torch.zeros((16, 1), dtype=torch.int32, device=dev)
    lo_gt, hi_gt = lo.clone(), hi.clone()
    lo_gt[::3] = hi_gt[::3] + 5
    lo_out, hi_out = lo.clone(), hi.clone()
    lo_out[::4] = -7
    hi_out[1::4] = m + 100
    hi_out[2::4] = m
    lo_lane = (lo + torch.randint(0, 3, q.shape, generator=g, device=dev,
                                  dtype=torch.int32)).contiguous()
    hi_lane = torch.maximum(lo_lane, hi - torch.randint(
        0, 3, q.shape, generator=g, device=dev, dtype=torch.int32))
    cases = {"segment above capacity": (long_v, z, z + n_long, q_long, 16),
             "segment above capacity, 6 rounds": (long_v, z, z + n_long,
                                                  q_long, 6),
             "lo > hi": (values, lo_gt, hi_gt, q, n_iter),
             "lo < 0, hi > M": (values, lo_out, hi_out, q, n_iter),
             "per-lane (R, W) bounds": (values, lo_lane, hi_lane, q, n_iter)}
    for w in (1, 3, 8, 40, 256, 600):
        cases[f"W {w}"] = (values, lo, hi, q[:, :w].contiguous(), n_iter)
    found = {}
    for name, args in cases.items():
        pos, hit = ops.searchsorted_segments(*args)
        torch.cuda.synchronize()
        pos_ref, hit_ref = ref.searchsorted_segments_ref(*args)
        need(torch.equal(pos, pos_ref) and torch.equal(hit, hit_ref),
             f"searchsorted_segments ({name}) disagrees with its plain "
             "version")
        found[name] = int(hit.sum())
    return found


def tile_edges(values, indptr, lo, hi, q, lanes) -> dict:
    """``tile_member_mask`` exactly against its plain version on inputs
    off the level step's path: widths that are not a multiple of 8 (one
    lane at a time) and a candidate pointer off 16 bytes, a row of more
    than one 512-lane slice, lane_len above W and negative, check widths
    that cut segments (7) or stage nothing (0), one so wide that a warp
    gets one buffer (40,000), lo > hi, and lo < 0 with hi > M (windows
    inside the first and the last CSR segment, so that the clamped values
    stay sorted, as the mask requires).  Returns the found count per
    case."""
    import torch
    from repro_torch.kernels import ops, ref
    m = values.shape[0]
    r, w = q.shape
    lo_gt, hi_gt = lo.clone(), hi.clone()
    lo_gt[::3] = hi_gt[::3] + 5
    lo_out, hi_out = lo.clone(), hi.clone()
    lo_out[::4], hi_out[::4] = -7, int(indptr[1])
    lo_out[1::4], hi_out[1::4] = int(indptr[-2]), m + 100
    wild = lanes.clone()
    wild[::2] = w + 77
    wild[1::4] = -3
    flat = torch.empty(r * w + 1, dtype=torch.int32, device=q.device)
    flat[1:] = q.reshape(-1)
    off16 = flat[1:].view(r, w)
    cases = {"lo > hi": (lo_gt, hi_gt, q, 512, lanes),
             "lo < 0, hi > M": (lo_out, hi_out, q, 512, lanes),
             "lane_len above W and negative": (lo, hi, q, 512, wild),
             "check_width 7": (lo, hi, q, 7, None),
             "check_width 0": (lo, hi, q, 0, lanes),
             "check_width 40000": (lo, hi, q[:64, :64].contiguous(), 40000,
                                   None),
             "cand off 16 bytes": (lo, hi, off16, 512, lanes)}
    for width in (3, 44, 601):
        cases[f"W {width}"] = (lo, hi, q[:, :width].contiguous(), 512,
                               lanes.clamp(max=width - 2))
    found = {}
    for name, (lo_, hi_, q_, cw, lane_len) in cases.items():
        rows = q_.shape[0]
        args = (values, lo_[:rows], hi_[:rows], q_, cw,
                None if lane_len is None else lane_len[:rows].contiguous())
        hit = ops.tile_member_mask(*args)
        torch.cuda.synchronize()
        need(torch.equal(hit, ref.tile_member_mask_ref(*args)),
             f"tile_member_mask ({name}) disagrees with its plain version")
        found[name] = int(hit.sum())
    return found


def bitset_edges(words, row, cand, lanes) -> dict:
    """``bitset_member_mask`` exactly against its plain version off the
    level step's path: widths that are not a multiple of 8 (a lane a
    thread: 3 and 601) and one that is (40, less than a warp's 256-lane
    slice), a candidate pointer off 16 bytes, lane_len above W
    and negative, rows out of range (negative and past H), and candidates
    negative and past NW x 32 (clamped to the first and the last word).
    Both contracts in every case.  Returns the found count per case."""
    import torch
    from repro_torch.kernels import ops, ref
    h, nw = words.shape
    r, w = cand.shape
    wild = lanes.clone()
    wild[::2] = w + 77
    wild[1::4] = -3
    bad_row = row.clone()
    bad_row[::3] = -5
    bad_row[1::3] = h + 9
    bad_cand = cand.clone()
    bad_cand[:, ::3] = -cand[:, ::3] - 1
    bad_cand[:, 1::3] += 32 * nw
    flat = torch.empty(r * w + 1, dtype=torch.int32, device=cand.device)
    flat[1:] = cand.reshape(-1)
    off16 = flat[1:].view(r, w)
    cases = {"lane_len above W and negative": (row, cand, wild),
             "rows out of range": (bad_row, cand, lanes),
             "cand negative and past NW x 32": (row, bad_cand, lanes),
             "cand off 16 bytes": (row, off16, lanes)}
    for width in (3, 40, 601):
        cases[f"W {width}"] = (row, cand[:, :width].contiguous(),
                               lanes.clamp(max=width - 2))
    found = {}
    for name, (row_, cand_, lane_len) in cases.items():
        for ll in (None, lane_len):
            hit = ops.bitset_member_mask(words, row_, cand_, ll)
            torch.cuda.synchronize()
            need(torch.equal(hit, ref.bitset_member_mask_ref(
                words, row_, cand_, ll)), f"bitset_member_mask ({name}, "
                 f"lane_len {'given' if ll is not None else 'none'}) "
                 "disagrees with its plain version")
            found[name if ll is not None else f"{name}, every lane"] = int(
                hit.sum())
    return found


def kernel_phase(T, db, hdb):
    """Each kernel against its plain version at the main path's shapes,
    on the same CUDA tensors; then both timed."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = db.device
    rng = np.random.default_rng(SEED)
    out = {}

    # searchsorted_segments: R = chunk rows, W = executor width
    cand, check, _ = level_inputs(db, rng, 2048, hubs_only=False)
    indptr = db.csr.indptr
    values = db.dev("indices")
    q = torch.from_numpy(cand).to(dev)
    lo = torch.from_numpy(indptr[check][:, None].astype(np.int32)).to(dev)
    hi = torch.from_numpy(indptr[check + 1][:, None].astype(np.int32)).to(dev)
    n_iter = db.bsearch_iters
    pos, found = ops.searchsorted_segments(values, lo, hi, q, n_iter)
    torch.cuda.synchronize()
    pos_ref, found_ref = ref.searchsorted_segments_ref(values, lo, hi, q,
                                                       n_iter)
    err = max(int((pos - pos_ref).abs().max()),
              int((found.int() - found_ref.int()).abs().max()))
    need(err == 0, f"searchsorted_segments disagrees with its plain version "
         f"(max abs err {err})")
    r, w = q.shape
    probed, rounds = search_work(values, lo, hi, q, n_iter)
    # the library call: torch.searchsorted on the same segments gathered
    # into (R, max length) rows padded with INT32_MAX (gathered once, not
    # timed), as the tile kernel's line times it
    n_seg = (hi - lo)[:, 0]
    width = int(n_seg.max())
    j2 = torch.arange(width, device=dev)
    segs = torch.where(j2[None] < n_seg[:, None],
                       values[(lo + j2[None]).clamp(0, values.shape[0] - 1)],
                       INT32_MAX).to(torch.int32).contiguous()
    lib_pos = torch.searchsorted(segs, q)
    need(torch.equal(lib_pos.int() + lo, pos),
         "torch.searchsorted disagrees with searchsorted_segments")
    edges = searchsorted_edges(values, lo, hi, q, n_iter)
    out["searchsorted_segments"] = dict(
        source="src/repro_torch/csrc/searchsorted.cu",
        replaces="src/repro/kernels/searchsorted.py:55",
        shape=f"values ({values.shape[0]},) int32, queries ({r}, {w}), "
              f"n_iter {n_iter}",
        max_abs_err=err, found=int(found.sum()),
        ms=device_ms(lambda: ops.searchsorted_segments(
            values, lo, hi, q, n_iter), 50,
                     "searchsorted_segments_kernel"),
        event_ms=cuda_ms(lambda: ops.searchsorted_segments(
            values, lo, hi, q, n_iter), 50),
        plain_ms=cuda_ms(lambda: ref.searchsorted_segments_ref(
            values, lo, hi, q, n_iter), 10),
        edge_cases=edges,
        values_read=probed, active_rounds=rounds,
        ops_model="3 int32 ops per active round (index add, compare, "
                  "select; the probe is a load) + 3 per lane (pos = lo + l, "
                  "the in-window and the equality compare)",
        bytes=4 * probed + lo.nbytes + hi.nbytes + q.nbytes + pos.nbytes
        + found.nbytes,
        ops=3 * rounds + 3 * r * w,
        library_ms=cuda_ms(lambda: torch.searchsorted(segs, q), 50),
        library_call=f"torch.searchsorted(segs, queries), segs the gathered "
                     f"INT32_MAX-padded ({r}, {width}) segments")

    # bitset_member_mask: the hub-only rows of a hybrid-db chunk, in both
    # contracts: every lane, and lane_len = the probe degrees (the live
    # lanes, as the level step passes them)
    cand, check, deg = level_inputs(hdb, rng, 2048, hubs_only=True)
    words = hdb.dev("bitset_words")
    row = hdb.dev("rep_tag")[torch.from_numpy(check).to(dev)]
    qh = torch.from_numpy(cand).to(dev)
    lanes = torch.from_numpy(deg).to(dev)
    mask = ops.bitset_member_mask(words, row, qh)
    mask_live = ops.bitset_member_mask(words, row, qh, lanes)
    torch.cuda.synchronize()
    mask_ref = ref.bitset_member_mask_ref(words, row, qh)
    err = max(int((mask.int() - mask_ref.int()).abs().max()),
              int((mask_live.int() - ref.bitset_member_mask_ref(
                  words, row, qh, lanes).int()).abs().max()))
    need(err == 0, f"bitset_member_mask disagrees with its plain version "
         f"(max abs err {err})")
    r, w = qh.shape
    lane_ok = torch.arange(w, device=dev)[None] < lanes[:, None]
    need(torch.equal(mask_live, mask & lane_ok), "bitset_member_mask with "
         "lane_len is not the every-lane mask ANDed with j < lane_len")
    n_words = words.shape[1]
    edges = bitset_edges(words, row, qh, lanes)

    def mask_work(live, lane_len_bytes):
        """Bytes and int32 ops the mask needs when ``live`` lanes of each
        row are tested: their candidates and the distinct words they hit
        read once, the whole mask written once, row and lane_len read."""
        ok = torch.arange(w, device=dev)[None] < live[:, None]
        n_live = int(ok.sum())
        lane_row = row[:, None].expand(r, w)
        words_read = distinct_words(n_words, lane_row[ok], qh[ok])
        return dict(live_lanes=n_live, live_share=n_live / (r * w),
                    words_read=words_read,
                    ops_model="6 int32 ops per live lane (shift, 2 clamps, "
                              "and, shift, and) + 4 per row (2 clamps each "
                              "of row and lane_len)",
                    bytes=4 * n_live + 4 * words_read + row.nbytes
                    + mask.nbytes + lane_len_bytes,
                    ops=6 * n_live + 4 * r)

    all_lanes = bound(dict(
        ms=device_ms(lambda: ops.bitset_member_mask(words, row, qh), 50,
                     "bitset_member_mask_kernel"),
        event_ms=cuda_ms(lambda: ops.bitset_member_mask(words, row, qh), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_member_mask_ref(words, row, qh),
                         10),
        previous_ms=PREVIOUS_BITSET_MASK_MS,
        **mask_work(torch.full_like(lanes, w), 0)))
    out["bitset_member"] = dict(
        source="src/repro_torch/csrc/bitset_member.cu",
        replaces="src/repro/kernels/intersect_bitset.py:103",
        shape=f"words {tuple(words.shape)} int32, cand ({r}, {w}), lane_len "
              f"the probe degrees",
        max_abs_err=err, found=int(mask_live.sum()),
        ms=device_ms(lambda: ops.bitset_member_mask(words, row, qh, lanes),
                     50, "bitset_member_mask_kernel"),
        event_ms=cuda_ms(lambda: ops.bitset_member_mask(words, row, qh,
                                                        lanes), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_member_mask_ref(words, row, qh,
                                                            lanes), 10),
        all_lanes=all_lanes, edge_cases=edges,
        distinct_rows=int(torch.unique(row).numel()),
        library_ms=None, library_call="none: no single PyTorch call",
        **mask_work(lanes, lanes.nbytes))

    # the standalone per-row count entry point of the same kernel source
    wrows = words[row.long()].contiguous()
    blen = lanes
    cnt = ops.bitset_member_count(wrows, qh, blen)
    torch.cuda.synchronize()
    cnt_ref = ref.bitset_member_count_ref(wrows, qh, blen)
    err = int((cnt - cnt_ref).abs().max())
    need(err == 0, f"bitset_member_count disagrees with its plain version "
         f"(max abs err {err})")
    need(torch.equal(cnt.long(), mask_live.sum(dim=1)),
         "bitset_member_count disagrees with bitset_member_mask's row sums")
    lane_row = torch.arange(r, device=dev)[:, None].expand(r, w)
    count_words = distinct_words(n_words, lane_row[lane_ok], qh[lane_ok])
    n_valid = int(lane_ok.sum())
    out["bitset_member_count"] = dict(
        source="src/repro_torch/csrc/bitset_member.cu",
        replaces="src/repro/kernels/intersect_bitset.py:103",
        shape=f"words {tuple(wrows.shape)} int32, b ({r}, {w})",
        max_abs_err=err, hits=int(cnt.sum()),
        ms=device_ms(lambda: ops.bitset_member_count(wrows, qh, blen), 50,
                     "bitset_member_count_kernel"),
        event_ms=cuda_ms(lambda: ops.bitset_member_count(wrows, qh, blen), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_member_count_ref(
            wrows, qh, blen), 10),
        previous_ms=PREVIOUS_BITSET_COUNT_MS,
        valid_lanes=n_valid, words_read=count_words,
        ops_model="7 int32 ops per valid lane (shift, 2 clamps, and, "
                  "shift, and, add)",
        bytes=4 * count_words + 4 * n_valid + blen.nbytes + cnt.nbytes,
        ops=7 * n_valid, library_ms=None)
    return {name: bound(k) for name, k in out.items()}


def kernel_phase_intersect(T, db, hdb):
    """The tile-intersection kernels (mask and count form) and the bitset
    AND-popcount against their plain versions on the same CUDA tensors,
    at the main path's shapes; then all timed."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = db.device
    rng = np.random.default_rng(SEED + 1)
    out = {}

    # tile_member_mask: 2048 rows that auto sends down the tile path, in
    # both contracts: every lane, and lane_len = the probe degrees (the
    # live lanes, as the level step passes them)
    cand, check, deg = level_inputs(db, rng, 2048, hubs_only=False,
                                    max_degree=TILE_WIDTH)
    indptr = db.csr.indptr
    values = db.dev("indices")
    m = values.shape[0]
    q = torch.from_numpy(cand).to(dev)
    lo = torch.from_numpy(indptr[check][:, None].astype(np.int32)).to(dev)
    hi = torch.from_numpy(indptr[check + 1][:, None].astype(np.int32)).to(dev)
    lanes = torch.from_numpy(deg).to(dev)
    cw = TILE_WIDTH
    mask = ops.tile_member_mask(values, lo, hi, q, cw)
    mask_live = ops.tile_member_mask(values, lo, hi, q, cw, lanes)
    torch.cuda.synchronize()
    mask_ref = ref.tile_member_mask_ref(values, lo, hi, q, cw)
    err = max(int((mask.int() - mask_ref.int()).abs().max()),
              int((mask_live.int() - ref.tile_member_mask_ref(
                  values, lo, hi, q, cw, lanes).int()).abs().max()))
    need(err == 0, f"tile_member_mask disagrees with its plain version "
         f"(max abs err {err})")
    r, w = q.shape
    lane_ok = torch.arange(w, device=dev)[None] < lanes[:, None]
    need(torch.equal(mask_live, mask & lane_ok), "tile_member_mask with "
         "lane_len is not the all-lane mask ANDed with j < lane_len")
    edges = tile_edges(values, indptr, lo, hi, q, lanes)
    # each row's staged segment, padded with INT32_MAX: the library call's
    # sorted rows and the count form's B (gathered once, not timed)
    n = (hi - lo)[:, 0].clamp(0, cw)
    j2 = torch.arange(cw, device=dev)
    segs = torch.where(j2[None] < n[:, None],
                       values[(lo + j2[None]).clamp(0, m - 1)],
                       INT32_MAX).to(torch.int32).contiguous()
    library_ms = cuda_ms(lambda: torch.searchsorted(segs, q), 50)
    ops_model = ("3 int32 ops per search round (index add, compare, select; "
                 "the probe is a load), ceil(log2 n) rounds a searched lane "
                 "of a row staging n values, + 3 per searched lane (2 "
                 "compares, select) + 3 per staged value (add, 2 clamps)")

    def work(live, lane_len_bytes):
        """Bytes and int32 ops the mask needs when ``live`` lanes of each
        row are searched: their candidates read once, the whole mask
        written once, the staged values of rows with a live lane read
        once, and lo, hi and lane_len."""
        searched = int(live.sum())
        staged = int(n[live > 0].sum())
        return dict(searched_lanes=searched, staged_values=staged,
                    search_rounds=halving_rounds(n, live), ops_model=ops_model,
                    bytes=4 * searched + 4 * staged + lo.nbytes + hi.nbytes
                    + mask.nbytes + lane_len_bytes,
                    ops=3 * halving_rounds(n, live) + 3 * searched
                    + 3 * staged)

    every = torch.full_like(lanes, w)
    all_lanes = bound(dict(
        ms=device_ms(lambda: ops.tile_member_mask(values, lo, hi, q, cw),
                     50, "tile_member_mask_kernel"),
        event_ms=cuda_ms(lambda: ops.tile_member_mask(values, lo, hi, q,
                                                      cw), 50),
        plain_ms=cuda_ms(lambda: ref.tile_member_mask_ref(values, lo, hi, q,
                                                          cw), 3),
        **work(every, 0)))
    all_lanes["previous_ms"] = PREVIOUS_TILE_MS
    out["tile_member_mask"] = dict(
        source="src/repro_torch/csrc/intersect.cu",
        replaces="src/repro/kernels/intersect.py:82",
        shape=f"indices ({m},) int32, cand ({r}, {w}), check_width {cw}, "
              f"lane_len the probe degrees ({int(lanes.sum())} live lanes)",
        max_abs_err=err, found=int(mask_live.sum()),
        ms=device_ms(lambda: ops.tile_member_mask(values, lo, hi, q, cw,
                                                  lanes), 50,
                     "tile_member_mask_kernel"),
        event_ms=cuda_ms(lambda: ops.tile_member_mask(values, lo, hi, q, cw,
                                                      lanes), 50),
        plain_ms=cuda_ms(lambda: ref.tile_member_mask_ref(
            values, lo, hi, q, cw, lanes), 3),
        all_lanes=all_lanes, edge_cases=edges, library_ms=library_ms,
        library_call="torch.searchsorted(segs, cand), segs the gathered "
                     "INT32_MAX-padded (rows, check_width) segments, every "
                     "lane", **work(lanes, lanes.nbytes))
    staged = int(n.sum())

    # the mask at full width (2048) on the searchsorted chunk of
    # kernel_phase (same seed, all rows): no segment is cut, so it must
    # equal the binary search's ``found``
    cand_f, check_f, _ = level_inputs(db, np.random.default_rng(SEED), 2048,
                                      hubs_only=False)
    q_f = torch.from_numpy(cand_f).to(dev)
    lo_f = torch.from_numpy(indptr[check_f][:, None].astype(np.int32)).to(dev)
    hi_f = torch.from_numpy(indptr[check_f + 1][:, None].astype(np.int32)
                            ).to(dev)
    full = ops.tile_member_mask(values, lo_f, hi_f, q_f, FULL_TILE_WIDTH)
    _, found_f = ops.searchsorted_segments(values, lo_f, hi_f, q_f,
                                           db.bsearch_iters)
    torch.cuda.synchronize()
    need(torch.equal(full, found_f), "tile_member_mask at full width "
         "disagrees with searchsorted_segments")
    out["tile_member_mask"].update(
        full_width_ms=cuda_ms(lambda: ops.tile_member_mask(
            values, lo_f, hi_f, q_f, FULL_TILE_WIDTH), 50),
        full_width_staged_values=int((hi_f - lo_f).sum()))

    # the count form, the Pallas kernel's contract: (2048, 2048) x (2048, 512)
    alen = lanes
    cnt = ops.intersect_count(q, alen, segs, n)
    torch.cuda.synchronize()
    cnt_ref = ref.intersect_count_ref(q, alen, segs, n)
    err = int((cnt - cnt_ref).abs().max())
    need(err == 0, f"intersect_count disagrees with its plain version "
         f"(max abs err {err})")
    need(torch.equal(cnt.long(), mask_live.sum(dim=1)),
         "intersect_count disagrees with tile_member_mask's row sums")
    n_valid = int(lane_ok.sum())
    rounds = lower_bound_rounds(segs, n, q, lane_ok)
    out["intersect_count"] = dict(
        source="src/repro_torch/csrc/intersect.cu",
        replaces="src/repro/kernels/intersect.py:82",
        shape=f"a ({r}, {w}), b {tuple(segs.shape)} int32",
        max_abs_err=err, hits=int(cnt.sum()),
        ms=device_ms(lambda: ops.intersect_count(q, alen, segs, n), 50,
                     "intersect_count_kernel"),
        event_ms=cuda_ms(lambda: ops.intersect_count(q, alen, segs, n), 50),
        plain_ms=cuda_ms(lambda: ref.intersect_count_ref(q, alen, segs, n),
                         3),
        valid_lanes=n_valid, search_rounds=rounds,
        ops_model="6 int32 ops per search round + 5 per valid A lane",
        bytes=4 * n_valid + 4 * staged + alen.nbytes + n.nbytes + cnt.nbytes,
        ops=6 * rounds + 5 * n_valid, library_ms=library_ms,
        library_call="the same torch.searchsorted call")

    # bitset_intersect_count: 2048 hub-hub edges' bitset rows
    csr = hdb.csr
    src = np.repeat(np.arange(csr.n_nodes), csr.degrees)
    eids = np.flatnonzero((src < hdb.n_hubs) & (csr.indices < hdb.n_hubs))
    e = rng.choice(eids, size=2048, replace=False)
    x = torch.from_numpy(src[e].astype(np.int64)).to(dev)
    y = csr.indices[e]
    words = hdb.dev("bitset_words")
    tag = hdb.dev("rep_tag")
    aw = words[tag[x].long()].contiguous()
    bw = words[tag[torch.from_numpy(y).to(dev)].long()].contiguous()
    both = ops.bitset_intersect_count(aw, bw)
    torch.cuda.synchronize()
    both_ref = ref.bitset_intersect_count_ref(aw, bw)
    err = int((both - both_ref).abs().max())
    need(err == 0, f"bitset_intersect_count disagrees with its plain version "
         f"(max abs err {err})")
    # |N(x) ∩ N(y)| once more: y's adjacency tested in x's bitset row
    width = max(8, 1 << (csr.max_degree - 1).bit_length())
    idx = csr.indptr[y][:, None] + np.arange(width)[None, :]
    ny = torch.from_numpy(csr.indices[np.clip(idx, 0, csr.indices.shape[0]
                                              - 1)].astype(np.int32)).to(dev)
    ny_ok = (torch.arange(width, device=dev)[None]
             < torch.from_numpy(csr.degrees[y]).to(dev)[:, None])
    hits = (ops.bitset_member_mask(words, tag[x], ny) & ny_ok).sum(dim=1)
    need(torch.equal(hits, both.long()),
         "bitset_intersect_count disagrees with bitset_member_mask")
    out["bitset_intersect_count"] = dict(
        source="src/repro_torch/csrc/bitset_intersect.cu",
        replaces="src/repro/kernels/intersect_bitset.py:52",
        shape=f"a, b {tuple(aw.shape)} int32 (rows of the "
              f"{tuple(words.shape)} bitset matrix)",
        max_abs_err=err, hits=int(both.sum()),
        ms=device_ms(lambda: ops.bitset_intersect_count(aw, bw), 50,
                     "bitset_intersect_count_kernel"),
        event_ms=cuda_ms(lambda: ops.bitset_intersect_count(aw, bw), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_intersect_count_ref(aw, bw), 10),
        ops_model="3 int32 ops per word pair (and, popc, add)",
        bytes=aw.nbytes + bw.nbytes + both.nbytes, ops=3 * aw.numel(),
        library_ms=None, library_call="none: PyTorch has no popcount")
    return {name: bound(k) for name, k in out.items()}


def allclose_err(got, want, tol: float) -> tuple[float, bool]:
    """Max abs error of ``got`` against ``want`` (float32), and whether
    every element is within ``tol + tol * |want|``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return float(err.max()), bool((err <= tol + tol * want.abs()).all())


def flash_bf16_sweep(randn) -> list:
    """The tensor-core flash kernel against its plain version at 2e-2 in
    bf16: D 64 and 128 with GQA groups 1, 4 and 16, every other multiple
    of 16 up to 128 (16 to 48 run the 64 instance with zero columns, 80
    its own, 96 and 112 the 128 one) with groups 1 and 4; causal and not,
    Tq 1, 64, 128 and 2048 against Tk 2048 (the causal offset), a short
    stream (Tk 64) and a ragged one (Tk 100, less than a key tile),
    contiguous and as transposed (B, T, H, D) views.  Every case must
    launch the tensor-core kernel.  Returns [D, Hq, Hkv, Tq, Tk, causal,
    strided, max abs err]."""
    import torch
    from repro_torch.kernels import build, ops, ref
    bf, rows = torch.bfloat16, []
    build.reset_launches()
    for d in (64, 128, 16, 32, 48, 80, 96, 112):
        for group in ((1, 4, 16) if d in (64, 128) else (1, 4)):
            hkv = 2
            hq = hkv * group
            for tq, tk in ((1, 2048), (64, 2048), (128, 2048), (2048, 2048),
                           (64, 64), (1, 64), (100, 100)):
                for causal in (True, False):
                    for strided in (False, True):
                        if strided:
                            q, k, v = (randn(1, t_, h_, d, dtype=bf
                                             ).transpose(1, 2)
                                       for h_, t_ in ((hq, tq), (hkv, tk),
                                                      (hkv, tk)))
                        else:
                            q, k, v = (randn(1, h_, t_, d, dtype=bf)
                                       for h_, t_ in ((hq, tq), (hkv, tk),
                                                      (hkv, tk)))
                        e, ok = allclose_err(
                            ops.flash_attention(q, k, v, causal),
                            ref.flash_attention_ref(q, k, v, causal), 2e-2)
                        need(ok, f"flash_attention_tc D {d} {hq}/{hkv} Tq "
                             f"{tq} Tk {tk} causal={causal} strided="
                             f"{strided}: beyond 2e-2 (max abs err {e})")
                        rows.append([d, hq, hkv, tq, tk, causal, strided, e])
    need(build.LAUNCHES["flash_attention_tc"] == len(rows)
         and build.LAUNCHES["flash_attention_mma"] == 0,
         f"the bf16 sweep did not run on the tensor-core kernel: "
         f"{build.LAUNCHES}")
    return rows


_SASS: list = []


def sass_counts(opcode: str):
    """``opcode`` instructions (``HGMMA``: wgmma; ``HMMA``: mma.sync) in
    the SASS of each kernel function of the built library that has any, by
    ``cuobjdump -sass`` where the toolkit has it; "not available" where it
    does not."""
    import shutil
    from repro_torch.kernels import build
    if not _SASS:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        if not Path(tool).exists():
            return "not available"
        _SASS.append(subprocess.run([tool, "-sass", build.build_info["path"]],
                                    capture_output=True, text=True).stdout)
    counts, fn = {}, None
    for line in _SASS[0].splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif opcode in line.split() or any(
                w.startswith(opcode + ".") for w in line.split()):
            if fn is not None:
                counts[fn] = counts.get(fn, 0) + 1
    return counts


def bound_3xtf32(k: dict) -> dict:
    """``bound`` of f32 attention (``flops`` at the FFMA peak) beside the
    least time of the same f32-exact work on the tensor cores as 3xTF32
    (three TF32 products of every flop at the TF32 peak); ``bound_ms`` is
    the lower of the two, and ``bound_note`` says which."""
    bound(k)
    k["bound_ffma_ms"] = k["bound_ms"]
    t_ops = 3 * k["flops"] / PEAK_FLOPS_S["tf32"]
    k["bound_3xtf32_ms"] = 1e3 * max(k["bytes"] / PEAK_BYTES_S, t_ops)
    if k["bound_3xtf32_ms"] < k["bound_ffma_ms"]:
        k["bound_ms"] = k["bound_3xtf32_ms"]
        k["bound_by"] = ("bytes" if k["bytes"] / PEAK_BYTES_S >= t_ops
                         else "operations")
        k["bound_note"] = ("3xTF32: 3 x flops at the TF32 peak, below the "
                           "FFMA bound")
    else:
        k["bound_note"] = "FFMA: flops at the fp32 peak"
    return k


def flash_mma_sweep(randn) -> list:
    """The mma.sync flash kernel against its plain version in what it
    takes: bf16 at head dims off the multiples of 16 (8, 40, 72; 36 with
    rows of 72 bytes; 7, 127 with odd rows), at 2e-2, and f32 at any (1,
    6, 37, 80, 100), at 2e-5; GQA groups 1 and 4, causal and not, Tq 1, 64
    and 256 against Tk 256 (the causal offset), a short stream (Tk 64) and
    a ragged one (Tk 100, less than a key tile); contiguous, as transposed
    (B, T, H, D) views, and as views one element into wider rows (bases
    off 16 bytes, so the staging copies narrow to 4 or 2 bytes; rows of 72
    or 24 bytes take 8).  Every case must launch the mma.sync kernel.
    Returns [dtype, D, Hq, Hkv, Tq, Tk, causal, layout, copy width, max
    abs err]."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import copy_width
    rows = []
    build.reset_launches()
    for dtype, tol, dims in ((torch.bfloat16, 2e-2, (8, 40, 72, 36, 7, 127)),
                             (torch.float32, 2e-5, (1, 6, 37, 80, 100))):
        for d in dims:
            for group in (1, 4):
                hkv = 2
                hq = hkv * group
                for tq, tk in ((1, 256), (64, 256), (256, 256), (64, 64),
                               (100, 100)):
                    for causal in (True, False):
                        for layout in ("contiguous", "transposed", "offset"):
                            def make(h_, t_):
                                if layout == "transposed":
                                    return randn(1, t_, h_, d, dtype=dtype
                                                 ).transpose(1, 2)
                                if layout == "offset":
                                    return randn(1, h_, t_, d + 1,
                                                 dtype=dtype)[..., 1:]
                                return randn(1, h_, t_, d, dtype=dtype)
                            q, k, v = (make(h_, t_) for h_, t_ in
                                       ((hq, tq), (hkv, tk), (hkv, tk)))
                            e, ok = allclose_err(
                                ops.flash_attention(q, k, v, causal),
                                ref.flash_attention_ref(q, k, v, causal),
                                tol)
                            name = str(dtype).split(".")[-1]
                            need(ok, f"flash_attention_mma {name} D {d} "
                                 f"{hq}/{hkv} Tq {tq} Tk {tk} causal="
                                 f"{causal} {layout}: beyond {tol} (max abs "
                                 f"err {e})")
                            rows.append([name, d, hq, hkv, tq, tk, causal,
                                         layout, copy_width(q, k, v), e])
    need(build.LAUNCHES["flash_attention_mma"] == len(rows)
         and build.LAUNCHES["flash_attention_tc"] == 0,
         f"the off-grid sweep did not run on the mma.sync kernel: "
         f"{build.LAUNCHES}")
    return rows


def kernel_phase_lm():
    """The flash-attention kernels against their plain versions on the
    same CUDA tensors, at the shapes their paths give them; then timed,
    with the library call where PyTorch has one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import _launch_mma, route
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    # flash_attention at stablelm-3b's prefill shape: 32 query and 32 KV
    # heads of 80 dims, 4 requests of 2048 tokens, bf16, causal, seen as
    # prefill passes them.  First the mma.sync kernel on it (the route
    # sends D 80 to the wgmma kernel, and the kernel this one replaced ran
    # it before that), beside SDPA on the same tensors; then the wgmma
    # kernel's D 80 instance.
    b, hq, hkv, t, d = LM_BATCH, 32, 32, LM_PROMPT, 80
    q, k, v = (randn(b, t, h_, d, dtype=bf).transpose(1, 2)
               for h_ in (hq, hkv, hkv))
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    work = dict(flops_model="4 B Hq T^2 D / 2 (QK^T and PV, causal half)",
                flops=4 * b * hq * t * t * d / 2, flops_type="bf16",
                bytes=q.nbytes + k.nbytes + v.nbytes + q.nbytes)
    lm_shape = (f"q ({b}, {hq}, {t}, {d}) bf16 as a transposed (B, T, H, "
                f"D) view, k, v ({b}, {hkv}, {t}, {d}), causal")
    mma_bf16 = bound(dict(
        shape=lm_shape,
        ms=device_ms(lambda: _launch_mma(q, k, v, True, d ** -0.5), 10,
                     "flash_attention_mma_kernel"),
        previous_ms=PREVIOUS_SIMT_BF16_MS,
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True), 20),
        library_call="scaled_dot_product_attention(q, k, v, "
                     "is_causal=True), contiguous", **work))
    log(json.dumps({"flash stablelm-3b prefill shape, bf16":
                    {"flash_attention_mma": mma_bf16}}))
    need(route(q.device, q.dtype, d) == "tc", "flash route of stablelm-3b's "
         "bf16 heads is not the tensor-core kernel")
    build.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(build.LAUNCHES["flash_attention_tc"] == 1
         and build.LAUNCHES["flash_attention_mma"] == 0,
         f"stablelm-3b's shape did not launch flash_attention_tc: "
         f"{build.LAUNCHES}")
    err, ok = allclose_err(o, ref.flash_attention_ref(q, k, v), 2e-2)
    need(ok, f"flash_attention_tc (bf16, stablelm-3b's shape) disagrees "
         f"with its plain version beyond 2e-2 (max abs err {err})")
    tc_stablelm = bound(dict(
        shape=lm_shape, instance="D 80", max_abs_err=err,
        tolerance=2e-2,
        ms=device_ms(lambda: ops.flash_attention(q, k, v), 20,
                     "flash_attention_tc_kernel"),
        event_ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 20),
        mma_ms=mma_bf16["ms"], library_ms=mma_bf16["library_ms"],
        **work))
    tc_stablelm["achieved_tflop_s"] = work["flops"] / tc_stablelm["ms"] / 1e9
    del q, k, v, qc, kc, vc, o

    # the mma.sync kernel in bf16 at head dims off the multiples of 16, at
    # stablelm-3b's prefill shape otherwise: D 72 (an off-grid width near
    # stablelm-3b's 80), 40 and 8
    off_grid = {}
    for d in (72, 40, 8):
        q, k, v = (randn(b, t, h_, d, dtype=bf).transpose(1, 2)
                   for h_ in (hq, hkv, hkv))
        need(route(q.device, q.dtype, d) == "mma", f"flash route of bf16 D "
             f"{d} is not the mma.sync kernel")
        build.reset_launches()
        o = ops.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        need(build.LAUNCHES["flash_attention_mma"] == 1,
             f"bf16 D {d} did not launch flash_attention_mma: "
             f"{build.LAUNCHES}")
        err, ok = allclose_err(o, ref.flash_attention_ref(q, k, v), 2e-2)
        need(ok, f"flash_attention_mma (bf16, D {d}) disagrees with its "
             f"plain version beyond 2e-2 (max abs err {err})")
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        off_grid[f"D {d}"] = bound(dict(
            shape=f"q ({b}, {hq}, {t}, {d}) bf16 as a transposed (B, T, H, "
                  f"D) view, k, v ({b}, {hkv}, {t}, {d}), causal",
            max_abs_err=err, tolerance=2e-2,
            ms=device_ms(lambda: ops.flash_attention(q, k, v), 10,
                         "flash_attention_mma_kernel"),
            event_ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 10),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 2),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=True), 20),
            library_call="scaled_dot_product_attention(q, k, v, "
                         "is_causal=True), contiguous",
            flops_model="4 B Hq T^2 D / 2 (QK^T and PV, causal half)",
            flops=4 * b * hq * t * t * d / 2, flops_type="bf16",
            bytes=4 * q.nbytes))
        off_grid[f"D {d}"]["achieved_tflop_s"] = (
            off_grid[f"D {d}"]["flops"] / off_grid[f"D {d}"]["ms"] / 1e9)
        del q, k, v, qc, kc, vc, o

    # flash_attention at the LM path's shape: chatglm3-6b's 32 query and 2
    # KV heads of 128 dims, 4 requests of 2048 tokens, bf16, causal; q, k
    # and v are (B, T, H, D) projections seen as (B, H, T, D), as prefill
    # passes them.  bf16 with D 128 routes to the tensor-core kernel.
    b, hq, hkv, t, d = LM_BATCH, 32, 2, LM_PROMPT, 128
    q = randn(b, t, hq, d, dtype=bf).transpose(1, 2)
    k = randn(b, t, hkv, d, dtype=bf).transpose(1, 2)
    v = randn(b, t, hkv, d, dtype=bf).transpose(1, 2)
    need(route(q.device, q.dtype, d) == "tc", "flash route of the path "
         "shape is not the tensor-core kernel")
    build.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(build.LAUNCHES["flash_attention_tc"] == 1,
         f"the path shape did not launch flash_attention_tc: "
         f"{build.LAUNCHES}")
    err, ok = allclose_err(o, ref.flash_attention_ref(q, k, v), 2e-2)
    need(ok, f"flash_attention_tc (bf16, path shape) disagrees with its "
         f"plain version beyond 2e-2 (max abs err {err})")
    # against the f32 attention of the same bf16 inputs, before rounding
    err_f32 = float((o.float() - ref.flash_attention_ref(
        q.float(), k.float(), v.float())).abs().max())
    tc_sweep = flash_bf16_sweep(randn)
    # the f32 sweep of the JAX package's tests (D 64), the decode shape
    # (Tq 1 against Tk 256), and chatglm3's group of 16 at D 128, through
    # the mma.sync kernel
    sweep = []
    build.reset_launches()
    for hq_, hkv_, tq_, tk_, d_ in ((4, 4, 256, 256, 64), (8, 2, 256, 256, 64),
                                    (4, 2, 1, 256, 64), (32, 2, 256, 256, 128),
                                    (32, 2, 1, 256, 128)):
        for causal in ((True, False) if tq_ > 1 else (True,)):
            qs, ks, vs = (randn(2, h_, t_, d_) for h_, t_ in
                          ((hq_, tq_), (hkv_, tk_), (hkv_, tk_)))
            e, ok = allclose_err(ops.flash_attention(qs, ks, vs, causal),
                                 ref.flash_attention_ref(qs, ks, vs, causal),
                                 2e-5)
            need(ok, f"flash_attention f32 {hq_}/{hkv_} Tq {tq_} Tk {tk_} "
                 f"D {d_} causal={causal}: beyond 2e-5 (max abs err {e})")
            sweep.append([hq_, hkv_, tq_, tk_, d_, causal, e])
    need(build.LAUNCHES["flash_attention_mma"] == len(sweep)
         and build.LAUNCHES["flash_attention_tc"] == 0,
         f"the f32 sweep did not run on the mma.sync kernel: "
         f"{build.LAUNCHES}")
    mma_sweep = flash_mma_sweep(randn)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    flops = 4 * b * hq * t * t * d / 2
    tc = dict(
        source="src/repro_torch/csrc/flash_attention_tc.cu",
        replaces="src/repro/kernels/flash_attention.py:81",
        shape=f"q ({b}, {hq}, {t}, {d}) bf16 as a transposed (B, T, H, D) "
              f"view, k, v ({b}, {hkv}, {t}, {d}), causal",
        max_abs_err=err, tolerance=2e-2, max_abs_err_vs_f32=err_f32,
        bf16_sweep=tc_sweep,
        bf16_sweep_max_abs_err=max(x[-1] for x in tc_sweep),
        ms=device_ms(lambda: ops.flash_attention(q, k, v), 20,
                     "flash_attention_tc_kernel"),
        event_ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 20),
        contiguous_ms=cuda_ms(lambda: ops.flash_attention(qc, kc, vc), 20),
        mma_ms=cuda_ms(lambda: _launch_mma(q, k, v, True, d ** -0.5), 5),
        previous_ms=PREVIOUS_FLASH_MS,
        plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 3),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), 20),
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "q, k, v, is_causal=True, enable_gqa=True), contiguous",
        flops_model="4 B Hq T^2 D / 2 (QK^T and PV, causal half)",
        flops=flops, flops_type="bf16",
        bytes=q.nbytes + k.nbytes + v.nbytes + o.nbytes,
        stablelm_3b=tc_stablelm, hgmma=sass_counts("HGMMA"))
    tc["achieved_tflop_s"] = flops / tc["ms"] / 1e9
    out["flash_attention_tc"] = tc
    del q, k, v, qc, kc, vc, o

    # the mma.sync kernel at the f32 path shape (the lm parity phase runs
    # it at full width and 2 layers): 3xTF32
    q = randn(b, t, hq, d).transpose(1, 2)
    k = randn(b, t, hkv, d).transpose(1, 2)
    v = randn(b, t, hkv, d).transpose(1, 2)
    need(route(q.device, q.dtype, d) == "mma", "flash route of f32 is not "
         "the mma.sync kernel")
    build.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(build.LAUNCHES["flash_attention_mma"] == 1,
         f"the f32 path shape did not launch flash_attention_mma: "
         f"{build.LAUNCHES}")
    err, ok = allclose_err(o, ref.flash_attention_ref(q, k, v), 2e-5)
    need(ok, f"flash_attention_mma (f32, path shape) disagrees with its "
         f"plain version beyond 2e-5 (max abs err {err})")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out["flash_attention_mma"] = dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:81",
        shape=f"q ({b}, {hq}, {t}, {d}) f32 as a transposed (B, T, H, D) "
              f"view, k, v ({b}, {hkv}, {t}, {d}), causal",
        max_abs_err=err, tolerance=2e-5, f32_sweep=sweep,
        f32_sweep_max_abs_err=max(x[-1] for x in sweep),
        off_grid_sweep=mma_sweep,
        off_grid_sweep_max_abs_err={
            dt: max(x[-1] for x in mma_sweep if x[0] == dt)
            for dt in ("bfloat16", "float32")},
        ms=device_ms(lambda: ops.flash_attention(q, k, v), 10,
                     "flash_attention_mma_kernel"),
        event_ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 5),
        previous_ms=PREVIOUS_SIMT_F32_MS,
        plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v), 2),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), 3),
        library_call="torch.nn.functional.scaled_dot_product_attention("
                     "q, k, v, is_causal=True, enable_gqa=True), f32, "
                     "contiguous",
        flops_model="4 B Hq T^2 D / 2 (QK^T and PV, causal half)",
        flops=flops, flops_type="fp32",
        bytes=q.nbytes + k.nbytes + v.nbytes + o.nbytes,
        bf16_off_grid=off_grid, bf16_stablelm_3b=mma_bf16,
        hmma=sass_counts("HMMA"))
    out["flash_attention_mma"]["achieved_tflop_s"] = (
        flops / out["flash_attention_mma"]["ms"] / 1e9)
    del q, k, v, qc, kc, vc, o

    return {name: (bound_3xtf32(k) if name == "flash_attention_mma"
                   else bound(k)) for name, k in out.items()}


def outer_dst(g, dist: str, n: int, e_real: int, e: int):
    """dst of the segment-outer line: ``e_real`` edges on ``n`` nodes,
    uniform (n u) or powerlaw (n u^3), sorted and padded with ``n`` to
    ``e``; and the real edges' nodes."""
    import torch
    u = torch.rand(e_real, generator=g, device="cuda", dtype=torch.float64)
    real = (n * (u if dist == "uniform" else u ** 3)).long().clamp(max=n - 1)
    dst = torch.full((e,), n, dtype=torch.int32, device="cuda")
    dst[:e_real] = torch.sort(real).values.int()
    return dst, real


def outer_case(msg, basis, dst, n: int, what: str) -> float:
    """``ops.segment_outer`` (bn 8, te 128) against its plain version at
    2e-4 on the same tensors; returns the max abs error."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_outer import block_tile_starts
    bt, n_tiles = block_tile_starts(dst.cpu().numpy(), n, OUTER_BN, OUTER_TE)
    a = ops.segment_outer(msg, basis, dst, bt, n, n_tiles, OUTER_BN, OUTER_TE)
    torch.cuda.synchronize()
    need(a.shape == (n, msg.shape[1], basis.shape[1])
         and a.dtype == torch.float32,
         f"segment_outer ({what}): shape {tuple(a.shape)} {a.dtype}")
    err, ok = allclose_err(a, ref.segment_outer_ref(msg, basis, dst, n), 2e-4)
    need(ok, f"segment_outer ({what}) disagrees with its plain version "
         f"beyond 2e-4 (max abs err {err})")
    return err


def outer_edges(g, randn) -> dict:
    """The segment outer product against its plain version at 2e-4 off
    the main shape: every edge on one node (E = 2^17), one edge per node,
    runs between empty nodes, a hub that starts on a range boundary and
    one that ends on one (at the ranges the kernel picks for that E), E =
    te, all padding, dst above n_nodes, C*M = 128 x 64 (above the old
    shared-memory cap; eight column passes), C 300 (three channel
    passes), M 80 (ten column passes), C 3 and M 5 (off the vector width)
    in f32 and bf16, M 4 and M 2 (a pass of 8 columns, those past M
    masked) in f32, bf16 and f16, M 16 in f16 (two passes), f16 and
    mixed bf16 x f32; then the edges of 1,024 nodes written among 131,072
    (130,048 zero rows), checked and timed beside its bound.  Returns
    the max abs error per case, and the timed case's line."""
    import torch
    from repro_torch.kernels.segment_outer import plan
    c, m, bf = OUTER_C, OUTER_M, torch.bfloat16

    def sorted_dst(n, e, lo=0, hi=None):
        hi = n if hi is None else hi
        return torch.sort(torch.randint(lo, hi, (e,), generator=g,
                                        device="cuda")).values.int()

    def case(what, e, n, dst, cc=c, mm=m, dtype=torch.float32,
             basis_dtype=None):
        msg = randn(e, cc, dtype=dtype)
        basis = randn(e, mm, dtype=basis_dtype or dtype)
        errs[what] = outer_case(msg, basis, dst, n, what)

    errs = {}
    e = 1 << 17
    full = torch.full
    case("every edge on one node", e, 64, full((e,), 37, dtype=torch.int32,
                                               device="cuda"))
    case("one edge per node", e, e, torch.arange(e, dtype=torch.int32,
                                                 device="cuda"))
    case("runs between empty nodes", 1 << 16, 4096,
         2 * sorted_dst(2048, 1 << 16))
    r = plan(e, c, m, torch.float32, "cuda")[0]
    n = 1024
    hub = full((5 * r + 7,), 500, dtype=torch.int32, device="cuda")
    case("hub from a range boundary", e, n, torch.cat(
        [sorted_dst(n, 3 * r, hi=500), hub,
         sorted_dst(n, e - 8 * r - 7, lo=501)]))
    hub = full((5 * r - 5,), 500, dtype=torch.int32, device="cuda")
    case("hub to a range boundary", e, n, torch.cat(
        [sorted_dst(n, r + 5, hi=500), hub, sorted_dst(n, e - 6 * r,
                                                       lo=501)]))
    errs["range_edges"] = r
    case("E = te", OUTER_TE, 16, sorted_dst(16, OUTER_TE))
    case("all padding", 256, 64, full((256,), 64, dtype=torch.int32,
                                      device="cuda"))
    case("dst above n_nodes", 1 << 14, 512, torch.cat(
        [sorted_dst(512, (1 << 14) - 300), full((300,), 700,
                                                dtype=torch.int32,
                                                device="cuda")]))
    case("C*M 128 x 64", 1 << 14, 512, sorted_dst(512, 1 << 14), mm=64)
    case("C 300", 1 << 14, 512, sorted_dst(512, 1 << 14), cc=300)
    case("M 80", 1 << 14, 512, sorted_dst(512, 1 << 14), cc=16, mm=80)
    case("C 3, M 5", 1 << 14, 512, sorted_dst(512, 1 << 14), cc=3, mm=5)
    case("C 3, M 5, bf16", 1 << 14, 512, sorted_dst(512, 1 << 14), cc=3,
         mm=5, dtype=bf)
    for mm in (4, 2):
        for name, dtype in (("f32", torch.float32), ("bf16", bf),
                            ("f16", torch.float16)):
            case(f"M {mm}, {name}", 1 << 14, 512, sorted_dst(512, 1 << 14),
                 mm=mm, dtype=dtype)
    case("M 16, f16", 1 << 14, 512, sorted_dst(512, 1 << 14), mm=16,
         dtype=torch.float16)
    dst, _ = outer_dst(g, "powerlaw", 4096, 1 << 16, 1 << 16)
    case("f16", 1 << 16, 4096, dst, dtype=torch.float16)
    case("mixed bf16 x f32", 1 << 16, 4096, dst, dtype=bf,
         basis_dtype=torch.float32)
    errs["large gap"] = outer_gap_case(g, randn)
    return errs


def outer_gap_case(g, randn) -> dict:
    """At MACE's widths, 2^17 edges on the first 1,024 of 131,072 nodes:
    the other 130,048 output rows are zero rows of edgeless nodes (0.6 GB
    of the 0.67 GB written), which the gap kernel spreads over the card.
    Against the plain version at 2e-4, then timed (all the call's
    kernels) beside its bytes bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.segment_outer import block_tile_starts
    e, n, hot = 1 << 17, OUTER_NODES, 1024
    dst = torch.sort(torch.randint(0, hot, (e,), generator=g,
                                   device="cuda")).values.int()
    msg, basis = randn(e, OUTER_C), randn(e, OUTER_M)
    err = outer_case(msg, basis, dst, n, "large gap")
    bt, n_tiles = block_tile_starts(dst.cpu().numpy(), n, OUTER_BN, OUTER_TE)
    nbytes = (msg.nbytes + basis.nbytes + dst.nbytes
              + 4 * n * OUTER_C * OUTER_M)
    ms = device_ms(lambda: ops.segment_outer(msg, basis, dst, bt, n, n_tiles,
                                             OUTER_BN, OUTER_TE), 5,
                   *OUTER_KERNELS)
    gap_ms = device_ms(lambda: ops.segment_outer(msg, basis, dst, bt, n,
                                                 n_tiles, OUTER_BN,
                                                 OUTER_TE), 5,
                       OUTER_KERNELS[2])
    bound_ms = 1e3 * nbytes / PEAK_BYTES_S
    return dict(max_abs_err=err, ms=ms, gap_ms=gap_ms, bytes=nbytes,
                bound_ms=bound_ms, bound_share=bound_ms / ms)


def kernel_phase_outer():
    """The segment outer product at MACE's widths (131,072 nodes at
    ogb_products' mean degree, C 128, M 9) on uniform and powerlaw dst, in
    float32 and bf16: against its plain version at 2e-4, two calls
    bit-identical, then timed (the three kernels of a call: the pass
    over the edge ranges, the merge of partial rows and the zero rows of
    edgeless nodes); then its edge cases."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.segment_outer import block_tile_starts, plan
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    n = OUTER_NODES
    e_real = round(n * OUTER_DEGREE)
    e = -(-e_real // OUTER_TE) * OUTER_TE
    out_bytes = 4 * n * OUTER_C * OUTER_M
    msg = randn(e, OUTER_C)
    basis = randn(e, OUTER_M)
    msg[e_real:] = 0
    basis[e_real:] = 0
    inputs = {"f32": (msg, basis),
              "bf16": (msg.to(torch.bfloat16), basis.to(torch.bfloat16))}
    lines = {}
    for dist in ("uniform", "powerlaw"):
        dst, real = outer_dst(g, dist, n, e_real, e)
        bt, n_tiles = block_tile_starts(dst.cpu().numpy(), n, OUTER_BN,
                                        OUTER_TE)
        line = lines[dist] = dict(
            n_tiles=n_tiles,
            max_node_edges=int(torch.bincount(real).max()),
            max_block_edges=int(torch.bincount(real // OUTER_BN).max()))
        for dtype, (mm, bb) in inputs.items():
            args = (mm, bb, dst, bt, n, n_tiles, OUTER_BN, OUTER_TE)
            a = ops.segment_outer(*args)
            a2 = ops.segment_outer(*args)
            torch.cuda.synchronize()
            need(torch.equal(a, a2), f"segment_outer ({dist}, {dtype}): two "
                 "calls differ")
            err, ok = allclose_err(a, ref.segment_outer_ref(mm, bb, dst, n),
                                   2e-4)
            need(ok, f"segment_outer ({dist}, {dtype}) disagrees with its "
                 f"plain version beyond 2e-4 (max abs err {err})")
            del a, a2
            nbytes = mm.nbytes + bb.nbytes + dst.nbytes + out_bytes
            line[dtype] = dict(
                max_abs_err=err, bit_identical=True,
                ranges=plan(e, OUTER_C, OUTER_M, mm.dtype, "cuda"),
                ms=device_ms(lambda: ops.segment_outer(*args), 5,
                             *OUTER_KERNELS),
                merge_ms=device_ms(lambda: ops.segment_outer(*args), 5,
                                   OUTER_KERNELS[1]),
                gap_ms=device_ms(lambda: ops.segment_outer(*args), 5,
                                 OUTER_KERNELS[2]),
                event_ms=cuda_ms(lambda: ops.segment_outer(*args), 5),
                plain_ms=cuda_ms(lambda: ref.segment_outer_ref(mm, bb, dst,
                                                               n), 2),
                bytes=nbytes, bound_ms=1e3 * nbytes / PEAK_BYTES_S)
            line[dtype]["bound_share"] = (line[dtype]["bound_ms"]
                                          / line[dtype]["ms"])
        line["f32"]["previous_ms"] = PREVIOUS_OUTER_MS[dist]
        del dst, real
    del inputs
    edges = outer_edges(g, randn)
    uni = lines["uniform"]["f32"]
    k = dict(
        source="src/repro_torch/csrc/segment_outer.cu",
        replaces="src/repro/kernels/segment_outer.py:72",
        shape=f"msg ({e}, {OUTER_C}), basis ({e}, {OUTER_M}), "
              f"{e_real} real edges on {n} nodes, bn {OUTER_BN}, "
              f"te {OUTER_TE}; figures of f32 on the uniform dst, all in "
              "by_dst",
        max_abs_err=max(x[d]["max_abs_err"] for x in lines.values()
                        for d in ("f32", "bf16")),
        tolerance=2e-4, by_dst=lines, edge_cases=edges, ms=uni["ms"],
        event_ms=uni["event_ms"], plain_ms=uni["plain_ms"],
        previous_ms=uni["previous_ms"],
        library_ms=None, library_call="none: no single PyTorch call",
        flops_model="2 C M per real edge", flops=2 * e_real * OUTER_C * OUTER_M,
        flops_type="fp32", bytes=uni["bytes"])
    del msg, basis
    torch.cuda.empty_cache()
    return {"segment_outer": bound(k)}


def gpu_profile(fn, what: str) -> dict:
    """Device time of one call of ``fn`` by kernel from ``torch.profiler``
    (device only), grouped into the flash kernel, the GEMMs and the rest,
    with the device's busy and idle share of the unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        key = e.key.lower()
        group = ("flash_attention" if "flash_attention" in key else
                 "gemm" if any(w in key for w in ("gemm", "xmma", "nvjet",
                                                  "cutlass", "matmul"))
                 else "other")
        groups[group] += device_us(e) / 1e6
    busy = sum(groups.values())
    return {"profile": what, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall,
            "device_s": groups,
            "share": {k: v / busy for k, v in groups.items()} if busy else {},
            "top_device_ms": [[e.key[:70], device_us(e) / 1e3, e.count]
                              for e in events[:10] if device_us(e) > 0]}


def lm_serve(cfg):
    """A model at full width and depth in bf16 (chatglm3-6b or
    stablelm-3b), weights from a seeded generator on the card: a batch of
    4 requests of 2048 synthetic prompt tokens, prefill, then 32 greedy
    decode steps.  The kernels' launch counters are set to 0 just before
    and read just after; every prefill layer must launch the wgmma flash
    kernel once and the mma.sync one never.  Then one prefill is
    profiled."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"lm params: {cfg.name}, {cfg.n_params} parameters, "
        f"{sum(p.nbytes for p in params.values())} bytes "
        f"({time.perf_counter() - t0:.2f} s)")
    ml = LM_PROMPT + LM_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=g, device="cuda")
    # warm-up: one short prompt, so cuBLAS and the kernel library are
    # loaded before the timed run
    tfm.decode_step(params, tfm.prefill(params, tokens[:, :128], cfg,
                                        max_len=ml)[0], tokens[:, :1], cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    build.reset_launches()
    t0 = time.perf_counter()
    cache, logits = tfm.prefill(params, tokens, cfg, max_len=ml)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = dict(build.LAUNCHES)
    ids = [logits.argmax(-1)]
    t0 = time.perf_counter()
    for _ in range(LM_DECODE):
        logits, cache = tfm.decode_step(params, cache, ids[-1], cfg)
        ids.append(logits.argmax(-1))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    ids = torch.cat(ids, dim=1)
    need(bool(torch.isfinite(logits).all()), "lm serve: non-finite logits")
    need(tuple(logits.shape) == (LM_BATCH, 1, cfg.padded_vocab),
         f"lm serve: logits shape {tuple(logits.shape)}")
    need(tuple(ids.shape) == (LM_BATCH, LM_DECODE + 1)
         and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab_size,
         "lm serve: greedy ids out of range")
    need(cache["len"] == ml, f"lm serve: cache len {cache['len']} != {ml}")
    need(prefill_launches["flash_attention_tc"] == cfg.n_layers
         and launches["flash_attention_tc"] == cfg.n_layers
         and launches["flash_attention_mma"] == 0,
         f"lm serve: {launches['flash_attention_tc']} wgmma and "
         f"{launches['flash_attention_mma']} mma.sync flash launches; "
         f"{cfg.n_layers} and 0 expected (one per layer of the prefill)")
    log(json.dumps(dict(
        path="lm serve", model=cfg.name, n_layers=cfg.n_layers,
        head_dim=cfg.head_dim,
        batch=LM_BATCH, prompt_tokens=LM_PROMPT, decode_steps=LM_DECODE,
        max_len=ml, prefill_s=prefill_s,
        prefill_tokens_s=LM_BATCH * LM_PROMPT / prefill_s,
        decode_ms_per_step=1e3 * decode_s / LM_DECODE,
        decode_tokens_s=LM_BATCH * LM_DECODE / decode_s,
        peak_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, first_ids=ids[:, :8].tolist())))
    del cache, logits
    log(json.dumps(gpu_profile(
        lambda: tfm.prefill(params, tokens, cfg, max_len=ml),
        f"prefill {cfg.name} {LM_BATCH}x{LM_PROMPT}")))
    del params
    torch.cuda.empty_cache()
    return launches, prefill_s


def lm_parity(model):
    """A model (chatglm3-6b: RMSNorm, half rotary, GQA; stablelm-3b:
    LayerNorm, 25% rotary, tied embeddings, heads of 80) at full width
    with 2 layers in float32 (TF32 off): the card's prefill logits and 4
    greedy decode steps against the port's CPU path on the same weights
    (1e-3), and on the card the decode logits against ``forward`` over
    the concatenated stream (2e-4, the JAX package's own decode-vs-forward
    tolerance)."""
    from dataclasses import replace
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(model, n_layers=PARITY_LAYERS, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = tfm.init_params(cfg, g, device="cuda")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    tokens = torch.randint(0, cfg.vocab_size, (1, PARITY_PROMPT), generator=g,
                           device="cuda")
    ml = PARITY_PROMPT + PARITY_STEPS
    errs = {}
    t0 = time.perf_counter()
    runs = {}
    build.reset_launches()
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        cache, logits = tfm.prefill(p, tokens.to(dev), cfg, max_len=ml)
        out = [logits]
        nxt = tokens[:, :1].to(dev)
        for _ in range(PARITY_STEPS):
            logits, cache = tfm.decode_step(p, cache, nxt, cfg)
            out.append(logits)
            nxt = logits.argmax(-1)
        runs[dev] = out
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        err, ok = allclose_err(a.cpu(), b, 1e-3)
        errs["prefill" if i == 0 else f"decode {i}"] = err
        need(ok, f"lm parity: card vs CPU logits (step {i}) beyond 1e-3 "
             f"(max abs err {err})")
        need(torch.equal(a.argmax(-1).cpu(), b.argmax(-1)),
             f"lm parity: card and CPU greedy ids differ at step {i}")
    cpu_s = time.perf_counter() - t0
    # decode against forward on the card, as the CPU test runs it
    prompt = tokens[:, :PARITY_FORWARD_PROMPT]
    cache, _ = tfm.prefill(params, prompt, cfg, max_len=ml)
    nxt, dec = prompt[:, :1], []
    for _ in range(PARITY_STEPS - 1):
        logits, cache = tfm.decode_step(params, cache, nxt, cfg)
        dec.append(logits)
        nxt = logits.argmax(-1)
    stream = torch.cat([prompt, prompt[:, :1]], dim=1)
    fwd_errs = []
    for i in range(PARITY_STEPS - 1):
        x, _ = tfm.forward(params, stream, cfg)
        full = tfm._lm_logits(x[:, -1:, :], params, cfg)
        err, ok = allclose_err(dec[i], full, 2e-4)
        fwd_errs.append(err)
        need(ok, f"lm parity: decode step {i} vs forward beyond 2e-4 "
             f"(max abs err {err})")
        stream = torch.cat([stream, full.argmax(-1)], dim=1)
    log(json.dumps(dict(
        path="lm parity", model=cfg.name, n_layers=cfg.n_layers,
        head_dim=cfg.head_dim,
        dtype="float32", prompt_tokens=PARITY_PROMPT, steps=PARITY_STEPS,
        forward_prompt_tokens=PARITY_FORWARD_PROMPT,
        card_vs_cpu_max_abs_err=errs, decode_vs_forward_max_abs_err=fwd_errs,
        wall_s=time.perf_counter() - t0, card_and_cpu_s=cpu_s,
        launches=dict(build.LAUNCHES))))
    launches = dict(build.LAUNCHES)
    # f32 attention runs on the mma.sync kernel: one launch per layer of
    # each prefill and forward
    need(launches["flash_attention_mma"] > 0
         and launches["flash_attention_tc"] == 0,
         f"lm parity: f32 flash launches {launches}")
    del params, cpu_params, runs
    torch.cuda.empty_cache()
    return launches


def main_path(T, dbs):
    """``count(engine="auto")`` of the six shapes on both dbs, with the
    kernels' launch counters set to 0 just before and read just after."""
    import torch
    from repro_torch.kernels import build
    counts = {}
    build.reset_launches()
    for db_name, db in dbs.items():
        for shape in SHAPES:
            before = dict(build.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            plan = T.plan_query(T.get_query(shape), T.GraphStats.of(db),
                                engine="auto")
            n, stats = T.execute_stats(plan, db)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[db_name, shape] = n
            log(json.dumps(dict(
                db=db_name, shape=shape, count=n, engine=plan.engine,
                wall_s=wall,
                launches={k: v - before[k] for k, v in build.LAUNCHES.items()},
                bitset_rows=stats.get("bitset_rows", 0),
                level_rows=stats.get("level_rows"),
                device_bytes=db.device_bytes(),
                peak_allocated_bytes=torch.cuda.max_memory_allocated())))
    return counts, dict(build.LAUNCHES)


def auto_path(T, dbs, counts):
    """The twelve counts again with ``check_mode="auto"``: each equals the
    ``bsearch`` count of the same db, rows go down both the tile and the
    binary-search path, and the tile kernel is launched.  Counters are set
    to 0 just before and read just after."""
    import torch
    from repro_torch.kernels import build
    rows = {"tile_rows": 0, "bsearch_rows": 0}
    build.reset_launches()
    for db_name, db in dbs.items():
        for shape in SHAPES:
            before = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            plan = T.plan_query(T.get_query(shape), T.GraphStats.of(db),
                                engine="auto")
            n, stats = T.execute_stats(plan, db, check_mode="auto",
                                       tile_width=TILE_WIDTH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            need(n == counts[db_name, shape],
                 f"auto mode {db_name} {shape}: {n} != bsearch "
                 f"{counts[db_name, shape]}")
            for k in rows:
                rows[k] += stats.get(k, 0)
            log(json.dumps(dict(
                path="auto", db=db_name, shape=shape, count=n,
                engine=plan.engine, wall_s=wall,
                launches={k: v - before[k] for k, v in build.LAUNCHES.items()},
                **{k: stats.get(k, 0) for k in ("tile_rows", "bsearch_rows",
                                                "bitset_rows")})))
    launches = dict(build.LAUNCHES)
    need(rows["tile_rows"] > 0 and rows["bsearch_rows"] > 0,
         f"auto mode did not split rows both ways: {rows}")
    need(launches["tile_member_mask"] > 0,
         "the auto path never launched tile_member_mask")
    return launches


def mode_turns(T, db, shape: str = "4-cycle") -> None:
    """``bsearch`` and ``auto`` counts of one shape in turns (bsearch,
    auto, auto, bsearch), each with its per-level host wall, then the
    ``auto`` count profiled."""
    import torch
    plan = T.plan_query(T.get_query(shape), T.GraphStats.of(db),
                        engine="vlftj")
    for mode in ("bsearch", "auto", "auto", "bsearch"):
        t0 = time.perf_counter()
        _, stats = T.execute_stats(plan, db, check_mode=mode,
                                   tile_width=TILE_WIDTH)
        torch.cuda.synchronize()
        log(json.dumps(dict(turn=mode, db="plain", shape=shape,
                            wall_s=time.perf_counter() - t0,
                            level_wall_s=stats["level_wall_s"])))
    profile_count(T, db, shape, check_mode="auto", tile_width=TILE_WIDTH)


def single_modes(T, db, counts):
    """The cyclic shapes on the plain db in ``tile`` mode (wide enough to
    cut nothing) and in ``bsearch2`` mode, against the ``bsearch``
    counts."""
    import torch
    from repro_torch.kernels import build
    need(FULL_TILE_WIDTH >= db.max_degree, "tile width below max degree")
    for kw in (dict(check_mode="tile", tile_width=FULL_TILE_WIDTH),
               dict(check_mode="bsearch2")):
        build.reset_launches()
        for shape in CYCLIC:
            before = dict(build.LAUNCHES)
            t0 = time.perf_counter()
            n = T.count(T.get_query(shape), db, engine="vlftj", **kw)
            torch.cuda.synchronize()
            log(json.dumps(dict(
                path=kw["check_mode"], db="plain", shape=shape, count=n,
                wall_s=time.perf_counter() - t0,
                launches={k: v - before[k]
                          for k, v in build.LAUNCHES.items()})))
            need(n == counts["plain", shape],
                 f"{kw}: {shape} {n} != bsearch {counts['plain', shape]}")


def check_rows(csr, shape: str, columns, rows: np.ndarray) -> None:
    """Streamed rows checked on the host with numpy alone: strictly
    increasing in lexicographic order (so sorted and duplicate-free),
    every pattern edge in the CSR and every ``<`` filter holding."""
    if rows.shape[0] > 1:
        d = rows[1:] - rows[:-1]
        nz = d != 0
        need(bool(nz.any(axis=1).all()), f"{shape}: duplicate rows")
        first = nz.argmax(axis=1)
        need(bool((d[np.arange(d.shape[0]), first] > 0).all()),
             f"{shape}: rows are not lexicographically sorted")
    n = csr.n_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), csr.degrees)
    keys = src * n + csr.indices.astype(np.int64)     # sorted: CSR order
    col = {v: rows[:, columns.index(v)] for v in columns}
    edges, less = PATTERNS[shape]
    for u, v in edges.split():
        k = col[u] * n + col[v]
        i = np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)
        need(bool((keys[i] == k).all()), f"{shape}: a row misses edge {u}{v}")
    for u, v in less.split():
        need(bool((col[u] < col[v]).all()), f"{shape}: a row breaks {u}<{v}")


def stream_path(T, db, counts):
    """``stream`` of the cyclic shapes at full scale in ``tile`` mode, so
    the final level is re-entered through the tile kernel; then the
    factorized 3-clique.  Counters are set to 0 just before and read just
    after."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.kernels import build
    from repro_torch.results import FactorizedResult
    kw = dict(check_mode="tile", tile_width=FULL_TILE_WIDTH)
    build.reset_launches()
    streamed = {}
    for shape in CYCLIC:
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        cur = E.stream(T.get_query(shape), db, engine="vlftj",
                       page_rows=4096, **kw)
        pages = list(cur)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = (np.concatenate(pages) if pages
                else np.zeros((0, len(cur.vars)), np.int64))
        log(json.dumps(dict(
            path="stream", db="plain", shape=shape, rows=int(rows.shape[0]),
            wall_s=wall, cursor=cur.stats, ll_calls=cur.executor.stats[
                "ll_calls"],
            launches={k: v - before[k] for k, v in build.LAUNCHES.items()})))
        need(rows.shape[0] == counts["plain", shape],
             f"stream {shape}: {rows.shape[0]} rows != count "
             f"{counts['plain', shape]}")
        t0 = time.perf_counter()
        check_rows(db.csr, shape, cur.vars, rows)
        log(f"host row check {shape}: {time.perf_counter() - t0:.3f} s")
        streamed[shape] = (cur.vars, rows)
    t0 = time.perf_counter()
    cols, rows = streamed["3-clique"]
    fr = E.enumerate(T.get_query("3-clique"), db, engine="vlftj", order=cols,
                     mode="factorized", **kw)
    need(isinstance(fr, FactorizedResult), "3-clique: not factorized")
    need(fr.count() == counts["plain", "3-clique"],
         f"factorized 3-clique: {fr.count()} != "
         f"{counts['plain', '3-clique']}")
    need(np.array_equal(fr.expand(), rows),
         "factorized 3-clique does not expand to the streamed rows")
    log(f"factorized 3-clique: {fr.count()} rows, {fr.nbytes} bytes "
        f"({time.perf_counter() - t0:.3f} s)")
    launches = dict(build.LAUNCHES)
    need(launches["tile_member_mask"] > 0,
         "the stream path never launched tile_member_mask")
    return launches


def profile_count(T, db, shape: str, db_name: str = "plain", **kw) -> None:
    """Where one count's time goes: device time by kernel (and copy) from
    ``torch.profiler`` tracing the device only, the port's check kernels'
    device time and launches, and the device's busy and idle share of the
    wall time, profiled and unprofiled.  ``kw`` goes to ``count`` (the
    check mode)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    query = T.get_query(shape)
    t0 = time.perf_counter()
    T.count(query, db, **kw)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.count(query, db, **kw)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy = sum(device_us(e) for e in events) / 1e6
    # the port's check kernels: [device ms, launches], template instances
    # summed
    mine = {}
    for name in PORT_JOIN_KERNELS:
        hits = [e for e in events if f"::{name}(" in e.key
                or f"::{name}<" in e.key]
        if hits:
            mine[name] = [sum(device_us(e) for e in hits) / 1e3,
                          sum(e.count for e in hits)]
    log(json.dumps({
        "profile": shape, "db": db_name, "count_kw": kw, "wall_s": wall,
        "wall_profiled_s": wall_profiled, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "port_kernels_device_ms": mine,
        "top_device_ms": [
            [e.key[:70], device_us(e) / 1e3, e.count]
            for e in events[:12] if device_us(e) > 0]}))


def host_k4(csr, chunk: int = 1 << 24) -> np.ndarray:
    """Per-vertex 4-clique counts with numpy alone, independent of the
    port's engines and kernels.  Each edge is oriented from the lower to
    the higher (degree, id) rank; triangles u < v < w in rank are the
    oriented edges (u, v) closed by a w in N+(v) with (u, w) an edge, and
    4-cliques extend a triangle by an x in N+(w) with (u, x) and (v, x)
    edges, so each is found once, from its three lowest-ranked vertices.
    Expansions run ``chunk`` lanes at a time to bound host memory."""
    n = csr.n_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), csr.degrees)
    dst = csr.indices.astype(np.int64)
    rank = np.empty(n, dtype=np.int64)
    rank[np.lexsort((np.arange(n), csr.degrees))] = np.arange(n)
    keys = np.sort((src * n + dst)[rank[src] < rank[dst]])
    eu, ev = keys // n, keys % n
    optr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(eu, minlength=n), out=optr[1:])

    def edge(a, b):
        k = a * n + b
        i = np.minimum(np.searchsorted(keys, k), keys.shape[0] - 1)
        return keys[i] == k

    def extend(cols: tuple, head: np.ndarray):
        """Each row of ``cols`` repeated once per x in N+(head), with x,
        in slices of at most ``chunk`` expanded lanes."""
        cnt = optr[head + 1] - optr[head]
        ends = np.cumsum(cnt)
        start = 0
        while start < head.shape[0]:
            stop = max(start + 1, int(np.searchsorted(
                ends, (ends[start - 1] if start else 0) + chunk)))
            c = cnt[start:stop]
            rep = np.repeat(np.arange(start, stop), c)
            off = np.arange(int(c.sum())) - np.repeat(np.cumsum(c) - c, c)
            yield (tuple(col[rep] for col in cols),
                   ev[np.repeat(optr[head[start:stop]], c) + off])
            start = stop

    tri = [[], [], []]
    for (u, v), w in extend((eu, ev), ev):
        keep = edge(u, w)
        for acc, col in zip(tri, (u, v, w)):
            acc.append(col[keep])
    u, v, w = (np.concatenate(acc) for acc in tri)
    k4 = np.zeros(n, dtype=np.int64)
    for (a, b, c), x in extend((u, v, w), w):
        keep = edge(a, x) & edge(b, x)
        for col in (a, b, c, x):
            k4 += np.bincount(col[keep], minlength=n)
    return k4


def host_counts(db) -> tuple[dict, int]:
    """Counts of the cliques, acyclic and lollipop shapes from walk
    vectors and per-vertex clique counts, on the host with scipy and numpy
    alone (conjunctive-query semantics: only adjacent variables must
    differ):

    * 3-clique = Σ_c t(c) / 3, with t(c) the triangles through c;
    * 4-clique = Σ_d k4(d) / 4, with k4(d) the 4-cliques through d
      (``host_k4``);
    * 3-path = v2ᵀ A³ v1;
    * 2-lollipop = Σ_c (A² v1)[c] · t(c);
    * 3-lollipop = Σ_d (A³ v1)[d] · k4(d).

    Also returns the rows ``engine="vlftj"`` would materialize for the
    3-lollipop before its last level, Σ_d k4(d) · (A · deg)[d]."""
    import scipy.sparse as sp
    csr = db.csr
    n = csr.n_nodes
    a = sp.csr_matrix((np.ones(csr.indices.shape[0], dtype=np.int64),
                       csr.indices, csr.indptr), shape=(n, n))
    v1, v2 = (np.isin(np.arange(n), db.unary[u]).astype(np.int64)
              for u in ("v1", "v2"))
    w2 = a @ (a @ v1)
    w3 = a @ w2
    t = np.asarray(a.multiply(a @ a).sum(axis=1)).ravel() // 2
    k4 = host_k4(csr)
    return ({"3-clique": int(t.sum()) // 3, "3-path": int(v2 @ w3),
             "2-lollipop": int(w2 @ t), "3-lollipop": int(w3 @ k4),
             "4-clique": int(k4.sum()) // 4},
            int(k4 @ (a @ csr.degrees)))


def cross_checks(T, dbs, counts):
    for shape in SHAPES:
        if shape != "4-cycle":   # a<b<c<d only slices the id space
            need(counts["plain", shape] == counts["hybrid", shape],
                 f"{shape}: plain {counts['plain', shape]} != hybrid "
                 f"{counts['hybrid', shape]}")
    for db_name, db in dbs.items():
        t0 = time.perf_counter()
        expect, lollipop_rows = host_counts(db)
        log(f"host counts {db_name}: {json.dumps(expect)}; 3-lollipop "
            f"vlftj would materialize {lollipop_rows} rows "
            f"({time.perf_counter() - t0:.3f} s)")
        for shape, n in expect.items():
            need(counts[db_name, shape] == n,
                 f"{db_name} {shape}: {counts[db_name, shape]} != host {n}")
        for shape in ("3-path", "2-lollipop"):
            t0 = time.perf_counter()
            n = T.count(T.get_query(shape), db, engine="vlftj")
            log(f"vlftj {db_name} {shape}: {n} "
                f"({time.perf_counter() - t0:.3f} s)")
            need(n == counts[db_name, shape],
                 f"{db_name} {shape}: auto {counts[db_name, shape]} != "
                 f"vlftj {n}")


def small_scale(T):
    """At 5% scale, every shape but the 3-lollipop enumerated on the card
    and on the plain CPU path (identical arrays), the 3-lollipop counted
    on both; on the card, each enumeration's length against its count and
    three counts against ``engine="vlftj"``."""
    import torch
    from repro_torch.core import engine as E
    got, card_rows = {}, {}
    for device in ("cuda", "cpu"):
        _, db, hdb = bench_gdb(T, SMALL_SCALE, device)
        for db_name, d in (("plain", db), ("hybrid", hdb)):
            for shape in SHAPES:
                t0 = time.perf_counter()
                q = T.get_query(shape)
                if shape not in ENUM_SHAPES:
                    got[device, db_name, shape] = T.count(q, d)
                    continue
                rows = E.enumerate(q, d, mode="flat").rows
                got[device, db_name, shape] = rows.shape[0]
                if device == "cuda":
                    n = T.count(q, d)
                    need(n == rows.shape[0],
                         f"scale {SMALL_SCALE} {db_name} {shape}: "
                         f"{rows.shape[0]} rows != count {n}")
                    card_rows[db_name, shape] = rows
                else:
                    need(np.array_equal(rows, card_rows.pop((db_name, shape))),
                         f"scale {SMALL_SCALE} {db_name} {shape}: card and "
                         "CPU enumerations differ")
                log(f"enumerate {device} {db_name} {shape}: {rows.shape[0]} "
                    f"rows ({time.perf_counter() - t0:.3f} s)")
        if device == "cuda":
            torch.cuda.synchronize()
            for shape in ("3-path", "2-lollipop", "3-lollipop"):
                t0 = time.perf_counter()
                n = T.count(T.get_query(shape), db, engine="vlftj")
                log(f"vlftj scale {SMALL_SCALE} plain {shape}: {n} "
                    f"({time.perf_counter() - t0:.3f} s)")
                need(n == got[device, "plain", shape],
                     f"scale {SMALL_SCALE} {shape}: auto "
                     f"{got[device, 'plain', shape]} != vlftj {n}")
    for (device, db_name, shape), n in got.items():
        if device == "cuda":
            need(n == got["cpu", db_name, shape],
                 f"scale {SMALL_SCALE} {db_name} {shape}: cuda {n} != cpu "
                 f"{got['cpu', db_name, shape]}")
    log("scale", SMALL_SCALE, json.dumps(
        {f"{db}/{s}": n for (dv, db, s), n in got.items() if dv == "cuda"}))


def baseline_records() -> dict:
    """``name -> ("count", n)`` or ``("blowup", rows)`` for the Table 6
    and 7 records of ``BENCH_baseline.json`` (the JAX package's counts)."""
    import re
    path = Path(__file__).resolve().parent / BASELINE
    out = {}
    for r in json.loads(path.read_text())["records"]:
        if not r["name"].startswith(("t6/", "t7/")):
            continue
        m = re.search(r"blowup_rows=(\d+)", r["derived"])
        if m:
            out[r["name"]] = ("blowup", int(m.group(1)))
        elif r["count"] is not None:  # not the 2-tree's vlftj "-"
            out[r["name"]] = ("count", r["count"])
    return out


def oracle_gdb(T, dataset: str, scale: float, selectivity: float,
               device: str):
    """A benchmark db as ``benchmarks/common.py`` ``bench_gdb`` makes it."""
    from repro_torch.graphs import make_snap_like, node_sample
    g = make_snap_like(dataset, seed=SEED, scale=scale)
    unary = {f"v{i}": node_sample(g.n_nodes, selectivity, seed=17 * i + 1)
             for i in range(1, 5)}
    return T.GraphDB(g, unary, device=device)


def held_count(T, query, db, engine: str, want: tuple, name: str):
    """Plan with ``engine`` (outside the timer, as the benchmarks do),
    count with the default ``verify=True`` and hold the count, or the
    ``JoinBlowup`` rows at ``BINARY_CAP``, to the record ``want``.
    Returns ``(count or blowup rows, wall seconds)``; a count is a
    Python int, so the card has finished when it returns."""
    plan = T.plan_query(query, T.GraphStats.of(db), engine=engine)
    kw = dict(cap=BINARY_CAP) if engine == "binary" else {}
    t0 = time.perf_counter()
    try:
        got = ("count", T.count(query, db, plan=plan, **kw))
    except T.JoinBlowup as e:
        need(e.cap == BINARY_CAP, f"{name}: blowup at cap {e.cap}")
        got = ("blowup", e.rows)
    wall = time.perf_counter() - t0
    need(got == want, f"{name}: {got} != record {want}")
    return got[1], wall


def oracle_tables(T, device: str = "cuda") -> dict:
    """Tables 6 and 7 rebuilt with the port, each count held to the JAX
    package's record: the card engines (``vlftj``, ``hybrid`` and
    ``yannakakis``) on ``device``, ``binary`` on the host at
    ``BINARY_CAP``.  One JSON line per table and db with the counts, the
    walls and the launches by kernel; returns the launches summed."""
    from repro_torch.kernels import build
    recs = baseline_records()
    build.reset_launches()
    total = dict.fromkeys(build.LAUNCHES, 0)
    cells = [("t6", ds, None, T6_SCALE, 8.0, CYCLIC,
              ("vlftj", "hybrid", "binary")) for ds in T6_DATASETS]
    cells += [("t7", ds, sel, T7_SCALE, float(sel), T7_SHAPES + ("2-tree",),
               ("ms-analogue", "vlftj", "binary"))
              for ds in T7_DATASETS for sel in T7_SELECTIVITIES]
    engine_of = {"ms-analogue": "yannakakis"}
    for table, ds, sel, scale, selectivity, shapes, engines in cells:
        t0 = time.perf_counter()
        db = oracle_gdb(T, ds, scale, selectivity, device)
        build_s = time.perf_counter() - t0
        before = dict(build.LAUNCHES)
        counts, walls = {}, {}
        for shape in shapes:
            q = T.get_query(shape)
            for tag in engines:
                name = "/".join([table, shape, ds]
                                + ([f"sel{sel}"] if sel else []) + [tag])
                if name not in recs:      # the 2-tree: ms-analogue only
                    continue
                n, wall = held_count(T, q, db, engine_of.get(tag, tag),
                                     recs[name], name)
                key = f"{shape}/{tag}"
                counts[key] = n if recs[name][0] == "count" else \
                    {"blowup_rows": n}
                walls[key] = wall
        launches = {k: v - before[k] for k, v in build.LAUNCHES.items()}
        for k, v in launches.items():
            total[k] += v
        log(json.dumps(dict(
            oracles=table, dataset=ds, selectivity=sel or 8, scale=scale,
            nodes=db.n_nodes, directed_edges=int(db.csr.n_edges),
            build_s=build_s, counts=counts, wall_s=walls,
            launches={k: v for k, v in launches.items() if v})))
    return total


def scalar_counts(T, device: str) -> dict:
    """``lftj_ref`` and ``minesweeper_ref`` counts of the cyclic shapes on
    Table 6's ca-GrQc, each held to the record: ``{shape/engine: [count,
    wall seconds]}``."""
    recs = baseline_records()
    db = oracle_gdb(T, ORACLE_DATASET, T6_SCALE, 8.0, device)
    out = {}
    for shape in CYCLIC:
        want = recs[f"t6/{shape}/{ORACLE_DATASET}/vlftj"]
        for engine in ("lftj_ref", "minesweeper_ref"):
            out[f"{shape}/{engine}"] = list(held_count(
                T, T.get_query(shape), db, engine, want,
                f"{shape}/{engine}"))
    return out


def _scalar_worker(conn, src: str) -> None:
    """Child process: :func:`scalar_counts` on the host, sent back as
    ``("ok", counts)`` or ``("error", traceback)``.  The scalar oracles
    read only the db's host CSR, so the child never touches the card."""
    import traceback
    try:
        sys.path.insert(0, src)
        import torch
        torch.set_num_threads(1)
        import repro_torch.core as T
        conn.send(("ok", scalar_counts(T, "cpu")))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def start_scalar_counts(src: Path):
    """Start :func:`scalar_counts` in a child process (the scalar
    oracles are host-bound Python for minutes, so they run beside the
    card paths); returns ``(process, receiving end)``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_scalar_worker, args=(send, str(src)),
                       daemon=True)
    proc.start()
    send.close()
    return proc, recv


def scalar_oracles(T, worker, device: str = "cuda") -> None:
    """The scalar oracles on Table 6's ca-GrQc: the worker's
    ``lftj_ref`` and ``minesweeper_ref`` counts of the cyclic shapes (held
    to the records there), and the 3-clique's rows from ``lftj_ref``,
    ``minesweeper_ref``, ``binary`` and ``vlftj`` on ``device`` as
    identical arrays."""
    from repro_torch.core import engine as E
    from repro_torch.kernels import build
    proc, recv = worker
    t0 = time.perf_counter()
    try:
        status, counts = recv.recv()
    except EOFError:
        proc.join()
        raise SmokeFailure("the scalar oracle worker died with exit code "
                           f"{proc.exitcode}") from None
    waited = time.perf_counter() - t0
    proc.join()
    need(status == "ok", f"scalar oracle counts failed:\n{counts}")
    db = oracle_gdb(T, ORACLE_DATASET, T6_SCALE, 8.0, device)
    before = dict(build.LAUNCHES)
    rows, walls = {}, {}
    for engine in ENUM_ENGINES:
        t0 = time.perf_counter()
        rows[engine] = E.enumerate(T.get_query("3-clique"), db,
                                   engine=engine, mode="flat").rows
        walls[engine] = time.perf_counter() - t0
    for engine in ENUM_ENGINES[1:]:
        need(np.array_equal(rows[engine], rows[ENUM_ENGINES[0]]),
             f"3-clique rows: {engine} != {ENUM_ENGINES[0]}")
    need(rows["vlftj"].shape[0] == counts["3-clique/lftj_ref"][0],
         "3-clique rows != count")
    log(json.dumps(dict(
        oracles="scalar", dataset=ORACLE_DATASET, scale=T6_SCALE,
        counts={k: n for k, (n, _) in counts.items()},
        wall_s={k: w for k, (_, w) in counts.items()}, waited_s=waited,
        enumerated_rows=int(rows["vlftj"].shape[0]), enumerate_wall_s=walls,
        launches={k: v - before[k] for k, v in build.LAUNCHES.items()
                  if v - before[k]})))


def verifier_lines(T, dbs) -> None:
    """``verify_for_execution`` of the six tier-1 ``auto`` plans on the
    full-scale dbs: no error, findings logged by rule and severity, no
    kernel launched; the first (cold) and a memoized call timed.  Then a
    plan whose GAO repeats a variable (V101) must raise
    ``PlanVerificationError`` from ``count`` before any launch."""
    import collections
    import dataclasses
    from repro_torch.analysis import (PlanVerificationError,
                                      verify_for_execution, verifier)
    from repro_torch.kernels import build
    verifier._VERIFY_CACHE.clear()      # so the first call is cold
    for db_name, db in dbs.items():
        before = dict(build.LAUNCHES)
        plans, findings, cold, warm = {}, {}, {}, {}
        for shape in SHAPES:
            plan = T.plan_query(T.get_query(shape), T.GraphStats.of(db),
                                engine="auto")
            t0 = time.perf_counter()
            found = verify_for_execution(plan, db)
            cold[shape] = time.perf_counter() - t0
            t0 = time.perf_counter()
            need(verify_for_execution(plan, db) == found,
                 f"{db_name} {shape}: memoized findings differ")
            warm[shape] = time.perf_counter() - t0
            need(not [f for f in found if f.severity == "error"],
                 f"{db_name} {shape}: {found}")
            plans[shape] = plan.describe()
            findings[shape] = dict(collections.Counter(
                f"{f.rule}/{f.severity}" for f in found))
        need(build.LAUNCHES == before,
             f"{db_name}: verification launched kernels")
        log(json.dumps(dict(
            verifier=db_name, plans=plans, findings=findings,
            cold_s=cold, memoized_s=warm)))
    db = dbs["plain"]
    q = T.get_query("4-cycle")
    plan = T.plan_query(q, T.GraphStats.of(db), engine="vlftj")
    bad = dataclasses.replace(plan, gao=(plan.gao[0],) * len(plan.gao),
                              levels=plan.levels)
    before = dict(build.LAUNCHES)
    try:
        T.count(q, db, plan=bad)
    except PlanVerificationError as e:
        rules = sorted({f.rule for f in e.findings})
    else:
        raise SmokeFailure("a GAO repeating a variable was not rejected")
    need("V101" in rules, f"bad plan rejected by {rules}, not V101")
    need(build.LAUNCHES == before, "the rejected plan launched kernels")
    log(json.dumps(dict(verifier="rejected", gao=list(bad.gao),
                        rules=rules)))


def oracles_phase(T, dbs, worker) -> dict:
    """The ``oracles`` phase: Tables 6 and 7, the scalar oracles (their
    counts from ``worker``, :func:`start_scalar_counts`) and the verifier
    lines; returns the launches of the tables' card counts."""
    t0 = time.perf_counter()
    launches = oracle_tables(T)
    log(f"oracle tables: {time.perf_counter() - t0:.2f} s, launches "
        f"{launches}")
    need(launches["searchsorted_segments"] > 0,
         "the oracle tables never launched searchsorted_segments")
    t0 = time.perf_counter()
    scalar_oracles(T, worker)
    log(f"scalar oracles: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    verifier_lines(T, dbs)
    log(f"verifier: {time.perf_counter() - t0:.2f} s")
    return launches


def main(argv=None) -> int:
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run, of "
                         f"{', '.join(PHASES)}, or oracles, the last part "
                         "of join alone (default: all; the kernels "
                         "line and the last line come only from a run of "
                         "all)")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES + ("oracles",)):
        ap.error(f"--phases takes {', '.join(PHASES)} or oracles (the "
                 "last part of join alone)")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: the port's package is not under {src}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch.core as T

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    worker = None
    if "join" in phases or "oracles" in phases:
        worker = start_scalar_counts(src)
    try:
        return run_phases(T, phases, smi, worker)
    finally:
        if worker is not None and worker[0].is_alive():
            worker[0].terminate()
        if worker is not None:
            worker[0].join()


def run_phases(T, phases, smi: str, worker) -> int:
    """The phases of ``main``, in order; ``worker`` computes the scalar
    oracles' counts beside them."""
    import torch
    from repro_torch.configs import CHATGLM3_6B, STABLELM_3B
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s "
        f"({build.build_info['path']})")
    for line in build.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    if {"kernels", "join", "oracles"} & set(phases):
        t0 = time.perf_counter()
        g, db, hdb = bench_gdb(T, 1.0, "cuda")
        dbs = {"plain": db, "hybrid": hdb}
        log(f"graph {DATASET}: {g.n_nodes} nodes, {g.indices.shape[0]} "
            f"directed edges, max degree {g.max_degree}, {hdb.n_hubs} hubs "
            f"x {hdb.layout.n_words} words ({time.perf_counter() - t0:.2f} "
            "s)")

    kern = {}
    if "kernels" in phases:
        for phase in (lambda: kernel_phase(T, db, hdb),
                      lambda: kernel_phase_intersect(T, db, hdb),
                      kernel_phase_lm, kernel_phase_outer):
            lines = phase()
            for name, k in lines.items():
                log(f"kernel {name}: {json.dumps(k)}")
            kern.update(lines)

    if "join" in phases:
        t0 = time.perf_counter()
        counts, launches = main_path(T, dbs)
        log(f"main path: {time.perf_counter() - t0:.2f} s, launches "
            f"{launches}")
        for name in ("searchsorted_segments", "bitset_member_mask"):
            need(launches[name] > 0, f"the main path never launched {name}")
        profile_count(T, db, "4-cycle")
        # the hybrid db's 4-cycle: its all-hub rows take the bitset mask
        profile_count(T, hdb, "4-cycle", db_name="hybrid")

        t0 = time.perf_counter()
        cross_checks(T, dbs, counts)
        log(f"cross-checks: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        auto_launches = auto_path(T, dbs, counts)
        log(f"auto path: {time.perf_counter() - t0:.2f} s, launches "
            f"{auto_launches}")
        t0 = time.perf_counter()
        mode_turns(T, db)
        log(f"mode turns: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        single_modes(T, db, counts)
        log(f"single modes: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        stream_launches = stream_path(T, db, counts)
        log(f"stream path: {time.perf_counter() - t0:.2f} s, launches "
            f"{stream_launches}")
        t0 = time.perf_counter()
        small_scale(T)
        log(f"small scale: {time.perf_counter() - t0:.2f} s")
    if "join" in phases or "oracles" in phases:
        t0 = time.perf_counter()
        oracles_phase(T, dbs, worker)
        log(f"oracles: {time.perf_counter() - t0:.2f} s")

    if "lm" in phases:
        # each model's serving path with its own counters, summed
        lm_launches = dict.fromkeys(build.LAUNCHES, 0)
        for cfg in (CHATGLM3_6B, STABLELM_3B):
            t0 = time.perf_counter()
            served, _ = lm_serve(cfg)
            log(f"lm serve {cfg.name}: {time.perf_counter() - t0:.2f} s, "
                f"launches {served}")
            for k, n in served.items():
                lm_launches[k] += n
        parity_launches = dict.fromkeys(build.LAUNCHES, 0)
        for cfg in (CHATGLM3_6B, STABLELM_3B):
            t0 = time.perf_counter()
            checked = lm_parity(cfg)
            log(f"lm parity {cfg.name}: {time.perf_counter() - t0:.2f} s, "
                f"launches {checked}")
            for k, n in checked.items():
                parity_launches[k] += n

    if phases != list(PHASES):
        log(f"partial run of {phases}: every check passed")
        return 0
    # each kernel once, with the launches of the path that runs it: the
    # bsearch main path for the first two, the auto path for the tile
    # kernel (the mask form of intersect_count_pallas; its count form is
    # the "kernel intersect_count" line above), the LM serving paths of
    # both models for the wgmma flash kernel, their f32 parity paths for
    # the mma.sync one (both replace flash_attention_pallas, split by
    # dtype and head dim); no path runs the bitset AND-popcount or the
    # segment outer product, which only the kernel router reaches
    entries = (("searchsorted_segments", "searchsorted_segments",
                launches["searchsorted_segments"]),
               ("bitset_member", "bitset_member",
                launches["bitset_member_mask"]),
               ("intersect_count", "tile_member_mask",
                auto_launches["tile_member_mask"]),
               ("bitset_intersect_count", "bitset_intersect_count",
                auto_launches["bitset_intersect_count"]),
               ("flash_attention_tc", "flash_attention_tc",
                lm_launches["flash_attention_tc"]),
               ("flash_attention_mma", "flash_attention_mma",
                parity_launches["flash_attention_mma"]),
               ("segment_outer", "segment_outer",
                lm_launches["segment_outer"]))
    keys = ("source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=n,
             **{k: kern[measured][k] for k in keys})
        for name, measured, n in entries]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
