"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,join,serve,dist,lm,train,gnn,arch]

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
shapes, granite-moe-3b-a800m's (D 64, GQA group 3) and
moonshot-v1-16b-a3b's (D 128, group 1), the mma.sync
kernel and SDPA on the same tensors, and a bf16 sweep over D 16-128,
GQA groups, causal offsets, short and ragged streams and strided
views) and the rest on mma.sync (``flash_attention_mma``: f32 in
3xTF32 at the path shape and the f32 sweep, bf16 at D 72, 40 and 8 at
stablelm-3b's shape, and a sweep of off-grid head dims in both dtypes,
strided and offset views among them).  The two lines count the
``HGMMA`` and ``HMMA`` instructions in the built library's SASS where
``cuobjdump`` exists.  The flash backward has two kernels, routed
as the forward is, each given the log-sum-exp its forward saves: bf16
with D a multiple of 16 on wgmma (``flash_attention_bwd_tc``) and the
rest on mma.sync (``flash_attention_bwd``: float32 as 3xTF32, bf16 at
the other head dims).  The first runs at the four models' heads at B 1 x
T 4096 in bf16, each of dq, dk and dv held against its plain version
relative to its largest |want| (2e-2), two calls bitwise equal, timed
beside its bound, SDPA's backward and the mma.sync kernel forced on the
same tensors; the second at the f32 path shape (2e-5) and in bf16 at
D 72 with stablelm-3b's heads (2e-2), the same way, beside the FFMA
kernel it replaced; each forward's lse is held against its plain
version there and on rows that see no key (1e-3 in log2 units; +inf on
those rows) with ``o`` bitwise unchanged by it; both run a 1,000-case
sweep through their routes (f32 at 2e-5 and bf16, head dims 8-128, GQA
groups 1-4 and 16, causal offsets, rows that see no key, strided
views); and ``torch.autograd.grad`` of ``ops.flash_attention`` launches
each once a backward (bf16 and float32).  The segment outer
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
* ``serve``: the port's ``QueryServer`` on the same CSR (``device=
  "cuda"``) answers the six shapes at selectivity 8 and 80 through
  ``execute_many`` twice (the second pass all plan-cache hits), each count
  equal to a direct ``count`` on the server's db; the 4-cycle through
  ``execute_concurrent`` beside four small 3-cliques, unpreempted
  (``fifo``) and in 50-500 quanta, the same counts and rows expanded, and
  a snapshot taken halfway, sent through ``PlanSnapshot.to_bytes`` /
  ``from_bytes`` and resumed by a fresh scheduler to the same count;
  ``limit=`` pages of the 3-path and their ``next_cursor``
  continuations, equal to ``enumerate(limit=)`` row for row;
  ``benchmarks/bench_serve.py``'s quick workload (both policies) with
  every deterministic field of ``BENCH_serve.json`` held exactly; one
  request traced and profiled (every level's estimate and observation,
  an event-timed kernel wall within the request's wall, the device's
  peak bytes, ``check_runtime`` clean), with the same count, engine
  meters and launches as with neither, EXPLAIN ANALYZE, the metrics
  snapshot, and two threads profiling at once;
* ``dist``: the server's partitioned route (``dist_edge_threshold``
  lowered to the graph's 1,778,854 directed edges) answers the 3-clique,
  4-clique and 4-cycle at selectivity 8 as ``vlftj+partitioned``
  over 4 worker threads x 2 parts, each count equal to the same parts
  run in sequence and to the unpartitioned engine (the three walls
  printed), the lollipops through the planner's engine on the same
  server, 3-path pages through the route equal to
  ``enumerate(limit=)``, and a dead worker's parts re-dealt; every
  deterministic field of ``BENCH_dist.json``'s join, skew and
  sharded-CSR rows held exactly (``spmd_join_step`` and
  ``AdaptiveJoin`` on the card, ``sharded_count`` on the host); the
  SPMD steps at world size 1 over NCCL at full scale (the 889,427-row
  triangle level replicated, with a ``FrontierRebalancer``, and over a
  1-shard ``ShardedGraphDB``, each equal to the 3-clique count, and the
  SpMV against ``index_add_``);
* chatglm3-6b, stablelm-3b and the two MoE models granite-moe-3b-a800m
  (40 experts, top 8, heads of 64 in GQA groups of 3) and
  moonshot-v1-16b-a3b (64 experts, top 6, two shared experts) served at
  full width and depth in bf16 (``lm serve``): 4 requests of 2048 prompt
  tokens, prefill (one launch of the wgmma flash kernel a layer, 28, 32,
  32 and 48, none of the mma.sync one) and 32 greedy decode steps, then
  one prefill profiled; an MoE model's line adds its parameter and
  active-parameter counts, its capacities at prefill and decode, the
  picks each layer's prefill drops and the experts' least and greatest
  load (each layer's input recorded in one more prefill and routed
  again), and a second profile, replayed on those inputs, names the MoE
  dispatch's share of the prefill's device time; each model at full
  width with 2 layers in f32
  (``lm parity``, on the mma.sync flash kernel): the card's prefill and
  decode logits against the port's CPU path (1e-3; an MoE model's router
  picks equal first, at its own capacity factor) and decode against
  ``forward`` over the concatenated stream (2e-4; an MoE model at
  ``capacity_factor = n_experts / top_k``, where nothing drops); and on
  one layer of each MoE model at a prefill's 4 x 2048 tokens in bf16,
  the one-card MoE FFN against the same layer in float32 on upcast
  copies (router picks equal first, then 2^-7), and
  ``layers.moe.moe_ffn`` over a world-size-1 NCCL group against the
  one-card MoE FFN in ``ep`` and ``tp`` mode (2^-8, one bf16 rounding
  step);
* ``train``: stablelm-3b trained at full width and depth in bf16 through
  ``Trainer.run`` (6 steps of 4 x 4096 tokens in 2 microbatches, remat
  on, from ``LMTokenPipeline`` over a token file with a learnable
  pattern): the loss finite and falling, the gradient norms finite, 4
  launches of the wgmma flash kernel and 2 of the tensor-core backward
  a layer a step, none of the mma.sync one or the mma.sync backward; one
  more step profiled (every gradient leaf finite; device time of the
  bf16 and the float32 GEMMs, the flash forward and backward, the
  optimizer and the rest, and the idle share); a 2-layer
  run checkpointed every 2 steps, restored bit for bit, its newest
  checkpoint corrupted and skipped, and resumed to the straight run's
  losses; the same 2-layer runs on a (1, 1) ``DeviceMesh`` over a
  world-size-1 NCCL group (the params DTensors laid out by
  ``param_specs``, the flash kernels launched through their custom ops:
  2 forward and 1 backward a layer a microbatch a step), its checkpoint
  restored with ``shardings=`` bit for bit, saved and restored timed,
  and resumed from step 2 on the mesh and on plain card tensors to the
  straight run's losses; one float32 train step of stablelm-3b and granite-moe-3b-a800m
  at full width and 2 layers on the card against the CPU path (router
  picks equal, loss and gradient norm within 1e-4, parameters within 3
  learning rates); one bf16 layer's gradients against float32 on upcast
  copies (stablelm-3b's dense layer, granite's MoE FFN; 2^-5 of each
  leaf's largest gradient); stablelm-3b's bf16 embedding gradient at the
  train step's 4 x 4096 Zipf tokens against float32 (2^-5 of its
  largest gradient; summed in float32) and against a second run (bit
  for bit); and the
  data-parallel and compressed train
  steps over a world-size-1 NCCL group on the tiny model of
  ``tests/test_fault_tolerance.py``, to its convergence criteria;
* ``gnn``: GatedGCN (16 layers x 70), PNA (4 x 75), EGNN (4 x 64) and
  MACE (2 layers, 128 channels, l_max 2, correlation 3) trained in
  float32 through ``Trainer.run`` at the JAX package's launcher scale (6
  steps, AdamW lr 3e-4, on one fixed graph of 100,000 nodes and
  1,600,000 directed edges moved to the card once): losses and
  gradient norms finite, every parameter leaf the loss reaches moved,
  step seconds, edges per second, peak memory, and one more step
  profiled (device time of the gathers, the scatters, the GEMMs and the
  rest, and the idle share); each model at full width on a 2,048-node
  graph, 8 card runs against the port's CPU path (loss, outputs and
  every gradient leaf within 1e-4 of its largest |want|; GatedGCN's
  gradients within 1e-2, where a ReLU input within rounding of 0 moves a
  whole edge term with the order of the card's atomic sums), MACE's ``loop``,
  ``couple_chunks=16``, ``remat`` and ``shard_couple`` against
  ``outer`` on the card (1e-5) and ``compute_bf16`` against float32
  (2^-5); one train step on each of the JAX package's one-card GNN
  shapes (``full_graph_sm`` for the four, ``molecule`` for EGNN and
  MACE); and ``examples/train_gnn_wcoj_features.py`` in the port: the
  3-cliques of an 800-node graph enumerated by ``VLFTJ`` on the card
  (``searchsorted_segments`` launched), each node's count equal to the
  host's, and GatedGCN's loss lower with the triangle features than
  without;
* ``arch``: the architecture registry (``ARCHS``: the JAX package's 11
  ids in its order, every ``smoke(device="cuda")`` finite, the paper
  engine's triangles from ``vlftj`` equal to ``lftj_ref``'s); xDeepFM at
  full width (39 fields x 1,000,000 rows x 10 dims, CIN 200-200-200, MLP
  400-400, float32) trained through the training launcher's wiring (6
  AdamW steps of 65,536 rows in 4 microbatches; step seconds, rows per
  second, peak memory, one more step profiled: embedding gathers,
  scatters, the CIN, the other GEMMs, the optimizer, the rest, and the
  idle share), its ``serve_p99`` (512 rows), ``serve_bulk`` (262,144 rows
  in chunks of 32,768) and ``retrieval_cand`` (1 x 1,000,000) forwards
  timed, and the reduced config on the card against the CPU (logits,
  loss and gradients within 1e-4 of each part's largest |want|, ids
  outside the vocabulary among them); command-r-plus-104b at full width
  with 8 of its 64 layers through the ``lm`` serving path (one wgmma
  flash launch a prefill layer, at D 128 and GQA group 12, and that
  shape against its plain version at 2e-2); ``launch.train.main`` at
  ``--reduced`` for the 10 trainable ids on the card (each loss finite)
  and ``--arch wcoj`` refused with the JAX launcher's message; and
  ``launch.serve.main`` at its defaults (50 requests on
  ``powerlaw_cluster(20000, 6)``), every served count equal to a direct
  count on the server's db; last, ``launch.dryrun`` of stablelm-3b's
  ``train_4k`` at the ``train`` phase's 4 x 4096 and of xDeepFM's
  ``train_batch`` on the host (fake CPU tensors, no launch): each line
  gives the FLOPs by operand type, the unfused bytes, the compute and
  memory terms at the H100 SXM peaks and their bound beside the step
  seconds measured in this run, and the card's name and power limit;
  then the per-chip programs on the production meshes (``arch mesh``
  lines): the dry run of stablelm-3b's ``train_4k``, xDeepFM's
  ``train_batch`` and WCOJ's ``triangle_frontier`` on 16x16 and
  2x16x16 (one chip's FLOPs by type, bytes, collectives by kind, the
  three terms and the bottleneck), chip 0's WCOJ join step on 16x16 on
  the card (a seeded random sorted CSR of the cell's 3,072,441 nodes
  and 234,370,166 entries; its 65,536 frontier rows; the count equal to
  the unsharded level step's exactly; ``searchsorted_segments``
  launched under its sharding rule) and chip 0's stablelm-3b train step
  on 16x16 (16 x 4096 tokens, 2 local heads, 32 layers; one warm-up and
  two timed steps over a fake process group, whose collectives move
  nothing; the loss finite; ``flash_attention_tc`` and
  ``flash_attention_bwd_tc`` launched under their sharding rules; the
  step's seconds beside the dry run's per-chip bound, peak memory).

The counts are checked against counts made on the host with scipy and
numpy alone (the cliques, 3-path and lollipops), across the two dbs
where the filters are renumbering invariant, and 3-path and the
2-lollipop against ``engine="vlftj"``.  At 2% scale every shape but the
3-lollipop is enumerated on the card and on the port's plain CPU path,
and the arrays must be identical (the CPU half runs in a child process
beside the card paths and sends back each array's SHA-256 digest; the
3-lollipop's 332,926,959 rows are too many to materialize; its counts
are compared instead).  Any failure
raises and exits non-zero.

Needs one CUDA device and the rest of the repository; it imports nothing
of JAX.  Prints one JSON line per shape and path, a ``kernels`` JSON
line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset (the
kernels against their plain versions, the join paths, the LM paths,
``oracles``, the last part of the join paths alone, or ``flash_bwd``,
the flash backward's part of the kernels alone) and then prints
neither the ``kernels`` line nor the last line (``--phases serve`` runs
the query server's phase alone, ``--phases dist`` distributed
execution's, ``--phases train`` training's, ``--phases gnn`` the
GNNs', ``--phases arch`` the registry's, xDeepFM's, command-r's, the
launchers', the dry run's and the per-chip programs', without a
measured stablelm-3b step).  It prints the whole script's seconds (``script:``) before
the card's line.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# 2%: the 2-lollipop's 13.8 M rows a db (33.0 M at 5% took 60 s on the
# card a db and pushed the whole run past 1,000 s on a slower host)
SMALL_SCALE = 0.02
#: shapes enumerated at SMALL_SCALE (the 3-lollipop's output is too big)
ENUM_SHAPES = SHAPES[:-1]
#: check_mode="auto"'s tile width on the main path, and the tile width of
#: the tile-only runs (at least the max degree, 1,577, so nothing is cut)
TILE_WIDTH, FULL_TILE_WIDTH = 512, 2048
INT32_MAX = 2 ** 31 - 1
#: the H100 SXM peaks (HBM bytes/s, int32 ops/s, and the FLOP/s of bf16
#: and TF32 on the tensor cores and of float32 on the CUDA cores) come
#: from ``repro_torch.launch.roofline`` (:func:`peaks`), the dry run's
#: roofline, so that both use one table
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
#: ``moe_ffn`` over NCCL against the one-card MoE FFN, both in bf16, as
#: absolute and relative tolerance: one bf16 rounding step of the output
#: (8 significant bits) fits within it at every |value| below 2, and the
#: line prints the largest |value| beside the error
MOE_FFN_TOL = 2.0 ** -8
#: the one-card MoE FFN in bf16 against the same layer in float32 on
#: upcast copies of its input and weights (TF32 off), absolute and
#: relative: the bf16 path rounds the experts' hidden activations, the
#: routed and the shared outputs and their sum to bf16, four roundings of
#: at most 2^-9 of their magnitudes each
MOE_BF16_TOL = 2.0 ** -7
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
#: the join paths, the query server and its scheduler, distributed
#: execution, the LM serving paths, LM training, GNN training
PHASES = ("kernels", "join", "serve", "dist", "lm", "train", "gnn",
          "arch")
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


# CUPTI delivers a profile window's device activity to ``torch.profiler``.
# In one whole run of this script on an H100 it delivered none for two
# windows in a row whose kernels had run, and the kernels phase failed; a
# window that comes back without device activity is run again, after the
# allocator's cached blocks are released, up to ``PROFILE_TRIES`` times.
PROFILE_TRIES = 3
PROFILER_EMPTY: list[str] = []
#: profile windows ``device_ms`` takes the median of
DEVICE_MS_WINDOWS = 3
#: kernel -> ``device_ms`` windows that recorded fewer launches than calls
SHORT_WINDOWS: dict[str, int] = {}
#: the kernel ``open_window`` launches (``torch.cuda._sleep``'s)
OPENING_KERNEL = "spin_kernel"


def open_window() -> None:
    """Launch one short spin kernel and wait for it, at the start of a
    profile window.  CUPTI often leaves out the first kernel launched in
    a window (``tools/profile_sum_cost.py``: 3 of 5 products recorded in
    most windows without it, 4 of 5 with it); this one takes that place
    and ``device_totals`` drops it where it is recorded."""
    import torch
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()


@dataclasses.dataclass
class DeviceTotal:
    """One name's device activity in a profile window, under the names
    ``key_averages()`` gives it: launches and device microseconds."""
    key: str
    count: int = 0
    self_device_time_total: float = 0.0


def device_totals(prof) -> list:
    """A closed profile window's device activity (kernels, copies,
    fills) by name, summed straight from its raw Kineto events.  The same
    sums under the same names as ``prof.key_averages()``'s device rows
    (a raw name is demangled as ``key_averages`` demangles it), but
    ``key_averages`` builds an event tree in Python first: 15.7 s for
    100,000 launches, against 0.95 s here (``tools/profile_sum_cost.py``,
    H100, torch 2.11), and a 4-cycle count launches several times
    that.  ``open_window``'s spin kernel is left out."""
    import torch
    from torch.autograd import DeviceType
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        return [e for e in prof.key_averages()
                if device_us(e) and OPENING_KERNEL not in e.key]
    out: dict[str, DeviceTotal] = {}
    names: dict[str, str] = {}
    for e in raw:
        if (e.device_type() != DeviceType.CPU
                and OPENING_KERNEL not in e.name()):
            name = e.name()
            if name not in names:
                names[name] = (torch._C._demangle(name) if len(name) > 1
                               else name)
            t = out.setdefault(names[name], DeviceTotal(names[name]))
            t.count += 1
            t.self_device_time_total += e.duration_ns() / 1e3
    return list(out.values())


def traced(fn, what: str) -> tuple:
    """``(events, out)``: the device activity (``device_totals``) of one
    call of ``fn`` under ``torch.profiler`` tracing the device only
    (synchronized before the window closes) and what that call returned.
    A window without device activity is retried (``PROFILE_TRIES``);
    where every try comes back empty, ``events`` is ``[]``, ``what`` is
    noted in ``PROFILER_EMPTY`` and the caller times with CUDA events or
    reports "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for i in range(PROFILE_TRIES):
        out = None
        if i:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            out = fn()
            torch.cuda.synchronize()
        events = device_totals(prof)
        if any(device_us(e) for e in events):
            if i:
                log(f"profiler: {what}: device activity on try {i + 1}")
            return events, out
        log(f"profiler: {what}: no device activity on try {i + 1}")
    PROFILER_EMPTY.append(what)
    return [], out


def fullest(fn, what: str, windows: int = 3) -> tuple:
    """``traced`` of ``fn`` in ``windows`` windows: the events of the one
    that recorded the most launches (CUPTI leaves launches out of a
    window, never adds any), the launches each window recorded, and
    what the last call returned.  ``([], counts, out)`` where no window
    recorded device activity."""
    best, counts, out = [], [], None
    for _ in range(windows):
        events, out = traced(fn, what)
        counts.append(sum(e.count for e in events))
        if counts[-1] > sum(e.count for e in best):
            best = events
    return best, counts, out


def device_ms(fn, reps: int, kernel: str, *more: str) -> float:
    """Device time of one launch of the CUDA kernel named ``kernel`` (its
    function name in ``csrc/``), from ``torch.profiler`` over ``reps``
    calls of ``fn``: the kernel's own time, averaged over the launches
    the profiler recorded, without the host's dispatch between launches
    that ``cuda_ms`` includes when a call's host work outlasts its kernel.
    The kernels named in ``more`` (launched with it, as a second pass,
    once a call or never) add the mean of their recorded launches.
    CUPTI leaves launches out of a window (often the first, sometimes
    more: ``tools/profile_sum_cost.py``), so each kernel is averaged over
    its own recorded launches, and the result is the median of
    ``DEVICE_MS_WINDOWS`` windows; a window with fewer than ``reps``
    launches of ``kernel`` is counted in ``SHORT_WINDOWS``.  Fails if the
    profiler records device activity but no launch of ``kernel``, in
    ``DEVICE_MS_WINDOWS + 2`` windows, naming what it recorded.  Where
    the profiler records no device activity at all (``traced``), the
    time is ``cuda_ms``'s: CUDA events over whole calls."""
    import statistics
    import torch

    def named(e, name):
        return f"::{name}(" in e.key or f"::{name}<" in e.key

    def calls():
        for _ in range(reps):
            fn()

    fn()
    torch.cuda.synchronize()
    got, seen = [], []
    for _ in range(DEVICE_MS_WINDOWS + 2):
        events, _ = traced(calls, f"device_ms {kernel}")
        if not events:
            log(f"profiler: {kernel}: ms from CUDA events over whole calls")
            return cuda_ms(fn, reps)
        per = {}
        for name in (kernel, *more):
            hits = [e for e in events if named(e, name)]
            n = sum(e.count for e in hits)
            if n:
                per[name] = sum(device_us(e) for e in hits) / 1e3 / n
                if name == kernel and n < reps:
                    SHORT_WINDOWS[kernel] = SHORT_WINDOWS.get(kernel, 0) + 1
        if kernel in per:
            got.append(sum(per.values()))
            if len(got) == DEVICE_MS_WINDOWS:
                break
        else:
            seen.append([(e.key[:80], e.count) for e in events
                         if device_us(e)])
    if not got:
        raise SmokeFailure(f"the profiler recorded no launch of {kernel}; "
                           f"on the device it recorded {seen}")
    return statistics.median(got)


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


def peaks():
    """``repro_torch.launch.roofline``: the H100 peaks ``PEAK_BYTES_S``,
    ``PEAK_INT32_OPS_S`` and ``PEAK_FLOPS_S`` (imported where used: the
    package is on the path only once ``main`` has put it there)."""
    from repro_torch.launch import roofline
    return roofline


def bound(k: dict) -> dict:
    """The larger of bytes over the HBM rate and the operations over their
    peak rate — int32 ops (``ops``) at the int32 rate, or floating-point
    operations (``flops``) at the peak of their type (``flops_type``) —
    and which of the two it is.  The peaks used are printed with it."""
    rl = peaks()
    t_bytes = k["bytes"] / rl.PEAK_BYTES_S
    if "flops" in k:
        k["peak_flops_s"] = rl.PEAK_FLOPS_S[k["flops_type"]]
        t_ops = k["flops"] / k["peak_flops_s"]
    else:
        k["peak_int32_ops_s"] = rl.PEAK_INT32_OPS_S
        t_ops = k["ops"] / rl.PEAK_INT32_OPS_S
    k["peak_bytes_s"] = rl.PEAK_BYTES_S
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
    bf16: D 64 and 128 with GQA groups 1, 4 and 16 (and 3 at D 64,
    granite-moe-3b-a800m's heads), every other multiple of 16 up to 128
    (16 to 48 run the 64 instance with zero columns, 80 its own, 96 and
    112 the 128 one) with groups 1 and 4; causal and not,
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
        for group in ((1, 3, 4, 16) if d == 64 else
                      (1, 4, 16) if d == 128 else (1, 4)):
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
    rl = peaks()
    k["bound_ffma_ms"] = k["bound_ms"]
    t_ops = 3 * k["flops"] / rl.PEAK_FLOPS_S["tf32"]
    k["bound_3xtf32_ms"] = 1e3 * max(k["bytes"] / rl.PEAK_BYTES_S, t_ops)
    if k["bound_3xtf32_ms"] < k["bound_ffma_ms"]:
        k["bound_ms"] = k["bound_3xtf32_ms"]
        k["bound_by"] = ("bytes" if k["bytes"] / rl.PEAK_BYTES_S >= t_ops
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


def flash_model_shape(cfg, randn) -> dict:
    """The wgmma kernel at an MoE model's prefill shape: ``cfg``'s query
    and KV heads, 4 requests of 2048 tokens, bf16, causal, as prefill
    passes them (granite-moe-3b-a800m: 24 and 8 heads of 64, the D 64
    instance at GQA group 3; moonshot-v1-16b-a3b: 16 and 16 of 128);
    against its plain version (2e-2) and timed beside SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import route
    bf = torch.bfloat16
    b, hq, hkv, t, d = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT,
                        cfg.head_dim)
    q, k, v = (randn(b, t, h_, d, dtype=bf).transpose(1, 2)
               for h_ in (hq, hkv, hkv))
    need(route(q.device, q.dtype, d) == "tc", f"flash route of {cfg.name}'s "
         "bf16 heads is not the tensor-core kernel")
    build.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    need(build.LAUNCHES["flash_attention_tc"] == 1
         and build.LAUNCHES["flash_attention_mma"] == 0,
         f"{cfg.name}'s shape did not launch flash_attention_tc: "
         f"{build.LAUNCHES}")
    err, ok = allclose_err(o, ref.flash_attention_ref(q, k, v), 2e-2)
    need(ok, f"flash_attention_tc (bf16, {cfg.name}'s shape) disagrees "
         f"with its plain version beyond 2e-2 (max abs err {err})")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    line = bound(dict(
        shape=f"q ({b}, {hq}, {t}, {d}) bf16 as a transposed (B, T, H, D) "
              f"view, k, v ({b}, {hkv}, {t}, {d}), causal",
        instance=f"D {d}", gqa_group=hq // hkv, max_abs_err=err,
        tolerance=2e-2,
        ms=device_ms(lambda: ops.flash_attention(q, k, v), 20,
                     "flash_attention_tc_kernel"),
        event_ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 20),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, enable_gqa=True), 20),
        library_call="scaled_dot_product_attention(q, k, v, "
                     "is_causal=True, enable_gqa=True), contiguous",
        flops_model="4 B Hq T^2 D / 2 (QK^T and PV, causal half)",
        flops=4 * b * hq * t * t * d / 2, flops_type="bf16",
        bytes=2 * q.nbytes + k.nbytes + v.nbytes))
    line["achieved_tflop_s"] = line["flops"] / line["ms"] / 1e9
    return line


def kernel_phase_lm():
    """The flash-attention kernels against their plain versions on the
    same CUDA tensors, at the shapes their paths give them; then timed,
    with the library call where PyTorch has one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import GRANITE_MOE_3B_A800M, MOONSHOT_V1_16B_A3B
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

    moe_shapes = {m.name.replace("-", "_").replace(".", "_"):
                  flash_model_shape(m, randn)
                  for m in (GRANITE_MOE_3B_A800M, MOONSHOT_V1_16B_A3B)}

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
        stablelm_3b=tc_stablelm, **moe_shapes,
        hgmma=sass_counts("HGMMA"))
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


#: the flash backward's lines: B 1 x T 4096 in bf16 (``train_4k``'s
#: sequence) with each model's heads, and its tolerance relative to the
#: largest |want| of each of dq, dk and dv: the forward's (2e-2 bf16,
#: 2e-5 f32)
FLASH_BWD_T = 4096
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
#: the mma.sync backward's kernels (f32, and bf16 off the multiples of 16;
#: the reduce kernel runs where the dk/dv kernel splits a GQA group's heads)
FLASH_BWD_KERNELS = ("flash_attention_bwd_mma_dq_kernel",
                     "flash_attention_bwd_mma_dkdv_kernel",
                     "flash_attention_bwd_mma_reduce_kernel")
#: the tensor-core backward's (bf16, D a multiple of 16; the reduce kernel
#: runs where the dk/dv kernel splits a GQA group's heads)
FLASH_BWD_TC_KERNELS = ("flash_attention_bwd_tc_dq_kernel",
                        "flash_attention_bwd_tc_dkdv_kernel",
                        "flash_attention_bwd_tc_reduce_kernel")
#: the tensor-core forward's log-sum-exp against its plain version,
#: absolute in log2 units: an error e scales P by 2^e, and 1e-3 is a third
#: of one bf16 rounding of P (2^-9)
FLASH_LSE_TOL = 1e-3
#: the mma route's backward lines, (B, Hq, Hkv, T, D): float32 at the
#: forward's f32 path shape (chatglm3-6b's heads, as the f32 parity runs
#: them) and bf16 at D 72 (off the multiples of 16) with stablelm-3b's
#: heads at B 1 x T 4096
FLASH_BWD_MMA_SHAPES = {"float32": (4, 32, 2, 2048, 128),
                        "bfloat16": (1, 32, 32, 4096, 72)}
#: the FFMA kernel the mma.sync backward replaced, at those shapes (device
#: ms), measured by this script's flash_bwd_mma_line before the redesign
#: on an NVIDIA H100 80GB HBM3 at 700 W (the PERF.md kernel table),
#: printed as ``previous_ms``
PREVIOUS_FFMA_BWD_MS = {"float32": 33.599, "bfloat16": 16.439}


def rel_err(got, want) -> float:
    """Max abs error of ``got`` against ``want`` over the largest |want|."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp(min=1e-30))


def same_bits(a, b) -> bool:
    """Whether two tensors of one dtype hold the same bits (NaN included)."""
    import torch
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """The (query, key) pairs attention computes for one head: every pair,
    or under the causal mask the keys at or before each query's position
    ``tk - tq + i``."""
    if not causal:
        return tq * tk
    pos = np.arange(tq) + (tk - tq)
    return int(np.clip(pos + 1, 0, tk).sum())


def device_total_ms(fn, reps: int) -> float:
    """Device time of every kernel ``fn`` launches, per call, from
    ``torch.profiler`` over ``reps`` calls (after one unprofiled call);
    ``cuda_ms``'s where the profiler records no device activity."""
    import torch
    fn()
    torch.cuda.synchronize()
    events, _ = traced(lambda: [fn() for _ in range(reps)],
                       "device_total_ms")
    if not events:
        return cuda_ms(fn, reps)
    return sum(device_us(e) for e in events) / 1e3 / reps


def bwd_errs(got, want) -> list:
    """Each of a backward's dq, dk, dv against the plain version's, relative
    to its largest |want|, after holding its shape, type and finiteness."""
    import torch
    for g, w in zip(got, want):
        need(g.shape == w.shape and g.dtype == w.dtype
             and bool(torch.isfinite(g).all()),
             f"flash backward: output {tuple(g.shape)} {g.dtype} is not "
             "the plain version's shape and type, or not finite")
    return [rel_err(g, w) for g, w in zip(got, want)]


def flash_bwd_errs(q, k, v, o, do, causal: bool = True, lse=None) -> list:
    """The backward of the forward's route and its plain version (which
    recomputes the log-sum-exp) on the same tensors: each of dq, dk, dv's
    error relative to its largest |want|."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    return bwd_errs(flash_attention_bwd_cuda(q, k, v, o, do, causal,
                                             lse=lse),
                    ref.flash_attention_bwd_ref(q, k, v, o, do, causal))


def flash_forward_lse(q, k, v, causal: bool = True) -> tuple:
    """The routed forward (either kernel) with the log-sum-exp on and off on
    the same inputs: ``o`` must keep its bits, and the lse must hold
    ``flash_attention_lse_ref`` (``FLASH_LSE_TOL``; +inf exactly on the rows
    that see no key).  Returns o, lse and a dict of the numbers."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     route)
    kernel = {"tc": "flash_attention_tc", "mma": "flash_attention_mma"}[
        route(q.device, q.dtype, q.shape[3])]
    plain_o = flash_attention_cuda(q, k, v, causal)
    o, lse = flash_attention_cuda(q, k, v, causal, return_lse=True)
    want = ref.flash_attention_lse_ref(q, k, causal)
    seen = torch.isfinite(want)
    blind_ok = torch.equal(torch.isposinf(lse), ~seen)
    err = float((lse[seen] - want[seen]).abs().max()) if seen.any() else 0.0
    what = (f"q {tuple(q.shape)} {q.dtype} k {tuple(k.shape)} "
            f"causal={causal}")
    need(same_bits(o, plain_o), f"{kernel} at {what}: o with the lse on is "
         "not bitwise o with it off")
    need(blind_ok and err <= FLASH_LSE_TOL,
         f"{kernel}'s lse at {what}: max abs err {err} "
         f"(tolerance {FLASH_LSE_TOL}), +inf exactly on the rows that see "
         f"no key: {blind_ok}")
    return o, lse, dict(lse_max_abs_err=err,
                        rows_without_key=int((~seen).sum()))


def flash_bwd_model_line(cfg, randn) -> dict:
    """The tensor-core backward at a model's heads, B 1 x T 4096, bf16,
    causal, q, k, v as the transposed (B, T, H, D) views the transformer
    passes, given the forward's lse (held first: ``flash_forward_lse``):
    held against its plain version, two calls bitwise equal, timed
    (``ms``: its kernels' device time), beside its bound (five causal
    Tq.Tk.D products, S, dP, dV, dK, dQ, at the bf16 rate, or the bytes of
    q, k, v, o, do and dq, dk, dv), its plain version, SDPA's backward on
    the same tensors (k and v expanded to the query heads) and the mma.sync
    kernel forced on the same bf16 tensors and lse (``mma_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention as fa
    bf, t = torch.bfloat16, FLASH_BWD_T
    b, hq, hkv, d = 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = (randn(b, t, h_, d, dtype=bf).transpose(1, 2)
               for h_ in (hq, hkv, hkv))
    o, lse, fwd = flash_forward_lse(q, k, v)
    do = randn(b, hq, t, d, dtype=bf)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do)
    run = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse)
    first = run()
    errs = bwd_errs(first, want)
    tol = FLASH_BWD_TOL["bfloat16"]
    need(max(errs) <= tol, f"flash_attention_bwd_tc at {cfg.name}'s shape: "
         f"dq, dk, dv errors {errs} beyond {tol}")
    deterministic = all(torch.equal(a, b_) for a, b_ in zip(first, run()))
    need(deterministic, f"flash_attention_bwd_tc at {cfg.name}'s shape: two "
         "calls on the same inputs differ")
    mma = lambda: fa._launch_bwd_mma(q, k, v, o, do, lse, True,
                                     1.0 / d ** 0.5)
    mma_errs = bwd_errs(mma(), want)
    need(max(mma_errs) <= tol, f"flash_attention_bwd (mma.sync, forced) at "
         f"{cfg.name}'s shape: errors {mma_errs} beyond {tol}")
    del first, want
    group = hq // hkv
    qe = q.detach().contiguous().requires_grad_()
    ke, ve = (x.repeat_interleave(group, dim=1).contiguous().requires_grad_()
              for x in (k, v))
    out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
    library_ms = device_total_ms(lambda: torch.autograd.grad(
        out, (qe, ke, ve), do, retain_graph=True), 5)
    pairs = visible_pairs(t, t, True)
    line = bound(dict(
        model=cfg.name, shape=f"q ({b}, {hq}, {t}, {d}) bf16 as a transposed "
        f"(B, T, H, D) view, k, v ({b}, {hkv}, {t}, {d}), causal",
        gqa_group=group, head_split=fa.bwd_split(
            b, hkv, t, group, torch.cuda.get_device_properties(
                0).multi_processor_count),
        max_abs_err=max(errs), dq_dk_dv_rel_err=errs, tolerance=tol,
        deterministic=deterministic, forward_lse=fwd,
        ms=device_ms(run, 5, *FLASH_BWD_TC_KERNELS),
        mma_ms=device_ms(mma, 3, *FLASH_BWD_KERNELS),
        mma_rel_err=mma_errs,
        plain_ms=cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do),
                         1),
        library_ms=library_ms,
        library_call="torch.autograd.grad of scaled_dot_product_attention("
                     "q, k, v, is_causal=True), k and v repeated to the "
                     "query heads, contiguous",
        flops_model="5 x 2 B Hq D x the causal (query, key) pairs (S, dP, "
                    "dV, dK, dQ)",
        flops=5 * 2 * b * hq * pairs * d, flops_type="bf16",
        bytes=3 * q.nbytes + k.nbytes + v.nbytes + o.nbytes + do.nbytes))
    line["achieved_tflop_s"] = line["flops"] / line["ms"] / 1e9
    line["vs_library"] = line["ms"] / library_ms
    line["mma_over_tc"] = line["mma_ms"] / line["ms"]
    del q, k, v, o, do, lse, qe, ke, ve, out
    torch.cuda.empty_cache()
    return line


def flash_bwd_mma_line(dtype_name: str) -> dict:
    """The mma route's backward (``flash_attention_bwd``) at its line's
    shape (``FLASH_BWD_MMA_SHAPES``), causal, q, k, v as transposed
    (B, T, H, D) views, from a generator of its own (so ``forward_digest``,
    the SHA-256 of the forward's output bytes, compares across trees),
    given the mma forward's lse (held first: ``flash_forward_lse``): held
    against its plain version (``FLASH_BWD_TOL``), two calls bitwise
    equal, one launch a call, timed (its kernels' device time, and the dq
    and dk/dv kernels' apart in ``by_kernel``) beside its bound (five
    causal products; in float32 the lower of FFMA and 3xTF32), its plain
    version, SDPA's backward on the same tensors (k and v
    repeated to the query heads) and the FFMA kernel it replaced
    (``previous_ms``)."""
    import hashlib
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    dtype = getattr(torch, dtype_name)
    b, hq, hkv, t, d = FLASH_BWD_MMA_SHAPES[dtype_name]
    q, k, v = (torch.randn((b, t, h_, d), generator=g, device="cuda"
                           ).to(dtype).transpose(1, 2)
               for h_ in (hq, hkv, hkv))
    do = torch.randn((b, hq, t, d), generator=g, device="cuda").to(dtype)
    name = fa.BWD_KERNELS["mma"]
    need(fa.bwd_kernel(q.device, dtype, d) == name,
         f"the backward route of {dtype_name} D {d} is not {name}")
    o, lse, fwd = flash_forward_lse(q, k, v)
    torch.cuda.synchronize()
    digest = hashlib.sha256(o.contiguous().view(torch.uint8).cpu().numpy()
                            .tobytes()).hexdigest()
    want = ref.flash_attention_bwd_ref(q, k, v, o, do)
    run = lambda: fa.flash_attention_bwd_cuda(q, k, v, o, do, lse=lse)
    build.reset_launches()
    first = run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    need(launches[name] == 1 and sum(launches.values()) == 1,
         f"one {name} call at {dtype_name} D {d} launched {launches}")
    errs = bwd_errs(first, want)
    tol = FLASH_BWD_TOL[dtype_name]
    need(max(errs) <= tol, f"{name} {dtype_name} D {d}: dq, dk, dv errors "
         f"{errs} beyond {tol}")
    deterministic = all(torch.equal(a, b_) for a, b_ in zip(first, run()))
    need(deterministic, f"{name} {dtype_name} D {d}: two calls on the same "
         "inputs differ")
    del first, want
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(q, k, v, o, do), 1)
    torch.cuda.empty_cache()
    group = hq // hkv
    qe = q.detach().contiguous().requires_grad_()
    ke, ve = (x.repeat_interleave(group, dim=1).contiguous().requires_grad_()
              for x in (k, v))
    out = F.scaled_dot_product_attention(qe, ke, ve, is_causal=True)
    library_ms = device_total_ms(lambda: torch.autograd.grad(
        out, (qe, ke, ve), do, retain_graph=True), 3)
    pairs = visible_pairs(t, t, True)
    line = dict(
        shape=f"q ({b}, {hq}, {t}, {d}) {dtype_name} as a transposed "
              f"(B, T, H, D) view, k, v ({b}, {hkv}, {t}, {d}), causal",
        gqa_group=group, max_abs_err=max(errs), dq_dk_dv_rel_err=errs,
        tolerance=tol, deterministic=deterministic, forward_lse=fwd,
        forward_digest=digest, launches_per_call=launches[name],
        ms=device_ms(run, 5, *FLASH_BWD_KERNELS),
        by_kernel={k.split("_mma_")[1]: device_ms(run, 3, k)
                   for k in FLASH_BWD_KERNELS[:2]},
        previous_ms=PREVIOUS_FFMA_BWD_MS[dtype_name],
        plain_ms=plain_ms, library_ms=library_ms,
        library_call="torch.autograd.grad of scaled_dot_product_attention("
                     "q, k, v, is_causal=True), k and v repeated to the "
                     "query heads, contiguous",
        flops_model="5 x 2 B Hq D x the causal (query, key) pairs (S, dP, "
                    "dV, dK, dQ)",
        flops=5 * 2 * b * hq * pairs * d,
        flops_type="fp32" if dtype == torch.float32 else "bf16",
        bytes=3 * q.nbytes + k.nbytes + v.nbytes + o.nbytes + do.nbytes
        + lse.nbytes)
    line = bound_3xtf32(line) if dtype == torch.float32 else bound(line)
    line["achieved_tflop_s"] = line["flops"] / line["ms"] / 1e9
    line["vs_library"] = line["ms"] / library_ms
    line["previous_over_ms"] = line["previous_ms"] / line["ms"]
    del q, k, v, o, do, lse, qe, ke, ve, out
    torch.cuda.empty_cache()
    return line


def flash_bwd_sweep(randn) -> list:
    """Each backward through its route against its plain version in f32
    (2e-5) and bf16 (2e-2), each error relative to the largest |want| of
    its output: D 16-128 in steps of 16 (bf16 on the tensor-core kernel)
    and the off-grid 72, 40 and 8 (the mma.sync kernel, as is all f32),
    each given its forward's lse; GQA groups 1 and 4 at every D, 16 at
    D 128, 3 at D 64, 2 at D 80; Tq = Tk 256, Tq 64 of Tk 256 (the causal
    offset), a ragged 100, Tq 1 of 128, and Tq 128 of Tk 64 (the first 64
    rows see no key under the causal mask and carry no gradient); causal
    and not; contiguous and as transposed (B, T, H, D) views.  Both launch
    counters must equal the cases of their route.  Returns [dtype, D, Hq,
    Hkv, Tq, Tk, causal, strided, kernel, max rel err]."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    rows, n = [], dict.fromkeys(fa.BWD_KERNELS.values(), 0)
    build.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for d in (16, 32, 48, 64, 80, 96, 112, 128, 72, 40, 8):
            groups = (1, 4) + {128: (16,), 64: (3,), 80: (2,)}.get(d, ())
            kernel = fa.bwd_kernel("cuda", dtype, d)
            for group in groups:
                hkv = 2
                hq = hkv * group
                for tq, tk in ((256, 256), (64, 256), (100, 100), (1, 128),
                               (128, 64)):
                    for causal in (True, False):
                        for strided in (False, True):
                            if strided:
                                q, k, v = (randn(1, t_, h_, d, dtype=dtype
                                                 ).transpose(1, 2)
                                           for h_, t_ in ((hq, tq),
                                                          (hkv, tk),
                                                          (hkv, tk)))
                            else:
                                q, k, v = (randn(2, h_, t_, d, dtype=dtype)
                                           for h_, t_ in ((hq, tq),
                                                          (hkv, tk),
                                                          (hkv, tk)))
                            o, lse = fa.flash_attention_cuda(
                                q, k, v, causal, return_lse=True)
                            do = randn(*o.shape, dtype=dtype)
                            e = max(flash_bwd_errs(q, k, v, o, do, causal,
                                                   lse))
                            need(e <= FLASH_BWD_TOL[name],
                                 f"{kernel} {name} D {d} {hq}/{hkv} Tq "
                                 f"{tq} Tk {tk} causal={causal} strided="
                                 f"{strided}: beyond {FLASH_BWD_TOL[name]} "
                                 f"(rel err {e})")
                            n[kernel] += 1
                            rows.append([name, d, hq, hkv, tq, tk, causal,
                                         strided, kernel, e])
    need(all(build.LAUNCHES[k] == c for k, c in n.items()),
         f"the backward sweep's launches {build.LAUNCHES}, want {n}")
    return rows


def flash_bwd_autograd(randn, dtype_name: str = "bfloat16") -> dict:
    """``torch.autograd.grad`` through ``ops.flash_attention`` on the card
    at stablelm-3b's heads (B 1 x T 4096, bf16 or float32), q, k, v leaves
    of shape (B, T, H, D) passed as transposed views: the forward saves its
    lse, exactly one launch of the route's backward for the backward
    (``flash_attention_bwd_tc`` in bf16, ``flash_attention_bwd`` in
    float32), and the gradients of the plain version (``FLASH_BWD_TOL``)."""
    import torch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.flash_attention import bwd_kernel
    dtype, t = getattr(torch, dtype_name), FLASH_BWD_T
    kernel = bwd_kernel("cuda", dtype, 80)
    leaves = [randn(1, t, 32, 80, dtype=dtype).requires_grad_()
              for _ in "qkv"]
    views = [x.transpose(1, 2) for x in leaves]
    o = ops.flash_attention(*views)
    do = randn(*o.shape, dtype=dtype)
    build.reset_launches()
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    need(launches[kernel] == 1 and sum(launches.values()) == 1,
         f"one {dtype_name} backward through ops.flash_attention launched "
         f"{launches}")
    with torch.no_grad():
        want = ref.flash_attention_bwd_ref(*views, o, do)
    errs = [rel_err(g.transpose(1, 2), w) for g, w in zip(grads, want)]
    need(max(errs) <= FLASH_BWD_TOL[dtype_name],
         f"{dtype_name} autograd through ops.flash_attention: errors {errs}")
    return dict(kernel=kernel, launches_per_backward=launches[kernel],
                dq_dk_dv_rel_err=errs)


def kernel_phase_flash_bwd():
    """The flash backward kernels: the tensor-core kernel at the four
    models' heads (and the mma.sync one forced on the same tensors), the
    mma.sync kernel at its two lines' shapes (``FLASH_BWD_MMA_SHAPES``),
    each forward's lse beside them and on rows that see no key, both
    kernels on the sweep through their routes, and autograd through each
    route, against their plain versions."""
    import torch
    from repro_torch.configs import (CHATGLM3_6B, GRANITE_MOE_3B_A800M,
                                     MOONSHOT_V1_16B_A3B, STABLELM_3B)
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    models = {c.name: flash_bwd_model_line(c, randn)
              for c in (STABLELM_3B, CHATGLM3_6B, GRANITE_MOE_3B_A800M,
                        MOONSHOT_V1_16B_A3B)}
    mma = {dt: flash_bwd_mma_line(dt) for dt in FLASH_BWD_MMA_SHAPES}
    # causal Tq 128 of Tk 64: the first 64 rows see no key (lse +inf), on
    # the tensor-core forward (bf16 D 64) and the mma.sync one (float32
    # D 64, bf16 D 72)
    blind = {f"{dt} D {d}": flash_forward_lse(*(
        randn(1, h_, t_, d, dtype=getattr(torch, dt))
        for h_, t_ in ((4, 128), (2, 64), (2, 64))))[2]
        for dt, d in (("bfloat16", 64), ("float32", 64), ("bfloat16", 72))}
    sweep = flash_bwd_sweep(randn)
    line = dict(models.pop(STABLELM_3B.name))
    replaces = ("src/repro/kernels/flash_attention.py:81 (the gradient of "
                "flash_attention_pallas; the JAX package has no backward "
                "kernel and differentiates its plain attention)")
    sweep_err = {(dt, k): max(r[-1] for r in sweep
                              if r[0] == dt and r[8] == k)
                 for dt, k in {(r[0], r[8]) for r in sweep}}
    bwd_hmma = sass_counts("HMMA")
    if isinstance(bwd_hmma, dict):
        bwd_hmma = {f: n for f, n in bwd_hmma.items() if "bwd_mma" in f}
        need(sum("dq_kernel" in f or "dkdv_kernel" in f for f in bwd_hmma)
             == 16, f"HMMA in the mma.sync backward's dq and dk/dv "
             f"instances (2 dtypes x 4 widths each): {bwd_hmma}")
    bwd = dict(mma["float32"])
    bwd.update(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces=replaces,
        max_abs_err=max(m["max_abs_err"] for m in mma.values()),
        error_note="max_abs_err: the largest error of dq, dk or dv relative "
                   "to its largest |want|, over the float32 and bf16 D 72 "
                   "lines; every other number is the float32 line's",
        bf16_d72=mma["bfloat16"],
        forced_on_tc_shapes={m["model"]: dict(ms=m["mma_ms"],
                                              rel_err=m["mma_rel_err"])
                             for m in [line, *models.values()]},
        forward_lse_without_key={k: x for k, x in blind.items()
                                 if k != "bfloat16 D 64"},
        autograd=flash_bwd_autograd(randn, "float32"),
        sweep_max_rel_err={dt: e for (dt, k), e in sweep_err.items()
                           if k == "flash_attention_bwd"},
        hmma=bwd_hmma)
    line.update(
        source="src/repro_torch/csrc/flash_attention_bwd_tc.cu",
        replaces=replaces,
        max_abs_err=max([line["max_abs_err"]]
                        + [m["max_abs_err"] for m in models.values()]),
        error_note="max_abs_err: the largest error of dq, dk or dv relative "
                   "to its largest |want|, over the four models' shapes",
        other_models=models, forward_lse_without_key=blind["bfloat16 D 64"],
        autograd=flash_bwd_autograd(randn), sweep_cases=len(sweep),
        sweep_max_rel_err={dt: e for (dt, k), e in sweep_err.items()
                           if k == "flash_attention_bwd_tc"})
    return {"flash_attention_bwd_tc": line, "flash_attention_bwd": bwd}


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
    bound_ms = 1e3 * nbytes / peaks().PEAK_BYTES_S
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
                bytes=nbytes, bound_ms=1e3 * nbytes / peaks().PEAK_BYTES_S)
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
    with the device's busy and idle share of the unprofiled wall ("not
    measured" where the profiler records no device activity)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events, _ = traced(fn, what)
    if not events:
        return {"profile": what, "wall_s": wall, "device_busy_s": None,
                "idle_share": None, "device_s": "not measured",
                "share": {}}
    events = sorted(events, key=device_us, reverse=True)
    groups = {"flash_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        group = ("flash_attention" if "flash_attention" in e.key.lower() else
                 "gemm" if is_gemm(e.key) else "other")
        groups[group] += device_us(e) / 1e6
    busy = sum(groups.values())
    return {"profile": what, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall,
            "device_s": groups,
            "share": {k: v / busy for k, v in groups.items()} if busy else {},
            "top_device_ms": [[e.key[:70], device_us(e) / 1e3, e.count]
                              for e in events[:10] if device_us(e) > 0]}


def leaves(params: dict):
    """The tensors of a parameter dict, nested dicts (an MoE config's
    ``"moe"``) included."""
    for v in params.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def params_to(params: dict, device: str) -> dict:
    """A copy of ``params`` on ``device``, nested dicts included."""
    return {k: params_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in params.items()}


@contextlib.contextmanager
def recorded_routes(calls: list):
    """``layers.moe.route`` wrapped so that each call appends its
    ``(logits, picks, pick logits)`` to ``calls``; the MoE layers call it
    once a layer."""
    from repro_torch.layers import moe
    real = moe.route

    def recording(x, router, top_k):
        out = real(x, router, top_k)
        calls.append(out)
        return out

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = real


def moe_inputs(params, tokens, cfg, ml: int) -> list:
    """Each MoE layer's input in one more prefill (``_moe_ffn_local``
    wrapped to record it)."""
    from repro_torch.models import transformer as tfm
    inputs = []
    real = tfm._moe_ffn_local

    def recording(x, lp, c):
        inputs.append(x)
        return real(x, lp, c)

    tfm._moe_ffn_local = recording
    try:
        tfm.prefill(params, tokens, cfg, max_len=ml)
    finally:
        tfm._moe_ffn_local = real
    need(len(inputs) == cfg.n_layers, f"lm serve: {len(inputs)} MoE "
         f"inputs in a prefill of {cfg.n_layers} layers")
    return inputs


def moe_routing(params, inputs, cfg) -> dict:
    """Each layer's picks per expert, from ``layers.moe.route`` on the
    layer's recorded prefill input, and the picks the capacity drops (an
    expert keeps its first ``capacity`` picks)."""
    import torch
    from repro_torch.layers.moe import capacity_of, route
    from repro_torch.models import transformer as tfm
    n_tokens = inputs[0].shape[0] * inputs[0].shape[1]
    cap = capacity_of(cfg.moe, n_tokens)
    layers = tfm._layer_stack(params)
    loads = torch.stack([
        torch.bincount(route(x.reshape(-1, cfg.d_model),
                             layers[i]["moe"]["router"],
                             cfg.moe.top_k)[1].reshape(-1),
                       minlength=cfg.moe.n_experts)
        for i, x in enumerate(inputs)]).cpu()
    dropped = (loads - cap).clamp(min=0).sum(dim=1)
    return dict(capacity_prefill=cap,
                capacity_decode=capacity_of(cfg.moe, LM_BATCH),
                picks_per_layer=n_tokens * cfg.moe.top_k,
                dropped_per_layer=dropped.tolist(),
                dropped_share=float(dropped.sum()) / (
                    cfg.n_layers * n_tokens * cfg.moe.top_k),
                expert_load_min=int(loads.min()),
                expert_load_max=int(loads.max()))


def is_gemm(kernel: str) -> bool:
    """Whether a device kernel's name is a matrix product's (cuBLAS,
    CUTLASS)."""
    key = kernel.lower()
    return any(w in key for w in ("gemm", "xmma", "nvjet", "cutlass",
                                  "matmul"))


def moe_profile(params, inputs, cfg, prefill_busy_s: float | None) -> dict:
    """The MoE layers' parts of one prefill's device time: every layer's
    ``_dispatch_compute`` and shared experts replayed on its recorded
    prefill input (``moe_inputs``) under ``torch.profiler`` (device
    only: the prefill's kernels on the prefill's tensors).  ``dispatch``
    is ``_dispatch_compute``'s kernels but its matrix products (routing,
    the sorts, the slot arithmetic, both scatters); ``expert_gemms`` its
    matrix products (the three expert products and the router's logits);
    each over ``prefill_busy_s``, the prefill's device time in the
    ``profile`` line ("not measured" where either profile recorded no
    device activity)."""
    import torch
    from repro_torch.layers.moe import capacity_of
    from repro_torch.models import transformer as tfm
    moe = cfg.moe
    cap = capacity_of(moe, inputs[0].shape[0] * inputs[0].shape[1])
    layers = [lp["moe"] for lp in tfm._layer_stack(params)]

    def dispatch():
        for x, lp in zip(inputs, layers):
            tfm._dispatch_compute(
                x.reshape(-1, cfg.d_model), lp["router"], lp["w_gate"],
                lp["w_up"], lp["w_down"], cfg=moe, e_off=0,
                n_total_experts=moe.n_experts, act=cfg.act, capacity=cap)

    def shared():
        for x, lp in zip(inputs, layers):
            tfm.shared_experts(x, lp, cfg.act)

    def device_s(fn, what: str) -> tuple[float, float] | None:
        fn()
        torch.cuda.synchronize()
        events, _ = traced(fn, f"moe profile {cfg.name} {what}")
        if not events:
            return None
        gemm = other = 0.0
        for e in events:
            if is_gemm(e.key):
                gemm += device_us(e) / 1e6
            else:
                other += device_us(e) / 1e6
        return gemm, other

    what = f"prefill {cfg.name} {LM_BATCH}x{LM_PROMPT}"
    measured = [device_s(dispatch, "dispatch")]
    if moe.n_shared_experts:
        measured.append(device_s(shared, "shared experts"))
    if prefill_busy_s is None or None in measured:
        return {"moe_profile": what, "parts_s": "not measured"}
    gemm, other = measured[0]
    parts = {"dispatch": other, "expert_gemms": gemm,
             "shared_experts": (sum(measured[1])
                                if moe.n_shared_experts else 0.0)}
    need(other > 0 and gemm > 0, f"moe profile: no device time ({parts})")
    parts["rest"] = prefill_busy_s - sum(parts.values())
    return {"moe_profile": what, "prefill_device_s": prefill_busy_s,
            "parts_s": parts,
            "share": {k: v / prefill_busy_s for k, v in parts.items()}}


def lm_serve(cfg):
    """A model at full width and depth in bf16 (chatglm3-6b, stablelm-3b,
    granite-moe-3b-a800m or moonshot-v1-16b-a3b), weights from a seeded
    generator on the card: a batch of 4 requests of 2048 synthetic prompt
    tokens, prefill, then 32 greedy decode steps.  The kernels' launch
    counters are set to 0 just before and read just after; every prefill
    layer must launch the wgmma flash kernel once and the mma.sync one
    never.  Then one prefill is profiled; an MoE model's line adds its
    capacities, the picks each layer's prefill drops and the experts'
    loads (routed again from each layer's input, recorded in one more
    prefill), and ``moe_profile`` names the MoE dispatch's share of the
    prefill's device time, replayed on the same inputs."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, g, device="cuda")
    torch.cuda.synchronize()
    log(f"lm params: {cfg.name}, {cfg.n_params} parameters, "
        f"{sum(p.nbytes for p in leaves(params))} bytes "
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
    peak = torch.cuda.max_memory_allocated()
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
    del cache, logits
    line = dict(
        path="lm serve", model=cfg.name, n_layers=cfg.n_layers,
        head_dim=cfg.head_dim, gqa_group=cfg.n_heads // cfg.n_kv_heads,
        n_params=cfg.n_params, n_active_params=cfg.n_active_params,
        batch=LM_BATCH, prompt_tokens=LM_PROMPT, decode_steps=LM_DECODE,
        max_len=ml, prefill_s=prefill_s,
        prefill_tokens_s=LM_BATCH * LM_PROMPT / prefill_s,
        decode_ms_per_step=1e3 * decode_s / LM_DECODE,
        decode_tokens_s=LM_BATCH * LM_DECODE / decode_s,
        peak_allocated_bytes=peak, launches=launches,
        first_ids=ids[:, :8].tolist())
    inputs = None
    if cfg.moe is not None:
        t0 = time.perf_counter()
        inputs = moe_inputs(params, tokens, cfg, ml)
        line["moe"] = moe_routing(params, inputs, cfg)
        line["moe"]["routing_s"] = time.perf_counter() - t0
    log(json.dumps(line))
    prof = gpu_profile(lambda: tfm.prefill(params, tokens, cfg, max_len=ml),
                       f"prefill {cfg.name} {LM_BATCH}x{LM_PROMPT}")
    log(json.dumps(prof))
    if cfg.moe is not None:
        t0 = time.perf_counter()
        parts = moe_profile(params, inputs, cfg, prof["device_busy_s"])
        parts["wall_s"] = time.perf_counter() - t0
        log(json.dumps(parts))
    del params, inputs
    torch.cuda.empty_cache()
    return launches, prefill_s


def topk_gap(logits, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th router
    logit: how near a pick came to another expert."""
    top = logits.float().sort(dim=-1, descending=True).values
    return float((top[:, k - 1] - top[:, k]).min())


def lm_parity(model):
    """A model (chatglm3-6b: RMSNorm, half rotary, GQA; stablelm-3b:
    LayerNorm, 25% rotary, tied embeddings, heads of 80; the MoE models:
    routed and shared experts) at full width with 2 layers in float32
    (TF32 off): the card's prefill logits and 4 greedy decode steps
    against the port's CPU path on the same weights (1e-3), an MoE
    model's router picks held equal first (a mismatch fails, naming the
    smallest gap between a k-th and (k+1)-th logit); and on the card the
    decode logits against ``forward`` over the concatenated stream (2e-4,
    the JAX package's own decode-vs-forward tolerance), an MoE model at
    ``capacity_factor = n_experts / top_k``, where no pick can drop (at
    its own factor decode drops what a longer ``forward`` keeps)."""
    from dataclasses import replace
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(model, n_layers=PARITY_LAYERS, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = tfm.init_params(cfg, g, device="cuda")
    cpu_params = params_to(params, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, PARITY_PROMPT), generator=g,
                           device="cuda")
    ml = PARITY_PROMPT + PARITY_STEPS
    errs = {}
    t0 = time.perf_counter()
    runs, routes = {}, {}
    build.reset_launches()
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        with recorded_routes(routes.setdefault(dev, [])):
            cache, logits = tfm.prefill(p, tokens.to(dev), cfg, max_len=ml)
            out = [logits]
            nxt = tokens[:, :1].to(dev)
            for _ in range(PARITY_STEPS):
                logits, cache = tfm.decode_step(p, cache, nxt, cfg)
                out.append(logits)
                nxt = logits.argmax(-1)
        runs[dev] = out
    extra = {}
    if cfg.moe is not None:
        k = cfg.moe.top_k
        need(len(routes["cuda"]) == len(routes["cpu"])
             == PARITY_LAYERS * (1 + PARITY_STEPS),
             f"lm parity: {len(routes['cuda'])} and {len(routes['cpu'])} "
             "MoE routes")
        for i, ((_, a, _), (lg, b, _)) in enumerate(zip(routes["cuda"],
                                                        routes["cpu"])):
            need(torch.equal(a.cpu(), b),
                 f"lm parity: router picks differ between card and CPU at "
                 f"route {i}; smallest k-th/(k+1)-th logit gap "
                 f"{topk_gap(lg, k)}")
        extra = dict(capacity_factor=cfg.moe.capacity_factor,
                     router_picks_equal=len(routes["cpu"]),
                     min_topk_gap=min(topk_gap(lg, k)
                                      for lg, _, _ in routes["cpu"]))
    del routes
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        err, ok = allclose_err(a.cpu(), b, 1e-3)
        errs["prefill" if i == 0 else f"decode {i}"] = err
        need(ok, f"lm parity: card vs CPU logits (step {i}) beyond 1e-3 "
             f"(max abs err {err})")
        need(torch.equal(a.argmax(-1).cpu(), b.argmax(-1)),
             f"lm parity: card and CPU greedy ids differ at step {i}")
    cpu_s = time.perf_counter() - t0
    # decode against forward on the card, as the CPU test runs it
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        extra["decode_vs_forward_capacity_factor"] = cfg.moe.capacity_factor
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
        launches=dict(build.LAUNCHES), **extra)))
    launches = dict(build.LAUNCHES)
    # f32 attention runs on the mma.sync kernel: one launch per layer of
    # each prefill and forward
    need(launches["flash_attention_mma"] > 0
         and launches["flash_attention_tc"] == 0,
         f"lm parity: f32 flash launches {launches}")
    del params, cpu_params, runs
    torch.cuda.empty_cache()
    return launches


def lm_moe_ffn(model) -> None:
    """The MoE FFN on one layer of the model's full-width parameters in
    bf16 and a prefill's 4 x 2048 tokens: the one-card
    ``_moe_ffn_local`` against the same layer in float32 on upcast copies
    of the input and the weights (TF32 off; the router picks held equal
    first, then ``MOE_BF16_TOL``), which holds the bf16 path's own
    arithmetic (``bmm_f32``'s bf16 products with float32 results, the
    bf16 buffer fill); then ``layers.moe.moe_ffn`` over a world-size-1
    NCCL group (an in-memory store, destroyed at the end) against
    ``_moe_ffn_local``, in ``ep`` and ``tp`` mode: equal within bf16
    rounding (``MOE_FFN_TOL``: the experts' float32 sums are added in
    the order of ``index_add_``'s atomics, so a rounding to bf16 may
    differ by one step); all timed."""
    from dataclasses import replace
    import torch
    import torch.distributed as dist
    from repro_torch.layers.moe import (init_moe_params, moe_ffn, route,
                                        shard_moe_params)
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    stacked = init_moe_params(g, model.d_model, model.moe, 1,
                              dtype=model.dtype, device="cuda")
    x = torch.randn((LM_BATCH, LM_PROMPT, model.d_model), generator=g,
                    device="cuda").to(model.dtype)
    lp = {k: v[0] for k, v in stacked.items()}
    want, want_aux = tfm._moe_ffn_local(x, lp, model)
    # the same layer in float32: the same routes, then no bf16 rounding
    x32, lp32 = x.float(), {k: v.float() for k, v in lp.items()}
    k = model.moe.top_k
    need(torch.equal(route(x.reshape(-1, model.d_model), lp["router"], k)[1],
                     route(x32.reshape(-1, model.d_model), lp32["router"],
                           k)[1]),
         f"lm moe_ffn: bf16 and f32 router picks differ ({model.name})")
    f32, f32_aux = tfm._moe_ffn_local(
        x32, lp32, replace(model, dtype=torch.float32))
    err32, ok = allclose_err(want, f32, MOE_BF16_TOL)
    need(ok and want.dtype == model.dtype,
         f"lm moe_ffn: bf16 vs f32 {model.name} beyond {MOE_BF16_TOL} (max "
         f"abs err {err32}, largest |f32| {float(f32.abs().max())})")
    out = dict(path="lm moe_ffn", model=model.name, world_size=1,
               backend="nccl", tokens=LM_BATCH * LM_PROMPT,
               bf16_vs_f32=dict(max_abs_err=err32, tolerance=MOE_BF16_TOL,
                                max_abs_f32=float(f32.abs().max()),
                                aux_err=abs(float(want_aux)
                                            - float(f32_aux)),
                                router_picks_equal=True),
               tolerance=MOE_FFN_TOL, max_abs_want=float(want.abs().max()),
               local_ms=cuda_ms(lambda: tfm._moe_ffn_local(x, lp, model), 3))
    del x32, lp32, f32
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        for mode in ("ep", "tp"):
            mcfg = replace(model.moe, shard_mode=mode)
            shard = {k: v[0] for k, v in
                     shard_moe_params(stacked, mcfg, 0, 1).items()}
            got, aux = moe_ffn(x, shard, mcfg, group, act=model.act,
                               dtype=model.dtype)
            err, ok = allclose_err(got, want, MOE_FFN_TOL)
            need(ok and got.dtype == want.dtype,
                 f"moe_ffn {mode} over NCCL vs _moe_ffn_local beyond "
                 f"{MOE_FFN_TOL} (max abs err {err}, largest |want| "
                 f"{out['max_abs_want']})")
            need(float(aux) == float(want_aux),
                 f"moe_ffn {mode}: aux {float(aux)} != {float(want_aux)}")
            out[mode] = dict(max_abs_err=err, aux=float(aux), ms=cuda_ms(
                lambda: moe_ffn(x, shard, mcfg, group, act=model.act,
                                dtype=model.dtype), 3))
    finally:
        dist.destroy_process_group()
    log(json.dumps(out))
    del stacked, lp, x, want
    torch.cuda.empty_cache()


#: the ``train`` phase: stablelm-3b at full width and depth, bf16,
#: ``train_4k``'s sequence (``src/repro/configs/common.py:67``) cut in
#: batch to 4 x 4096 tokens in 2 microbatches, 6 steps through
#: ``Trainer.run``; the optimizer's learning rate raised so that a few
#: steps move the loss
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 2, 6
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
#: (b) resume at full width with 2 layers, and (b') the same on a (1, 1)
#: mesh with elastic restore; (c) card vs CPU in float32 at
#: full width with 2 layers on a batch of 2 x 256 tokens; (d) one layer in
#: bf16 against float32 on upcast copies at 4 x 2048 tokens
RESUME_LAYERS, RESUME_STEPS = 2, 4
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, TRAIN_PARITY_LR = 2, 256, 1e-4
#: (c): loss and grad_norm, card against CPU, as absolute and relative
#: tolerance (float32 paths that sum in other orders: 3xTF32 attention,
#: cuBLAS, the CPU's BLAS); the updated parameters within 3 learning rates
#: (Adam turns a gradient element near zero, where the two sums differ in
#: sign, into an update of about lr)
TRAIN_PARITY_TOL = 1e-4
GRAD_BATCH, GRAD_SEQ = 4, 2048
#: (d): bf16 gradients against float32 ones, each leaf's max abs error
#: over its largest |f32 grad|: the bf16 layer rounds its activations and
#: every gradient it passes on to bf16 (2^-9 each), a few times a layer
BF16_GRAD_TOL = 2.0 ** -5
#: (e): ``tests/test_fault_tolerance.py``'s tiny model and its criteria
COMPRESSED_STEPS = 25
#: (d'): the embedding gradient's tokens, a Zipf draw of this exponent
#: (a few rows take thousands of the step's tokens, as text's do)
EMBED_ZIPF = 1.1


def learnable_token_file(path: Path, vocab: int, rows: int, seq: int) -> None:
    """An int32 token file of ``rows`` chains of ``seq + 1`` tokens, each
    from a seeded random start by ``x -> (3x + 7) % vocab``, so every
    label is ``(token * 3 + 7) % vocab`` (the pattern of
    ``tests/test_fault_tolerance.py``).  ``LMTokenPipeline`` reads a
    batch's rows as consecutive chains."""
    rng = np.random.default_rng(SEED)
    toks = np.empty((rows, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, rows)
    for i in range(seq):
        toks[:, i + 1] = (toks[:, i] * 3 + 7) % vocab
    toks.astype(np.int32).tofile(path)


def device_groups(events, classify) -> dict:
    """Device seconds of a profile's kernels (``traced``'s events), summed
    by ``classify(name)``."""
    out = {}
    for e in events:
        if device_us(e):
            key = classify(e.key)
            out[key] = out.get(key, 0.0) + device_us(e) / 1e6
    return out


def gemm_dtype(kernel: str) -> str:
    """The operand type of a GEMM kernel, read off its name: cuBLAS's
    ``nvjet_`` kernels name their types in three letters (the first the
    inputs': ``s`` float32, ``t`` bf16, ``h`` fp16; ``nvjet_tst`` is bf16
    in and out, ``nvjet_tss`` bf16 in and float32 out), the xmma and
    CUTLASS kernels spell them (``bf16bf16``, ``f32f32``).  "other" where
    the name says neither."""
    import re
    low = kernel.lower()
    m = re.search(r"nvjet_([a-z])[a-z]{2}_", low)
    if m:
        return {"s": "f32", "t": "bf16", "h": "f16"}.get(m.group(1), "other")
    if "bf16" in low:
        return "bf16"
    if "f32f32" in low or "sgemm" in low:
        return "f32"
    return "other"


def train_kernel_group(name: str) -> str:
    """A training step's device kernels by part: the flash backward (both
    kernels) and forward, the GEMMs by operand type (``gemm_dtype``: the
    bf16 products, and the float32 ones, which are the float32-cotangent
    products of ``_WideProduct``'s backward), the rest."""
    low = name.lower()
    if "flash_attention_bwd" in low:
        return "flash_backward"
    if "flash_attention" in low:
        return "flash_forward"
    return f"gemm_{gemm_dtype(name)}" if is_gemm(name) else "other"


def train_main(tmp: Path) -> dict:
    """(a) stablelm-3b at full width and depth, bf16, seeded weights,
    through ``Trainer.run``: ``TRAIN_STEPS`` steps of 4 x 4096 tokens in 2
    microbatches, remat on, from ``LMTokenPipeline`` over a learnable
    token file.  Holds finite losses falling from the first step to the
    last, finite gradient norms, and the launches of the path: 4 of
    ``flash_attention_tc`` a layer a step (2 microbatches x forward and
    remat's recompute), 2 of ``flash_attention_bwd_tc``, none of
    ``flash_attention_mma`` or the mma.sync ``flash_attention_bwd``.  Then
    one more step by hand, profiled in two windows (the microbatches' forward
    and backward; the AdamW update), every gradient leaf held finite, and
    the device time by part, the GEMMs split by operand type (the ten
    GEMM kernels that took the most time listed by name)."""
    import torch
    from repro_torch.configs import STABLELM_3B
    from repro_torch.data import LMTokenPipeline
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    from repro_torch.train import (OptimizerConfig, Trainer, adamw_update,
                                   value_and_grad)
    from repro_torch.train.tree import tree_map, unflatten
    cfg = STABLELM_3B
    path = tmp / "tokens.bin"
    learnable_token_file(path, cfg.vocab_size,
                         TRAIN_BATCH * (TRAIN_STEPS + 3), TRAIN_SEQ)
    pipe = LMTokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
                           token_file=str(path))
    lf = lambda p, b: tfm.loss_fn(p, b, cfg)
    opt = OptimizerConfig(**TRAIN_OPT)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(lf, tfm.init_params(cfg, g, device="cuda"), opt,
                      pipe.get_batch, microbatches=TRAIN_MICRO,
                      device="cuda")
    build.reset_launches()
    hist = trainer.run(TRAIN_STEPS, log_every=1, resume="none")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    walls = [h["wall"] for h in hist]
    step_s = [b - a for a, b in zip([0.0] + walls, walls)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    losses = [h["loss"] for h in hist]
    need(all(np.isfinite(x) for x in losses)
         and all(np.isfinite(h["grad_norm"]) for h in hist),
         f"train: a loss or gradient norm is not finite: {hist}")
    need(losses[-1] < losses[0],
         f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    layers = cfg.n_layers * TRAIN_STEPS
    need(launches["flash_attention_tc"] == 2 * TRAIN_MICRO * layers
         and launches["flash_attention_bwd_tc"] == TRAIN_MICRO * layers
         and launches["flash_attention_mma"] == 0
         and launches["flash_attention_bwd"] == 0,
         f"train: launches {launches}, want flash_attention_tc "
         f"{2 * TRAIN_MICRO * layers}, flash_attention_bwd_tc "
         f"{TRAIN_MICRO * layers}, flash_attention_mma and "
         "flash_attention_bwd 0")

    # one more step by hand, profiled: make_train_step's work in two windows
    batch = tree_map(lambda x: torch.as_tensor(np.array(x), device="cuda"),
                     pipe.get_batch(TRAIN_STEPS))
    rows = TRAIN_BATCH // TRAIN_MICRO

    def mean_grads():
        finite, gsum = True, None
        for i in range(TRAIN_MICRO):
            mb = tree_map(lambda x: x[i * rows:(i + 1) * rows], batch)
            _, grads = value_and_grad(lf, trainer.params, mb)
            finite &= all(bool(torch.isfinite(x).all()) for x in grads)
            if gsum is None:
                gsum = [x.float() for x in grads]
            else:
                for acc, x in zip(gsum, grads):
                    acc.add_(x.float())
            del grads
        for acc in gsum:
            acc.div_(TRAIN_MICRO)
        return finite, gsum

    ev_grad, (grads_finite, gsum) = traced(mean_grads, "train gradients")
    need(grads_finite, "train: a gradient leaf is not finite")
    mean = unflatten(trainer.params, gsum)
    ev_opt, _ = traced(lambda: adamw_update(trainer.params, mean,
                                            trainer.opt_state, opt),
                       "train optimizer")
    steady = float(np.median(step_s[1:]))
    if ev_grad and ev_opt:
        parts = device_groups(ev_grad, train_kernel_group)
        gemms = sorted(((s, k[:90]) for k, s in device_groups(
            ev_grad, lambda k: k if is_gemm(k) else "").items() if k),
            reverse=True)[:10]
        parts["optimizer"] = sum(device_groups(ev_opt,
                                               lambda _: "o").values())
        busy = sum(parts.values())
        profiled = dict(device_busy_s=busy, device_s=parts,
                        share={k: v / busy for k, v in parts.items()},
                        idle_share=1 - busy / steady,
                        idle_note="1 - the profiled step's device time "
                                  "over the median unprofiled step",
                        top_gemm_kernels=[dict(kernel=k, s=s_,
                                               type=gemm_dtype(k))
                                          for s_, k in gemms])
    else:
        profiled = "not measured"
    out = dict(
        path="train", model=cfg.name, n_layers=cfg.n_layers,
        n_params=cfg.n_params, dtype="bfloat16", remat=cfg.remat,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=TRAIN_MICRO,
        loss_seq_chunk=cfg.loss_seq_chunk, optimizer=TRAIN_OPT,
        loss=losses, grad_norm=[h["grad_norm"] for h in hist],
        lr=[h["lr"] for h in hist], wall_s=walls, step_s=step_s,
        tokens_per_s=[tokens / s for s in step_s],
        steady_step_s=steady, steady_tokens_per_s=tokens / steady,
        peak_bytes=peak, peak_gb=peak / 1e9, launches=launches,
        profile=profiled, every_gradient_leaf_finite=grads_finite)
    log(json.dumps(out))
    del trainer, batch, gsum, mean, ev_grad, ev_opt
    torch.cuda.empty_cache()
    return out


def train_resume(tmp: Path) -> dict:
    """(b) stablelm-3b at full width with 2 layers, bf16: 4 steps straight;
    4 steps with ``ckpt_every=2`` (checkpoints 2 and 4), checkpoint 4
    restored bit-identical to the trainer's state; then checkpoint 4
    corrupted, and a fresh ``Trainer`` with ``resume="auto"`` falls back
    to checkpoint 2 and takes steps 3 and 4, their losses equal to the
    straight run's (a relative 1e-5; ``bitwise`` says whether they are
    identical, as they are where every kernel of the step is
    deterministic)."""
    from dataclasses import replace
    import torch
    from repro_torch.configs import STABLELM_3B
    from repro_torch.data import LMTokenPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.train import CheckpointManager, OptimizerConfig, Trainer
    from repro_torch.train.tree import leaves, tree_map
    cfg = replace(STABLELM_3B, n_layers=RESUME_LAYERS)
    pipe = LMTokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
                           token_file=str(tmp / "tokens.bin"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p0 = tfm.init_params(cfg, g, device="cuda")
    ckpt = tmp / "ckpt"
    t0 = time.perf_counter()

    def trainer(ckpt_dir):
        return Trainer(lambda p, b: tfm.loss_fn(p, b, cfg),
                       tree_map(torch.clone, p0),
                       OptimizerConfig(**TRAIN_OPT), pipe.get_batch,
                       ckpt_dir=ckpt_dir, ckpt_every=2,
                       microbatches=TRAIN_MICRO, device="cuda")

    straight = trainer(None)
    hs = straight.run(RESUME_STEPS, log_every=1)
    saving = trainer(str(ckpt))
    hc = saving.run(RESUME_STEPS, log_every=1)
    cm = CheckpointManager(str(ckpt))
    need(cm.steps() == [2, 4], f"train resume: checkpoints {cm.steps()}")
    state = {"params": saving.params, "opt": saving.opt_state}
    restored = cm.restore(4, state)
    need(all(a.dtype == b.dtype and torch.equal(a, b)
             for a, b in zip(leaves(restored), leaves(state))),
         "train resume: checkpoint 4 is not the trainer's state bit for bit")
    del restored
    victim = ckpt / "step-00000004" / "leaf-00003.npy"
    with open(victim, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    need(not cm.verify(4) and cm.latest_step() == 2,
         "train resume: the corrupted checkpoint 4 was not skipped")
    resumed = trainer(str(ckpt))
    hr = resumed.run(RESUME_STEPS - 2, log_every=1)
    need(resumed.start_step == 2 and [h["step"] for h in hr] == [3, 4],
         f"train resume: resumed at {resumed.start_step}, steps "
         f"{[h['step'] for h in hr]}")
    want = [h["loss"] for h in hs[2:]]
    got = [h["loss"] for h in hr]
    diff = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    need(diff <= 1e-5, f"train resume: losses of steps 3-4 {got} vs the "
         f"straight run's {want}")
    out = dict(path="train resume", model=cfg.name, n_layers=cfg.n_layers,
               straight_loss=[h["loss"] for h in hs],
               checkpointed_loss=[h["loss"] for h in hc],
               resumed_loss=got, resumed_from=2, max_rel_diff=diff,
               bitwise=got == want,
               params_bitwise=all(torch.equal(a, b) for a, b in zip(
                   leaves(resumed.params), leaves(straight.params))),
               restored_bit_identical=True, corrupted_skipped=True,
               wall_s=time.perf_counter() - t0)
    log(json.dumps(out))
    del straight, saving, resumed, p0, state
    torch.cuda.empty_cache()
    return out


def train_elastic(tmp: Path) -> dict:
    """(b') (b)'s cut on a (1, 1) ``("data", "model")`` ``DeviceMesh``
    over a world-size-1 NCCL group (an in-memory store, destroyed at the
    end), the params DTensors laid out by ``param_specs``:
    ``RESUME_STEPS`` straight; the same with ``ckpt_every=2``; checkpoint
    4 restored with ``shardings=`` equal to the saver's state bit for bit
    (``full_tensor``, every leaf, dtype and layout), and a blocking save
    of that state writing checkpoint 4's files again (timed, as is the
    restore); then checkpoint 2 resumed by a fresh ``Trainer`` on the
    mesh and one on plain card tensors, each taking steps 3 and 4 within
    a relative 1e-5 of the straight run's losses.  Each run's flash
    launches (counters zeroed just before it, read just after) are held
    to 2 ``flash_attention_tc`` a layer a microbatch a step (the forward
    and remat's recompute, through ``kernels.custom``'s ops on the mesh's
    DTensors) and 1 ``flash_attention_bwd_tc``, no other flash kernel.
    ``sha_equal_no_mesh`` says whether checkpoint 2's files hash as (b)'s
    (a finding: the mesh's cross-entropy is the vocabulary-parallel
    formula, which rounds otherwise); ``step_s`` gives the median step
    seconds of the straight run and of each resume (host clock, between
    logged steps)."""
    import shutil
    from dataclasses import replace
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import STABLELM_3B
    from repro_torch.configs.common import named
    from repro_torch.data import LMTokenPipeline
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh, process_mesh
    from repro_torch.layers.sharding import (is_dtensor, mesh_of,
                                             placements, sharding_of)
    from repro_torch.models import transformer as tfm
    from repro_torch.train import CheckpointManager, OptimizerConfig, Trainer
    from repro_torch.train.tree import leaves, tree_map
    cfg = replace(STABLELM_3B, n_layers=RESUME_LAYERS)
    pipe = LMTokenPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size,
                           token_file=str(tmp / "tokens.bin"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p0 = tfm.init_params(cfg, g, device="cuda")
    ckpt = tmp / "ckpt_mesh"
    lf = lambda p, b: tfm.loss_fn(p, b, cfg, mesh=mesh_of(b["tokens"]))
    per_step = {"flash_attention_tc": 2 * TRAIN_MICRO * cfg.n_layers,
                "flash_attention_bwd_tc": TRAIN_MICRO * cfg.n_layers,
                "flash_attention_mma": 0, "flash_attention_bwd": 0}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dm = process_mesh(make_mesh((1, 1), ("data", "model")), "cuda")
        psh = named(dm, tfm.param_specs(cfg))

        def spread():
            return tree_map(lambda t, sh: distribute_tensor(
                t.clone(), dm, placements(dm, sh.spec), src_data_rank=None),
                p0, psh)

        def trainer(params, ckpt_dir, every=2):
            return Trainer(lf, params, OptimizerConfig(**TRAIN_OPT),
                           pipe.get_batch, ckpt_dir=ckpt_dir,
                           ckpt_every=every, microbatches=TRAIN_MICRO,
                           device="cuda")

        launches = {}

        def counted(name: str, tr, steps: int) -> list:
            torch.cuda.synchronize()
            build.reset_launches()
            hist = tr.run(steps, log_every=1)
            torch.cuda.synchronize()
            got = {k: build.LAUNCHES[k] for k in per_step}
            want = {k: n * steps for k, n in per_step.items()}
            need(got == want, f"train elastic: {name} launched {got}, "
                 f"want {want}")
            launches[name] = got
            return hist

        hs = counted("straight", trainer(spread(), None), RESUME_STEPS)
        saving = trainer(spread(), str(ckpt))
        hc = counted("checkpointed", saving, RESUME_STEPS)
        cm = CheckpointManager(str(ckpt))
        need(cm.steps() == [2, 4],
             f"train elastic: checkpoints {cm.steps()}")
        state = {"params": saving.params, "opt": saving.opt_state}
        torch.cuda.synchronize()
        ts = time.perf_counter()
        CheckpointManager(str(tmp / "ckpt_timed")).save(4, state,
                                                        blocking=True)
        save_s = time.perf_counter() - ts
        step4 = ckpt / "step-00000004"
        timed = tmp / "ckpt_timed" / "step-00000004"
        written = sum(f.stat().st_size for f in timed.iterdir())
        need((timed / "manifest.json").read_bytes()
             == (step4 / "manifest.json").read_bytes(),
             "train elastic: a blocking save of the saver's state did not "
             "write checkpoint 4's files")
        shutil.rmtree(tmp / "ckpt_timed")
        shardings = {"params": psh, "opt": {"m": psh, "v": psh}}
        tr_ = time.perf_counter()
        restored = cm.restore(4, state, shardings=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - tr_
        pairs = list(zip(leaves(restored), leaves(state)))
        need(all(a.dtype == b.dtype and is_dtensor(a) == is_dtensor(b)
                 and sharding_of(a) == sharding_of(b)
                 and torch.equal(a.full_tensor() if is_dtensor(a) else a,
                                 b.full_tensor() if is_dtensor(b) else b)
                 for a, b in pairs),
             "train elastic: checkpoint 4 restored with shardings= is not "
             "the saver's state bit for bit")
        del restored, pairs, state, saving
        shutil.rmtree(step4)
        resumed, walls = {}, {"straight on mesh": hs}
        for name, params in (("mesh", spread()),
                             ("plain", tree_map(torch.clone, p0))):
            # from checkpoint 2, saving nothing more
            tr = trainer(params, str(ckpt), every=100)
            hr = counted(f"resumed on {name}", tr, RESUME_STEPS - 2)
            need(tr.start_step == 2 and [h["step"] for h in hr] == [3, 4],
                 f"train elastic: {name} resumed at {tr.start_step}, "
                 f"steps {[h['step'] for h in hr]}")
            need(all(is_dtensor(t) == (name == "mesh")
                     for t in leaves(tr.params)),
                 f"train elastic: the {name} resume changed the layout")
            resumed[name] = [h["loss"] for h in hr]
            walls[name] = hr
            del tr, params
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    want = [h["loss"] for h in hs[2:]]
    diff = {k: max(abs(a - b) / abs(b) for a, b in zip(v, want))
            for k, v in resumed.items()}
    need(max(diff.values()) <= 1e-5, f"train elastic: losses of steps 3-4 "
         f"{resumed} vs the straight run's {want}")
    step_s = lambda h: float(np.median(np.diff([x["wall"] for x in h])))
    sha = lambda d: [(l["path"], l["sha"]) for l in json.loads(
        (d / "step-00000002" / "manifest.json").read_text())["leaves"]]
    out = dict(path="train elastic", model=cfg.name, n_layers=cfg.n_layers,
               mesh={"data": 1, "model": 1}, backend="nccl",
               straight_loss=[h["loss"] for h in hs],
               checkpointed_loss=[h["loss"] for h in hc],
               resumed_loss=resumed, resumed_from=2, max_rel_diff=diff,
               bitwise={k: v == want for k, v in resumed.items()},
               restored_bit_identical=True, save_s=save_s,
               restore_s=restore_s, gb_written=written / 1e9,
               step_s={k: step_s(h) for k, h in walls.items()},
               sha_equal_no_mesh=sha(ckpt) == sha(tmp / "ckpt"),
               launches=launches, wall_s=time.perf_counter() - t0)
    log(json.dumps(out))
    del p0
    torch.cuda.empty_cache()
    return out


def train_parity(model) -> dict:
    """(c) ``model`` at full width with 2 layers in float32 (TF32 off): one
    ``make_train_step`` on the card (the mma.sync forward, the f32
    backward kernel) against the port's CPU path on the same weights and
    batch.  Holds an MoE model's router picks equal first, then loss and
    ``grad_norm`` (``TRAIN_PARITY_TOL``) and every updated parameter
    (3 learning rates)."""
    from dataclasses import replace
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tfm
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.train.tree import flatten_with_paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = replace(model, n_layers=PARITY_LAYERS, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = {"card": tfm.init_params(cfg, g, device="cuda")}
    params["host"] = params_to(params["card"], "cpu")
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_PARITY_BATCH,
                                            TRAIN_PARITY_SEQ), dtype=np.int32)
    batch = {"tokens": toks, "labels": (toks * 3 + 7) % cfg.vocab_size}
    opt = OptimizerConfig(lr=TRAIN_PARITY_LR, warmup_steps=1, total_steps=10)
    step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    t0 = time.perf_counter()
    metrics, routes = {}, {}
    build.reset_launches()
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        p = params[where]
        with recorded_routes(routes.setdefault(where, [])):
            p, _, m = step(p, init_opt_state(p), {
                k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        params[where] = p
        metrics[where] = {k: float(v) for k, v in m.items()}
        if where == "card":
            launches = dict(build.LAUNCHES)
    extra = {}
    if cfg.moe is not None:
        k = cfg.moe.top_k
        need(len(routes["card"]) == len(routes["host"]) > 0,
             f"train parity: {len(routes['card'])} and "
             f"{len(routes['host'])} MoE routes")
        with torch.no_grad():
            for i, ((_, a, _), (lg, b, _)) in enumerate(zip(
                    routes["card"], routes["host"])):
                need(torch.equal(a.cpu(), b),
                     f"train parity: router picks differ between card and "
                     f"CPU at route {i}; smallest k-th/(k+1)-th logit gap "
                     f"{topk_gap(lg, k)}")
            extra = dict(router_picks_equal=len(routes["host"]),
                         min_topk_gap=min(topk_gap(lg, k)
                                          for lg, _, _ in routes["host"]))
    del routes
    errs = {}
    for key in ("loss", "grad_norm", "lr"):
        a, b = metrics["card"][key], metrics["host"][key]
        errs[key] = abs(a - b)
        need(abs(a - b) <= TRAIN_PARITY_TOL * (1 + abs(b)),
             f"train parity {cfg.name}: {key} card {a} vs CPU {b}")
    paths, card = flatten_with_paths(params["card"])
    _, cpu = flatten_with_paths(params["host"])
    worst = max((float((a.cpu() - b).abs().max()), p)
                for p, a, b in zip(paths, card, cpu))
    need(worst[0] <= 3 * TRAIN_PARITY_LR,
         f"train parity {cfg.name}: parameter {worst[1]} differs by "
         f"{worst[0]} after one step (lr {TRAIN_PARITY_LR})")
    need(launches["flash_attention_mma"] == 2 * cfg.n_layers
         and launches["flash_attention_bwd"] == cfg.n_layers
         and launches["flash_attention_tc"] == 0
         and launches["flash_attention_bwd_tc"] == 0,
         f"train parity {cfg.name}: launches {launches}")
    out = dict(path="train parity", model=cfg.name, n_layers=cfg.n_layers,
               dtype="float32", batch=TRAIN_PARITY_BATCH,
               seq=TRAIN_PARITY_SEQ, card=metrics["card"],
               cpu=metrics["host"], abs_err=errs,
               tolerance=TRAIN_PARITY_TOL,
               max_param_diff=worst[0], max_param_diff_leaf=worst[1],
               param_tolerance=3 * TRAIN_PARITY_LR, launches=launches,
               wall_s=time.perf_counter() - t0, **extra)
    log(json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return out


def train_bf16_grads(model) -> dict:
    """(d) one full-width layer of ``model`` in bf16 at 4 x 2048 tokens —
    stablelm-3b's whole dense layer (the flash kernels and the dense FFN's
    float32-result products), granite's ``_moe_ffn_local`` (the experts'
    ``bmm_f32``) — against the same layer in float32 on upcast copies of
    its input and weights (TF32 off): the loss is ``sum(y * r)`` for a
    fixed random float32 ``r``.  An MoE layer's router picks are held
    equal first; then each gradient leaf (the input's and every
    parameter's) within ``BF16_GRAD_TOL`` of its largest |f32 grad|."""
    from dataclasses import replace
    import torch
    from repro_torch.layers.moe import init_moe_params, route
    from repro_torch.models import transformer as tfm
    from repro_torch.train.tree import flatten_with_paths, tree_map, unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cfg = replace(model, n_layers=1)
    if cfg.moe is None:
        lp = tfm._layer_stack(tfm.init_params(cfg, g, device="cuda"))[0]
        pos = torch.arange(GRAD_SEQ, dtype=torch.int32,
                           device="cuda").expand(GRAD_BATCH, GRAD_SEQ)
        layer = lambda x, p, c: tfm._layer(x, p, c, pos)[0]
        what = "_layer (attention and the dense FFN)"
    else:
        lp = {k: v[0] for k, v in init_moe_params(
            g, cfg.d_model, cfg.moe, 1, dtype=cfg.dtype,
            device="cuda").items()}
        layer = lambda x, p, c: tfm._moe_ffn_local(x, p, c)[0]
        what = "_moe_ffn_local"
    x = torch.randn((GRAD_BATCH, GRAD_SEQ, cfg.d_model), generator=g,
                    device="cuda").to(cfg.dtype)
    r = torch.randn(x.shape, generator=g, device="cuda")
    if cfg.moe is not None:
        k = cfg.moe.top_k
        need(torch.equal(route(x.reshape(-1, cfg.d_model), lp["router"],
                               k)[1],
                         route(x.float().reshape(-1, cfg.d_model),
                               lp["router"].float(), k)[1]),
             f"train bf16 grads: bf16 and f32 router picks differ "
             f"({cfg.name})")
    grads = {}
    for name, c, xin, p in (
            ("bf16", cfg, x, lp),
            ("f32", replace(cfg, dtype=torch.float32), x.float(),
             tree_map(lambda t: t.float(), lp))):
        paths, flat = flatten_with_paths(p)
        req = [xin.detach().requires_grad_()] + [
            t.detach().requires_grad_() for t in flat]
        y = layer(req[0], unflatten(p, req[1:]), c)
        grads[name] = torch.autograd.grad((y.float() * r).sum(), req)
    errs = {}
    for path, a, b in zip(["x"] + paths, grads["bf16"], grads["f32"]):
        errs[path] = rel_err(a, b)
    worst = max(errs, key=errs.get)
    need(errs[worst] <= BF16_GRAD_TOL,
         f"train bf16 grads {cfg.name}: {worst}'s bf16 gradient differs "
         f"from float32 by {errs[worst]} of its largest |grad|")
    out = dict(path="train bf16 grads", model=cfg.name, layer=what,
               tokens=GRAD_BATCH * GRAD_SEQ, rel_err=errs,
               tolerance=BF16_GRAD_TOL,
               router_picks_equal=True if cfg.moe else None)
    log(json.dumps(out))
    del grads, lp, x, r
    torch.cuda.empty_cache()
    return out


def train_embed_grad(model) -> dict:
    """(d') ``_embed``'s gradient of ``model``'s bf16 table (its full
    vocabulary and width) at the train step's 4 x 4096 tokens, drawn
    Zipf so that rows repeat, with two ids outside the table (which read
    a clamped row and send it nothing): against the same on a float32
    copy within ``BF16_GRAD_TOL`` of its largest |f32 grad|, and against
    a second bf16 run bit for bit.  The loss is ``sum(rows * r)`` for a
    fixed random float32 ``r``.  For the record only, the same error of
    two bf16 sums in place of ``_embed``'s float32 one (on the clamped
    ids, against their own float32 gradient): the indexing's own
    backward ``table[ids]`` and one ``index_add_``."""
    import torch
    from repro_torch.models import transformer as tfm
    n = model.padded_vocab
    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    table = (torch.randn((n, model.d_model), generator=g,
                         device="cuda") * 0.02).to(model.dtype)
    rank = torch.arange(1, model.vocab_size + 1, device="cuda",
                        dtype=torch.float64)
    tokens = torch.multinomial(rank ** -EMBED_ZIPF, TRAIN_BATCH * TRAIN_SEQ,
                               replacement=True, generator=g)
    tokens = tokens.reshape(TRAIN_BATCH, TRAIN_SEQ).to(torch.int32)
    tokens[0, 0], tokens[1, 1] = n + 5, -n - 9
    ids = torch.where(tokens < 0, tokens + n, tokens).clamp(0, n - 1).long()
    r = torch.randn((TRAIN_BATCH, TRAIN_SEQ, model.d_model), generator=g,
                    device="cuda")

    def grad(tab, rows_of):
        tab = tab.detach().requires_grad_()
        return torch.autograd.grad((rows_of(tab).float() * r).sum(), tab)[0]

    def embed(cfg):
        return lambda tab: tfm._embed({"embed": tab}, tokens, cfg)

    f32_cfg = dataclasses.replace(model, dtype=torch.float32)
    bf16 = grad(table, embed(model))
    again = grad(table, embed(model))
    f32 = grad(table.float(), embed(f32_cfg))
    err = rel_err(bf16, f32)
    repeat = same_bits(bf16, again)
    indexed = lambda tab: tab[ids]
    f32_ids = grad(table.float(), indexed)
    bf16_sums = {
        "indexing": rel_err(grad(table, indexed), f32_ids),
        "index_add_": rel_err(grad(table, lambda tab: tab.index_select(
            0, ids.reshape(-1)).reshape(r.shape)), f32_ids)}
    counts = torch.bincount(ids.reshape(-1), minlength=n)
    out = dict(path="train embed grad", model=model.name,
               table=[n, model.d_model],
               dtype=str(model.dtype).removeprefix("torch."),
               tokens=TRAIN_BATCH * TRAIN_SEQ, zipf=EMBED_ZIPF,
               most_repeated_row=int(counts.max()),
               rows_hit=int((counts > 0).sum()), rel_err=err,
               tolerance=BF16_GRAD_TOL, repeat_same_bits=repeat,
               bf16_sums_rel_err=bf16_sums)
    log(json.dumps(out))
    need(err <= BF16_GRAD_TOL,
         f"train embed grad {model.name}: the bf16 embedding gradient "
         f"differs from float32 by {err} of its largest |grad|")
    need(repeat, f"train embed grad {model.name}: two bf16 runs differ")
    del table, bf16, again, f32, f32_ids, r
    torch.cuda.empty_cache()
    return out


def train_compressed() -> dict:
    """(e) ``make_dp_train_step`` and ``make_compressed_train_step`` over a
    world-size-1 NCCL group (an in-memory store, destroyed at the end) on
    ``tests/test_fault_tolerance.py``'s tiny model (2 layers, d_model 64,
    float32) for 25 steps each, from the same seeded weights: the
    compressed run's last loss below 0.8 x its first, and within 0.35 x
    the first of the uncompressed run."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import (init_compressed_state,
                                  make_compressed_train_step,
                                  make_dp_train_step)
    from repro_torch.kernels import build
    from repro_torch.models.transformer import (TransformerConfig,
                                                init_params, loss_fn)
    from repro_torch.train import OptimizerConfig, init_opt_state
    from repro_torch.train.tree import tree_map
    cfg = TransformerConfig(name="t", n_layers=2, d_model=64, n_heads=4,
                            n_kv_heads=2, d_ff=128, vocab_size=256,
                            dtype=torch.float32, remat=False)
    lf = lambda p, b: loss_fn(p, b, cfg)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)
    p0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda")

    def batch(s):
        rng = np.random.default_rng(s)
        toks = rng.integers(0, 64, (16, 32), dtype=np.int32)
        return {"tokens": torch.as_tensor(toks, device="cuda"),
                "labels": torch.as_tensor((toks * 3 + 7) % 256,
                                          device="cuda")}

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        curves = {}
        build.reset_launches()
        for name in ("compressed", "uncompressed"):
            p = tree_map(torch.clone, p0)
            opt, err = init_opt_state(p), init_compressed_state(p)
            step_c = make_compressed_train_step(lf, oc)
            step_u = make_dp_train_step(lf, oc)
            losses = []
            for s in range(COMPRESSED_STEPS):
                if name == "compressed":
                    p, opt, err, m = step_c(p, opt, err, batch(s))
                else:
                    p, opt, m = step_u(p, opt, batch(s))
                losses.append(float(m["loss"]))
            curves[name] = losses
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
    finally:
        dist.destroy_process_group()
    lc, lu = curves["compressed"], curves["uncompressed"]
    need(lc[-1] < 0.8 * lc[0], f"train compressed: the compressed run did "
         f"not learn: {lc[0]} -> {lc[-1]}")
    need(abs(lc[-1] - lu[-1]) < 0.35 * lu[0],
         f"train compressed: {lc[-1]} vs uncompressed {lu[-1]}")
    need(launches["flash_attention_bwd"] == 2 * cfg.n_layers
         * COMPRESSED_STEPS and launches["flash_attention_bwd_tc"] == 0,
         f"train compressed: launches {launches}")
    out = dict(path="train compressed", world_size=1, backend="nccl",
               steps=COMPRESSED_STEPS, compressed=lc, uncompressed=lu,
               launches=launches, wall_s=time.perf_counter() - t0)
    log(json.dumps(out))
    return out


def train_phase() -> dict:
    """(a)-(e) of the ``train`` phase, in a temporary directory for the
    token file and the checkpoints; returns (a)'s launches (``main``) and
    median step seconds (``steady_step_s``), the launches of (c)'s
    float32 steps summed (``parity``: the mma.sync backward's path) and
    those of (b')'s runs on the mesh and off it (``elastic``)."""
    import tempfile
    from repro_torch.configs import GRANITE_MOE_3B_A800M, STABLELM_3B
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        main = train_main(tmp)
        log(f"train main: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        train_resume(tmp)
        log(f"train resume: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        elastic = train_elastic(tmp)
        log(f"train elastic: {time.perf_counter() - t0:.2f} s")
    parity = {}
    for model in (STABLELM_3B, GRANITE_MOE_3B_A800M):
        t0 = time.perf_counter()
        for k, n in train_parity(model)["launches"].items():
            parity[k] = parity.get(k, 0) + n
        log(f"train parity {model.name}: {time.perf_counter() - t0:.2f} s")
    for model in (STABLELM_3B, GRANITE_MOE_3B_A800M):
        t0 = time.perf_counter()
        train_bf16_grads(model)
        log(f"train bf16 grads {model.name}: "
            f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_embed_grad(STABLELM_3B)
    log(f"train embed grad: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_compressed()
    log(f"train compressed: {time.perf_counter() - t0:.2f} s")
    return {"main": main["launches"], "parity": parity,
            "elastic": elastic["launches"],
            "steady_step_s": main["steady_step_s"]}


#: the ``gnn`` phase (a): the four GNNs trained at the JAX package's
#: launcher scale (``src/repro/launch/train.py:47-57`` without
#: ``--reduced``): one fixed graph of 100,000 nodes and 1,600,000 directed
#: edges, 16 features, coordinates, 4 graphs, full-width configs
#: (``make_cfg(16, 16)``), AdamW at lr 3e-4 with warmup min(100, steps)
GNN_NODES, GNN_EDGES, GNN_FEAT, GNN_GRAPHS = 100_000, 1_600_000, 16, 4
GNN_STEPS, GNN_LR = 6, 3e-4
#: (b) card against the port's CPU path at full width on a smaller graph,
#: float32 (TF32 off): loss, outputs and every gradient leaf within
#: ``GNN_PARITY_TOL`` of each one's largest |want| (float32 sums in other
#: orders, the card's by atomics); MACE's switches on the card against
#: ``outer`` within ``GNN_VARIANT_TOL``; ``compute_bf16`` against float32
#: within ``GNN_BF16_TOL``, the ``train`` phase's bf16 convention
GNN_PARITY_GRAPH = dict(n_nodes=2048, n_edges=16384, d_feat=16, seed=1,
                        coords=True, n_graphs=4, n_classes=16)
GNN_PARITY_TOL, GNN_VARIANT_TOL, GNN_BF16_TOL = 1e-4, 1e-5, 2.0 ** -5
#: GatedGCN's gradients, whose float32 floor is above ``GNN_PARITY_TOL``:
#: a ReLU input within rounding of 0 flips with the order of a sum, and
#: one edge's whole term then enters or leaves a gradient element.  The
#: card against itself with the edges reordered (the same function) gave
#: 2.24e-3 on ``E1``, and once the card against the CPU as well; on the
#: CPU, reordering gives 1.1e-4 with ReLU, 8.1e-6 with a smooth
#: activation in its place, and 1.2e-14 in float64 (PERF.md, PR 24)
GNN_GRAD_TOL = {"gatedgcn": 1e-2}
#: card runs of each parity line: the card's atomics sum in another order
#: each time, and the line holds the worst of them
GNN_PARITY_REPEATS = 8
GNN_MACE_VARIANTS = {"loop": dict(a_basis_mode="loop"),
                     "couple_chunks_16": dict(couple_chunks=16),
                     "remat": dict(remat=True),
                     "shard_couple": dict(shard_couple=True)}
#: (c) the JAX package's one-card GNN shapes, one train step each; edges
#: are padded to a multiple of 512 as ``GNNArch._batch_abs`` pads them
GNN_SHAPE_RUNS = (("full_graph_sm", ("gatedgcn", "pna", "egnn", "mace")),
                  ("molecule", ("egnn", "mace")))
#: (d) ``examples/train_gnn_wcoj_features.py``: triangle counts from the
#: join as GatedGCN features on ``powerlaw_cluster(800, 4, seed=0)``
WCOJ_NODES, WCOJ_M, WCOJ_STEPS = 800, 4, 60


def gnn_archs() -> tuple:
    from repro_torch.configs import EGNN, GATEDGCN, MACE, PNA
    return GATEDGCN, PNA, EGNN, MACE


def gnn_kernel_group(name: str) -> str:
    """A GNN step's device kernels by part, read off PyTorch's kernel
    names: the gathers (``index_select``, ``h[src]``: the vectorized
    gather, ``indexSelect*``, and the scatter-gather kernel in its gather
    form, ``internal_kernel<false``, which rows of other than 16-byte
    multiples take), the scatters (``index_add_`` and ``index_reduce``,
    ``indexFunc*``: the message sums and maxima and the gathers'
    backward; the scatter-gather kernel's scatter form), the GEMMs, the
    rest (elementwise work, reductions, norms, the optimizer)."""
    low = name.lower()
    if "_scatter_gather" in low:
        return "gather" if "internal_kernel<false" in low else "scatter"
    if "vectorized_gather" in low or "indexselect" in low:
        return "gather"
    if "indexfunc" in low:
        return "scatter"
    return "gemm" if is_gemm(name) else "other"


def gnn_train(arch, g) -> dict:
    """(a) ``arch`` at full width through ``Trainer.run``: ``GNN_STEPS``
    steps of the loss closed over the launcher's graph ``g`` (on the card
    already), then one more step by hand, profiled (its gradient and its
    AdamW update).  Holds finite losses and gradient norms, and that
    every parameter leaf moved but those the loss does not reach (zero
    gradient and zero values, such as the last EGNN layer's coordinate
    MLP biases: the energy reads no coordinates), which are named."""
    import torch
    from repro_torch.train import (OptimizerConfig, Trainer, adamw_update,
                                   value_and_grad)
    from repro_torch.train.tree import flatten_with_paths, unflatten
    t0 = time.perf_counter()
    cfg = arch.make_cfg(GNN_FEAT, 16)
    params = arch.init_fn(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    paths, before = flatten_with_paths(params)
    before = [p.clone() for p in before]
    opt = OptimizerConfig(lr=GNN_LR, warmup_steps=min(100, GNN_STEPS),
                          total_steps=GNN_STEPS)
    lf = lambda p, b: arch.loss_fn(p, g, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(lf, params, opt, lambda step: {"step": np.zeros(1)},
                      device="cuda")
    hist = trainer.run(GNN_STEPS, log_every=1, resume="none")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    need(all(np.isfinite(losses)) and all(np.isfinite(norms)),
         f"gnn {arch.arch_id}: a loss or gradient norm is not finite: "
         f"{hist}")
    walls = [h["wall"] for h in hist]
    step_s = [b - a for a, b in zip([0.0] + walls, walls)]
    steady = float(np.median(step_s[1:]))

    def step():
        _, grads = value_and_grad(lf, trainer.params, None)
        adamw_update(trainer.params, unflatten(trainer.params, grads),
                     trainer.opt_state, opt)
        return grads

    events, grads = traced(step, f"gnn train {arch.arch_id}")
    unreached = [p for p, gr in zip(paths, grads) if not bool(gr.any())]
    still = [p for p, a, b in zip(paths, flatten_with_paths(
        trainer.params)[1], before) if not bool((a != b).any())]
    need(set(still) <= set(unreached),
         f"gnn {arch.arch_id}: leaves the loss reaches did not move: "
         f"{sorted(set(still) - set(unreached))}")
    profiled = "not measured"
    if events:
        parts = device_groups(events, gnn_kernel_group)
        busy = sum(parts.values())
        top = sorted(device_groups(events, lambda k: k).items(),
                     key=lambda kv: -kv[1])[:10]
        profiled = dict(device_busy_s=busy, device_s=parts,
                        share={k: v / busy for k, v in parts.items()},
                        idle_share=1 - busy / steady,
                        idle_note="1 - the profiled step's device time "
                                  "over the median unprofiled step",
                        top_kernels=[dict(kernel=k[:200], s=s,
                                          group=gnn_kernel_group(k))
                                     for k, s in top])
    out = dict(
        path="gnn train", model=arch.arch_id, cfg=str(cfg),
        n_params=sum(p.numel() for p in before), nodes=g.n_nodes,
        edges=g.n_edges, graphs=g.n_graphs, steps=GNN_STEPS, lr=GNN_LR,
        reduced=None, loss=losses, grad_norm=norms, step_s=step_s,
        steady_step_s=steady, edges_per_s=g.n_edges / steady,
        peak_bytes=peak, peak_gb=peak / 1e9, leaves=len(paths),
        leaves_not_moved=still, leaves_without_gradient=unreached,
        profile=profiled, seconds=time.perf_counter() - t0)
    log(json.dumps(out))
    del trainer, params, before, grads, events
    torch.cuda.empty_cache()
    return out


def gnn_outputs(arch, params, g, cfg) -> list:
    """What ``arch``'s forward returns, as a list of tensors: logits,
    EGNN's ``(h, x)``, MACE's irrep state."""
    from repro_torch.models import gnn
    fwd = {"gatedgcn": gnn.gatedgcn_forward, "pna": gnn.pna_forward,
           "egnn": gnn.egnn_forward, "mace": gnn.mace_forward}[arch.arch_id]
    out = fwd(params, g, cfg)
    return list(out) if isinstance(out, tuple) else [out]


def gnn_grads(arch, params, g, cfg) -> tuple:
    """``(loss, outputs, gradient leaves)`` of ``arch`` on ``g``."""
    import torch
    from repro_torch.train import value_and_grad
    loss, grads = value_and_grad(lambda p, _: arch.loss_fn(p, g, cfg),
                                 params, None)
    with torch.no_grad():
        outs = gnn_outputs(arch, params, g, cfg)
    return loss, outs, grads


def norm_err(got, want) -> float:
    """||got - want|| over ||want|| (Frobenius, in float64)."""
    want = want.double()
    return float((got.double() - want).norm()
                 / want.norm().clamp(min=1e-300))


def gnn_errs(got: tuple, want: tuple, paths: list) -> dict:
    """Each part's error relative to its largest |want|: the loss, the
    largest over the outputs, and over the gradient leaves the largest
    (with its leaf), and the largest norm error (``norm_err``)."""
    (lg, og, gg), (lw, ow, gw) = got, want
    grad_errs = [rel_err(a.cpu(), b.cpu()) for a, b in zip(gg, gw)]
    worst = int(np.argmax(grad_errs))
    return dict(loss=rel_err(lg.cpu().reshape(1), lw.cpu().reshape(1)),
                outputs=max(rel_err(a.cpu(), b.cpu())
                            for a, b in zip(og, ow)),
                grads=grad_errs[worst], worst_leaf=paths[worst],
                grads_norm=max(norm_err(a.cpu(), b.cpu())
                               for a, b in zip(gg, gw)))


def gnn_parity(arch) -> dict:
    """(b) ``arch`` at full width in float32 on ``GNN_PARITY_GRAPH``: the
    card against the port's CPU path on the same parameters; for MACE
    also its switches on the card against ``outer`` and ``compute_bf16``
    against float32.  ``reordered`` is the float32 floor: the same
    computation with the edges in another order (the same function),
    on the card against the card and on the CPU against the CPU."""
    import dataclasses
    import torch
    from repro_torch.models.gnn import random_graph_batch
    from repro_torch.train.tree import flatten_with_paths, tree_map
    t0 = time.perf_counter()
    g = random_graph_batch(**GNN_PARITY_GRAPH)
    perm = np.random.default_rng(SEED).permutation(g.n_edges)
    gp = dataclasses.replace(g, src=g.src[perm], dst=g.dst[perm])
    gc = g.to("cuda")
    cfg = arch.make_cfg(GNN_PARITY_GRAPH["d_feat"], 16)
    cpu = arch.init_fn(cfg, torch.Generator().manual_seed(SEED),
                       device="cpu")
    paths = flatten_with_paths(cpu)[0]
    card = tree_map(lambda t: t.to("cuda"), cpu)
    want = gnn_grads(arch, cpu, g, cfg)
    runs = [gnn_errs(gnn_grads(arch, card, gc, cfg), want, paths)
            for _ in range(GNN_PARITY_REPEATS)]
    errs = max(runs, key=lambda e: (e["grads"], e["outputs"], e["loss"]))
    base = gnn_grads(arch, card, gc, cfg)
    reordered = dict(
        card=gnn_errs(gnn_grads(arch, card, gp.to("cuda"), cfg), base,
                      paths),
        cpu=gnn_errs(gnn_grads(arch, cpu, gp, cfg), want, paths))
    grad_tol = GNN_GRAD_TOL.get(arch.arch_id, GNN_PARITY_TOL)
    out = dict(path="gnn parity", model=arch.arch_id,
               graph=GNN_PARITY_GRAPH, repeats=GNN_PARITY_REPEATS,
               card_vs_cpu=errs,
               card_vs_cpu_grads_by_run=[e["grads"] for e in runs],
               tolerance=GNN_PARITY_TOL, grad_tolerance=grad_tol,
               reordered=reordered)
    log(json.dumps(out))
    need(max(errs["loss"], errs["outputs"]) <= GNN_PARITY_TOL
         and errs["grads"] <= grad_tol,
         f"gnn parity {arch.arch_id}: card against CPU {errs}, tolerance "
         f"{GNN_PARITY_TOL} (gradients {grad_tol})")
    if arch.arch_id == "mace":
        out = dict(path="gnn parity mace switches", variants_vs_outer={})
        for name, over in GNN_MACE_VARIANTS.items():
            out["variants_vs_outer"][name] = gnn_errs(gnn_grads(
                arch, card, gc, dataclasses.replace(cfg, **over)), base,
                paths)
        out["variant_tolerance"] = GNN_VARIANT_TOL
        out["bf16_vs_f32"] = gnn_errs(gnn_grads(arch, card, gc,
                                                dataclasses.replace(
                                                    cfg, compute_bf16=True)),
                                      base, paths)
        out["bf16_tolerance"] = GNN_BF16_TOL
        log(json.dumps(out))
        for name, e in out["variants_vs_outer"].items():
            need(max(e["loss"], e["outputs"], e["grads"]) <= GNN_VARIANT_TOL,
                 f"gnn parity mace {name}: against outer {e}, tolerance "
                 f"{GNN_VARIANT_TOL}")
        e = out["bf16_vs_f32"]
        need(max(e["loss"], e["outputs"], e["grads"]) <= GNN_BF16_TOL,
             f"gnn parity mace compute_bf16: against float32 {e}, "
             f"tolerance {GNN_BF16_TOL}")
    log(f"gnn parity {arch.arch_id}: {time.perf_counter() - t0:.2f} s")
    return out


def gnn_shape_batch(arch_id: str, shape: str, needs_coords: bool):
    """The JAX package's ``shape`` (``GNN_SHAPES``) as a graph batch:
    ``full_graph_sm`` one random graph of Cora's sizes (2,708 nodes,
    10,556 undirected edges), ``molecule`` 128 random graphs of 30 nodes
    and 64 undirected edges side by side (block-diagonal); edges padded
    with dummy self-loops to a multiple of 512."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.models.gnn import (GraphBatch, pad_graph,
                                        random_graph_batch)
    sh = GNN_SHAPES[shape]
    if shape == "molecule":
        n, b = sh["n_nodes"], sh["batch"]
        mols = [random_graph_batch(n, 2 * sh["n_edges"], sh["d_feat"],
                                   seed=SEED + i, coords=True, n_classes=16)
                for i in range(b)]
        cat = lambda f: np.concatenate([getattr(m, f) for m in mols])
        off = np.repeat(np.arange(b, dtype=np.int32) * n, 2 * sh["n_edges"])
        g = GraphBatch(src=cat("src") + off, dst=cat("dst") + off,
                       n_nodes=n * b, node_feat=cat("node_feat"),
                       coords=cat("coords"),
                       graph_id=np.repeat(np.arange(b, dtype=np.int32), n),
                       n_graphs=b, labels=cat("labels"))
    else:
        g = random_graph_batch(sh["n_nodes"], 2 * sh["n_edges"],
                               sh["d_feat"], seed=SEED, coords=needs_coords,
                               n_classes=16)
    return pad_graph(g, g.n_nodes, -(-g.n_edges // 512) * 512)


def gnn_shapes() -> list:
    """(c) one train step of each model on each of its shapes: the loss
    and the gradient norm finite."""
    import torch
    from repro_torch.train import OptimizerConfig, Trainer
    archs = {a.arch_id: a for a in gnn_archs()}
    out = []
    for shape, ids in GNN_SHAPE_RUNS:
        for arch_id in ids:
            t0 = time.perf_counter()
            arch = archs[arch_id]
            g = gnn_shape_batch(arch_id, shape, arch.needs_coords).to("cuda")
            cfg = arch.make_cfg(g.node_feat.shape[1], 16)
            params = arch.init_fn(cfg, torch.Generator(
                device="cuda").manual_seed(SEED), device="cuda")
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(lambda p, b: arch.loss_fn(p, g, cfg), params,
                         OptimizerConfig(lr=GNN_LR, warmup_steps=1,
                                         total_steps=1),
                         lambda step: {"step": np.zeros(1)}, device="cuda")
            h = tr.run(1, log_every=1, resume="none")[0]
            need(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
                 f"gnn shape {shape} {arch_id}: {h}")
            line = dict(path="gnn shape", shape=shape, model=arch_id,
                        nodes=g.n_nodes, edges=g.n_edges, graphs=g.n_graphs,
                        d_feat=g.node_feat.shape[1], loss=h["loss"],
                        grad_norm=h["grad_norm"], step_s=h["wall"],
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        seconds=time.perf_counter() - t0)
            log(json.dumps(line))
            out.append(line)
    return out


def triangles_per_node(csr) -> np.ndarray:
    """Each node's triangles on the host, diag(A³) / 2 with scipy."""
    import scipy.sparse as sp
    n = csr.n_nodes
    a = sp.csr_matrix((np.ones(csr.indices.shape[0], dtype=np.int64),
                       csr.indices, csr.indptr), shape=(n, n))
    return np.asarray(a.multiply(a @ a).sum(axis=1)).ravel() // 2


def gnn_wcoj(T) -> dict:
    """(d) ``examples/train_gnn_wcoj_features.py`` in the port: the
    3-cliques of ``powerlaw_cluster(800, 4, seed=0)`` enumerated by
    ``VLFTJ`` on the card (its launches counted), each node's count
    equal to the host's, then GatedGCN (3 x 32) trained ``WCOJ_STEPS``
    steps without and with ``log1p(triangles)`` as a feature; the loss
    with it must be lower.  Returns the enumeration's launches."""
    import torch
    from repro_torch.graphs import powerlaw_cluster
    from repro_torch.kernels import build
    from repro_torch.models.gnn import GraphBatch
    from repro_torch.models.gnn.gatedgcn import (GatedGCNConfig,
                                                 gatedgcn_loss,
                                                 init_gatedgcn)
    from repro_torch.train import OptimizerConfig, Trainer
    t0 = time.perf_counter()
    g = powerlaw_cluster(n=WCOJ_NODES, m_per_node=WCOJ_M, seed=0)
    gdb = T.GraphDB(g, {}, device="cuda")
    build.reset_launches()
    tris = T.VLFTJ(T.get_query("3-clique"), gdb).enumerate()
    launches = dict(build.LAUNCHES)
    tri = np.zeros(g.n_nodes, np.float32)
    np.add.at(tri, tris.ravel(), 1.0)
    host = triangles_per_node(g)
    need(np.array_equal(tri, host.astype(np.float32)),
         "gnn wcoj: per-node triangle counts differ from the host's")
    rng = np.random.default_rng(0)
    labels = (tri > np.median(tri)).astype(np.int32)
    base = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    ea = g.edge_array()

    def final_loss(with_wcoj: bool) -> float:
        feat = np.concatenate([base] + ([np.log1p(tri)[:, None]]
                                        if with_wcoj else []), 1)
        batch = GraphBatch(src=ea[:, 0], dst=ea[:, 1], n_nodes=g.n_nodes,
                           node_feat=feat, labels=labels).to("cuda")
        cfg = GatedGCNConfig(n_layers=3, d_hidden=32, d_in=feat.shape[1],
                             n_classes=2)
        tr = Trainer(
            lambda p, b: gatedgcn_loss(p, batch, cfg),
            init_gatedgcn(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda"),
            OptimizerConfig(lr=3e-3, warmup_steps=10,
                            total_steps=WCOJ_STEPS),
            lambda step: {"_": np.zeros(1)}, device="cuda")
        return tr.run(WCOJ_STEPS, log_every=WCOJ_STEPS)[-1]["loss"]

    plain, wcoj = final_loss(False), final_loss(True)
    need(wcoj < plain, f"gnn wcoj: the triangle features did not lower "
         f"the loss ({wcoj} against {plain})")
    out = dict(path="gnn wcoj", nodes=g.n_nodes, edges=g.n_edges,
               triangles=int(tris.shape[0]), max_per_node=int(tri.max()),
               loss_without=plain, loss_with=wcoj, steps=WCOJ_STEPS,
               launches=launches, seconds=time.perf_counter() - t0)
    log(json.dumps(out))
    return out


def gnn_phase(T) -> dict:
    """(a)-(d) of the ``gnn`` phase, float32 with TF32 off; returns (d)'s
    launches."""
    import torch
    from repro_torch.models.gnn import random_graph_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g = random_graph_batch(GNN_NODES, GNN_EDGES, GNN_FEAT, seed=SEED,
                           coords=True, n_graphs=GNN_GRAPHS).to("cuda")
    log(f"gnn graph: {g.n_nodes} nodes, {g.n_edges} directed edges "
        f"({time.perf_counter() - t0:.2f} s); "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated on the "
        "card with it")
    for arch in gnn_archs():
        t0 = time.perf_counter()
        gnn_train(arch, g)
        log(f"gnn train {arch.arch_id}: {time.perf_counter() - t0:.2f} s")
    del g
    torch.cuda.empty_cache()
    failed = []
    for arch in gnn_archs():
        try:
            gnn_parity(arch)
        except SmokeFailure as e:
            failed.append(str(e))
            log(f"FAILED: {e}")
    t0 = time.perf_counter()
    gnn_shapes()
    log(f"gnn shapes: {time.perf_counter() - t0:.2f} s")
    launches = gnn_wcoj(T)["launches"]
    need(not failed, "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# arch: the registry, xDeepFM at full width, command-r-plus-104b with its
# depth cut, and the two launchers
# ---------------------------------------------------------------------------

#: the JAX package's registry, its ids in its order
#: (``src/repro/configs/__init__.py:14-20``)
ARCH_IDS = ("stablelm-3b", "chatglm3-6b", "command-r-plus-104b",
            "moonshot-v1-16b-a3b", "granite-moe-3b-a800m", "gatedgcn",
            "egnn", "pna", "mace", "xdeepfm", "wcoj")
#: (b) xDeepFM's ``train_batch`` of 65,536 rows a step in microbatches of
#: 16,384: the whole batch would hold ~90 GB of CIN products and their
#: gradients at once (three (B·10, Hk·39) float32 products saved, 44.9 GB,
#: and two 20.4 GB transients in the backward), over one 80 GB card
XDF_STEPS, XDF_MICROBATCHES = 6, 4
#: ``serve_bulk``'s 262,144 rows run in row chunks: its (B·10, 7800)
#: product would be 82 GB at once; the rows are independent
XDF_BULK_CHUNK = 32_768
XDF_P99_CALLS, XDF_RETRIEVAL_CALLS = 30, 20
XDF_PARITY_TOL = 1e-4
XDF_PARITY_ROWS = 1024
#: (c) command-r-plus-104b's depth cut: 8 of 64 layers (15.7 B parameters,
#: 31.5 GB of bf16 weights; all 64 are 208 GB)
COMMANDR_LAYERS = 8
#: (d) the JAX training launcher's message for ``--arch wcoj``
#: (``src/repro/launch/train.py:75-76``)
WCOJ_TRAIN_MESSAGE = ("--arch wcoj: family wcoj is not a trainable "
                      "architecture (use launch.serve for wcoj)")


def arch_registry() -> dict:
    """(a) ``ARCHS`` has the JAX package's 11 ids in its order, and every
    ``smoke(device="cuda")`` is finite (``WCOJArch.smoke`` raises unless
    ``vlftj``'s triangles equal ``lftj_ref``'s).  Returns the launches."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    need(tuple(ARCHS) == ARCH_IDS, f"arch registry: ids {list(ARCHS)}")
    build.reset_launches()
    out = {}
    for arch_id, arch in ARCHS.items():
        t0 = time.perf_counter()
        got = arch.smoke(device="cuda")
        torch.cuda.synchronize()
        need(all(np.isfinite(v) for v in got.values()),
             f"arch smoke {arch_id}: {got}")
        out[arch_id] = dict(got, family=arch.family,
                            seconds=time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    log(json.dumps({"path": "arch registry", "ids": list(ARCHS),
                    "smoke": out, "launches": launches}))
    torch.cuda.empty_cache()
    return launches


def xdf_train() -> tuple:
    """(b) xDeepFM at full width (39 fields x 1,000,000 rows x 10 dims,
    CIN 200-200-200, MLP 400-400, float32) through the training launcher's
    recsys wiring (``launch.train.build_trainer``): ``XDF_STEPS`` AdamW
    steps of ``train_batch``'s 65,536 rows from ``recsys_synthetic_batch``,
    in ``XDF_MICROBATCHES`` microbatches.  Then one more step by hand,
    profiled in three windows: the microbatches' gradients, the CIN's
    forward and backward replayed on the same microbatches' embeddings,
    and the AdamW update (each the fullest of 3, ``fullest``: a replay
    window short of launches would move CIN time into "gemms").  The device time as embedding gathers
    (``index_select``), scatters (its backward, ``index_add_``), the CIN
    (all its kernels), the other GEMMs, the optimizer and the rest
    (``gnn_kernel_group``'s reading of the names).  Returns the trained
    parameters and the line."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as launch_train
    from repro_torch.models import xdeepfm as xdf
    from repro_torch.train import adamw_update, value_and_grad
    from repro_torch.train.tree import leaves as tree_leaves
    from repro_torch.train.tree import tree_map, unflatten
    cfg = ARCHS["xdeepfm"].cfg
    batch_rows = ARCHS["xdeepfm"].shapes["train_batch"]["batch"]
    args = launch_train.parse_args([
        "--arch", "xdeepfm", "--steps", str(XDF_STEPS), "--seed", str(SEED),
        "--microbatches", str(XDF_MICROBATCHES), "--resume", "none",
        "--log-every", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = launch_train.build_trainer("xdeepfm", args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    hist = trainer.run(XDF_STEPS, log_every=1, resume="none")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    need(all(np.isfinite(x) for x in losses)
         and all(np.isfinite(h["grad_norm"]) for h in hist),
         f"xdeepfm train: a loss or gradient norm is not finite: {hist}")
    walls = [h["wall"] for h in hist]
    step_s = [b - a for a, b in zip([0.0] + walls, walls)]
    steady = float(np.median(step_s[1:]))

    batch = tree_map(lambda x: torch.as_tensor(np.array(x), device="cuda"),
                     trainer.get_batch(XDF_STEPS))
    need(batch["ids"].shape[0] == batch_rows, f"xdeepfm train: the "
         f"launcher's batch has {batch['ids'].shape[0]} rows, train_batch "
         f"{batch_rows}")
    rows = batch_rows // XDF_MICROBATCHES
    mbs = [tree_map(lambda x: x[i * rows:(i + 1) * rows], batch)
           for i in range(XDF_MICROBATCHES)]

    def mean_grads():
        gsum = None
        for mb in mbs:
            _, grads = value_and_grad(trainer.loss_fn, trainer.params, mb)
            if gsum is None:
                gsum = grads
            else:
                for acc, x in zip(gsum, grads):
                    acc.add_(x)
            del grads
        for acc in gsum:
            acc.div_(XDF_MICROBATCHES)
        return gsum

    with torch.no_grad():
        x0s = [xdf.embedding_bag(trainer.params["embed"], xdf._field_ids(
            mb["ids"].long(), cfg)).transpose(1, 2).contiguous()
            for mb in mbs]

    def cin_replay():
        ws = [w.detach().requires_grad_(True) for w in trainer.params["cin"]]
        for x0 in x0s:
            x0 = x0.requires_grad_(True)
            with torch.enable_grad():
                y = (xdf.cin(x0, ws) @ trainer.params["out_cin"]).sum()
                torch.autograd.grad(y, [x0] + ws)

    ev_grad, n_grad, gsum = fullest(mean_grads, "xdeepfm train gradients")
    finite = all(bool(torch.isfinite(x).all()) for x in gsum)
    need(finite, "xdeepfm train: a gradient leaf is not finite")
    mean = unflatten(trainer.params, gsum)
    ev_cin, n_cin, _ = fullest(cin_replay, "xdeepfm train CIN replay")
    ev_opt, n_opt, _ = fullest(
        lambda: adamw_update(trainer.params, mean, trainer.opt_state,
                             trainer.opt_cfg), "xdeepfm train optimizer")
    if ev_grad and ev_cin and ev_opt:
        grad = device_groups(ev_grad, gnn_kernel_group)
        cin = device_groups(ev_cin, gnn_kernel_group)
        parts = dict(embedding_gathers=grad.get("gather", 0.0),
                     scatters=grad.get("scatter", 0.0),
                     cin=sum(cin.values()),
                     gemms=grad.get("gemm", 0.0) - cin.get("gemm", 0.0),
                     optimizer=sum(device_groups(ev_opt,
                                                 lambda _: "o").values()))
        parts["rest"] = (sum(grad.values()) - parts["embedding_gathers"]
                         - parts["scatters"] - parts["gemms"] - parts["cin"])
        busy = sum(parts.values())
        top = sorted(device_groups(ev_grad, lambda k: k).items(),
                     key=lambda kv: -kv[1])[:10]
        profiled = dict(device_busy_s=busy, device_s=parts,
                        share={k: v / busy for k, v in parts.items()},
                        idle_share=1 - busy / steady,
                        idle_note="1 - the profiled step's device time "
                                  "over the median unprofiled step",
                        cin_note="the CIN's forward and backward replayed "
                                 "on the step's embeddings; gemms and rest "
                                 "are the gradient window's less the CIN's",
                        window_launches=dict(gradients=n_grad, cin=n_cin,
                                             optimizer=n_opt),
                        top_kernels=[dict(kernel=k[:120], s=s,
                                          group=gnn_kernel_group(k))
                                     for k, s in top])
    else:
        profiled = "not measured"
    out = dict(
        path="xdeepfm train", shape="train_batch", cfg=str(cfg),
        n_params=sum(p.numel() for p in tree_leaves(trainer.params)),
        batch=batch_rows, microbatches=XDF_MICROBATCHES,
        rows_per_microbatch=rows, steps=XDF_STEPS, lr=args.lr,
        init_s=init_s, loss=losses, grad_norm=[h["grad_norm"] for h in hist],
        step_s=step_s, steady_step_s=steady, rows_per_s=batch_rows / steady,
        peak_bytes=peak, peak_gb=peak / 1e9, profile=profiled,
        every_gradient_leaf_finite=finite)
    log(json.dumps(out))
    params = trainer.params
    del trainer, batch, mbs, gsum, mean, x0s, ev_grad, ev_cin, ev_opt
    torch.cuda.empty_cache()
    return params, out


def event_times_ms(fn, calls: int) -> list:
    """CUDA-event time of each of ``calls`` calls of ``fn``, after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def xdf_serve(params) -> dict:
    """(b) xDeepFM's three forward shapes at full size on the trained
    parameters: ``serve_p99`` (512 rows, the median of ``XDF_P99_CALLS``
    calls), ``serve_bulk`` (262,144 rows in chunks of ``XDF_BULK_CHUNK``
    rows; the first chunk's first rows equal the same rows' logits in a
    call of their own within 1e-5 of their largest |value|) and
    ``retrieval_cand`` (1 query against 1,000,000 candidates of field 0's
    rows); each finite and of its shape."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import recsys_synthetic_batch
    from repro_torch.models import xdeepfm as xdf
    arch = ARCHS["xdeepfm"]
    cfg, shapes = arch.cfg, arch.shapes

    def ids(step: int, rows: int):
        return torch.as_tensor(recsys_synthetic_batch(
            step, rows, cfg.n_sparse, cfg.vocab_per_field,
            seed=SEED)["ids"], device="cuda")

    out = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        p99_ids = ids(100, shapes["serve_p99"]["batch"])
        times = event_times_ms(
            lambda: xdf.xdeepfm_forward(params, p99_ids, cfg), XDF_P99_CALLS)
        logits = xdf.xdeepfm_forward(params, p99_ids, cfg)
        need(tuple(logits.shape) == (p99_ids.shape[0],)
             and bool(torch.isfinite(logits).all()),
             f"xdeepfm serve_p99: logits {tuple(logits.shape)} not finite")
        out["serve_p99"] = dict(rows=p99_ids.shape[0], calls=len(times),
                                median_ms=float(np.median(times)),
                                p99_ms=float(np.percentile(times, 99)),
                                min_ms=min(times))

        bulk = shapes["serve_bulk"]["batch"]
        bulk_ids = ids(101, bulk)

        def bulk_forward():
            return torch.cat([xdf.xdeepfm_forward(
                params, bulk_ids[i:i + XDF_BULK_CHUNK], cfg)
                for i in range(0, bulk, XDF_BULK_CHUNK)])

        times = event_times_ms(bulk_forward, 2)
        logits = bulk_forward()
        need(tuple(logits.shape) == (bulk,)
             and bool(torch.isfinite(logits).all()),
             f"xdeepfm serve_bulk: logits {tuple(logits.shape)} not finite")
        alone = xdf.xdeepfm_forward(params, bulk_ids[:512], cfg)
        chunk_err = rel_err(logits[:512], alone)
        need(chunk_err <= 1e-5, f"xdeepfm serve_bulk: a chunk's logits "
             f"differ from the same rows' in a call of their own by "
             f"{chunk_err} of their largest")
        out["serve_bulk"] = dict(rows=bulk, chunk_rows=XDF_BULK_CHUNK,
                                 chunks=-(-bulk // XDF_BULK_CHUNK),
                                 chunk_vs_alone=chunk_err,
                                 ms=min(times), calls_ms=times,
                                 rows_per_s=bulk / min(times) * 1e3)

        n_cand = shapes["retrieval_cand"]["n_candidates"]
        q = ids(102, 1)
        cand = torch.arange(n_cand, device="cuda")
        times = event_times_ms(
            lambda: xdf.retrieval_scores(params, q, cand, cfg),
            XDF_RETRIEVAL_CALLS)
        scores = xdf.retrieval_scores(params, q, cand, cfg)
        need(tuple(scores.shape) == (n_cand,)
             and bool(torch.isfinite(scores).all()),
             "xdeepfm retrieval_cand: scores not finite")
        out["retrieval_cand"] = dict(candidates=n_cand, calls=len(times),
                                     median_ms=float(np.median(times)),
                                     min_ms=min(times))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({"path": "xdeepfm serve", **out}))
    return out


def xdf_parity() -> dict:
    """(b) the reduced config (vocab 1000 a field, CIN (16, 16), MLP (32,
    32)) on the card against the port's CPU path, on the same parameters
    carried across by ``convert.xdeepfm_params_from_numpy`` and the same
    ids (``XDF_PARITY_ROWS`` pipeline rows and 8 rows of ids outside
    [0, vocab), negative ones among them): logits, loss and every
    gradient leaf within ``XDF_PARITY_TOL`` of each part's largest
    |want|."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.convert import xdeepfm_params_from_numpy
    from repro_torch.data import recsys_synthetic_batch
    from repro_torch.models import xdeepfm as xdf
    from repro_torch.train import value_and_grad
    from repro_torch.train.tree import flatten_with_paths, tree_map
    cfg = ARCHS["xdeepfm"].reduced_cfg()
    host = xdf.init_xdeepfm(cfg, torch.Generator().manual_seed(SEED),
                            device="cpu")
    arrays = tree_map(lambda t: t.numpy(), host)
    batch = recsys_synthetic_batch(0, XDF_PARITY_ROWS, cfg.n_sparse,
                                   cfg.vocab_per_field, seed=SEED)
    rng = np.random.default_rng(SEED)
    wild = rng.integers(-5 * cfg.total_vocab, 5 * cfg.total_vocab,
                        (8, cfg.n_sparse)).astype(np.int32)
    batch = {"ids": np.concatenate([batch["ids"], wild]),
             "labels": np.concatenate([batch["labels"],
                                       np.ones(8, np.int32)])}
    runs = {}
    for dev in ("cpu", "cuda"):
        p = xdeepfm_params_from_numpy(arrays, device=dev)
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, grads = value_and_grad(
            lambda pp, bb: xdf.xdeepfm_loss(pp, bb, cfg), p, b)
        with torch.no_grad():
            logits = xdf.xdeepfm_forward(p, b["ids"], cfg)
        runs[dev] = (loss.cpu(), logits.cpu(), [g.cpu() for g in grads])
    (lw, ow, gw), (lg, og, gg) = runs["cpu"], runs["cuda"]
    paths = flatten_with_paths(host)[0]
    grad_errs = [rel_err(a, b) for a, b in zip(gg, gw)]
    worst = int(np.argmax(grad_errs))
    errs = dict(logits=rel_err(og, ow),
                loss=rel_err(lg.reshape(1), lw.reshape(1)),
                grads=grad_errs[worst], worst_leaf=paths[worst])
    log(json.dumps({"path": "xdeepfm parity", "cfg": str(cfg),
                    "rows": XDF_PARITY_ROWS + 8, "tolerance": XDF_PARITY_TOL,
                    "errors": errs}))
    need(max(errs["logits"], errs["loss"], errs["grads"]) <= XDF_PARITY_TOL,
         f"xdeepfm parity: card against CPU beyond {XDF_PARITY_TOL}: {errs}")
    return errs


def commandr_serve() -> dict:
    """(c) command-r-plus-104b at full width (d_model 12,288, 96 query and
    8 KV heads of 128, d_ff 33,792, vocab 256,000, LayerNorm, tied) with
    its depth cut to ``COMMANDR_LAYERS`` of 64, bf16: the ``lm`` phase's
    serving path (``lm_serve``: prefill 4 x 2048, 32 decode steps, one
    launch of the wgmma flash kernel a prefill layer, none of the
    mma.sync one), then the wgmma kernel at its prefill shape (D 128, GQA
    group 12) against its plain version at 2e-2, timed beside SDPA
    (``flash_model_shape``).  Returns the serving path's launches."""
    import torch
    from repro_torch.configs import COMMAND_R_PLUS_104B
    cfg = dataclasses.replace(COMMAND_R_PLUS_104B, n_layers=COMMANDR_LAYERS)
    log(json.dumps({"path": "arch command-r cut",
                    "reduced": {"n_layers": f"{COMMANDR_LAYERS} of "
                                f"{COMMAND_R_PLUS_104B.n_layers}"},
                    "n_params_full": COMMAND_R_PLUS_104B.n_params,
                    "n_params_run": cfg.n_params,
                    "bf16_gb_full": 2 * COMMAND_R_PLUS_104B.n_params / 1e9,
                    "bf16_gb_run": 2 * cfg.n_params / 1e9}))
    launches, _ = lm_serve(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    line = flash_model_shape(cfg, randn)
    need(line["gqa_group"] == 12 and cfg.head_dim == 128,
         f"command-r's heads: group {line['gqa_group']}, D {cfg.head_dim}")
    log(json.dumps({"path": "arch flash command-r", **line}))
    torch.cuda.empty_cache()
    return launches


def arch_launchers(T) -> dict:
    """(d) ``launch.train.main`` at ``--reduced --steps 3 --device cuda``
    for the 10 trainable ids (each loss finite), ``--arch wcoj`` refused
    with the JAX launcher's message, and ``launch.serve.main`` at its
    defaults (``powerlaw_cluster(20000, 6)``, 50 requests) on the card,
    each served count equal to a direct ``count`` of the same query on
    the server's db with the result's engine (``QueryServer.execute_batch``
    wrapped to record the server, requests and results).  Returns the
    launches of the training runs and of the served batch."""
    import io
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import build
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    runs, launches = {}, {}
    build.reset_launches()
    for arch_id, arch in ARCHS.items():
        if arch.family == "wcoj":
            continue
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main([
                "--arch", arch_id, "--reduced", "--steps", "3",
                "--log-every", "1", "--resume", "none", "--device", "cuda"])
        lines = buf.getvalue().splitlines()
        losses = [float(x.split()[3]) for x in lines if x.startswith("step")]
        need(rc == 0 and len(losses) == 3 and all(np.isfinite(losses)),
             f"launch.train {arch_id}: rc {rc}, output {lines}")
        runs[arch_id] = dict(loss=losses, device_line=lines[0],
                             seconds=time.perf_counter() - t0)
    launches["train"] = dict(build.LAUNCHES)
    refused = None
    try:
        launch_train.main(["--arch", "wcoj", "--device", "cuda"])
    except SystemExit as e:
        refused = str(e)
    need(refused == WCOJ_TRAIN_MESSAGE,
         f"launch.train --arch wcoj: {refused!r}")
    log(json.dumps({"path": "arch launch.train", "runs": runs,
                    "wcoj": refused, "launches": launches["train"]}))

    recorded = []
    real = launch_serve.QueryServer.execute_batch

    def recording(server, reqs):
        results = real(server, reqs)
        recorded.append((server, reqs, results))
        return results

    buf = io.StringIO()
    launch_serve.QueryServer.execute_batch = recording
    t0 = time.perf_counter()
    build.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            rc = launch_serve.main(["--device", "cuda"])
    finally:
        launch_serve.QueryServer.execute_batch = real
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches["serve"] = dict(build.LAUNCHES)
    (server, reqs, results), = recorded
    need(rc == 0 and len(results) == 50,
         f"launch.serve: rc {rc}, {len(results)} results")
    t0 = time.perf_counter()
    for req, res in zip(reqs, results):
        direct = T.count(T.get_query(req.query_name),
                         server._gdb_for(req.selectivity, req.seed),
                         engine=res.engine)
        need(direct == res.count, f"launch.serve {req}: served {res.count} "
             f"!= direct {res.engine} count {direct}")
    log(json.dumps({
        "path": "arch launch.serve", "graph_nodes": server.csr.n_nodes,
        "directed_edges": int(server.csr.indices.shape[0]),
        "requests": len(results), "seconds": serve_s,
        "engine_s": sum(r.latency_s for r in results),
        "percentiles": launch_serve.percentiles(results),
        "counts": [[r.request.query_name, r.request.selectivity,
                    r.request.seed, r.engine, r.count] for r in results],
        "direct_counts_s": time.perf_counter() - t0,
        "launches": launches["serve"]}))
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"  launch.serve: {line}")
    del server, recorded
    torch.cuda.empty_cache()
    return launches


#: (e) the dry run's time on the host, which the phase keeps under this
DRYRUN_BUDGET_S = 45.0


def arch_dryrun(train_step_s, xdf_step_s: float) -> None:
    """(e) ``launch.dryrun`` of two one-card cells whose steps this run
    measured: stablelm-3b's ``train_4k`` cut to the ``train`` phase's
    batch (4 x 4096 in 2 microbatches, an ``LMArch`` copy of that shape)
    and xDeepFM's ``train_batch`` (65,536 rows; (b) runs them in 4
    microbatches).  The dry run costs each cell on fake CPU tensors (host
    time only, no launch; flash attention as the card's fused kernels,
    the rest on its plain path): FLOPs by operand type, unfused
    bytes, the compute and memory terms and the bound, the larger of the
    two, beside the step seconds measured in this run (``train_step_s``
    is None when the ``train`` phase did not run) and measured / bound,
    with the card's name and power limit."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh((1, 1), ("data", "model"))
    lm = dataclasses.replace(
        ARCHS["stablelm-3b"], microbatches=TRAIN_MICRO,
        shapes={"train_4k": dict(kind="train", seq=TRAIN_SEQ,
                                 batch=TRAIN_BATCH)})
    smi = _nvidia_smi()
    for name, cell, measured in (
            ("stablelm-3b train_4k 4x4096", lm.cell("train_4k", mesh),
             train_step_s),
            ("xdeepfm train_batch", ARCHS["xdeepfm"].cell("train_batch",
                                                          mesh),
             xdf_step_s)):
        rec = dryrun.measure(cell)
        rl = rec["roofline"]
        need(rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
             and rl["bound_s"] > 0, f"arch dryrun {name}: {rec}")
        log(json.dumps(dict(
            path="arch dryrun", cell=name, kind=cell.kind,
            flops_by_dtype=rec["cost"]["flops_by_dtype"],
            bytes=rec["cost"]["bytes accessed"],
            top_bytes_by_op=rec["cost"]["top_bytes_by_op"],
            t_compute_s=rl["t_compute"], t_memory_s=rl["t_memory"],
            bound_s=rl["bound_s"], bottleneck=rl["bottleneck"],
            model_flops=cell.model_flops, trace_s=rec["trace_s"],
            measured_step_s=("not measured" if measured is None
                             else measured),
            measured_over_bound=("not measured" if measured is None
                                 else measured / rl["bound_s"]),
            bound_note="the count on fake CPU tensors: products by "
                       "operand type at the H100 SXM peaks, bytes unfused "
                       "(each op's inputs and outputs), flash attention "
                       "and its backward as the card's fused kernels",
            card=smi)))
    seconds = time.perf_counter() - t0
    log(f"arch dryrun: {seconds:.2f} s of host time (budget "
        f"{DRYRUN_BUDGET_S:.0f} s)")


#: (f) the cells of the per-chip programs, and the step's time limit
MESH_CELLS = (("stablelm-3b", "train_4k"), ("xdeepfm", "train_batch"),
              ("wcoj", "triangle_frontier"))
MESH_STEP_LIMIT_S = 90.0


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def arch_mesh_dryrun(smi: str) -> dict:
    """(f a) ``launch.dryrun`` of :data:`MESH_CELLS` on the 16x16 and
    2x16x16 meshes: one chip's program on fake CPU tensors laid out as
    DTensors over a fake process group (host time only); one line a cell
    and mesh with the chip's FLOPs by type, bytes, collectives by kind,
    the three terms and the bottleneck.  Returns the records."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    recs = {}
    for arch_id, shape in MESH_CELLS:
        for mesh_name in ("single", "multi"):
            mesh, rec_name = dryrun.MESHES[mesh_name]
            cell = ARCHS[arch_id].cell(shape, mesh)
            rec = dryrun.measure(cell, mesh)
            rl = rec["roofline"]
            need(rec["cost"]["flops"] > 0 and rl["bound_s"] > 0,
                 f"arch mesh dryrun {arch_id} {shape} {rec_name}: {rec}")
            coll = rec["coll"]
            log(json.dumps(dict(
                path="arch mesh dryrun", cell=f"{arch_id} {shape}",
                mesh=rec_name, chips=mesh.size,
                flops_by_dtype=rec["cost"]["flops_by_dtype"],
                bytes=rec["cost"]["bytes accessed"],
                coll_bytes={k: v for k, v in coll.items()
                            if not k.startswith("n_")},
                coll_calls={k[2:]: v for k, v in coll.items()
                            if k.startswith("n_")},
                memory=rec["memory"], t_compute_s=rl["t_compute"],
                t_memory_s=rl["t_memory"],
                t_collective_s=rl["t_collective"],
                bottleneck=rl["bottleneck"], bound_s=rl["bound_s"],
                trace_s=rec["trace_s"],
                note="one chip's share, counted on fake CPU tensors: the "
                     "port's unfused count, not XLA's", card=smi)))
            recs[(arch_id, rec_name)] = rec
    return recs


def _random_csr(n: int, e: int, seed: int):
    """A seeded random CSR on the card: ``e`` (src, dst) pairs, sorted by
    source and then destination, as int32 ``indptr`` and ``indices``."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=gen, device="cuda")
    key = src * n + torch.randint(0, n, (e,), generator=gen, device="cuda")
    del src
    key = torch.sort(key).values
    indices = (key % n).to(torch.int32)
    src = key // n
    del key
    indptr = torch.searchsorted(
        src, torch.arange(n + 1, device="cuda")).to(torch.int32)
    del src
    return indptr, indices


def arch_mesh_wcoj(bound_s: float, smi: str) -> dict:
    """(f b) chip 0's program of WCOJ ``triangle_frontier`` on 16x16: the
    cell's join step on DTensors over a fake 256-rank group, the graph
    (a seeded random sorted CSR of the cell's nodes and CSR entries)
    whole on the card, this chip's 65,536 of the 1,048,576 frontier rows
    (edges sampled from the graph); the count must equal that of the same
    rows through the unsharded ``_expand_level`` on the card, exactly.
    Returns the launches of the sharded step."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.common import place
    from repro_torch.core.vlftj import _expand_level
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import MESHES
    from repro_torch.launch.mesh import device_mesh
    from repro_torch.layers.sharding import on_mesh
    mesh, _ = MESHES["single"]
    sh = ARCHS["wcoj"].shapes["triangle_frontier"]
    n, e, c = sh["n_nodes"], sh["n_edges"], sh["frontier"]
    cell = ARCHS["wcoj"].cell("triangle_frontier", mesh)
    t0 = time.perf_counter()
    indptr, indices = _random_csr(n, e, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = cell.in_shardings[2].shard_shape((c, 2))[0]
    pick = torch.randint(0, e, (rows,), generator=gen, device="cuda")
    srcs = torch.searchsorted(indptr[1:].long(), pick, right=True)
    frontier = torch.stack([srcs.to(torch.int32), indices[pick]], dim=1)
    mult = torch.ones(rows, dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    dm = device_mesh(mesh, "cuda")
    args = [place(t, s, dm, shape) for t, s, shape in zip(
        (indptr, indices, frontier, mult), cell.in_shardings,
        ((n + 1,), (e,), (c, 2), (c,)))]
    step_s = []
    build.reset_launches()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with on_mesh(args):
            total = cell.fn(*args)
        got = int(total.full_tensor())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    want = int(_expand_level(
        indptr, indices, (), frontier, mult,
        torch.ones(rows, dtype=torch.bool, device="cuda"),
        probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
        width=sh["width"], n_iter=18, count_only=True, needs_degree=False,
        unroll=True).sum())
    need(got == want, f"arch mesh wcoj: the sharded count {got} != the "
         f"unsharded {want}")
    need(launches["searchsorted_segments"] > 0,
         "arch mesh wcoj never launched searchsorted_segments")
    log(json.dumps(dict(
        path="arch mesh wcoj", cell="wcoj triangle_frontier",
        mesh="pod16x16", chip=0, graph_nodes=n, csr_entries=e,
        indices_gb=indices.numel() * 4 / 1e9, frontier_rows=rows,
        count=got, unsharded_count=want, graph_build_s=graph_s,
        step_s=min(step_s), steps_s=step_s, bound_s=bound_s,
        measured_over_bound=min(step_s) / bound_s,
        launches={k: v for k, v in launches.items() if v},
        note="the count is chip 0's partial: the fake group's all-reduce "
             "moves nothing", card=smi)))
    del indptr, indices, args
    torch.cuda.empty_cache()
    return launches


def _local_values(leaf, shape, name: str, gen, id_limit: int):
    """Chip 0's shard of a parameter, moment or batch leaf of the LM's
    train cell: normal(0, 0.02) bf16 weights, float32 norm scales of 1,
    zero moments and step, token ids below ``id_limit``."""
    import torch
    if name.startswith(("m/", "v/")) or name == "step":
        return torch.zeros(shape, dtype=leaf.dtype, device="cuda")
    if name.split("/")[-1] in ("ln1", "ln2", "ln_f"):
        return torch.ones(shape, dtype=leaf.dtype, device="cuda")
    if leaf.dtype in (torch.int32, torch.int64):
        return torch.randint(0, id_limit, shape, generator=gen,
                             device="cuda", dtype=leaf.dtype)
    return (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(
        leaf.dtype)


def _defined_collectives():
    """A dispatch mode for chip 0's program over the fake group, whose
    collectives leave their outputs as they were allocated (uninitialized
    memory): the slots of the other chips in an all-gather's,
    reduce-scatter's or all-to-all's output are set to zeros and chip 0's
    own slot to its own data, so every value is chip 0's partial (an
    all-reduce already returns chip 0's input).  Nothing is moved and the
    collectives still run through the group.  ``seen`` counts the
    collectives by op; ``calls`` the ops the mode saw and ``handler_s``
    the host seconds its handler spent outside the ops themselves."""
    from collections import Counter

    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    def own_slot(out, inp, n, gather_dim, shard_dim):
        out.zero_()
        part = inp.chunk(n, dim=shard_dim)[0] if shard_dim is not None \
            else inp
        out.narrow(gather_dim, 0, part.shape[gather_dim]).copy_(part)

    class Defined(TorchDispatchMode):
        seen = Counter()
        calls, handler_s = 0, 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            t0 = time.perf_counter()
            self.calls += 1
            if any(issubclass(t, DTensor) for t in types):
                self.handler_s += time.perf_counter() - t0
                return NotImplemented
            t1 = time.perf_counter()
            out = func(*args, **(kwargs or {}))
            t2 = time.perf_counter()
            self._fill(func, args, out)
            self.handler_s += (t1 - t0) + (time.perf_counter() - t2)
            return out

        def _fill(self, func, args, out):
            name = func._schema.name
            if func.namespace in ("_c10d_functional", "_dtensor", "c10d"):
                self.seen[name] += 1
            if name == "_c10d_functional::all_gather_into_tensor":
                own_slot(out, args[0], args[1], 0, None)
            elif name == "_c10d_functional::reduce_scatter_tensor":
                out.copy_(args[0][:out.shape[0]])
            elif name == "_c10d_functional::all_to_all_single":
                out_sizes, in_sizes = args[1], args[2]
                out.zero_()
                if out_sizes and in_sizes:
                    out[:out_sizes[0]].copy_(args[0][:in_sizes[0]])
            elif name == "_dtensor::shard_dim_alltoall":
                n = out.shape[args[1]] // args[0].shape[args[1]]
                own_slot(out, args[0], n, args[1], args[2])

    return Defined()


def _mode_call_us(n: int = 20000) -> float:
    """The host microseconds a dispatch mode that passes every op through
    adds to one small op on the card (the trampoline into Python), from
    ``n`` in-place adds timed without and with it."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Through(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    x = torch.zeros(16, device="cuda")
    walls = []
    for mode in (None, Through(), None, Through()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode if mode is not None else contextlib.nullcontext():
            for _ in range(n):
                x.add_(1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return (min(walls[1], walls[3]) - min(walls[0], walls[2])) / n * 1e6


def arch_mesh_lm(bound_s: float, smi: str) -> dict:
    """(f c) chip 0's program of stablelm-3b ``train_4k`` on 16x16: the
    cell's train step (all 32 layers, remat, AdamW) on DTensors over a
    fake 256-rank group, each leaf chip 0's shard (16 x 4096 tokens, 2
    of the 32 heads, 1/16 of the FFN and of the vocabulary), seeded
    random weights, token ids in chip 0's vocabulary slice; one warm-up
    and two timed steps, a finite loss and gradient norm, and the
    tensor-core flash kernels launched under their sharding rules.
    The collectives run through the fake group, which moves nothing and
    takes no time: every value is chip 0's partial.  Returns the launches
    of the timed steps."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.common import ShapeDtype, place
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import MESHES
    from repro_torch.launch.mesh import device_mesh
    mesh, _ = MESHES["single"]
    cell = ARCHS["stablelm-3b"].cell("train_4k", mesh)
    dm = device_mesh(mesh, "cuda")
    # token ids in chip 0's slice of the vocabulary: over the fake group
    # a chip's embedding rows are whole only for its own ids (the rest
    # are zeros, and 64 norms' gradients at zero rows overflow)
    id_limit = cell.in_shardings[0]["embed"].shard_shape(
        cell.args[0]["embed"].shape)[0]

    def walk(arg, shd, name, gen):
        if isinstance(arg, ShapeDtype):
            local = shd.shard_shape(arg.shape) if shd is not None else \
                arg.shape
            return place(_local_values(arg, local, name, gen, id_limit),
                         shd, dm, arg.shape)
        return {k: walk(v, shd[k] if isinstance(shd, dict) else shd,
                        f"{name}/{k}" if name else k, gen)
                for k, v in arg.items()}

    gen = torch.Generator(device="cuda").manual_seed(0)
    params, opt, batch = (walk(a, shd, "", gen) for a, shd in zip(
        cell.args, cell.in_shardings))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, norms = [], [], []
    mode = _defined_collectives()
    for i in range(3):
        if i == 1:
            build.reset_launches()
            mode.calls, mode.handler_s = 0, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode:
            params, opt, metrics = cell.fn(params, opt, batch)
            loss = float(metrics["loss"].to_local())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"].to_local()))
    launches = dict(build.LAUNCHES)
    # the harness' mode on the host, a timed step: its handler's own
    # seconds plus a trampoline into Python for each op it saw
    call_us = _mode_call_us()
    calls, handler_s = mode.calls / 2, mode.handler_s / 2
    harness = dict(ops_per_step=calls, handler_s_per_step=handler_s,
                   trampoline_us=call_us,
                   est_s_per_step=handler_s + calls * call_us * 1e-6)
    need(all(np.isfinite(losses)) and all(np.isfinite(norms)),
         f"arch mesh lm: losses {losses}, gradient norms {norms}")
    need(max(step_s) <= MESH_STEP_LIMIT_S,
         f"arch mesh lm: a step took {max(step_s):.1f} s")
    for name in ("flash_attention_tc", "flash_attention_bwd_tc"):
        need(launches[name] > 0, f"arch mesh lm never launched {name}")
    step = min(step_s[1:])
    log(json.dumps(dict(
        path="arch mesh lm", cell="stablelm-3b train_4k", mesh="pod16x16",
        chip=0, tokens=[16, 4096], token_ids_below=id_limit,
        local_heads=2, layers=32,
        losses=losses, grad_norms=norms, warmup_s=step_s[0], step_s=step,
        steps_s=step_s[1:],
        bound_s=bound_s, measured_over_bound=step / bound_s,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_per_step={k: v / 2 for k, v in launches.items() if v},
        collectives_per_step={k: v / 3 for k, v in mode.seen.items()},
        harness_mode=harness,
        note="collectives through a fake group: they move nothing and take "
             "no time, so the values are chip 0's partials", card=smi)))
    del params, opt, batch
    torch.cuda.empty_cache()
    return launches


def arch_mesh() -> dict:
    """(f) the per-chip programs on the production meshes: (a) the dry
    run, (b) chip 0's WCOJ join step and (c) chip 0's stablelm-3b train
    step on the card.  Returns the launches of (b) and (c)."""
    from repro_torch.launch.mesh import release_fake_world
    smi = _nvidia_smi()
    t0 = time.perf_counter()
    try:
        recs = arch_mesh_dryrun(smi)
        log(f"arch mesh dryrun: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        wcoj = arch_mesh_wcoj(
            recs[("wcoj", "pod16x16")]["roofline"]["bound_s"], smi)
        log(f"arch mesh wcoj: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        lm = arch_mesh_lm(
            recs[("stablelm-3b", "pod16x16")]["roofline"]["bound_s"], smi)
        log(f"arch mesh lm: {time.perf_counter() - t0:.2f} s")
    finally:
        release_fake_world()
    return {"mesh_wcoj": wcoj, "mesh_lm": lm}


def arch_phase(T, train_step_s=None) -> dict:
    """(a)-(e) of the ``arch`` phase, float32 with TF32 off (command-r in
    bf16); returns each path's launches.  ``train_step_s`` is the
    ``train`` phase's median step seconds, for (e)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    log(f"arch: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated on "
        "the card before the phase")
    launches = {}
    t0 = time.perf_counter()
    launches["registry"] = arch_registry()
    log(f"arch registry: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params, xdf_line = xdf_train()
    log(f"arch xdeepfm train: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    xdf_serve(params)
    del params
    torch.cuda.empty_cache()
    log(f"arch xdeepfm serve: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    xdf_parity()
    log(f"arch xdeepfm parity: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches["command_r"] = commandr_serve()
    log(f"arch command-r: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches.update(arch_launchers(T))
    log(f"arch launchers: {time.perf_counter() - t0:.2f} s")
    arch_dryrun(train_step_s, xdf_line["steady_step_s"])
    launches.update(arch_mesh())
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
            stats = stats["raw"]
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
            stats = stats["raw"]
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
    query = T.get_query(shape)
    t0 = time.perf_counter()
    T.count(query, db, **kw)
    wall = time.perf_counter() - t0

    def counted():
        t0 = time.perf_counter()
        T.count(query, db, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    events, wall_profiled = traced(counted, f"profile {shape} {db_name}")
    if not events:
        log(json.dumps({"profile": shape, "db": db_name, "count_kw": kw,
                        "wall_s": wall, "device_busy_s": "not measured"}))
        return
    events = sorted(events, key=device_us, reverse=True)
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


def host_walks(db) -> tuple:
    """``(A, v2, A² v1, A³ v1)`` on the host with scipy: ``db``'s
    adjacency matrix, the indicator of its ``v2`` sample and the walk
    vectors from its ``v1`` sample (the 3-path count is v2ᵀ A³ v1)."""
    import scipy.sparse as sp
    csr = db.csr
    n = csr.n_nodes
    a = sp.csr_matrix((np.ones(csr.indices.shape[0], dtype=np.int64),
                       csr.indices, csr.indptr), shape=(n, n))
    v1, v2 = (np.isin(np.arange(n), db.unary[u]).astype(np.int64)
              for u in ("v1", "v2"))
    w2 = a @ (a @ v1)
    return a, v2, w2, a @ w2


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
    csr = db.csr
    a, v2, w2, w3 = host_walks(db)
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


def rows_digest(rows: np.ndarray) -> tuple:
    """``(shape, dtype, SHA-256 of the bytes)`` of an array: equal for
    identical arrays, so two processes compare rows without sending
    them."""
    import hashlib
    rows = np.ascontiguousarray(rows)
    return rows.shape, str(rows.dtype), hashlib.sha256(rows.data).hexdigest()


def small_scale_host(T) -> dict:
    """The CPU half of :func:`small_scale`, in a child process: on the
    plain CPU path at ``SMALL_SCALE``, ``(db, shape) -> ("rows", digest,
    seconds)`` for the shapes of ``ENUM_SHAPES`` and ``("count", n,
    seconds)`` for the 3-lollipop."""
    from repro_torch.core import engine as E
    _, db, hdb = bench_gdb(T, SMALL_SCALE, "cpu")
    out = {}
    for db_name, d in (("plain", db), ("hybrid", hdb)):
        for shape in SHAPES:
            t0 = time.perf_counter()
            q = T.get_query(shape)
            if shape in ENUM_SHAPES:
                got = ("rows", rows_digest(E.enumerate(q, d,
                                                       mode="flat").rows))
            else:
                got = ("count", T.count(q, d))
            out[db_name, shape] = got + (time.perf_counter() - t0,)
    return out


def small_scale(T, worker):
    """At 2% scale, every shape but the 3-lollipop enumerated on the card
    and on the plain CPU path (identical arrays: the CPU half,
    :func:`small_scale_host`, runs in ``worker`` and sends each array's
    digest), the 3-lollipop counted on both; on the card, each
    enumeration's length against its count and three counts against
    ``engine="vlftj"``."""
    import torch
    from repro_torch.core import engine as E
    _, db, hdb = bench_gdb(T, SMALL_SCALE, "cuda")
    card = {}
    for db_name, d in (("plain", db), ("hybrid", hdb)):
        for shape in SHAPES:
            t0 = time.perf_counter()
            q = T.get_query(shape)
            if shape not in ENUM_SHAPES:
                card[db_name, shape] = ("count", T.count(q, d))
                continue
            rows = E.enumerate(q, d, mode="flat").rows
            n = T.count(q, d)
            need(n == rows.shape[0],
                 f"scale {SMALL_SCALE} {db_name} {shape}: "
                 f"{rows.shape[0]} rows != count {n}")
            card[db_name, shape] = ("rows", rows_digest(rows))
            log(f"enumerate cuda {db_name} {shape}: {rows.shape[0]} rows "
                f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.synchronize()

    def size(v):
        return v[1][0][0] if v[0] == "rows" else v[1]

    for shape in ("3-path", "2-lollipop", "3-lollipop"):
        t0 = time.perf_counter()
        n = T.count(T.get_query(shape), db, engine="vlftj")
        log(f"vlftj scale {SMALL_SCALE} plain {shape}: {n} "
            f"({time.perf_counter() - t0:.3f} s)")
        need(n == size(card["plain", shape]),
             f"scale {SMALL_SCALE} {shape}: auto "
             f"{size(card['plain', shape])} != vlftj {n}")
    t0 = time.perf_counter()
    host = host_result(worker, "the small-scale CPU enumerations")
    log(f"small scale: waited {time.perf_counter() - t0:.2f} s for the CPU "
        "half")
    need(set(host) == set(card), f"CPU half ran {sorted(host)}")
    for (db_name, shape), (kind, got, secs) in host.items():
        log(f"{'enumerate' if kind == 'rows' else 'count'} cpu {db_name} "
            f"{shape}: {size((kind, got))} ({secs:.3f} s, in the child)")
        need((kind, got) == card[db_name, shape],
             f"scale {SMALL_SCALE} {db_name} {shape}: card "
             f"{card[db_name, shape]} != CPU {(kind, got)}")
    log("scale", SMALL_SCALE, json.dumps(
        {f"{db}/{s}": size(v) for (db, s), v in card.items()}))


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


def _host_worker(conn, src: str, job: str, threads: int) -> None:
    """Child process: the host job ``job`` (``"scalar"``,
    :func:`scalar_counts` on the CPU, or ``"small"``,
    :func:`small_scale_host`), sent back as ``("ok", result)`` or
    ``("error", traceback)``.  Both read host data alone, so the child
    never touches the card."""
    import traceback
    try:
        sys.path.insert(0, src)
        import torch
        torch.set_num_threads(threads)
        import repro_torch.core as T
        if job == "scalar":
            conn.send(("ok", scalar_counts(T, "cpu")))
        else:
            conn.send(("ok", small_scale_host(T)))
    except Exception:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


def start_host_job(src: Path, job: str, threads: int = 1):
    """Start :func:`_host_worker` on ``job`` in a child process (host-bound
    work for minutes, run beside the card paths); returns ``(process,
    receiving end)``."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=_host_worker,
                       args=(send, str(src), job, threads), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def host_result(worker, what: str):
    """Wait for the result of ``worker`` (:func:`start_host_job`); fails
    if it died or raised."""
    proc, recv = worker
    try:
        status, out = recv.recv()
    except EOFError:
        proc.join()
        raise SmokeFailure(f"the worker of {what} died with exit code "
                           f"{proc.exitcode}") from None
    proc.join()
    need(status == "ok", f"{what} failed:\n{out}")
    return out


def scalar_oracles(T, worker, device: str = "cuda") -> None:
    """The scalar oracles on Table 6's ca-GrQc: the worker's
    ``lftj_ref`` and ``minesweeper_ref`` counts of the cyclic shapes (held
    to the records there), and the 3-clique's rows from ``lftj_ref``,
    ``minesweeper_ref``, ``binary`` and ``vlftj`` on ``device`` as
    identical arrays."""
    from repro_torch.core import engine as E
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    counts = host_result(worker, "the scalar oracle counts")
    waited = time.perf_counter() - t0
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
    counts from ``worker``, :func:`start_host_job`) and the verifier
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


#: the ``serve`` phase: the query server on the soc-Slashdot CSR at these
#: selectivities (seed 0), the 4-cycle scheduled in 50-500 quanta of
#: ``SERVE_QUANTA`` target beside four small 3-cliques, and ``limit=``
#: pages of the 3-path at the second selectivity
SERVE_SELECTIVITIES = (8.0, 80.0)
SERVE_QUANTA = 200
#: the parked-state quota of the scheduled 4-cycle: its penultimate
#: frontier at this scale is far above the default 64 MiB quota, which
#: would fail the job with a 429-style result at its first parking
SERVE_PARK_BYTES = 4 << 30
SERVE_PAGE_ROWS, SERVE_PAGES = 20_000, 5
#: ``benchmarks/bench_serve.py``'s quick workload (the JAX package's
#: ``BENCH_serve.json``): one heavy full-graph 3-path enumeration and 16
#: small 3-path counts on ``powerlaw_cluster(800, 5, seed=0)``
BENCH_SERVE = "BENCH_serve.json"
SERVE_BENCH_GRAPH = (800, 5, 0)
SERVE_BENCH_QUANTUM, SERVE_BENCH_SMALL, SERVE_BENCH_PAGE = 4096, 16, 2048
#: the record's fields that depend only on the host (row meters and the
#: rows-expanded virtual clock); its walls are a TPU run's, never compared
SERVE_BENCH_EXACT = ("heavy_rows_expanded", "heavy_quanta",
                     "heavy_preemptions", "total_rows_expanded",
                     "small_p50_vclock", "small_p99_vclock")


class ServedLaunches:
    """Kernel launches of the served calls alone: :meth:`window` sets the
    counters to 0 just before a served call and adds them up just after,
    so the direct counts and other references between windows are left
    out."""

    def __init__(self):
        from repro_torch.kernels import build
        self.build = build
        self.total = dict.fromkeys(build.LAUNCHES, 0)

    @contextlib.contextmanager
    def window(self):
        self.build.reset_launches()
        yield
        for k, n in self.build.LAUNCHES.items():
            self.total[k] += n


def serve_at_scale(T, g, served: ServedLaunches):
    """``execute_many`` of the six shapes at both selectivities, twice
    (the second pass all plan-cache hits), each count held to a direct
    ``count`` with the result's engine on the server's warmed db.  Returns
    the server and the counts."""
    import torch
    from repro_torch.serve import QueryRequest, QueryServer
    server = QueryServer(g, device="cuda")
    reqs = [QueryRequest(shape, selectivity=sel, seed=0)
            for sel in SERVE_SELECTIVITIES for shape in SHAPES]
    counts = {}
    for rnd in (1, 2):
        t0 = time.perf_counter()
        with served.window():
            results = server.execute_many(reqs)
        wall = time.perf_counter() - t0
        for r in results:
            key = (r.request.query_name, r.request.selectivity)
            need(r.plan_cached == (rnd == 2),
                 f"serve round {rnd} {key}: plan_cached {r.plan_cached}")
            if rnd == 1:
                counts[key] = (r.count, r.engine)
            else:
                need((r.count, r.engine) == counts[key],
                     f"serve {key}: round 2 {r.count} != {counts[key]}")
            log(json.dumps(dict(
                serve=rnd, shape=key[0], selectivity=key[1],
                engine=r.engine, count=r.count, latency_s=r.latency_s,
                plan_cached=r.plan_cached,
                kernel_dispatches=r.stats["engine"]["kernel_dispatches"])))
        log(json.dumps(dict(serve_round=rnd, wall_s=wall,
                            plan_cache=server.plan_cache_info())))
    t0 = time.perf_counter()
    for (shape, sel), (n, engine) in counts.items():
        direct = T.count(T.get_query(shape), server._gdb_for(sel, 0),
                         engine=engine)
        need(direct == n, f"serve {shape} sel {sel}: {n} != direct "
             f"{engine} count {direct}")
    torch.cuda.synchronize()
    log(f"serve direct counts: {time.perf_counter() - t0:.2f} s, all equal")
    return server, counts


def serve_preemption(T, g, server, counts, served: ServedLaunches) -> dict:
    """The 4-cycle through ``execute_concurrent`` beside four small
    3-cliques: first in ``fifo`` (unpreempted, the wall to compare), then
    with a quantum that cuts it into ~``SERVE_QUANTA`` quanta; then a
    snapshot taken halfway, round-tripped through bytes and resumed on a
    fresh scheduler of a fresh server."""
    from repro_torch.serve import (PlanSnapshot, QuantumScheduler,
                                   QueryRequest, QueryServer, TenantQuota)
    sel = SERVE_SELECTIVITIES[0]
    quota = TenantQuota(max_frontier_bytes=SERVE_PARK_BYTES)
    want = counts["4-cycle", sel][0]
    smalls = [QueryRequest("3-clique", engine="vlftj",
                           selectivity=SERVE_SELECTIVITIES[1], seed=s)
              for s in range(4)]
    small_want = [T.count(T.get_query("3-clique"), server._gdb_for(
        SERVE_SELECTIVITIES[1], s), engine="vlftj") for s in range(4)]
    heavy = QueryRequest("4-cycle", engine="vlftj", selectivity=sel)
    out = {}
    quantum = None
    for policy in ("fifo", "quantum"):
        if policy == "quantum":
            quantum = max(64, out["fifo"]["rows_expanded"] // SERVE_QUANTA)
        t0 = time.perf_counter()
        with served.window():
            res = server.execute_concurrent(
                [heavy] + smalls, policy=policy,
                quantum_rows=quantum or SERVE_BENCH_QUANTUM,
                quotas={heavy.tenant: quota})
        wall = time.perf_counter() - t0
        need(all(r.engine != "rejected" for r in res),
             f"scheduled ({policy}): {[r.stats.get('error') for r in res]}")
        need(res[0].count == want, f"scheduled 4-cycle ({policy}): "
             f"{res[0].count} != {want}")
        need([r.count for r in res[1:]] == small_want,
             f"scheduled 3-cliques ({policy}): {[r.count for r in res[1:]]}"
             f" != {small_want}")
        st = res[0].stats
        out[policy] = dict(wall_s=wall, quanta=st["quanta"],
                           preemptions=st["preemptions"],
                           rows_expanded=st["rows_expanded"],
                           small_vclock_done=[r.stats["vclock_done"]
                                              for r in res[1:]],
                           heavy_vclock_done=st["vclock_done"])
    need(50 <= out["quantum"]["quanta"] <= 500,
         f"the 4-cycle ran in {out['quantum']['quanta']} quanta, not 50-500")
    need(out["quantum"]["rows_expanded"] == out["fifo"]["rows_expanded"],
         "preemption changed the rows expanded")
    # a snapshot taken halfway, through bytes, resumed elsewhere
    sched = QuantumScheduler(server, quantum_rows=quantum,
                             default_quota=quota)
    token = sched.submit(heavy)
    with served.window():
        while sched.stats["quanta"] < out["quantum"]["quanta"] // 2:
            need(sched.step(),
                 "the 4-cycle finished before its halfway point")
    snap = server._cursors[token][0]
    need(isinstance(snap, PlanSnapshot), f"parked {type(snap).__name__}")
    wire = snap.to_bytes()
    back = PlanSnapshot.from_bytes(wire)
    # the resumed run advances the snapshot in place: describe it first
    out["snapshot"] = dict(phase=back.phase, level=back.start_level,
                           frontier_rows=int(back.frontier.shape[0]),
                           offset=back.offset, bytes=len(wire))
    fresh = QueryServer(g, device="cuda")
    resumed = QuantumScheduler(fresh, quantum_rows=quantum,
                               default_quota=quota)
    tok = resumed.submit(heavy)
    job = resumed._jobs[0]
    fresh._register_cursor(back, job.label, job.plan, token=tok)
    t0 = time.perf_counter()
    with served.window():
        (res,) = resumed.run()
    need(res.count == want,
         f"snapshot resume: {res.count} != {want}")
    out["snapshot"].update(resume_quanta=res.stats["quanta"],
                           resume_wall_s=time.perf_counter() - t0)
    out["quantum_rows"] = quantum
    out["overhead"] = out["quantum"]["wall_s"] / out["fifo"]["wall_s"]
    log(json.dumps({"serve_preemption": out}))
    return out


def serve_rows(T, server, served: ServedLaunches) -> None:
    """A ``limit=`` 3-path request and its ``next_cursor`` continuations:
    ``SERVE_PAGES`` full pages that, concatenated, equal
    ``enumerate(..., limit=)`` row for row."""
    from repro_torch.core import engine as E
    from repro_torch.serve import QueryRequest
    q = T.get_query("3-path")
    sel = SERVE_SELECTIVITIES[1]
    total = T.count(q, server._gdb_for(sel, 0))
    need(total > SERVE_PAGES * SERVE_PAGE_ROWS,
         f"3-path count {total} at sel {sel}: fewer than "
         f"{SERVE_PAGES} pages")
    t0 = time.perf_counter()
    with served.window():
        first = server.execute(QueryRequest("3-path", engine="vlftj",
                                            selectivity=sel,
                                            limit=SERVE_PAGE_ROWS))
        pages, tok, lat = [first.rows], first.next_cursor, [first.latency_s]
        while tok is not None and len(pages) < SERVE_PAGES:
            nxt = server.execute(QueryRequest("3-path", cursor=tok,
                                              limit=SERVE_PAGE_ROWS))
            pages.append(nxt.rows)
            lat.append(nxt.latency_s)
            tok = nxt.next_cursor
    need([p.shape[0] for p in pages] == [SERVE_PAGE_ROWS] * SERVE_PAGES,
         f"3-path pages {[p.shape[0] for p in pages]}")
    rows = np.concatenate(pages)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = E.enumerate(q, server._gdb_for(sel, 0), plan=first.plan,
                       order=first.row_vars, limit=rows.shape[0]).rows
    need(np.array_equal(rows, want), "served 3-path pages != enumerate")
    log(json.dumps(dict(serve_rows="3-path", selectivity=sel, count=total,
                        pages=[int(p.shape[0]) for p in pages],
                        page_latency_s=lat, wall_s=wall,
                        enumerate_s=time.perf_counter() - t0,
                        open_cursors=server.cursor_info())))


def serve_bench_record(T) -> dict:
    """``benchmarks/bench_serve.py``'s quick workload with the port, both
    policies, every deterministic field held to ``BENCH_serve.json``
    exactly; the walls are printed beside the record's, not compared.
    Returns the launches of its two scheduler runs."""
    from repro_torch.graphs import powerlaw_cluster
    from repro_torch.serve import (QuantumScheduler, QueryRequest,
                                   QueryServer, TenantQuota)
    record = json.loads((Path(__file__).resolve().parent
                         / BENCH_SERVE).read_text())["policies"]
    n, m, seed = SERVE_BENCH_GRAPH
    csr = powerlaw_cluster(n, m, seed=seed)
    got, launches = {}, ServedLaunches()
    for policy in ("fifo", "quantum"):
        server = QueryServer(csr, page_rows=SERVE_BENCH_PAGE, device="cuda")
        sched = QuantumScheduler(
            server, quantum_rows=SERVE_BENCH_QUANTUM, policy=policy,
            default_quota=TenantQuota(max_in_flight=SERVE_BENCH_SMALL + 1))
        reqs = [QueryRequest("3-path", engine="vlftj", limit=10**9,
                             selectivity=1.0)]
        reqs += [QueryRequest("3-path", engine="vlftj", seed=i % 4)
                 for i in range(SERVE_BENCH_SMALL)]
        t0 = time.time()
        with launches.window():
            for req in reqs:
                sched.submit(req, collect_rows=req.limit is None)
            results = sched.run()
        wall_s = time.time() - t0
        heavy, smalls = results[0], results[1:]
        vlat = np.array([r.stats["vclock_done"] - r.stats["vclock_submit"]
                         for r in smalls], dtype=np.int64)
        wlat = np.array([r.latency_s for r in smalls])
        total = sum(r.stats["rows_expanded"] for r in results)
        g = {"small_p50_vclock": int(np.percentile(vlat, 50)),
             "small_p99_vclock": int(np.percentile(vlat, 99)),
             "heavy_rows_expanded": heavy.stats["rows_expanded"],
             "heavy_quanta": heavy.stats["quanta"],
             "heavy_preemptions": heavy.stats["preemptions"],
             "total_rows_expanded": total}
        for k in SERVE_BENCH_EXACT:
            need(g[k] == record[policy][k], f"BENCH_serve {policy} {k}: "
                 f"{g[k]} != recorded {record[policy][k]}")
        got[policy] = dict(
            g, wall_s=wall_s,
            small_p99_wall_us=float(np.percentile(wlat, 99) * 1e6),
            recorded_wall_s=record[policy]["wall_s"],
            recorded_small_p99_wall_us=record[policy]["small_p99_wall_us"])
    log(json.dumps({"serve_bench": got, "launches": launches.total}))
    return launches.total


def serve_observability(T, server) -> None:
    """One traced and profiled request; profile on against off; the
    profile against the static census; EXPLAIN ANALYZE; the metrics
    snapshot; profiles in two threads at once."""
    import threading
    from repro_torch.analysis import audit_recompilation, check_runtime
    from repro_torch.kernels import build
    from repro_torch.obs import DeviceProfile, explain_analyze
    from repro_torch.serve import QueryRequest
    sel = SERVE_SELECTIVITIES[0]
    req = dict(query_name="3-clique", engine="vlftj", selectivity=sel)
    runs = {}
    for on in (False, True, False):
        build.reset_launches()
        res = server.execute(QueryRequest(**req, trace=on, profile=on))
        runs.setdefault(on, []).append(
            (res, dict(build.LAUNCHES)))
    off, on = runs[False][0], runs[True][0]
    meters = ("chunks", "ll_calls", "candidates", "rows_expanded")
    for res, launches in runs[False] + runs[True]:
        need(res.count == off[0].count, "profile changed the count")
        need(launches == off[1], f"profile changed the launches: "
             f"{launches} != {off[1]}")
        need({k: res.stats["engine"]["raw"][k] for k in meters}
             == {k: off[0].stats["engine"]["raw"][k] for k in meters},
             "profile changed the engine meters")
    res = on[0]
    tr, prof = res.trace, res.profile
    for lv in range(len(res.plan.gao)):
        rec = tr.levels.get(lv, {})
        need(rec.get("est_rows") is not None
             and rec.get("obs_rows") is not None,
             f"trace level {lv}: {rec}")
    span = [s for s in tr.spans if s["name"] == "profile/kernel/intersect"]
    need(len(span) == 1, f"profile spans {[s['name'] for s in tr.spans]}")
    kernel_s = prof.kernel_wall_s("intersect")
    need(0 < kernel_s <= res.latency_s,
         f"event-timed kernel wall {kernel_s} s not in (0, "
         f"{res.latency_s}]")
    need(prof.memory["device_peak_bytes"] is not None,
         "no device peak bytes on the card")
    gdb = server._gdb_for(sel, 0)
    audit = audit_recompilation(res.plan, T.GraphStats.of(gdb))
    finding = check_runtime(audit, prof)
    need(finding is None, f"check_runtime: {finding}")
    ex = explain_analyze(T.get_query("3-clique"), gdb, engine="vlftj")
    need(ex.count == res.count, "explain_analyze count")
    log(ex.render())
    snap = server.metrics()
    json.dumps(snap)
    # two threads profiling at once: each profile sees its own calls
    plan = res.plan
    solo = prof.jit["calls"]
    got, barrier = {}, threading.Barrier(2)

    def work(i):
        p = DeviceProfile(f"thread-{i}")
        barrier.wait(timeout=60)
        with p.activate():
            n, _ = T.execute_stats(plan, gdb)
        got[i] = (n, p.jit["calls"], p.kernel_wall_s("intersect"))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    need(not any(th.is_alive() for th in threads), "a thread hung")
    for i in range(2):
        need(got.get(i, (None,))[:2] == (res.count, solo),
             f"thread {i}: {got.get(i)} != ({res.count}, {solo})")
        need(got[i][2] > 0, f"thread {i}: no kernel wall")
    log(json.dumps(dict(
        serve_observability="3-clique", selectivity=sel, count=res.count,
        latency_s=res.latency_s, profile=prof.to_dict(),
        trace_levels=[tr.levels[lv] for lv in sorted(tr.levels)],
        max_q_error=tr.max_q_error, census_total=audit.total,
        metrics_series=len(snap), threads=got,
        profile_off_latency_s=[r.latency_s for r, _ in runs[False]])))


def serve_phase(T, g) -> tuple:
    """The ``serve`` phase: the query server and its scheduler at
    ``soc-Slashdot0811`` scale, the JAX package's serve record, and the
    observability they report through.  Returns the launches of the
    served calls at scale (each window's counters set to 0 just before
    the call and read just after; the direct counts and ``enumerate``
    they are held to fall outside) and those of the record's workload."""
    served = ServedLaunches()
    t0 = time.perf_counter()
    server, counts = serve_at_scale(T, g, served)
    log(f"serve at scale: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    serve_preemption(T, g, server, counts, served)
    log(f"serve preemption: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    serve_rows(T, server, served)
    log(f"serve rows: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    record = serve_bench_record(T)
    log(f"serve record: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    serve_observability(T, server)
    log(f"serve observability: {time.perf_counter() - t0:.2f} s")
    return served.total, record


#: the ``dist`` phase: the query server's partitioned route on the
#: soc-Slashdot CSR (the threshold lowered to the graph's own edges: no
#: SNAP_LIKE graph reaches the default 4,194,304), ``DIST_WORKERS`` x
#: ``DIST_GRANULARITY`` parts, each routed shape's count on the thread
#: pool, in sequence and unpartitioned.  The lollipops are served with
#: the planner's engine on the same server: the 2-lollipop's vlftj count
#: took ~20 s in sequence and ~94 s on the pool on one H100 80GB HBM3 at
#: 700 W, and the 3-lollipop's vlftj plan materializes a ~744 M-row
#: frontier.  The shapes of ``DIST_HOST_HELD`` are held against their
#: host count (``host_walks``) in place of the sequence's and the
#: unpartitioned engine's reruns: the 3-path's three runs took ~55 s (75
#: s on a slower host), more than the script's time allows beside the
#: ``arch mesh`` step
DIST_SELECTIVITY = 8.0
DIST_WORKERS, DIST_GRANULARITY = 4, 2
DIST_ROUTED = ("3-clique", "4-clique", "4-cycle", "3-path")
DIST_HOST_HELD = ("3-path",)
DIST_PLANNED = ("2-lollipop", "3-lollipop")
#: ``benchmarks/bench_dist.py``'s quick workloads (the JAX package's
#: ``BENCH_dist.json``): the triangle level of ``powerlaw_cluster(1200,
#: 6, seed=0)`` padded to the record's 8 devices; the Zipf 3-path skew
#: rows (``zipf_graph(8000, 200000, alpha=1.4, seed=0)``, samples at
#: selectivity 150, 16 shards, threshold 1.2); the sharded-CSR rows
#: (``powerlaw_cluster(300, 4, seed=11)``, samples at selectivity 6, 8
#: shards, a fresh ``ShardedGraphDB`` per shape)
BENCH_DIST = "BENCH_dist.json"
DIST_JOIN_GRAPH, DIST_JOIN_PAD = (1200, 6, 0), 8
DIST_SKEW_GRAPH, DIST_SKEW_SEL = (8000, 200000, 1.4, 0), 150
DIST_SKEW_SHARDS, DIST_SKEW_THRESHOLD = 16, 1.2
DIST_CSR_GRAPH, DIST_CSR_SEL, DIST_CSR_SHARDS = (300, 4, 11), 6, 8
#: the record's fields that depend only on the data (its ``us_per_call``,
#: ``rows_per_s``, ``makespan_ratio`` and ``total_time_us`` are a TPU or
#: CPU run's walls, never compared)
DIST_EXACT = {"join": ("rows", "triangles"),
              "skew": ("count", "shards", "cost_makespan", "rebalances",
                       "cost_ratio"),
              "sharded_csr": ("count", "match", "shards",
                              "exchanged_values")}


def dist_route(T, g) -> dict:
    """The server's partitioned route at scale: each routed shape's count
    through ``QueryServer(..., dist_edge_threshold=g.n_edges)`` (the
    thread pool), then the same parts in sequence and the unpartitioned
    engine, all equal (those of ``DIST_HOST_HELD`` equal to their host
    count instead); the lollipops through the planner's engine on the
    same server; 3-path pages through the route
    against ``enumerate(limit=)``.  Returns the launches of the routed
    calls alone."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.dist import PartitionedJoin
    from repro_torch.serve import QueryRequest, QueryServer
    server = QueryServer(g, device="cuda", dist_edge_threshold=g.n_edges,
                         dist_workers=DIST_WORKERS,
                         dist_granularity=DIST_GRANULARITY)
    routed = ServedLaunches()
    gdb = server._gdb_for(DIST_SELECTIVITY, 0)
    for shape in DIST_ROUTED:
        q = T.get_query(shape)
        t0 = time.perf_counter()
        with routed.window():
            res = server.execute(QueryRequest(
                shape, engine="vlftj", selectivity=DIST_SELECTIVITY))
        routed_s = time.perf_counter() - t0
        # the window zeroed the counters just before this call
        launched = routed.build.LAUNCHES["searchsorted_segments"]
        st = server.last_dist_stats
        need(res.engine == "vlftj+partitioned",
             f"dist {shape}: served by {res.engine}")
        need(st["parts"] == DIST_WORKERS * DIST_GRANULARITY
             and st["backend"] == "thread", f"dist {shape}: {st['parts']} "
             f"parts on {st['backend']}")
        need(st["makespan"] <= st["total_time"] + 1e-9,
             f"dist {shape}: makespan {st['makespan']} > total "
             f"{st['total_time']}")
        thread = dict(wall_s=st["wall_time"], makespan_s=st["makespan"],
                      total_s=st["total_time"],
                      part_counts=st["part_counts"])
        if shape in DIST_HOST_HELD:
            _, v2, _, w3 = host_walks(gdb)
            host = int(v2 @ w3)
            need(res.count == host, f"dist {shape}: routed {res.count}, "
                 f"host {host}")
            log(json.dumps(dict(
                dist_route=shape, selectivity=DIST_SELECTIVITY,
                count=res.count, host_count=host, engine=res.engine,
                request_s=routed_s, searchsorted_launches=launched,
                thread=thread)))
            continue
        seq = PartitionedJoin(q, gdb, n_workers=DIST_WORKERS,
                              granularity=DIST_GRANULARITY, plan=res.plan,
                              backend="sequential")
        n_seq = seq.count()
        t0 = time.perf_counter()
        direct = T.count(q, gdb, engine="vlftj")
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        need(res.count == n_seq == direct, f"dist {shape}: routed "
             f"{res.count}, sequential {n_seq}, direct {direct}")
        need(seq.stats["part_counts"] == st["part_counts"],
             f"dist {shape}: part counts differ between the pool and "
             "the sequence")
        log(json.dumps(dict(
            dist_route=shape, selectivity=DIST_SELECTIVITY, count=res.count,
            engine=res.engine, request_s=routed_s,
            searchsorted_launches=launched, thread=thread,
            sequential=dict(wall_s=seq.stats["wall_time"],
                            total_s=seq.stats["total_time"]),
            unpartitioned_s=direct_s,
            thread_over_sequential=st["wall_time"]
            / seq.stats["wall_time"])))
    for shape in DIST_PLANNED:
        res = server.execute(QueryRequest(shape,
                                          selectivity=DIST_SELECTIVITY))
        direct = T.count(T.get_query(shape), gdb, engine=res.engine)
        need(res.engine != "vlftj" and res.count == direct,
             f"dist {shape}: {res.engine} {res.count} != direct {direct}")
        log(json.dumps(dict(dist_route=shape, engine=res.engine,
                            count=res.count, latency_s=res.latency_s)))
    # pages of the 3-path through the route
    sel = SERVE_SELECTIVITIES[1]
    q = T.get_query("3-path")
    t0 = time.perf_counter()
    with routed.window():
        first = server.execute(QueryRequest(
            "3-path", engine="vlftj", selectivity=sel,
            limit=SERVE_PAGE_ROWS))
        pages, tok = [first.rows], first.next_cursor
        while tok is not None and len(pages) < SERVE_PAGES:
            nxt = server.execute(QueryRequest("3-path", cursor=tok,
                                              limit=SERVE_PAGE_ROWS))
            pages.append(nxt.rows)
            tok = nxt.next_cursor
    wall = time.perf_counter() - t0
    need(first.engine == "vlftj+partitioned",
         f"dist 3-path pages served by {first.engine}")
    need([p.shape[0] for p in pages] == [SERVE_PAGE_ROWS] * SERVE_PAGES,
         f"dist 3-path pages {[p.shape[0] for p in pages]}")
    rows = np.concatenate(pages)
    want = E.enumerate(q, server._gdb_for(sel, 0), plan=first.plan,
                       order=first.row_vars, limit=rows.shape[0]).rows
    need(np.array_equal(rows, want), "dist 3-path pages != enumerate")
    log(json.dumps(dict(dist_rows="3-path", selectivity=sel,
                        pages=[int(p.shape[0]) for p in pages],
                        wall_s=wall)))
    # a dead worker: its parts re-dealt, its time 0
    plan = server._plan_for(QueryRequest("4-cycle", engine="vlftj"),
                            gdb)[0]
    want = T.count(T.get_query("4-cycle"), gdb, engine="vlftj")
    pj = PartitionedJoin(T.get_query("4-cycle"), gdb,
                         n_workers=DIST_WORKERS,
                         granularity=DIST_GRANULARITY, plan=plan, dead={2})
    got = pj.count()
    need(got == want and pj.stats["worker_time"][2] == 0.0
         and 2 not in pj.schedule,
         f"dead worker: {got} != {want} or worker 2 ran "
         f"({pj.stats['worker_time']})")
    log(json.dumps(dict(dist_dead_worker="4-cycle", count=got,
                        worker_time=pj.stats["worker_time"],
                        wall_s=pj.stats["wall_time"])))
    return routed.total


def dist_record() -> dict:
    """``BENCH_dist.json``'s deterministic fields, by row name."""
    rows = json.loads((Path(__file__).resolve().parent
                       / BENCH_DIST).read_text())["rows"]
    out = {}
    for row in rows:
        kind = row["name"].split("/")[0]
        if kind in DIST_EXACT:
            fields = dict(kv.split("=") for kv in row["derived"].split(";"))
            out[row["name"]] = {k: fields[k] for k in DIST_EXACT[kind]
                                if k in fields}
    return out


def hold(record: dict, name: str, got: dict) -> None:
    """Each field of ``got`` (formatted as the record formats it) equal
    to the record's row ``name``."""
    want = record[name]
    need(set(got) == set(want), f"BENCH_dist {name}: fields {sorted(got)} "
         f"!= {sorted(want)}")
    for k, v in got.items():
        need(str(v) == want[k], f"BENCH_dist {name} {k}: {v} != recorded "
             f"{want[k]}")


def dist_bench(T, group) -> dict:
    """Every deterministic field of ``BENCH_dist.json``'s join, skew and
    sharded-CSR rows, held exactly: ``spmd_join_step`` on the card at
    world size 1, ``AdaptiveJoin`` on the card, ``ShardedGraphDB`` /
    ``sharded_count`` on the host (held against ``vlftj`` on the card).
    Returns the walls beside the record's."""
    import torch
    from repro_torch.dist import (AdaptiveJoin, ShardedGraphDB,
                                  sharded_count, spmd_join_step)
    from repro_torch.graphs import node_sample, powerlaw_cluster, zipf_graph
    record = dist_record()
    out = {}
    # join/<n>shard: the record pads the frontier to its 8 devices
    n, m, seed = DIST_JOIN_GRAPH
    g = powerlaw_cluster(n, m, seed=seed)
    db = T.GraphDB(g, {}, device="cuda")
    ea = g.edge_array()
    fr = ea[ea[:, 0] < ea[:, 1]].astype(np.int32)
    pad = (-fr.shape[0]) % DIST_JOIN_PAD
    mult = np.concatenate([np.ones(fr.shape[0], np.int64),
                           np.zeros(pad, np.int64)])
    fr = np.concatenate([fr, np.zeros((pad, 2), np.int32)])
    width, _ = T.executor_geometry(db.max_degree)
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
              width=width, n_iter=db.bsearch_iters, needs_degree=False)
    step = spmd_join_step(group, kw)
    t0 = time.perf_counter()
    tri = int(step(db.dev("indptr"), db.dev("indices"), fr, mult))
    join_s = time.perf_counter() - t0
    need(tri == T.VLFTJ(T.get_query("3-clique"), db).count(),
         f"join: spmd {tri} != vlftj")
    for name in ("join/1shard", "join/8shard"):
        hold(record, name, {"rows": fr.shape[0], "triangles": tri})
    out["join"] = dict(rows=int(fr.shape[0]), triangles=tri, wall_s=join_s)
    # skew/static and skew/rebalanced
    n, m, alpha, seed = DIST_SKEW_GRAPH
    g = zipf_graph(n, m, alpha=alpha, seed=seed)
    unary = {f"v{i}": node_sample(g.n_nodes, DIST_SKEW_SEL, seed=i)
             for i in range(1, 5)}
    db = T.GraphDB(g, unary, device="cuda")
    q = T.get_query("3-path")
    runs = {}
    for label, rebalance in (("static", False), ("rebalanced", True)):
        aj = AdaptiveJoin(q, db, n_shards=DIST_SKEW_SHARDS,
                          threshold=DIST_SKEW_THRESHOLD, rebalance=rebalance)
        t0 = time.perf_counter()
        c = aj.count()
        runs[label] = (c, aj.stats, time.perf_counter() - t0)
    cost_ratio = (runs["rebalanced"][1]["cost_makespan"]
                  / max(runs["static"][1]["cost_makespan"], 1e-12))
    for label, (c, st, wall) in runs.items():
        got = {"count": c, "shards": DIST_SKEW_SHARDS,
               "cost_makespan": f"{st['cost_makespan']:.0f}",
               "rebalances": len(st["rebalances"])}
        if label == "rebalanced":
            got["cost_ratio"] = f"{cost_ratio:.3f}"
        hold(record, f"skew/{label}", got)
        out[f"skew/{label}"] = dict(got, makespan_s=st["makespan"],
                                    total_s=st["total_time"], wall_s=wall)
    # sharded_csr/<shape>
    n, m, seed = DIST_CSR_GRAPH
    g = powerlaw_cluster(n, m, seed=seed)
    unary = {f"v{i}": node_sample(g.n_nodes, DIST_CSR_SEL, seed=i)
             for i in range(1, 5)}
    db = T.GraphDB(g, unary, device="cuda")
    for shape in SHAPES:
        sg = ShardedGraphDB(g, DIST_CSR_SHARDS, unary)
        t0 = time.perf_counter()
        got = sharded_count(T.get_query(shape), sg)
        wall = time.perf_counter() - t0
        ref = T.count(T.get_query(shape), db, engine="vlftj")
        fields = {"count": got, "match": int(got == ref),
                  "shards": DIST_CSR_SHARDS,
                  "exchanged_values": sg.exchange["values"]}
        hold(record, f"sharded_csr/{shape}", fields)
        out[f"sharded_csr/{shape}"] = dict(fields, wall_s=wall)
    torch.cuda.synchronize()
    log(json.dumps({"dist_bench": out}))
    return out


def dist_spmd(T, g, db, group) -> dict:
    """The SPMD steps at soc-Slashdot0811 scale at world size 1 over
    NCCL: the triangle level (every edge with a < b) replicated, with a
    ``FrontierRebalancer`` as the plan's callback, and over a 1-shard
    ``ShardedGraphDB``, each equal to the 3-clique count; the SpMV
    against ``index_add_`` over the whole edge list.  Returns the
    launches of the three join steps."""
    import torch
    from repro_torch.dist import (FrontierRebalancer, ShardedGraphDB,
                                  spmd_join_step, spmd_sharded_join_step,
                                  spmd_spmv_step)
    q = T.get_query("3-clique")
    want = T.count(q, db)
    ea = g.edge_array()
    fr = ea[ea[:, 0] < ea[:, 1]].astype(np.int32)
    mult = np.ones(fr.shape[0], np.int64)
    width, chunk = T.executor_geometry(db.max_degree)
    kw = dict(probe_cols=(0, 1), n_unary=0, lower_cols=(1,), upper_cols=(),
              width=width, n_iter=db.bsearch_iters, needs_degree=False)
    # the rebalancer prices the plan's last level by its probe columns
    # (the filter direction does not enter the cost)
    plan = T.plan_query(q, T.GraphStats.of(db), engine="vlftj")
    need(plan.levels[2].edge_sources == (0, 1),
         f"3-clique's last level {plan.levels[2]}")
    launches = ServedLaunches()
    out = dict(rows=int(fr.shape[0]), width=width, chunk_rows=chunk,
               count=want)
    args = (db.dev("indptr"), db.dev("indices"), fr, mult)
    t0 = time.perf_counter()
    with launches.window():
        got = int(spmd_join_step(group, kw)(*args))
    out["replicated_s"] = time.perf_counter() - t0
    need(got == want, f"spmd_join_step {got} != 3-clique {want}")
    reb = FrontierRebalancer(plan, n_shards=8, degrees=g.degrees,
                             threshold=1.01)
    t0 = time.perf_counter()
    with launches.window():
        got = int(spmd_join_step(group, kw, plan=plan.with_level_callback(
            reb))(*args))
    out["rebalanced_s"] = time.perf_counter() - t0
    need(got == want and reb.events,
         f"rebalanced spmd_join_step {got} != {want} ({reb.events})")
    out["rebalance"] = reb.events[0]
    sgdb = ShardedGraphDB(g, 1)
    t0 = time.perf_counter()
    with launches.window():
        got = spmd_sharded_join_step(group, kw, sgdb)(fr, mult)
    out["sharded_s"] = time.perf_counter() - t0
    need(got == want, f"spmd_sharded_join_step {got} != {want}")
    idx, sid = db.dev("indices"), db.dev("src_ids")
    c = torch.arange(g.n_nodes, dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    y = spmd_spmv_step(group, g.n_nodes)(idx, sid, c)
    torch.cuda.synchronize()
    out["spmv_s"] = time.perf_counter() - t0
    oracle = torch.zeros(g.n_nodes, dtype=torch.int64, device="cuda")
    oracle.index_add_(0, sid.long(), c[idx.long()])
    need(torch.equal(y, oracle), "spmd_spmv_step != index_add_")
    out["launches"] = launches.total
    log(json.dumps({"dist_spmd": out}))
    return launches.total


def dist_phase(T, g, db) -> dict:
    """The ``dist`` phase: the server's partitioned route at scale, a dead
    worker, ``BENCH_dist.json``'s deterministic fields, and the SPMD
    steps over a world-size-1 NCCL group (an in-memory store, no
    network), destroyed at the end.  Returns the launches of the routed
    calls and of the SPMD join steps."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    routed = dist_route(T, g)
    log(f"dist route: {time.perf_counter() - t0:.2f} s, launches of the "
        f"routed calls {routed}")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        t0 = time.perf_counter()
        dist_bench(T, group)
        log(f"dist record: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        spmd = dist_spmd(T, g, db, group)
        log(f"dist spmd: {time.perf_counter() - t0:.2f} s")
    finally:
        dist.destroy_process_group()
    return {"routed": routed, "spmd": spmd}


def main(argv=None) -> int:
    import argparse
    import torch
    started = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run, of "
                         f"{', '.join(PHASES)}, or oracles, the last part "
                         "of join alone (default: all; the kernels "
                         "line and the last line come only from a run of "
                         "all); lm serves the two dense and the two MoE "
                         "models, checks their parity, holds the bf16 "
                         "MoE FFN against float32 and runs moe_ffn over "
                         "NCCL; train trains stablelm-3b at full width "
                         "and depth and runs the resume, parity, bf16 "
                         "gradient and compressed-step checks; gnn trains "
                         "GatedGCN, PNA, EGNN and MACE at the launcher's "
                         "scale and runs their parity, shape and WCOJ "
                         "feature checks; arch runs every registry smoke, "
                         "trains and serves xDeepFM at full width, serves "
                         "command-r-plus-104b cut to 8 layers, drives "
                         "both launchers and sets two cells' dry-run "
                         "bounds beside their measured steps")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES + ("oracles", "flash_bwd")):
        ap.error(f"--phases takes {', '.join(PHASES)}, oracles (the last "
                 "part of join alone) or flash_bwd (the flash backward's "
                 "part of kernels alone)")
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
    workers = {}
    if "join" in phases or "oracles" in phases:
        workers["scalar"] = start_host_job(src, "scalar")
    if "join" in phases:
        workers["small"] = start_host_job(src, "small", threads=2)
    try:
        return run_phases(T, phases, smi, workers, started)
    finally:
        for proc, _ in workers.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()


def run_phases(T, phases, smi: str, workers: dict, started: float) -> int:
    """The phases of ``main``, in order; ``workers`` compute the scalar
    oracles' counts and the small-scale CPU enumerations beside them;
    ``started`` is the script's start on the host clock."""
    import torch
    from repro_torch.configs import (CHATGLM3_6B, GRANITE_MOE_3B_A800M,
                                     MOONSHOT_V1_16B_A3B, STABLELM_3B)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s "
        f"({build.build_info['path']})")
    for line in build.build_info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            log("  ptxas:", line.split("'")[1])  # the mangled kernel name
        elif "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    if {"kernels", "join", "oracles", "serve", "dist"} & set(phases):
        t0 = time.perf_counter()
        g, db, hdb = bench_gdb(T, 1.0, "cuda")
        dbs = {"plain": db, "hybrid": hdb}
        log(f"graph {DATASET}: {g.n_nodes} nodes, {g.indices.shape[0]} "
            f"directed edges, max degree {g.max_degree}, {hdb.n_hubs} hubs "
            f"x {hdb.layout.n_words} words ({time.perf_counter() - t0:.2f} "
            "s)")

    kern = {}
    if "flash_bwd" in phases and "kernels" not in phases:
        for name, k in kernel_phase_flash_bwd().items():
            log(f"kernel {name}: {json.dumps(k)}")
    if "kernels" in phases:
        for phase in (lambda: kernel_phase(T, db, hdb),
                      lambda: kernel_phase_intersect(T, db, hdb),
                      kernel_phase_lm, kernel_phase_flash_bwd,
                      kernel_phase_outer):
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
        small_scale(T, workers["small"])
        log(f"small scale: {time.perf_counter() - t0:.2f} s")
    if "join" in phases or "oracles" in phases:
        t0 = time.perf_counter()
        oracles_phase(T, dbs, workers["scalar"])
        log(f"oracles: {time.perf_counter() - t0:.2f} s")

    if "serve" in phases:
        t0 = time.perf_counter()
        serve_launches, record_launches = serve_phase(T, g)
        log(f"serve: {time.perf_counter() - t0:.2f} s, launches of the "
            f"served calls {serve_launches}, of the record's workload "
            f"{record_launches}")
        for name, n in (("served calls", serve_launches),
                        ("record's workload", record_launches)):
            need(n["searchsorted_segments"] > 0,
                 f"the {name} never launched searchsorted_segments")

    if "dist" in phases:
        t0 = time.perf_counter()
        dist_launches = dist_phase(T, g, db)
        log(f"dist: {time.perf_counter() - t0:.2f} s, launches of the "
            f"routed calls {dist_launches['routed']}, of the SPMD join "
            f"steps {dist_launches['spmd']}")
        for name, n in dist_launches.items():
            need(n["searchsorted_segments"] > 0,
                 f"the {name} calls never launched searchsorted_segments")

    if "lm" in phases:
        # each model's serving path with its own counters, summed
        models = (CHATGLM3_6B, STABLELM_3B, GRANITE_MOE_3B_A800M,
                  MOONSHOT_V1_16B_A3B)
        lm_launches = dict.fromkeys(build.LAUNCHES, 0)
        for cfg in models:
            t0 = time.perf_counter()
            served, _ = lm_serve(cfg)
            log(f"lm serve {cfg.name}: {time.perf_counter() - t0:.2f} s, "
                f"launches {served}")
            for k, n in served.items():
                lm_launches[k] += n
        parity_launches = dict.fromkeys(build.LAUNCHES, 0)
        for cfg in models:
            t0 = time.perf_counter()
            checked = lm_parity(cfg)
            log(f"lm parity {cfg.name}: {time.perf_counter() - t0:.2f} s, "
                f"launches {checked}")
            for k, n in checked.items():
                parity_launches[k] += n
        for cfg in (GRANITE_MOE_3B_A800M, MOONSHOT_V1_16B_A3B):
            t0 = time.perf_counter()
            lm_moe_ffn(cfg)
            log(f"lm moe_ffn {cfg.name}: {time.perf_counter() - t0:.2f} s")

    if "train" in phases:
        t0 = time.perf_counter()
        train_launches = train_phase()
        log(f"train: {time.perf_counter() - t0:.2f} s, launches of the "
            f"main path {train_launches['main']}, of the float32 parity "
            f"steps {train_launches['parity']}, of the elastic runs "
            f"{train_launches['elastic']}")

    if "gnn" in phases:
        t0 = time.perf_counter()
        gnn_launches = gnn_phase(T)
        log(f"gnn: {time.perf_counter() - t0:.2f} s, launches of the WCOJ "
            f"feature enumeration {gnn_launches}")
        need(gnn_launches["searchsorted_segments"] > 0,
             "the WCOJ feature enumeration never launched "
             "searchsorted_segments")

    if "arch" in phases:
        t0 = time.perf_counter()
        arch_launches = arch_phase(
            T, train_launches["steady_step_s"] if "train" in phases
            else None)
        log(f"arch: {time.perf_counter() - t0:.2f} s, launches of the "
            f"registry's smokes {arch_launches['registry']}, of "
            f"command-r's serving path {arch_launches['command_r']}, of "
            f"the training launcher's runs {arch_launches['train']}, of "
            f"the serving launcher's batch {arch_launches['serve']}, of "
            f"chip 0's WCOJ join step on 16x16 "
            f"{arch_launches['mesh_wcoj']}, of chip 0's stablelm-3b train "
            f"steps on 16x16 {arch_launches['mesh_lm']}")
        for path, kernels in (("registry", ("searchsorted_segments",
                                            "flash_attention_mma",
                                            "flash_attention_bwd")),
                              ("command_r", ("flash_attention_tc",)),
                              ("train", ("flash_attention_mma",
                                         "flash_attention_bwd")),
                              ("serve", ("searchsorted_segments",)),
                              ("mesh_wcoj", ("searchsorted_segments",)),
                              ("mesh_lm", ("flash_attention_tc",
                                           "flash_attention_bwd_tc"))):
            for name in kernels:
                need(arch_launches[path][name] > 0,
                     f"the arch phase's {path} path never launched {name}")

    log(f"profiler: windows without device activity after "
        f"{PROFILE_TRIES} tries: {PROFILER_EMPTY}; device_ms windows "
        f"short of launches: {SHORT_WINDOWS}")
    log(f"script: {time.perf_counter() - started:.2f} s")
    if phases != list(PHASES):
        log(f"partial run of {phases}: every check passed")
        return 0
    # each kernel once, with the launches of the path that runs it: the
    # bsearch main path for the first two, the auto path for the tile
    # kernel (the mask form of intersect_count_pallas; its count form is
    # the "kernel intersect_count" line above), the LM serving paths of
    # the four models for the wgmma flash kernel, their f32 parity paths for
    # the mma.sync one (both replace flash_attention_pallas, split by
    # dtype and head dim), the training main path for the tensor-core
    # flash backward and the float32 train steps of (c) for the mma.sync
    # one; no path runs the bitset AND-popcount or the segment outer
    # product, which only the kernel router reaches
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
               ("flash_attention_bwd_tc", "flash_attention_bwd_tc",
                train_launches["main"]["flash_attention_bwd_tc"]),
               ("flash_attention_bwd", "flash_attention_bwd",
                train_launches["parity"]["flash_attention_bwd"]),
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
