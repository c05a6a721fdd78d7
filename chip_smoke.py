"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes
(exact equality) and times both, then drives the main path — ``count``
with ``engine="auto"`` for the six tier-1 graph patterns on the
``soc-Slashdot0811``-like graph (77,360 nodes, 1,778,854 directed edges)
as a plain ``GraphDB`` and as a ``HybridGraphDB`` — and checks its counts:
the cliques, 3-path and lollipops against counts made on the host with
scipy and numpy alone, the shapes whose filters are renumbering invariant
across the two dbs, 3-path and the 2-lollipop against ``engine="vlftj"``
on the same db, and all six at 5% scale against the port's plain CPU
path.  Any failure raises and exits non-zero.

Needs one CUDA device and the rest of the repository; it imports nothing
of JAX.  Prints one JSON line per shape, a ``kernels`` JSON line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.
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
DATASET, SEED, SELECTIVITY = "soc-Slashdot0811", 0, 8.0
SMALL_SCALE = 0.05
#: H100 SXM peaks.  HBM bytes/s from NVIDIA's data sheet.  The data sheet
#: gives no int32 rate: its 67 TFLOP/s fp32 is 132 SMs x 128 FMA lanes x
#: 2 FLOP x 1.98 GHz, and the CUDA C++ Programming Guide's arithmetic
#: throughput table gives compute capability 9.0 64 results per clock
#: per SM for 32-bit integer add, compare, min/max, shift and logic
#: (against 128 for fp32), so int32 ops peak at 67e12 / 4 per second.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4


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


def level_inputs(db, rng, rows: int, hubs_only: bool):
    """One level-step chunk as the engine builds it: ``rows`` random
    directed edges (x, y); candidates are the shorter endpoint's segment
    padded to the executor width, checked against the other endpoint."""
    csr = db.csr
    src = np.repeat(np.arange(csr.n_nodes), csr.degrees)
    eids = np.arange(csr.indices.shape[0])
    if hubs_only:
        eids = eids[(src < db.n_hubs) & (csr.indices < db.n_hubs)]
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


def bound(k: dict) -> dict:
    """The larger of bytes over the HBM rate and int32 ops over the int32
    rate, and which of the two it is."""
    t_bytes = k["bytes"] / PEAK_BYTES_S
    t_ops = k["ops"] / PEAK_INT32_OPS_S
    k["bound_ms"] = 1e3 * max(t_bytes, t_ops)
    k["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return k


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
    out["searchsorted_segments"] = dict(
        source="src/repro_torch/csrc/searchsorted.cu",
        replaces="src/repro/kernels/searchsorted.py:55",
        shape=f"values ({values.shape[0]},) int32, queries ({r}, {w}), "
              f"n_iter {n_iter}",
        max_abs_err=err, found=int(found.sum()),
        ms=cuda_ms(lambda: ops.searchsorted_segments(values, lo, hi, q,
                                                     n_iter), 50),
        plain_ms=cuda_ms(lambda: ref.searchsorted_segments_ref(
            values, lo, hi, q, n_iter), 10),
        values_read=probed, active_rounds=rounds,
        ops_model="10 int32 ops per active round (compare, add, shift, "
                  "2 clamps, compare, and, add, 2 selects) + 5 per lane",
        bytes=4 * probed + lo.nbytes + hi.nbytes + q.nbytes + pos.nbytes
        + found.nbytes,
        ops=10 * rounds + 5 * r * w, library_ms=None)

    # bitset_member_mask: the hub-only rows of a hybrid-db chunk
    cand, check, deg = level_inputs(hdb, rng, 2048, hubs_only=True)
    words = hdb.dev("bitset_words")
    row = hdb.dev("rep_tag")[torch.from_numpy(check).to(dev)]
    qh = torch.from_numpy(cand).to(dev)
    mask = ops.bitset_member_mask(words, row, qh)
    torch.cuda.synchronize()
    mask_ref = ref.bitset_member_mask_ref(words, row, qh)
    err = int((mask.int() - mask_ref.int()).abs().max())
    need(err == 0, f"bitset_member_mask disagrees with its plain version "
         f"(max abs err {err})")
    r, w = qh.shape
    n_words = words.shape[1]
    mask_words = distinct_words(n_words, row[:, None], qh)
    out["bitset_member"] = dict(
        source="src/repro_torch/csrc/bitset_member.cu",
        replaces="src/repro/kernels/intersect_bitset.py:103",
        shape=f"words {tuple(words.shape)} int32, cand ({r}, {w})",
        max_abs_err=err, found=int(mask.sum()),
        ms=cuda_ms(lambda: ops.bitset_member_mask(words, row, qh), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_member_mask_ref(words, row, qh),
                         10),
        distinct_rows=int(torch.unique(row).numel()),
        words_read=mask_words,
        ops_model="6 int32 ops per lane (shift, 2 clamps, and, shift, and) "
                  "+ 2 per row (clamp)",
        bytes=4 * mask_words + row.nbytes + qh.nbytes + mask.nbytes,
        ops=6 * r * w + 2 * r, library_ms=None)

    # the standalone per-row count entry point of the same kernel source
    wrows = words[row.long()].contiguous()
    blen = torch.from_numpy(deg).to(dev)
    cnt = ops.bitset_member_count(wrows, qh, blen)
    torch.cuda.synchronize()
    cnt_ref = ref.bitset_member_count_ref(wrows, qh, blen)
    err = int((cnt - cnt_ref).abs().max())
    need(err == 0, f"bitset_member_count disagrees with its plain version "
         f"(max abs err {err})")
    need(int(cnt.sum()) == int((mask & (torch.arange(w, device=dev)[None]
                                        < blen[:, None])).sum()),
         "bitset_member_count disagrees with bitset_member_mask")
    valid = torch.arange(w, device=dev)[None] < blen[:, None]
    lane_row = torch.arange(r, device=dev)[:, None].expand(r, w)
    count_words = distinct_words(n_words, lane_row[valid], qh[valid])
    n_valid = int(valid.sum())
    out["bitset_member_count"] = dict(
        source="src/repro_torch/csrc/bitset_member.cu",
        replaces="src/repro/kernels/intersect_bitset.py:103",
        shape=f"words {tuple(wrows.shape)} int32, b ({r}, {w})",
        max_abs_err=err, hits=int(cnt.sum()),
        ms=cuda_ms(lambda: ops.bitset_member_count(wrows, qh, blen), 50),
        plain_ms=cuda_ms(lambda: ref.bitset_member_count_ref(
            wrows, qh, blen), 10),
        valid_lanes=n_valid, words_read=count_words,
        ops_model="7 int32 ops per valid lane (shift, 2 clamps, and, "
                  "shift, and, add)",
        bytes=4 * count_words + 4 * n_valid + blen.nbytes + cnt.nbytes,
        ops=7 * n_valid, library_ms=None)
    return {name: bound(k) for name, k in out.items()}


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


def profile_count(T, db, shape: str) -> None:
    """Where one count's time goes: device time by kernel (and copy) from
    ``torch.profiler`` tracing the device only, and the device's busy and
    idle share of the wall time, profiled and unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    query = T.get_query(shape)
    t0 = time.perf_counter()
    T.count(query, db)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.count(query, db)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = sorted(prof.key_averages(), key=device_us, reverse=True)
    busy = sum(device_us(e) for e in events) / 1e6
    log(json.dumps({
        "profile": shape, "db": "plain", "wall_s": wall,
        "wall_profiled_s": wall_profiled, "device_busy_s": busy,
        "idle_share": 1 - busy / wall, "top_device_ms": [
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
    """All six counts at 5% scale on the card and on the plain CPU path."""
    got = {}
    for device in ("cuda", "cpu"):
        _, db, hdb = bench_gdb(T, SMALL_SCALE, device)
        for db_name, d in (("plain", db), ("hybrid", hdb)):
            for shape in SHAPES:
                got[device, db_name, shape] = T.count(T.get_query(shape), d)
        if device == "cuda":
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


def main() -> int:
    import torch
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
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build.library()
    log(f"nvcc build: {time.perf_counter() - t0:.2f} s "
        f"({build.build_info['path']})")
    for line in build.build_info["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    g, db, hdb = bench_gdb(T, 1.0, "cuda")
    dbs = {"plain": db, "hybrid": hdb}
    log(f"graph {DATASET}: {g.n_nodes} nodes, {g.indices.shape[0]} directed "
        f"edges, max degree {g.max_degree}, {hdb.n_hubs} hubs x "
        f"{hdb.layout.n_words} words ({time.perf_counter() - t0:.2f} s)")

    kern = kernel_phase(T, db, hdb)
    for name, k in kern.items():
        log(f"kernel {name}: {json.dumps(k)}")

    t0 = time.perf_counter()
    counts, launches = main_path(T, dbs)
    log(f"main path: {time.perf_counter() - t0:.2f} s, launches {launches}")
    for name in ("searchsorted_segments", "bitset_member_mask"):
        need(launches[name] > 0, f"the main path never launched {name}")
    profile_count(T, db, "4-cycle")

    t0 = time.perf_counter()
    cross_checks(T, dbs, counts)
    log(f"cross-checks: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    small_scale(T)
    log(f"small scale: {time.perf_counter() - t0:.2f} s")

    path_launches = {"searchsorted_segments": launches["searchsorted_segments"],
                     "bitset_member": launches["bitset_member_mask"]}
    keys = ("source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [
        dict(name=name, route="cuda", launches=path_launches[name],
             **{k: kern[name][k] for k in keys})
        for name in ("searchsorted_segments", "bitset_member")]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
