// Segment outer product: MACE's A-basis scatter, written by hand for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/segment_outer.py, segment_outer_pallas (the
// TPU kernel body _kernel).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, segment_outer_ref.  Reached through the
// kernel router (src/repro_torch/kernels/ops.py) only, as in the JAX
// package: no model calls it.
//
//     out[n, c * M + m] = sum over edges j with dst[j] == n of
//                         round_T(msg[j, c] * basis[j, m])
//
// msg (E, Cp) and basis (E, M) of one type T (float, bf16 or f16; the
// wrapper promotes mixed inputs and pads C to Cp, a multiple of 16 bytes a
// row), dst (E,) int32 sorted ascending; out (n_nodes, C * M) float32.  In
// bf16 and f16 each product is rounded to T and then summed in float32, as
// the TPU kernel does (`prod` in the input type, cast to float32 before
// its dot).  An edge whose dst lies outside [0, n_nodes) adds nothing, as
// in the TPU kernel: padding rows carry dst = n_nodes.  The TPU kernel's
// block_tile0 and n_tiles only window each node block's edges; for the
// arguments block_tile_starts gives, the window covers every edge of the
// block, so this kernel walks the sorted edges directly and takes neither.
//
// What bounds it on the H100: each edge's C + M values are read once and
// each output row written once.  At MACE's widths (C 128, M 9) in float32
// that is 552 bytes an edge for 1,152 multiply-adds (~2 per byte; the card
// does ~20 float32 FLOP per byte of device memory), so device-memory bytes
// bound it; the tensor cores are not needed.  The TPU kernel's design (a
// node block a grid step, a one-hot matmul) would put a powerlaw hub's
// ~10^5 edges on one SM.
//
// What the design does about it: it balances edges over the SMs and keeps
// bytes in flight on each.
// - Edge ranges, not node blocks.  The sorted edges are cut into equal
//   ranges, a few for every warp the card holds at once (so the block
//   scheduler evens out ranges that write more rows), and each warp takes
//   one range (and one column pass, below) on its own: no __syncthreads.
//   A hub's edges spread over as many warps as its ranges.
// - One writer per output row, no atomics: a run of equal dst inside a
//   range is written to `out` by its warp; a run that crosses a range
//   boundary leaves one partial row per range in `partial` (slot 0: the
//   range's first run if it began earlier; slot 1: its last run if it goes
//   on), and segment_outer_merge_kernel adds them in range order (float64)
//   and writes the row.  Each warp marks the nodes whose runs it starts
//   in `seen` (a byte a node), and segment_outer_gap_kernel, a block for
//   every 256 nodes, writes zero rows for the unmarked ones, so a long
//   run of edgeless nodes (trailing padding nodes, a sparse dst) spreads
//   over the card as a hub's edges do.  So two calls give bit-identical
//   results.
// - Bytes in flight: a warp stages its edges through a cp.async ring of
//   kStages stages (32 bytes of each msg column a stage: 8 float32 or 16
//   bf16 edges, with their basis rows and dst), kStages - 1 in flight
//   while it computes on one.
// - Operands: a lane owns 4 channels (one 16-byte, or 8-byte in bf16/f16,
//   shared-memory load, coalesced across the warp) and all MT basis
//   columns of them in registers; the edge's basis row is a shared-memory
//   broadcast.  One FMA an output update in float32; in bf16/f16 one
//   packed multiply (rounding each product to the type, as the TPU kernel
//   does) for two updates, then a float32 add.  A ballot over the stage's
//   dst marks where runs start, so the edges between are a plain loop of
//   loads and FMAs, a whole stage of them in the common case.
// - Precision: products are summed in float32 over at least kChunk edges
//   (a stage at a time), and each chunk is added into a compensated
//   (Kahan) float32 total.  A node may have 10^5 edges (the powerlaw
//   inputs), where a plain float32 sum differs from the exact one by ~1e-3
//   on entries near 0.
// - Registers: the three 4 x MT sums (108 at M 9) need __launch_bounds__
//   of two blocks (8 warps) an SM; three blocks spilled and ran slower.
// - Wider inputs: a pass covers 128 channels and MT basis columns (MT 9 at
//   M 9, else 8; M below 8 masks the columns past M); wider msg or basis
//   run more passes, each its own warp task over the same ranges.  Where M
//   takes more than one column pass, the wrapper lays basis out as
//   (passes, E, MT), zero-padded, so a pass stages only its own columns.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;               // warps a block, each on its own task
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;           // blocks an SM at least (registers)
constexpr int kStages = 3;              // cp.async ring depth a warp
constexpr int kPassCh = 128;            // channels a pass: 4 a lane
constexpr int kChunk = 16;              // edges summed plainly per Kahan add,
                                        // at least (a stage at a time)
constexpr int kMinRange = 256;          // edges a range at least
// ranges for every warp the card holds at once: more even out the ranges
// that write more rows (the block scheduler hands out the next as one
// ends), fewer leave fewer partial rows for the merge
constexpr int kWaves = 4;
constexpr int kMergeThreads = 256;
constexpr int kMergeCols = 128;         // output columns a merge warp adds
constexpr int kGapNodes = 256;          // nodes a gap block, one a thread
constexpr int64_t kNone = INT64_MIN;    // no run yet

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; only the first `bytes` are read, the rest of
// the 16 are zero-filled
__device__ __forceinline__ void cp_async16(void* s, const void* g, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(s)), "l"(g), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int64_t round16(int64_t x) {
  return (x + 15) / 16 * 16;
}
__host__ __device__ constexpr int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// shared-memory bytes of one stage: msg rows of cw_max channels, the basis
// rows (mw columns, padded to 16 bytes) and the dst values
int64_t stage_bytes(int64_t cw_max, int64_t mw, int sz) {
  const int64_t s = 32 / sz;
  return s * cw_max * sz + round16(s * mw * sz) + round16(s * 4);
}

// lane's 4 channels (a_src) times the edge's basis columns [m0, m0 + MT)
// (b_src; those at or past M count as 0) into acc
template <int MT>
__device__ __forceinline__ void mac_edge(const float* a_src,
                                         const float* b_src, int mrem,
                                         float (&acc)[4][MT]) {
  const float4 a = *reinterpret_cast<const float4*>(a_src);
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    const float b = k < mrem ? b_src[k] : 0.f;
    acc[0][k] = fmaf(a.x, b, acc[0][k]);
    acc[1][k] = fmaf(a.y, b, acc[1][k]);
    acc[2][k] = fmaf(a.z, b, acc[2][k]);
    acc[3][k] = fmaf(a.w, b, acc[3][k]);
  }
}

// bf16: the packed multiply rounds each product to bf16 (the products of
// two bf16 are exact in float32, so this is the plain version's rounding)
template <int MT>
__device__ __forceinline__ void mac_edge(const __nv_bfloat16* a_src,
                                         const __nv_bfloat16* b_src, int mrem,
                                         float (&acc)[4][MT]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(a_src);
  const __nv_bfloat162 a01 = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 a23 = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    const __nv_bfloat16 b = k < mrem ? b_src[k] : __float2bfloat16(0.f);
    const __nv_bfloat162 bb = __bfloat162bfloat162(b);
    const __nv_bfloat162 p01 = __hmul2(a01, bb);
    const __nv_bfloat162 p23 = __hmul2(a23, bb);
    acc[0][k] += __low2float(p01);
    acc[1][k] += __high2float(p01);
    acc[2][k] += __low2float(p23);
    acc[3][k] += __high2float(p23);
  }
}

template <int MT>
__device__ __forceinline__ void mac_edge(const __half* a_src,
                                         const __half* b_src, int mrem,
                                         float (&acc)[4][MT]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(a_src);
  const __half2 a01 = *reinterpret_cast<const __half2*>(&raw.x);
  const __half2 a23 = *reinterpret_cast<const __half2*>(&raw.y);
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    const __half b = k < mrem ? b_src[k] : __float2half(0.f);
    const __half2 bb = __half2half2(b);
    const __half2 p01 = __hmul2(a01, bb);
    const __half2 p23 = __hmul2(a23, bb);
    acc[0][k] += __low2float(p01);
    acc[1][k] += __high2float(p01);
    acc[2][k] += __low2float(p23);
    acc[3][k] += __high2float(p23);
  }
}

// add the chunk sums into the compensated totals and clear them
template <int MT>
__device__ __forceinline__ void kahan_add(float (&acc)[4][MT],
                                          float (&tot)[4][MT],
                                          float (&cmp)[4][MT]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      const float y = acc[i][k] - cmp[i][k];
      const float t = tot[i][k] + y;
      cmp[i][k] = (t - tot[i][k]) - y;
      tot[i][k] = t;
      acc[i][k] = 0.f;
    }
}

// the lane's values into one output (or partial) row: columns
// (lc + i) * M + m0 + k.  `vec`: the lane's 4 * M values are one contiguous
// 16-byte aligned run (MT == M, all 4 channels real, C*M % 4 == 0)
template <int MT>
__device__ __forceinline__ void store_row(float* row, const float (&v)[4][MT],
                                          int lc, int c, int m, int m0,
                                          bool vec) {
  if (vec) {
    float4* p = reinterpret_cast<float4*>(row + static_cast<int64_t>(lc) * m);
#pragma unroll
    for (int q = 0; q < MT; ++q)
      p[q] = make_float4(v[(4 * q) / MT][(4 * q) % MT],
                         v[(4 * q + 1) / MT][(4 * q + 1) % MT],
                         v[(4 * q + 2) / MT][(4 * q + 2) % MT],
                         v[(4 * q + 3) / MT][(4 * q + 3) % MT]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (lc + i >= c) break;
    float* r = row + static_cast<int64_t>(lc + i) * m + m0;
#pragma unroll
    for (int k = 0; k < MT; ++k)
      if (m0 + k < m) r[k] = v[i][k];
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) segment_outer_kernel(
    const T* __restrict__ msg, const T* __restrict__ basis,
    const int32_t* __restrict__ dst, int64_t e, int c, int cp, int m, int mw,
    int64_t n_nodes, int64_t range_edges, int64_t n_ranges, int n_cpass,
    int64_t stage_size, float* __restrict__ out,
    float* __restrict__ partial, uint8_t* __restrict__ seen) {
  // edges a stage: 32 bytes of every msg column, so a stage's basis and
  // dst bytes are whole 16-byte pieces from a 16-byte aligned start
  constexpr int S = 32 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_mpass = (m + MT - 1) / MT;
  const int64_t task = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (task >= n_ranges * n_cpass * n_mpass) return;
  const int64_t range = task % n_ranges;
  const int pass = static_cast<int>(task / n_ranges);
  const int mpass = pass / n_cpass;
  const int c0 = (pass % n_cpass) * kPassCh, m0 = mpass * MT;
  // this pass's basis: (E, mw) with mw = M in one pass, else (E, MT) of
  // the (passes, E, MT) layout
  const T* pbasis = basis + static_cast<int64_t>(mpass) * e * mw;
  const int cw_max = min(kPassCh, cp), cw = min(kPassCh, cp - c0);
  const int lc = c0 + 4 * lane;
  const int lofs = 4 * lane < cw ? 4 * lane : 0;  // idle lanes read column 0
  const int mrem = m - m0;
  const int64_t cm = static_cast<int64_t>(c) * m;
  const bool owns = lc < c;
  const bool vec = MT == m && lc + 4 <= c && cm % 4 == 0;
  const int64_t r0 = range * range_edges;
  const int64_t r1 = min64(r0 + range_edges, e);
  const int64_t before = r0 > 0 ? dst[r0 - 1] : kNone;
  const int64_t after = r1 < e ? dst[r1] : kNone;
  const int64_t n_stages = (r1 - r0 + S - 1) / S;

  // stage layout: msg [S][cw_max], basis [S][mw] (padded), dst [S]
  const int64_t msg_bytes = static_cast<int64_t>(S) * cw_max * sizeof(T);
  const int64_t basis_bytes =
      round16(static_cast<int64_t>(S) * mw * sizeof(T));
  unsigned char* ring = smem + warp * kStages * stage_size;
  // 16-byte pieces of a pass's msg row slice; a lane steps 32 pieces
  const int ppr = cw * static_cast<int>(sizeof(T)) / 16;
  const int step_r = 32 / ppr, step_k = 32 % ppr;
  const int first_r = lane / ppr, first_k = lane % ppr;

  auto issue = [&](int64_t t) {
    unsigned char* buf = ring + (t % kStages) * stage_size;
    const int64_t j0 = r0 + t * S;
    const int n = static_cast<int>(min64(S, r1 - j0));
    const unsigned char* gm = reinterpret_cast<const unsigned char*>(
        msg + j0 * cp + c0);
    const int64_t row_g = static_cast<int64_t>(cp) * sizeof(T);
    const int row_s = cw_max * static_cast<int>(sizeof(T));
    for (int r = first_r, k = first_k; r < n;) {
      cp_async16(buf + r * row_s + 16 * k, gm + r * row_g + 16 * k, 16);
      r += step_r;
      k += step_k;
      if (k >= ppr) {
        k -= ppr;
        ++r;
      }
    }
    const int bb = n * mw * static_cast<int>(sizeof(T));
    const unsigned char* gb =
        reinterpret_cast<const unsigned char*>(pbasis + j0 * mw);
    for (int off = 16 * lane; off < bb; off += 512)
      cp_async16(buf + msg_bytes + off, gb + off, min(16, bb - off));
    const unsigned char* gd = reinterpret_cast<const unsigned char*>(dst + j0);
    for (int off = 16 * lane; off < 4 * n; off += 512)
      cp_async16(buf + msg_bytes + basis_bytes + off, gd + off,
                 min(16, 4 * n - off));
  };

  float acc[4][MT], tot[4][MT], cmp[4][MT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < MT; ++k) acc[i][k] = tot[i][k] = cmp[i][k] = 0.f;

  int64_t cur = kNone;  // the run's node
  bool live = false;    // cur in [0, n_nodes)
  bool head = false;    // the run began before this range
  int cnt = 0;          // edges in acc

  // the run of `cur` is complete in this range (or goes on past it: cont)
  auto finish = [&](bool cont) {
    if (!live) return;
    kahan_add<MT>(acc, tot, cmp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < MT; ++k) tot[i][k] -= cmp[i][k];
    float* row = head   ? partial + (2 * range) * cm
                 : cont ? partial + (2 * range + 1) * cm
                        : out + cur * cm;
    if (owns) store_row<MT>(row, tot, lc, c, m, m0, vec);
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages) issue(t);
    cp_async_commit();
  }
  for (int64_t t = 0; t < n_stages; ++t) {
    if (t + kStages - 1 < n_stages) issue(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* buf = ring + (t % kStages) * stage_size;
    const T* s_msg = reinterpret_cast<const T*>(buf) + lofs;
    const T* s_basis = reinterpret_cast<const T*>(buf + msg_bytes);
    const int32_t* s_dst =
        reinterpret_cast<const int32_t*>(buf + msg_bytes + basis_bytes);
    const int n = static_cast<int>(min64(S, r1 - r0 - t * S));
    // bit r: edge r starts a new run (its dst differs from the edge before)
    const int64_t d_lane = lane < n ? s_dst[lane] : 0;
    const int64_t d_prev = lane == 0 ? cur : (lane < n ? s_dst[lane - 1] : 0);
    const unsigned starts =
        __ballot_sync(0xffffffffu, lane < n && d_lane != d_prev);
    if (starts == 0 && n == S) {
      // the common case: the whole stage adds to the current run (unrolled
      // by 4, not fully: the bf16 body is ~110 instructions an edge, and a
      // full unroll ran 15% slower on the H100)
      if (live) {
#pragma unroll 4
        for (int r = 0; r < S; ++r)
          mac_edge<MT>(s_msg + r * cw_max, s_basis + r * mw, mrem, acc);
        cnt += S;
      }
    } else {
      for (int r = 0; r < n;) {
        if (starts >> r & 1) {
          const int64_t d = s_dst[r];
          if (cur != kNone) finish(false);
          head = cur == kNone && before == d;
          cur = d;
          live = d >= 0 && d < n_nodes;
          if (live && pass == 0 && lane == 0) seen[d] = 1;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < MT; ++k)
              acc[i][k] = tot[i][k] = cmp[i][k] = 0.f;
          cnt = 0;
        }
        const unsigned later = starts & ~((2u << r) - 1u);
        const int end = later ? __ffs(later) - 1 : n;
        if (live) {
          for (int q = r; q < end; ++q)
            mac_edge<MT>(s_msg + q * cw_max, s_basis + q * mw, mrem, acc);
          cnt += end - r;
        }
        r = end;
      }
    }
    if (cnt >= kChunk) {
      kahan_add<MT>(acc, tot, cmp);
      cnt = 0;
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  finish(after == cur);
}

// One warp for each range and 128 columns: if the range's last run goes on
// past it and began in it, add that run's partial rows (this range's slot
// 1, then slot 0 of each later range it reaches, in order, in float64)
// into the columns of its output row.
__global__ void __launch_bounds__(kMergeThreads) segment_outer_merge_kernel(
    const int32_t* __restrict__ dst, int64_t e, int64_t cm, int64_t n_nodes,
    int64_t range_edges, int64_t n_ranges, const float* __restrict__ partial,
    float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t n_chunks = (cm + kMergeCols - 1) / kMergeCols;
  const int64_t task =
      static_cast<int64_t>(blockIdx.x) * (kMergeThreads / 32) +
      (threadIdx.x >> 5);
  const int64_t range = task / n_chunks;
  if (range >= n_ranges) return;
  const int64_t r0 = range * range_edges;
  const int64_t r1 = min64(r0 + range_edges, e);
  if (r1 >= e) return;
  const int32_t v = dst[r1 - 1];
  if (dst[r1] != v || v < 0 || v >= n_nodes) return;
  if (r0 > 0 && dst[r0 - 1] == v) return;  // an earlier range owns the run
  // the run goes on past range + k: monotone in k, true at k = 0
  auto goes_on = [&](int64_t k) {
    const int64_t end = min64((range + k + 1) * range_edges, e);
    return end < e && dst[end] == v;
  };
  int64_t lo = 0, hi = 1;  // gallop, then bisect: the run ends in range + hi
  while (goes_on(hi)) {
    lo = hi;
    hi *= 2;
  }
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (goes_on(mid))
      lo = mid;
    else
      hi = mid;
  }
  const int64_t col0 = (task % n_chunks) * kMergeCols;
  const float* first = partial + (2 * range + 1) * cm;
  float* row = out + static_cast<int64_t>(v) * cm;
  if (cm % 4 == 0) {  // rows are 16-byte aligned: a float4 a lane
    const int64_t col = col0 + 4 * lane;
    if (col >= cm) return;
    const float4 x = *reinterpret_cast<const float4*>(first + col);
    double s0 = x.x, s1 = x.y, s2 = x.z, s3 = x.w;
#pragma unroll 8
    for (int64_t b = range + 1; b <= range + hi; ++b) {
      const float4 y =
          *reinterpret_cast<const float4*>(partial + 2 * b * cm + col);
      s0 += y.x;
      s1 += y.y;
      s2 += y.z;
      s3 += y.w;
    }
    *reinterpret_cast<float4*>(row + col) =
        make_float4(static_cast<float>(s0), static_cast<float>(s1),
                    static_cast<float>(s2), static_cast<float>(s3));
    return;
  }
  for (int64_t col = col0 + lane; col < min64(col0 + kMergeCols, cm);
       col += 32) {
    double sum = first[col];
#pragma unroll 8
    for (int64_t b = range + 1; b <= range + hi; ++b)
      sum += partial[2 * b * cm + col];
    row[col] = static_cast<float>(sum);
  }
}

// A block for each kGapNodes nodes, a thread each: a node that no run
// started on (unmarked in `seen` by the edge-range pass) gets a zero
// output row, the block's warps taking those rows in turn.  The
// edge-range pass and the merge write every other row.
__global__ void __launch_bounds__(kGapNodes) segment_outer_gap_kernel(
    const uint8_t* __restrict__ seen, int64_t cm, int64_t n_nodes,
    float* __restrict__ out) {
  constexpr int kGapWarps = kGapNodes / 32;
  __shared__ unsigned empty[kGapWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kGapNodes;
  const int64_t v = v0 + threadIdx.x;
  const bool gap = v < n_nodes && !seen[v];
  const unsigned bits = __ballot_sync(0xffffffffu, gap);
  if (lane == 0) empty[warp] = bits;
  __syncthreads();
  for (int i = warp; i < kGapNodes; i += kGapWarps) {
    if (!(empty[i / 32] >> (i % 32) & 1u)) continue;
    float* row = out + (v0 + i) * cm;
    if (cm % 4 == 0) {  // rows are 16-byte aligned: a float4 a lane
      for (int64_t col = 4 * lane; col < cm; col += 128)
        *reinterpret_cast<float4*>(row + col) = make_float4(0.f, 0.f, 0.f,
                                                            0.f);
    } else {
      for (int64_t col = lane; col < cm; col += 32) row[col] = 0.f;
    }
  }
}

enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };

int pick_mt(int64_t m) { return m == 9 ? 9 : 8; }

// the basis columns a pass stages an edge: all M in one pass, else MT of
// the wrapper's (passes, E, MT) layout
int64_t pass_width(int64_t m, int mt) { return m <= mt ? m : mt; }

int dtype_size(int dtype) { return dtype == kF32 ? 4 : 2; }

// the launch of one pass-1 instance, by the same arguments for every type
struct Launch {
  const void *msg, *basis, *dst;
  int64_t e, c, cp, m, mw, n_nodes, range_edges, n_ranges, n_cpass,
      stage_size, grid, smem;
  void *out, *partial, *seen;
  cudaStream_t stream;
};

template <typename T, int MT>
void* kernel_fn() {
  return reinterpret_cast<void*>(segment_outer_kernel<T, MT>);
}

template <typename T, int MT>
void launch_pass(const Launch& a) {
  segment_outer_kernel<T, MT><<<static_cast<unsigned>(a.grid), kThreads,
                                static_cast<size_t>(a.smem), a.stream>>>(
      static_cast<const T*>(a.msg), static_cast<const T*>(a.basis),
      static_cast<const int32_t*>(a.dst), a.e, static_cast<int>(a.c),
      static_cast<int>(a.cp), static_cast<int>(a.m), static_cast<int>(a.mw),
      a.n_nodes,
      a.range_edges, a.n_ranges, static_cast<int>(a.n_cpass), a.stage_size,
      static_cast<float*>(a.out), static_cast<float*>(a.partial),
      static_cast<uint8_t*>(a.seen));
}

// one kernel instance: its function (for attributes and occupancy) and its
// launcher
struct Instance {
  void* fn;
  void (*launch)(const Launch&);
};

template <typename T, int MT>
Instance instance() {
  return {kernel_fn<T, MT>(), launch_pass<T, MT>};
}

Instance pick_instance(int dtype, int mt) {
  switch (dtype * 16 + mt) {
    case kF32 * 16 + 8: return instance<float, 8>();
    case kF32 * 16 + 9: return instance<float, 9>();
    case kBf16 * 16 + 8: return instance<__nv_bfloat16, 8>();
    case kBf16 * 16 + 9: return instance<__nv_bfloat16, 9>();
    case kF16 * 16 + 8: return instance<__half, 8>();
    case kF16 * 16 + 9: return instance<__half, 9>();
    default: return {nullptr, nullptr};
  }
}

// the kernel instance, its passes, its staged basis width and its dynamic
// shared memory
struct Plan {
  Instance inst;
  int64_t n_cpass, n_mpass, mw, stage_size, smem;
};

int make_plan(int64_t cp, int64_t m, int dtype, Plan* p) {
  if (dtype < kF32 || dtype > kF16 || cp < 1 || m < 1 || m > INT32_MAX ||
      (cp * dtype_size(dtype)) % 16 || cp > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mt = pick_mt(m);
  p->inst = pick_instance(dtype, mt);
  p->n_cpass = (cp + kPassCh - 1) / kPassCh;
  p->n_mpass = (m + mt - 1) / mt;
  p->mw = pass_width(m, mt);
  p->stage_size = stage_bytes(min64(cp, kPassCh), p->mw, dtype_size(dtype));
  p->smem = p->stage_size * kStages * kWarps;
  return static_cast<int>(cudaFuncSetAttribute(
      p->inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p->smem)));
}

}  // namespace

// The edges a range and the number of ranges for E edges of Cp channels and
// M basis columns in `dtype` (0 float32, 1 bf16, 2 f16): kWaves tasks for
// every warp the card holds at once (from the occupancy of the kernel
// instance), at least kMinRange edges, a multiple of the stage.  Writes
// {range_edges, n_ranges, mw} to out (int64[3]): mw is the basis columns a
// pass stages, M where one pass takes them all, else the pass width, and
// then the launch reads basis as (ceil(M / mw), E, mw), zero-padded.
extern "C" int segment_outer_plan(int64_t e, int64_t cp, int64_t m,
                                  int dtype, void* out) {
  Plan p;
  int rc = make_plan(cp, m, dtype, &p);
  if (rc) return rc;
  int dev = 0, sms = 0, blocks = 0;
  if ((rc = static_cast<int>(cudaGetDevice(&dev)))) return rc;
  if ((rc = static_cast<int>(cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev))))
    return rc;
  if ((rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &blocks, p.inst.fn, kThreads, static_cast<size_t>(p.smem)))))
    return rc;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t s = 32 / dtype_size(dtype);
  const int64_t tasks = static_cast<int64_t>(kWaves) * blocks * kWarps * sms;
  int64_t r = (e * p.n_cpass * p.n_mpass + tasks - 1) / tasks;
  r = r < kMinRange ? kMinRange : r;
  r = (r + s - 1) / s * s;
  int64_t* o = static_cast<int64_t*>(out);
  o[0] = r;
  o[1] = e > 0 ? (e + r - 1) / r : 0;
  o[2] = p.mw;
  return 0;
}

// The wrapper (kernels/segment_outer.py) checks shapes and types, pads C to
// Cp, lays basis out as segment_outer_plan says, aligns the tensors to 16
// bytes, and allocates `partial` (n_ranges, 2, C * M) float32 and `seen`
// (n_nodes bytes, cleared here).  Launches the pass over the ranges, the
// merge, then the zero rows of the nodes without edges.
extern "C" int segment_outer_launch(
    const void* msg, const void* basis, const void* dst, int64_t e, int64_t c,
    int64_t cp, int64_t m, int64_t n_nodes, int64_t range_edges,
    int64_t n_ranges, int dtype, void* out, void* partial, void* seen,
    void* stream) {
  Plan p;
  int rc = make_plan(cp, m, dtype, &p);
  if (rc) return rc;
  const int64_t s = 32 / dtype_size(dtype);
  if (e < 1 || c < 1 || c > cp || n_nodes < 1 || range_edges < 1 ||
      range_edges % s || n_ranges != (e + range_edges - 1) / range_edges)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMergeWarps = kMergeThreads / 32;
  const int64_t tasks = n_ranges * p.n_cpass * p.n_mpass;
  const int64_t grid = (tasks + kWarps - 1) / kWarps;
  const int64_t merge_tasks =
      n_ranges * ((c * m + kMergeCols - 1) / kMergeCols);
  const int64_t merge_grid = (merge_tasks + kMergeWarps - 1) / kMergeWarps;
  const int64_t gap_grid = (n_nodes + kGapNodes - 1) / kGapNodes;
  if (grid >= (int64_t{1} << 31) || merge_grid >= (int64_t{1} << 31) ||
      gap_grid >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((rc = static_cast<int>(
           cudaMemsetAsync(seen, 0, static_cast<size_t>(n_nodes), st))))
    return rc;
  p.inst.launch({msg, basis, dst, e, c, cp, m, p.mw, n_nodes, range_edges,
                 n_ranges, p.n_cpass, p.stage_size, grid, p.smem, out,
                 partial, seen, st});
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  if (n_ranges > 1)
    segment_outer_merge_kernel<<<static_cast<unsigned>(merge_grid),
                                 kMergeThreads, 0, st>>>(
        static_cast<const int32_t*>(dst), e, c * m, n_nodes, range_edges,
        n_ranges, static_cast<const float*>(partial),
        static_cast<float*>(out));
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;
  segment_outer_gap_kernel<<<static_cast<unsigned>(gap_grid), kGapNodes, 0,
                             st>>>(static_cast<const uint8_t*>(seen), c * m,
                                   n_nodes, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
