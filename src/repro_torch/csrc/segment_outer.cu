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
//                         msg[j, c] * basis[j, m]
//
// msg (E, C) and basis (E, M) f32, dst (E,) int32 sorted ascending and
// padded with n_nodes, block_tile0 (n_blocks,) int32 from
// block_tile_starts; out (n_nodes, C * M) f32.  The arguments are used as
// the TPU kernel uses them: node block b (nodes b*bn .. b*bn+bn-1) reads
// edge tiles block_tile0[b] + t for t < n_tiles; tiles at or past
// E / te are gated out, so the last tile is never counted twice; an edge
// counts for block b only if dst - b*bn lies in [0, bn), which drops the
// padding rows.
//
// Design: one block of 256 threads per node block, which owns its bn
// output rows outright (no atomics, deterministic).  Edges are staged 32
// at a time in shared memory (msg and basis rows, coalesced), and each
// thread owns ceil(C*M / 256) of the C*M output columns, at most 8 per
// pass (more passes when C*M > 2048).  For each staged edge a thread adds msg[c]*basis[m]
// into a register accumulator of the current destination node, and adds
// that accumulator into the block's (bn, C*M) shared-memory sum when the
// destination changes: the edges are sorted, so that happens about once
// per node.  The register sum is compensated (Kahan): a node may have
// 10^5 edges (the powerlaw graphs), where two plain float32 sums in
// different orders differ by ~1e-2 on entries near 0; the compensated
// sum stays within float32 rounding of the exact one.  The TPU kernel's one-hot (TE, BN) x (TE, C*M) matmul does bn
// times the multiply-adds of this scatter; here each edge product is
// formed once.
// Because the edges are sorted, a block stops at the first edge past its
// last node instead of walking all n_tiles tiles of the static window.
//
// What bounds it on the H100: each edge's C + M floats are read once and
// each output row written once.  At MACE's widths (C 128, M 9) an edge
// brings 552 bytes for 1,152 multiply-adds, about 2 per byte, and the card
// does 10 f32 multiply-adds per byte of device memory it reads: device-
// memory bytes bound it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;  // output columns a thread owns per pass, at most
constexpr int kStage = 32;   // edges staged in shared memory at a time
constexpr int kPast = 1 << 30;  // staged marker: the edge lies past the block

// kCols: output columns a thread owns per pass (ceil(C*M / 256), at most 8)
template <int kCols>
__global__ void __launch_bounds__(kThreads) segment_outer_kernel(
    const float* __restrict__ msg, const float* __restrict__ basis,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ tile0,
    int64_t total_tiles, int c, int m, int bn, int te, int n_tiles,
    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int cm = c * m;
  float* acc = smem;                    // [bn][cm]
  float* s_msg = acc + bn * cm;         // [kStage][c]
  float* s_basis = s_msg + kStage * c;  // [kStage][m]
  int* s_rel = reinterpret_cast<int*>(s_basis + kStage * m);  // [kStage]
  const int tid = threadIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t first_tile = tile0[blockIdx.x];

  for (int i = tid; i < bn * cm; i += kThreads) acc[i] = 0.f;

  for (int col0 = 0; col0 < cm; col0 += kThreads * kCols) {
    int ci[kCols], mi[kCols];
    bool own[kCols];
    float run[kCols], comp[kCols];  // Kahan sum of the current node's run
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = col0 + tid + k * kThreads;
      own[k] = col < cm;
      ci[k] = own[k] ? col / m : 0;
      mi[k] = own[k] ? col - (col / m) * m : 0;
      run[k] = comp[k] = 0.f;
    }
    int cur = -1;
    bool past = false;
    for (int t = 0; t < n_tiles && !past; ++t) {
      const int64_t g = first_tile + t;
      if (g >= total_tiles) break;
      for (int e0 = 0; e0 < te && !past; e0 += kStage) {
        const int ns = min(kStage, te - e0);
        const int64_t base = g * te + e0;
        __syncthreads();  // the previous stage's readers are done
        // unrolled, so each thread's loads are in flight together
#pragma unroll 8
        for (int i = tid; i < ns * c; i += kThreads) s_msg[i] = msg[base * c + i];
#pragma unroll 4
        for (int i = tid; i < ns * m; i += kThreads)
          s_basis[i] = basis[base * m + i];
        if (tid < ns) {
          const int64_t rel = static_cast<int64_t>(dst[base + tid]) - n0;
          s_rel[tid] = rel < 0 ? -1 : (rel >= bn ? kPast : static_cast<int>(rel));
        }
        __syncthreads();
        for (int j = 0; j < ns; ++j) {
          const int r = s_rel[j];  // the same for every thread of the block
          if (r < 0) continue;
          if (r == kPast) {
            past = true;
            break;
          }
          if (r != cur) {
            if (cur >= 0) {
#pragma unroll
              for (int k = 0; k < kCols; ++k)
                if (own[k]) acc[cur * cm + col0 + tid + k * kThreads] += run[k];
            }
#pragma unroll
            for (int k = 0; k < kCols; ++k) run[k] = comp[k] = 0.f;
            cur = r;
          }
          const float* mrow = s_msg + j * c;
          const float* brow = s_basis + j * m;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (!own[k]) continue;
            const float y = fmaf(mrow[ci[k]], brow[mi[k]], -comp[k]);
            const float t = run[k] + y;
            comp[k] = (t - run[k]) - y;
            run[k] = t;
          }
        }
      }
    }
    if (cur >= 0) {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (own[k]) acc[cur * cm + col0 + tid + k * kThreads] += run[k];
    }
  }
  __syncthreads();
  float* orow = out + n0 * cm;
  for (int i = tid; i < bn * cm; i += kThreads) orow[i] = acc[i];
}

template <int kCols>
int launch(const void* msg, const void* basis, const void* dst,
           const void* tile0, int64_t e, int64_t c, int64_t m, int64_t bn,
           int64_t te, int64_t n_tiles, int64_t blocks, void* out,
           void* stream) {
  const size_t smem = sizeof(float) * (bn * c * m + kStage * (c + m)) +
                      sizeof(int) * kStage;
  const cudaError_t err = cudaFuncSetAttribute(
      segment_outer_kernel<kCols>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_outer_kernel<kCols><<<static_cast<unsigned>(blocks), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msg), static_cast<const float*>(basis),
      static_cast<const int32_t*>(dst), static_cast<const int32_t*>(tile0),
      e / te, static_cast<int>(c), static_cast<int>(m), static_cast<int>(bn),
      static_cast<int>(te), static_cast<int>(n_tiles),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper (kernels/segment_outer.py) checks E % te == 0,
// n_nodes % bn == 0 and that the shared memory fits.
extern "C" int segment_outer_launch(
    const void* msg, const void* basis, const void* dst, const void* tile0,
    int64_t e, int64_t c, int64_t m, int64_t n_nodes, int64_t bn, int64_t te,
    int64_t n_tiles, void* out, void* stream) {
  if (bn < 1 || te < 1 || n_nodes % bn != 0 || e % te != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = n_nodes / bn;
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
                         int64_t, void*, void*);
  static const Launch by_cols[kMaxCols] = {launch<1>, launch<2>, launch<3>,
                                           launch<4>, launch<5>, launch<6>,
                                           launch<7>, launch<8>};
  int64_t cols = (c * m + kThreads - 1) / kThreads;
  cols = cols < 1 ? 1 : (cols > kMaxCols ? kMaxCols : cols);
  return by_cols[cols - 1](msg, basis, dst, tile0, e, c, m, bn, te, n_tiles,
                           blocks, out, stream);
}
