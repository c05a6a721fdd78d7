// Bitset AND-popcount: per-row |A ∩ B| of two hub bitset rows, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/intersect_bitset.py,
// bitset_intersect_count_pallas (the TPU kernel body _bitset_and_kernel).
// Plain PyTorch version: src/repro_torch/kernels/ref.py,
// bitset_intersect_count_ref.  Reached through the kernel router only
// (src/repro_torch/kernels/ops.py), as in the JAX package: no engine
// calls it.
//
// out[r] = sum over w of popcount(a[r, w] & b[r, w]) for (R, NW) words.
// Words arrive as int32 bit patterns (see core/device_graph.py) and are
// read as uint32_t: the same 32 bits.
//
// Design: one warp per row.  The lanes stride over the row's words (32
// neighbouring words per step, so each warp load is one 128-byte line),
// AND them, count with __popc, and the warp sums its lanes with shuffles.
// No atomics and no cross-warp sum, so the count is deterministic.  The
// TPU kernel carries a row's running sum across sequential word-tile grid
// steps; here a row's whole sum stays inside one warp, which needs no
// carry.
//
// What bounds it on the H100: each word of both inputs is read once and
// the work per word is three integer operations, so it is bound by
// device-memory bytes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void bitset_intersect_count_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    int64_t rows, int64_t n_words, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t r = first; r < rows; r += step) {
    const uint32_t* arow = a + r * n_words;
    const uint32_t* brow = b + r * n_words;
    int32_t hits = 0;
    for (int64_t w = lane; w < n_words; w += 32)
      hits += __popc(__ldg(arow + w) & __ldg(brow + w));
    for (int off = 16; off > 0; off >>= 1)
      hits += __shfl_down_sync(0xffffffffu, hits, off);
    if (lane == 0) out[r] = hits;
  }
}

}  // namespace

extern "C" int bitset_intersect_count_launch(
    const void* a, const void* b, int64_t rows, int64_t n_words, void* out,
    void* stream) {
  if (rows == 0) return 0;
  int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  bitset_intersect_count_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), rows,
      n_words, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
