// Bitset membership: the hub-bitset check of the hybrid layout, written by
// hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/intersect_bitset.py, bitset_member_count_pallas
// (the TPU kernel body _bitset_member_kernel) and the per-lane form of it
// that the JAX level step computes inline (src/repro/core/vlftj.py, the
// ``check_mode == "bitset"`` branch of _expand_level).  Plain PyTorch
// versions: src/repro_torch/kernels/ref.py, bitset_member_mask_ref and
// bitset_member_count_ref.
//
// Two entry points:
//  * bitset_member_mask_launch: found[r, c] = bit (cand & 31) of
//    words[row[r], cand >> 5], with row clamped to [0, H-1] and
//    cand >> 5 clamped to [0, NW-1] as the JAX gathers clamp.  This is
//    what the level step launches.
//  * bitset_member_count_launch: out[r] = number of valid b[r, j]
//    (j < b_len[r]) whose bit is set in words[r, :], exactly what
//    bitset_member_count_pallas computes.  One block per row; the sum is
//    a warp-shuffle reduction, then one shared-memory pass over the warps,
//    with no atomics, so the result is deterministic.
//
// Bitset words arrive as int32 bit patterns (the PyTorch side stores the
// uint32 words as int32, since torch.uint32 has only partial operator
// support) and are read here as uint32_t: the same 32 bits.
//
// What bounds it on the H100: one dependent gather per lane into the
// (H, NW) word matrix, so it is memory-latency bound.  At the largest
// configuration the port runs, the matrix is 18.8 MB and stays resident
// in the 50 MB L2.  This first version is simple and right (one thread
// per lane, no shared-memory staging); making it fast is a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bitset_member_mask_kernel(
    const uint32_t* __restrict__ words, int64_t n_rows_words, int64_t n_words,
    const int32_t* __restrict__ row, const int32_t* __restrict__ cand,
    int64_t rows, int64_t width, uint8_t* __restrict__ found) {
  const int64_t n = rows * width;
  const int32_t h_last = static_cast<int32_t>(n_rows_words - 1);
  const int32_t w_last = static_cast<int32_t>(n_words - 1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / width;
    const int32_t q = cand[i];
    const int32_t h = min(max(__ldg(row + r), 0), h_last);
    const int32_t wi = min(max(q >> 5, 0), w_last);
    const uint32_t w = __ldg(words + static_cast<int64_t>(h) * n_words + wi);
    found[i] = static_cast<uint8_t>((w >> (q & 31)) & 1u);
  }
}

constexpr int kCountThreads = 256;

__global__ void bitset_member_count_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int32_t* __restrict__ b, int64_t lb,
    const int32_t* __restrict__ b_len, int32_t* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const int32_t len = b_len[r];
  const int32_t w_last = static_cast<int32_t>(n_words - 1);
  const uint32_t* wrow = words + r * n_words;
  const int32_t* brow = b + r * lb;
  int32_t hits = 0;
  for (int64_t j = threadIdx.x; j < lb; j += blockDim.x) {
    if (j < len) {  // padded lanes never count (the reference tests bit 0)
      const int32_t q = brow[j];
      const int32_t wi = min(max(q >> 5, 0), w_last);
      hits += static_cast<int32_t>((__ldg(wrow + wi) >> (q & 31)) & 1u);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    hits += __shfl_down_sync(0xffffffffu, hits, off);
  __shared__ int32_t warp_sums[kCountThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = hits;
  __syncthreads();
  if (warp == 0) {
    hits = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      hits += __shfl_down_sync(0xffffffffu, hits, off);
    if (lane == 0) out[r] = hits;
  }
}

unsigned grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  return static_cast<unsigned>(blocks);
}

}  // namespace

extern "C" int bitset_member_mask_launch(
    const void* words, int64_t n_rows_words, int64_t n_words,
    const void* row, const void* cand, int64_t rows, int64_t width,
    void* found, void* stream) {
  const int64_t n = rows * width;
  if (n == 0) return 0;
  const int threads = 256;
  bitset_member_mask_kernel<<<grid_for(n, threads), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_rows_words, n_words,
      static_cast<const int32_t*>(row), static_cast<const int32_t*>(cand),
      rows, width, static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitset_member_count_launch(
    const void* words, int64_t n_words, const void* b, int64_t rows,
    int64_t lb, const void* b_len, void* out, void* stream) {
  if (rows == 0) return 0;
  bitset_member_count_kernel<<<static_cast<unsigned>(rows), kCountThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(b), lb,
      static_cast<const int32_t*>(b_len), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
