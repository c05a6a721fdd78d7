// Sorted-list intersection for the VLFTJ tile check, written by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/intersect.py, intersect_count_pallas (the
// TPU kernel body _intersect_kernel), and the per-lane form of its
// strategy that the JAX level step computes inline (src/repro/core/
// vlftj.py, the ``check_mode == "tile"`` branch of _expand_level).  Plain
// PyTorch versions: src/repro_torch/kernels/ref.py, tile_member_mask_ref
// and intersect_count_ref.
//
// Two entry points:
//  * tile_member_mask_launch: found[r, j] is true iff cand[r, j] equals
//    one of indices[lo[r] + k] for 0 <= k < check_width with
//    lo[r] + k < hi[r] (the index clamped to [0, M-1], as the reference
//    clamps its gather).  This is what the level step launches.  Like the
//    reference it sees only the first check_width values of a segment.
//  * intersect_count_launch: out[r] = number of valid a[r, i]
//    (i < a_len[r]) found among the valid b[r, 0:b_len[r]), the contract
//    of intersect_count_pallas, for any R, LA and LB (the Pallas R % 8 and
//    L % 128 rules do not apply).  Not on the engine's path.
//
// The TPU kernel compares a tile of A with a tile of B densely on the VPU
// and skips disjoint tile pairs.  Here a lane instead runs a lower-bound
// search of its value in the row's B.  That equals the dense compare
// only because B is sorted: CSR adjacency segments are sorted and
// de-duplicated (src/repro_torch/graphs/csr.py), and the clamped indices
// of a staged segment are non-decreasing, so the staged values are
// sorted too.  The count form needs B sorted for the same reason; A
// need not be.
//
// What bounds it on the H100: the mask form reads each row's segment
// prefix once into shared memory (at most check_width int32: 2 KB at
// 512, 8 KB at 2048), then every lane runs ~log2(n) dependent
// shared-memory probes, so it is bound by integer operations and shared
// memory latency, not by device memory.  The count form searches B in
// device memory (L2-resident at the sizes the port runs).  Both sum
// nothing across blocks: the count form reduces with warp shuffles and
// one shared-memory pass, with no atomics, so counts are deterministic.
// This first version is simple and right; making it fast is a later
// change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index k in [0, n) with seg[k] >= q (n if none).
__device__ __forceinline__ int64_t lower_bound(const int32_t* seg, int64_t n,
                                               int32_t q) {
  int64_t l = 0, h = n;
  while (l < h) {
    const int64_t mid = (l + h) >> 1;
    if (seg[mid] < q) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  return l;
}

__global__ void tile_member_mask_kernel(
    const int32_t* __restrict__ indices, int64_t m,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ cand, int64_t rows, int64_t width,
    int check_width, uint8_t* __restrict__ found) {
  extern __shared__ int32_t seg[];
  const int64_t last = m - 1;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t l = lo[r];
    const int64_t h = hi[r];
    // staged prefix length: lanes k < check_width with l + k < h
    const int64_t n = min(max(h - l, int64_t{0}),
                          static_cast<int64_t>(check_width));
    for (int64_t k = threadIdx.x; k < n; k += blockDim.x)
      seg[k] = __ldg(indices + min(max(l + k, int64_t{0}), last));
    __syncthreads();
    const int32_t* crow = cand + r * width;
    uint8_t* frow = found + r * width;
    for (int64_t j = threadIdx.x; j < width; j += blockDim.x) {
      const int32_t q = crow[j];
      const int64_t p = lower_bound(seg, n, q);
      frow[j] = static_cast<uint8_t>(p < n && seg[p] == q);
    }
    __syncthreads();  // the next row overwrites seg
  }
}

__global__ void intersect_count_kernel(
    const int32_t* __restrict__ a, int64_t la,
    const int32_t* __restrict__ a_len, const int32_t* __restrict__ b,
    int64_t lb, const int32_t* __restrict__ b_len, int64_t rows,
    int32_t* __restrict__ out) {
  __shared__ int32_t warp_sums[kThreads / 32];
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const int64_t na = min(max(static_cast<int64_t>(a_len[r]), int64_t{0}),
                           la);
    const int64_t nb = min(max(static_cast<int64_t>(b_len[r]), int64_t{0}),
                           lb);
    const int32_t* arow = a + r * la;
    const int32_t* brow = b + r * lb;
    int32_t hits = 0;
    for (int64_t i = threadIdx.x; i < na; i += blockDim.x) {
      const int32_t q = arow[i];
      int64_t l = 0, h = nb;
      while (l < h) {
        const int64_t mid = (l + h) >> 1;
        if (__ldg(brow + mid) < q) {
          l = mid + 1;
        } else {
          h = mid;
        }
      }
      hits += static_cast<int32_t>(l < nb && __ldg(brow + l) == q);
    }
    for (int off = 16; off > 0; off >>= 1)
      hits += __shfl_down_sync(0xffffffffu, hits, off);
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
    __syncthreads();  // the next row overwrites warp_sums
  }
}

unsigned grid_for_rows(int64_t rows) {
  const int64_t cap = int64_t{1} << 30;
  return static_cast<unsigned>(rows < cap ? rows : cap);
}

}  // namespace

extern "C" int tile_member_mask_launch(
    const void* indices, int64_t m, const void* lo, const void* hi,
    const void* cand, int64_t rows, int64_t width, int check_width,
    void* found, void* stream) {
  if (rows == 0 || width == 0) return 0;
  const size_t smem = static_cast<size_t>(check_width) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        tile_member_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_member_mask_kernel<<<grid_for_rows(rows), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indices), m,
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(cand), rows, width, check_width,
      static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int intersect_count_launch(
    const void* a, int64_t la, const void* a_len, const void* b, int64_t lb,
    const void* b_len, int64_t rows, void* out, void* stream) {
  if (rows == 0) return 0;
  intersect_count_kernel<<<grid_for_rows(rows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), la, static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b), lb, static_cast<const int32_t*>(b_len),
      rows, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
