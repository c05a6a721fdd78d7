// Segmented batched binary search: the vectorized ``seek_lub`` of the
// VLFTJ level step, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/searchsorted.py, searchsorted_segments_pallas
// (the TPU kernel body _searchsorted_kernel).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, searchsorted_segments_ref.
//
// Per lane (r, c): a branchless lower bound of q[r, c] in values[lo:hi)
// over exactly n_iter rounds, with every probe index clamped to [0, M-1]
// as the reference clamps its gathers.  pos = first index in [lo, hi)
// with values[pos] >= q (hi if none); found = pos < hi and values[pos] == q.
//
// What bounds it on the H100: n_iter dependent gathers per lane into
// ``values`` (the CSR ``indices`` array), so it is memory-latency bound,
// not bandwidth bound.  At the largest configuration the port runs,
// ``indices`` is 7.1 MB and stays resident in the 50 MB L2, so the
// gathers are L2 hits; the lanes of a warp probe neighbouring addresses
// in the first rounds (they share a segment) and diverge later.
//
// Design: one thread per lane, no shared memory.  lo/hi are read with
// their own row and column strides, so the (R, 1) bounds the engine
// passes are never broadcast in memory.  Any R and W are accepted.  This
// first version is simple and right; making it fast (a cooperative
// per-row search, segment staging in shared memory) is a later change.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void searchsorted_segments_kernel(
    const int32_t* __restrict__ values, int64_t m,
    const int32_t* __restrict__ lo, int64_t lo_s0, int64_t lo_s1,
    const int32_t* __restrict__ hi, int64_t hi_s0, int64_t hi_s1,
    const int32_t* __restrict__ queries, int64_t rows, int64_t width,
    int n_iter, int32_t* __restrict__ pos, uint8_t* __restrict__ found) {
  const int64_t n = rows * width;
  const int32_t last = static_cast<int32_t>(m - 1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = i / width;
    const int64_t c = i - r * width;
    const int32_t q = queries[i];
    int32_t l = lo[r * lo_s0 + c * lo_s1];
    const int32_t h0 = hi[r * hi_s0 + c * hi_s1];
    int32_t h = h0;
    for (int it = 0; it < n_iter; ++it) {
      const bool active = l < h;
      // int32 wrap-around like the reference's jnp arithmetic, without UB
      const int32_t mid = static_cast<int32_t>(static_cast<uint32_t>(l) +
                                               static_cast<uint32_t>(h)) >> 1;
      const int32_t midc = min(max(mid, 0), last);
      const int32_t v = __ldg(values + midc);
      const bool go_right = active && (v < q);
      l = go_right ? mid + 1 : l;
      h = (active && !go_right) ? mid : h;
    }
    pos[i] = l;
    const int32_t vp = __ldg(values + min(max(l, 0), last));
    found[i] = static_cast<uint8_t>((l < h0) && (vp == q));
  }
}

}  // namespace

extern "C" int searchsorted_segments_launch(
    const void* values, int64_t m,
    const void* lo, int64_t lo_s0, int64_t lo_s1,
    const void* hi, int64_t hi_s0, int64_t hi_s1,
    const void* queries, int64_t rows, int64_t width, int n_iter,
    void* pos, void* found, void* stream) {
  const int64_t n = rows * width;
  if (n == 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  searchsorted_segments_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), m,
      static_cast<const int32_t*>(lo), lo_s0, lo_s1,
      static_cast<const int32_t*>(hi), hi_s0, hi_s1,
      static_cast<const int32_t*>(queries), rows, width, n_iter,
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}
