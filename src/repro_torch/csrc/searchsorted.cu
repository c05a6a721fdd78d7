// Segmented batched binary search: the vectorized ``seek_lub`` of the
// VLFTJ level step, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/searchsorted.py, searchsorted_segments_pallas
// (the TPU kernel body _searchsorted_kernel).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, searchsorted_segments_ref.
//
// Per lane (r, c): a branchless lower bound of q[r, c] in values[lo:hi)
// over at most n_iter rounds, with every probe index clamped to [0, M-1]
// as the reference clamps its gathers.  pos = first index in [lo, hi)
// with values[pos] >= q (hi if none); found = pos < hi and values[pos] == q.
// A round whose window has closed (l >= h) changes nothing, so a thread
// leaves the round loop once none of its lanes is open: the outputs stay
// bit for bit those of the reference's n_iter rounds.
//
// What bounds it on the H100: the rounds' compares and selects (int32
// operations; at the main path's chunk, 2048 x 2048 lanes, n_iter 12 and
// segments of 40 values at the median, about 6 of the 12 rounds are
// active), and the 38 MB of queries and outputs.  A kernel of one thread
// per lane that runs every round as a dependent gather into ``values``
// (the CSR ``indices``, 7.1 MB and resident in L2) wastes both: the closed
// rounds still load, and all lanes of a row search one segment that
// nothing shares between them.
//
// Design: a block of 256 threads owns `rpb` rows (one row when W > 512,
// up to 32 when W is narrow, set by the launcher), each row `256 / rpb`
// threads, each thread 8 of the row's lanes at once (two 4-lane vectors:
// 16-byte loads of the queries and stores of pos where W % 4 == 0), in
// passes over the row.  Where lo and hi are per row (column stride 0) and
// 0 <= lo <= hi <= M, the block stages the rows' segments values[lo:hi)
// in shared memory with coalesced loads, as many rows as fit in kCap
// values (32 KB), and notes which are not sorted.  Two searches give
// the reference's (pos, found) exactly, chosen per row from the inputs
// alone:
//  * a staged, sorted segment that n_iter rounds search to the end (the
//    engine's case): a fixed-step branchless lower bound in shared memory
//    whose step sizes depend on the segment's length alone (one load,
//    compare and select a lane-round, where the reference's round takes
//    about ten operations);
//  * every other row (per-lane (R, W) windows, bounds outside [0, M],
//    segments that do not fit, are not sorted or need more rounds than
//    n_iter): the reference's rounds in ``values`` in global memory, with
//    the clamped probes.
// A lane that has closed its window leaves the rounds, and a thread once
// all its lanes have.  Each warp plans the staging itself, and the first
// pass's queries are loaded before the staging, so a block waits on two
// rounds of global loads before it searches.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;         // lanes per vector load and store
constexpr int kGroups = 2;      // vectors per thread in flight
constexpr int kLanes = kVec * kGroups;
constexpr int kCap = 8192;      // staged values per block (32 KB)
constexpr int kMaxRows = 32;    // rows per block at most (one warp plans)

// The reference's rounds for up to kLanes lanes, exactly, in ``values``
// with clamped probes.  A thread stops once none of its lanes is open.
__device__ __forceinline__ void search_rounds(
    const int32_t* __restrict__ values, int32_t last, int n_iter,
    int32_t (&l)[kLanes], int32_t (&h)[kLanes], const int32_t (&q)[kLanes]) {
  for (int it = 0; it < n_iter; ++it) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const bool active = l[j] < h[j];
      any |= active;
      // int32 wrap-around like the reference's arithmetic, without UB
      const int32_t mid = static_cast<int32_t>(
          static_cast<uint32_t>(l[j]) + static_cast<uint32_t>(h[j])) >> 1;
      const int32_t v =
          active ? __ldg(values + min(max(mid, 0), last)) : 0;
      const bool go_right = active && v < q[j];
      l[j] = go_right ? mid + 1 : l[j];
      h[j] = (active && !go_right) ? mid : h[j];
    }
    // the rest of the rounds would change nothing for this thread
    if (!any) break;
  }
}

__global__ void __launch_bounds__(kThreads) searchsorted_segments_kernel(
    const int32_t* __restrict__ values, int64_t m,
    const int32_t* __restrict__ lo, int64_t lo_s0, int64_t lo_s1,
    const int32_t* __restrict__ hi, int64_t hi_s0, int64_t hi_s1,
    const int32_t* __restrict__ queries, int64_t rows, int64_t width,
    int n_iter, int rpb, int vec, int32_t* __restrict__ pos,
    uint8_t* __restrict__ found) {
  __shared__ int32_t seg[kCap];
  // per group, bit i: staged row i is not sorted.  Two slots, by the
  // parity of the block's group: a slot is cleared during the other
  // group, between its last read and its next write.
  __shared__ uint32_t unsorted[2];

  const bool per_row = lo_s1 == 0 && hi_s1 == 0;
  const int32_t last = static_cast<int32_t>(m - 1);
  const int tpr = kThreads / rpb;             // threads per row
  const int rib = threadIdx.x / tpr;          // this thread's row in block
  const int t = threadIdx.x - rib * tpr;
  const int lane = threadIdx.x % 32;
  const int64_t n_groups = (rows + rpb - 1) / rpb;
  if (threadIdx.x < 2) unsorted[threadIdx.x] = 0;
  __syncthreads();

  for (int64_t grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int slot = static_cast<int>((grp - blockIdx.x) / gridDim.x) & 1;
    if (threadIdx.x == 0) unsorted[slot ^ 1] = 0;
    // every warp plans the staging on its own (no barrier): lane i reads
    // row i's bounds; a row is staged if its segment is valid and fits
    // after the rows before it
    const int64_t pr = grp * rpb + lane;
    int32_t p_lo = 0, p_hi = 0, len = -1;
    if (lane < rpb && pr < rows) {
      p_lo = lo[pr * lo_s0];
      p_hi = hi[pr * hi_s0];
      if (per_row && 0 <= p_lo && p_lo <= p_hi && p_hi <= m &&
          p_hi - p_lo <= kCap)
        len = p_hi - p_lo;
    }
    const int64_t r = grp * rpb + rib;
    const bool row_ok = r < rows;
    const int32_t* qrow = queries + r * width;
    bool fast = false;
    int32_t r_lo = 0, r_hi = 0, s_start = 0;
    // lane of vector g, element e in the pass at `base`:
    // base + kVec * (t + tpr * g) + e
    for (int64_t base = 0; base < width; base += int64_t{tpr} * kLanes) {
      int32_t l[kLanes], h[kLanes], h0[kLanes], q[kLanes];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int64_t c0 = base + kVec * (t + int64_t{tpr} * g);
        if (vec && row_ok && c0 < width) {
          const int4 v4 = *reinterpret_cast<const int4*>(qrow + c0);
          q[kVec * g] = v4.x;
          q[kVec * g + 1] = v4.y;
          q[kVec * g + 2] = v4.z;
          q[kVec * g + 3] = v4.w;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int j = kVec * g + e;
          const int64_t c = c0 + e;
          const bool ok = row_ok && c < width;
          if (!vec) q[j] = ok ? qrow[c] : 0;
          else if (!ok) q[j] = 0;
          if (!per_row) {
            l[j] = ok ? lo[r * lo_s0 + c * lo_s1] : 0;
            h0[j] = ok ? hi[r * hi_s0 + c * hi_s1] : 0;
          }
        }
      }
      if (base == 0) {
        // the first pass's loads above are in flight while the block
        // plans and stages
        int32_t end = len > 0 ? len : 0;  // inclusive prefix sum
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int32_t x = __shfl_up_sync(0xffffffffu, end, off);
          if (lane >= off) end += x;
        }
        const bool fits = len >= 0 && end <= kCap;
        const int32_t start = end - (len > 0 ? len : 0);
        // stage every row that fits (the loop is the same in every warp),
        // noting the rows whose segment is not sorted
        uint32_t bad = 0;
        for (int i = 0; i < rpb; ++i) {
          const bool st = __shfl_sync(0xffffffffu, fits, i);
          const int32_t s0 = __shfl_sync(0xffffffffu, start, i);
          const int32_t v0 = __shfl_sync(0xffffffffu, p_lo, i);
          const int32_t n = __shfl_sync(0xffffffffu, len, i);
          if (!st) continue;
          for (int x = threadIdx.x; x < n; x += kThreads) {
            const int32_t v = __ldg(values + v0 + x);
            seg[s0 + x] = v;
            if (x + 1 < n && __ldg(values + v0 + x + 1) < v) bad |= 1u << i;
          }
        }
        if (bad) atomicOr(&unsorted[slot], bad);
        const bool staged = row_ok && __shfl_sync(0xffffffffu, fits, rib);
        r_lo = __shfl_sync(0xffffffffu, p_lo, rib);
        r_hi = __shfl_sync(0xffffffffu, p_hi, rib);
        s_start = __shfl_sync(0xffffffffu, start, rib);
        __syncthreads();
        // a sorted staged segment whose n_iter rounds close every window
        // (floor(log2 n) + 1 of them) has one lower bound, which any
        // search finds: the fixed-step one below.  (Below 2^30, l + h
        // never wraps, so the reference's rounds find it too.)
        const int32_t n = r_hi - r_lo;
        const int need = n > 0 ? 32 - __clz(n) : 0;
        fast = staged && !((unsorted[slot] >> rib) & 1u) && n_iter >= need &&
               r_hi <= (1 << 30);
      }
      int32_t res[kLanes];
      bool hit[kLanes];
      if (fast) {
        // branchless lower bound in seg[s0 .. s0 + n): the step sizes
        // depend on n alone, so the loop is the same for every lane
        const int32_t n = r_hi - r_lo;
        const int32_t* a = seg + s_start;
        int32_t b[kLanes];
#pragma unroll
        for (int j = 0; j < kLanes; ++j) b[j] = 0;
        for (int32_t rest = n; rest > 1;) {
          const int32_t half = rest >> 1;
#pragma unroll
          for (int j = 0; j < kLanes; ++j)
            b[j] = a[b[j] + half] < q[j] ? b[j] + half : b[j];
          rest -= half;
        }
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          const int32_t k = n > 0 && a[b[j]] < q[j] ? b[j] + 1 : b[j];
          res[j] = r_lo + k;
          hit[j] = k < n && a[k] == q[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          if (per_row) {
            l[j] = r_lo;
            h0[j] = r_hi;
          }
          h[j] = h0[j];
        }
        search_rounds(values, last, n_iter, l, h, q);
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          res[j] = l[j];
          hit[j] = l[j] < h0[j] &&
                   __ldg(values + min(max(l[j], 0), last)) == q[j];
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int64_t c0 = base + kVec * (t + int64_t{tpr} * g);
        if (!row_ok || c0 >= width) continue;
        const int j = kVec * g;
        if (vec) {
          *reinterpret_cast<int4*>(pos + r * width + c0) =
              make_int4(res[j], res[j + 1], res[j + 2], res[j + 3]);
          *reinterpret_cast<uint32_t*>(found + r * width + c0) =
              static_cast<uint32_t>(hit[j]) |
              static_cast<uint32_t>(hit[j + 1]) << 8 |
              static_cast<uint32_t>(hit[j + 2]) << 16 |
              static_cast<uint32_t>(hit[j + 3]) << 24;
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            if (c0 + e >= width) break;
            pos[r * width + c0 + e] = res[j + e];
            found[r * width + c0 + e] = static_cast<uint8_t>(hit[j + e]);
          }
        }
      }
    }
    __syncthreads();  // the next group restages the shared segment
  }
}

}  // namespace

extern "C" int searchsorted_segments_launch(
    const void* values, int64_t m,
    const void* lo, int64_t lo_s0, int64_t lo_s1,
    const void* hi, int64_t hi_s0, int64_t hi_s1,
    const void* queries, int64_t rows, int64_t width, int n_iter,
    void* pos, void* found, void* stream) {
  if (rows * width == 0) return 0;
  // rows per block: about 4 lanes a thread, between 1 and kMaxRows
  int rpb = 1;
  while (rpb < kMaxRows && int64_t{2} * rpb * width <= 4 * kThreads) rpb *= 2;
  // 16-byte loads of the queries and stores of pos, 4-byte ones of found
  const int vec = width % kVec == 0 &&
                  reinterpret_cast<uintptr_t>(queries) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(pos) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(found) % 4 == 0;
  int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  searchsorted_segments_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(values), m,
      static_cast<const int32_t*>(lo), lo_s0, lo_s1,
      static_cast<const int32_t*>(hi), hi_s0, hi_s1,
      static_cast<const int32_t*>(queries), rows, width, n_iter, rpb, vec,
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(found));
  return static_cast<int>(cudaGetLastError());
}
