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
//  * tile_member_mask_launch: found[r, j] is true iff j < lane_len[r]
//    (every j where lane_len is null) and cand[r, j] equals one of
//    indices[lo[r] + k] for 0 <= k < check_width with lo[r] + k < hi[r]
//    (the index clamped to [0, M-1], as the reference clamps its
//    gather).  lane_len is the Pallas kernel's a_len: lanes at or past it
//    are dead, and their candidates are not used.  This is what the
//    level step launches, with lane_len = the probe degree (0 for
//    invalid rows).  Like the reference it sees only the first
//    check_width values of a segment.
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
// The mask form, and what bounds it on the H100.  At the level step's
// chunk (2048 rows of W = 2048 lanes, check_width 512) a row's live
// lanes are its probe degree: 40 at the median, so nearly all lanes are
// dead.  Over all lanes the function needs about 22 MB of candidates and
// mask (0.0064 ms at 3.35 TB/s) and some 90 M int32 operations for its
// ~log2(n) search rounds a lane (0.0053 ms): bytes bound it, narrowly.
// With lane_len only the live lanes' candidates are read, and the 4 MB
// mask (every lane is written) bounds it.  The design:
//  * a warp takes one item: 1024 lanes of one row (4096 items at the
//    chunk's 2048 rows of 2048 lanes), 8 warps a block, and a persistent
//    grid of as many blocks as fit on the SMs, each warp walking items
//    with a stride.  A row of 40 live lanes keeps 5 threads searching,
//    where a block of 256 threads a row (the first version) left 251
//    idle; splitting wide rows keeps more warps on each SM when every
//    lane is live, and an item of no live lane only writes zeros.
//    Slices of 512 and 2048 lanes, and 4 or 16 warps a block, were
//    slower on the card in one of the two contracts;
//  * each warp stages its item's check segment prefix (n = min(hi - lo,
//    check_width) values) in its own shared-memory buffer with cp.async,
//    and its next item's into a second buffer while it searches the
//    current one (one buffer where two do not fit); an item with no live
//    lane stages nothing and only writes its zeros;
//  * a thread takes eight adjacent lanes: two 16-byte loads of their
//    candidates and one 8-byte store of their mask bytes (W % 8 == 0 and
//    aligned pointers, which the engine's widths give; one lane at a
//    time otherwise).  The group that straddles lane_len loads up to
//    seven dead lanes' candidates and ignores them.  Lanes 32 apart
//    instead (one shared-memory load then serves 32 consecutive sorted
//    queries, with fewer bank conflicts) were slower on the card;
//  * the search is a branchless lower bound that halves the window
//    length: ceil(log2 n) rounds of one shared-memory load, compare and
//    select with 32-bit indices, the same rounds for every lane of the
//    row (n is per row), so no lane waits for a longer search; eight
//    independent searches a thread hide the loads' latency.  It needs no
//    padding: every probe lies inside [0, n).  Dead lanes skip it and
//    store 0.
// The count form searches B in device memory (L2-resident at the sizes
// the port runs), one block of 256 threads a row; it reduces with warp
// shuffles and one shared-memory pass, with no atomics, so counts are
// deterministic.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskWarps = 8;          // warps (items in flight) a block
constexpr int kSlice = 1024;           // lanes of a row a warp takes
constexpr int kLanes = 8;              // adjacent lanes a thread takes
constexpr int kMaxSmem = 232448;       // shared memory one block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp's work item: lanes [j0, j1) of row r, whose check segment
// starts at lo, with n values staged and the lanes below `live` live.
struct Item {
  int64_t r, j0, j1, lo;
  int n, live;
};

__device__ __forceinline__ Item item_of(int64_t t, int64_t slices,
                                        const int32_t* lo, const int32_t* hi,
                                        const int32_t* lane_len,
                                        int check_width, int64_t width) {
  Item it;
  it.r = t / slices;
  it.j0 = (t % slices) * kSlice;
  it.j1 = min(it.j0 + kSlice, width);
  it.lo = lo[it.r];
  it.n = static_cast<int>(min(max(static_cast<int64_t>(hi[it.r]) - it.lo,
                                  int64_t{0}),
                              static_cast<int64_t>(check_width)));
  const int64_t live =
      lane_len == nullptr ? width : static_cast<int64_t>(lane_len[it.r]);
  it.live = static_cast<int>(min(max(live, int64_t{0}), width));
  return it;
}

// The warp's lanes start copying the item's staged values into seg; an
// item with no live lane stages nothing.
__device__ __forceinline__ void stage(int32_t* seg, const Item& it,
                                      const int32_t* __restrict__ indices,
                                      int64_t last, int lane) {
  if (it.live <= it.j0) return;
  for (int k = lane; k < it.n; k += 32)
    cp_async4(seg + k, indices + min(max(it.lo + k, int64_t{0}), last));
}

// Membership of kLanes queries in the sorted seg[0, n), n >= 1, as one
// byte each of the result: a lower bound that halves the window length,
// base + len <= n throughout, so every probe is inside the segment; at
// the end the bound is base or base + 1.
__device__ __forceinline__ uint64_t search(const int32_t* seg, int n,
                                           const int32_t (&q)[kLanes]) {
  int base[kLanes];
#pragma unroll
  for (int e = 0; e < kLanes; ++e) base[e] = 0;
  for (int len = n; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int e = 0; e < kLanes; ++e)
      base[e] = seg[base[e] + half] < q[e] ? base[e] + half : base[e];
    len -= half;
  }
  uint64_t bits = 0;
#pragma unroll
  for (int e = 0; e < kLanes; ++e) {
    const int32_t v = seg[base[e]];
    bool hit = v == q[e];
    if (v < q[e] && base[e] + 1 < n) hit = seg[base[e] + 1] == q[e];
    bits |= static_cast<uint64_t>(hit) << (8 * e);
  }
  return bits;
}

// One item by one warp: a thread takes kLanes adjacent lanes at a time.
template <bool kVec>
__device__ __forceinline__ void mask_item(const int32_t* seg, const Item& it,
                                          const int32_t* __restrict__ crow,
                                          uint8_t* __restrict__ frow,
                                          int lane) {
  const int64_t end = min(it.j1, static_cast<int64_t>(it.live));
  for (int64_t j = it.j0 + kLanes * lane; j < it.j1; j += 32 * kLanes) {
    uint64_t bits = 0;
    if (j < end && it.n > 0) {
      int32_t q[kLanes];
      if constexpr (kVec) {
        const int4 a = *reinterpret_cast<const int4*>(crow + j);
        const int4 b = *reinterpret_cast<const int4*>(crow + j + 4);
        q[0] = a.x, q[1] = a.y, q[2] = a.z, q[3] = a.w;
        q[4] = b.x, q[5] = b.y, q[6] = b.z, q[7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < kLanes; ++e) q[e] = j + e < end ? crow[j + e] : 0;
      }
      bits = search(seg, it.n, q);
      // lanes at or past lane_len stay false
      const int64_t dead = j + kLanes - it.live;
      if (dead > 0) bits &= ~uint64_t{0} >> (8 * dead);
    }
    if constexpr (kVec) {
      *reinterpret_cast<uint64_t*>(frow + j) = bits;
    } else {
#pragma unroll
      for (int e = 0; e < kLanes; ++e)
        if (j + e < it.j1) frow[j + e] = (bits >> (8 * e)) & 1u;
    }
  }
}

// Each warp walks the items blockIdx.x * warps + warp, then every
// grid-wide warp count further.  With two buffers a warp stages its next
// item while it searches the current one.
template <bool kVec>
__global__ void __launch_bounds__(kMaskWarps * 32) tile_member_mask_kernel(
    const int32_t* __restrict__ indices, int64_t m,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    const int32_t* __restrict__ cand, const int32_t* __restrict__ lane_len,
    int64_t rows, int64_t width, int check_width, int n_bufs,
    uint8_t* __restrict__ found) {
  extern __shared__ int32_t smem[];
  const int warps = static_cast<int>(blockDim.x) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* bufs = smem + static_cast<int64_t>(warp) * n_bufs * check_width;
  const int64_t slices = (width + kSlice - 1) / kSlice;
  const int64_t items = rows * slices;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * warps;
  int64_t t = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (t >= items) return;
  const int64_t last = m - 1;
  Item cur = item_of(t, slices, lo, hi, lane_len, check_width, width);
  stage(bufs, cur, indices, last, lane);
  cp_async_commit();
  for (int i = 0; t < items; ++i, t += stride) {
    const int64_t tn = t + stride;
    Item next = cur;
    if (tn < items)
      next = item_of(tn, slices, lo, hi, lane_len, check_width, width);
    int32_t* seg = bufs + (n_bufs == 2 ? (i & 1) * check_width : 0);
    if (n_bufs == 2) {
      if (tn < items)
        stage(bufs + ((i + 1) & 1) * check_width, next, indices, last, lane);
      cp_async_commit();
      cp_async_wait<1>();  // item t's copies are done; item tn's may run
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies visible to the whole warp
    mask_item<kVec>(seg, cur, cand + cur.r * width, found + cur.r * width,
                    lane);
    __syncwarp();  // seg is read to the end before it is staged again
    if (n_bufs == 1 && tn < items) {
      stage(bufs, next, indices, last, lane);
      cp_async_commit();
    }
    cur = next;
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

// The persistent grid's size: as many blocks of the mask kernel as fit
// on all SMs at `smem` bytes each (kept for the last shape asked).
template <bool kVec>
cudaError_t mask_grid_cap(int threads, size_t smem, int64_t* cap) {
  thread_local int dev_c = -1, threads_c = -1;
  thread_local size_t smem_c = 0;
  thread_local int64_t cap_c = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_c || threads != threads_c || smem != smem_c) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_member_mask_kernel<kVec>, threads, smem);
    if (err != cudaSuccess) return err;
    dev_c = dev, threads_c = threads, smem_c = smem;
    cap_c = static_cast<int64_t>(sms) * std::max(per_sm, 1);
  }
  *cap = cap_c;
  return cudaSuccess;
}

template <bool kVec>
int launch_mask(const int32_t* indices, int64_t m, const int32_t* lo,
                const int32_t* hi, const int32_t* cand,
                const int32_t* lane_len, int64_t rows, int64_t width,
                int check_width, uint8_t* found, cudaStream_t stream) {
  // two staging buffers a warp where they fit, else one; fewer warps a
  // block where even that does not
  const size_t buf = static_cast<size_t>(check_width) * sizeof(int32_t);
  const size_t max_smem = kMaxSmem;
  const int n_bufs = 2 * buf <= max_smem ? 2 : 1;
  int warps = kMaskWarps;
  while (warps > 1 && warps * n_bufs * buf > max_smem) warps /= 2;
  const size_t smem = warps * n_bufs * buf;
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        tile_member_mask_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 32 * warps;
  int64_t cap = 0;
  const cudaError_t err = mask_grid_cap<kVec>(threads, smem, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = rows * ((width + kSlice - 1) / kSlice);
  const int64_t blocks = std::min((items + warps - 1) / warps, cap);
  tile_member_mask_kernel<kVec><<<static_cast<unsigned>(blocks), threads,
                                  smem, stream>>>(
      indices, m, lo, hi, cand, lane_len, rows, width, check_width, n_bufs,
      found);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lane_len may be null (every lane live).
extern "C" int tile_member_mask_launch(
    const void* indices, int64_t m, const void* lo, const void* hi,
    const void* cand, const void* lane_len, int64_t rows, int64_t width,
    int check_width, void* found, void* stream) {
  if (rows == 0 || width == 0) return 0;
  if (check_width < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = width % kLanes == 0 &&
                   reinterpret_cast<uintptr_t>(cand) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(found) % 8 == 0;
  const auto args = [&](auto launch) {
    return launch(static_cast<const int32_t*>(indices), m,
                  static_cast<const int32_t*>(lo),
                  static_cast<const int32_t*>(hi),
                  static_cast<const int32_t*>(cand),
                  static_cast<const int32_t*>(lane_len), rows, width,
                  check_width, static_cast<uint8_t*>(found),
                  static_cast<cudaStream_t>(stream));
  };
  return vec ? args(&launch_mask<true>) : args(&launch_mask<false>);
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
