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
//  * bitset_member_mask_launch: found[r, c] = c < lane_len[r] and bit
//    (cand & 31) of words[row[r], cand >> 5], with row clamped to
//    [0, H-1] and cand >> 5 to [0, NW-1] as the JAX gathers clamp, and
//    lane_len clamped to [0, W] (every lane where lane_len is null).  This
//    is what the level step launches, with lane_len the probe degrees.
//  * bitset_member_count_launch: out[r] = number of valid b[r, j]
//    (j < b_len[r]) whose bit is set in words[r, :], exactly what
//    bitset_member_count_pallas computes.
//
// Bitset words arrive as int32 bit patterns (the PyTorch side stores the
// uint32 words as int32, since torch.uint32 has only partial operator
// support) and are read here as uint32_t: the same 32 bits.
//
// What bounds it on the H100: bytes.  The mask writes one byte a lane (the
// 4.2 MB mask of a 2048 x 2048 chunk) and reads a candidate and a word for
// each live lane; at the path's degrees most lanes of a chunk are dead (a
// probe segment holds tens of values in a 2048-lane row), so with lane_len
// the mask's write is nearly all of it.  The word matrix (18.8 MB at the
// largest configuration the port runs) stays in the 50 MB L2, so a gather
// costs latency rather than bandwidth.
//
// Design.  Mask: a warp owns a 256-lane slice of one row: it reads row[r]
// and lane_len[r] once (one division per slice, none per lane) and clamps
// them once; each thread then owns 8 consecutive lanes: two int4
// candidate loads (only those holding a live lane), one gather per live
// lane, and one 8-byte store of the 8 result bytes, zeros past lane_len.
// Rows whose width is not a multiple of 8 or whose candidates are not
// 16-byte aligned take a lane-a-thread loop with the same contract.  The
// word row (9.7 KB at 2,418 words) is not staged in shared memory: a row's
// live lanes read a few dozen distinct words of it, so staging would read
// the whole row to use a few percent of it.  Count: 128 threads a row, two
// rows a block, a lane a thread up to min(b_len[r], LB); the sum is a fixed
// shuffle tree and a pass over the row's four warps in shared memory, with
// no atomics, so the result is deterministic.  (Timed on the card at the
// path's hub chunk: 8 lanes a thread beat 16 and 4 in the mask, and 128
// threads a row with scalar loads beat a warp a row and int4 loads in the
// count.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kLanesPerThread = 8;  // two int4 candidate loads
constexpr int kSlice = 32 * kLanesPerThread;  // lanes a warp item covers

// lane count clamped to [0, hi]
__device__ __forceinline__ int64_t clamp_len(int32_t n, int64_t hi) {
  const int64_t x = n < 0 ? 0 : n;
  return x < hi ? x : hi;
}

__device__ __forceinline__ uint32_t word_bit(const uint32_t* __restrict__ wrow,
                                             int32_t w_last, int32_t q) {
  const int32_t wi = min(max(q >> 5, 0), w_last);
  return (__ldg(wrow + wi) >> (q & 31)) & 1u;
}

// kVec: width % 8 == 0 and cand 16-byte aligned
template <bool kVec>
__global__ void __launch_bounds__(kThreads) bitset_member_mask_kernel(
    const uint32_t* __restrict__ words, int64_t n_rows_words, int64_t n_words,
    const int32_t* __restrict__ row, const int32_t* __restrict__ cand,
    const int32_t* __restrict__ lane_len, int64_t rows, int64_t width,
    uint8_t* __restrict__ found) {
  const int32_t h_last = static_cast<int32_t>(n_rows_words - 1);
  const int32_t w_last = static_cast<int32_t>(n_words - 1);
  const int lane = threadIdx.x & 31;
  const int64_t slices = (width + kSlice - 1) / kSlice;
  const int64_t items = rows * slices;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
       it < items; it += stride) {
    const int64_t r = it / slices;
    const int64_t s0 = (it - r * slices) * kSlice;
    const int32_t h = min(max(__ldg(row + r), 0), h_last);
    const int64_t live =
        lane_len == nullptr ? width : clamp_len(__ldg(lane_len + r), width);
    const uint32_t* wrow = words + static_cast<int64_t>(h) * n_words;
    const int32_t* crow = cand + r * width;
    uint8_t* frow = found + r * width;
    const int64_t end = s0 + kSlice < width ? s0 + kSlice : width;
    if constexpr (kVec) {
      const int64_t j0 = s0 + kLanesPerThread * lane;
      if (j0 >= end) continue;
      uint32_t out[2];  // the 8 result bytes
#pragma unroll
      for (int gq = 0; gq < 2; ++gq) {
        const int64_t j = j0 + 4 * gq;
        uint32_t packed = 0u;
        if (j < live) {
          const int4 c4 = __ldg(reinterpret_cast<const int4*>(crow + j));
          const int32_t cs[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j + e < live)
              packed |= word_bit(wrow, w_last, cs[e]) << (8 * e);
        }
        out[gq] = packed;
      }
      *reinterpret_cast<uint2*>(frow + j0) = make_uint2(out[0], out[1]);
    } else {
      for (int64_t j = s0 + lane; j < end; j += 32)
        frow[j] = j < live ? static_cast<uint8_t>(word_bit(wrow, w_last,
                                                           crow[j]))
                           : uint8_t{0};
    }
  }
}

// kGroup threads share a row (kThreads / kGroup rows a block), a lane a
// thread; each sums its lanes, then the group sums by a fixed shuffle tree
// and, across its warps, in shared memory.
constexpr int kGroup = 128;
__global__ void __launch_bounds__(kThreads) bitset_member_count_kernel(
    const uint32_t* __restrict__ words, int64_t n_words,
    const int32_t* __restrict__ b, int64_t rows, int64_t lb,
    const int32_t* __restrict__ b_len, int32_t* __restrict__ out) {
  constexpr int kRowsPerBlock = kThreads / kGroup;
  constexpr int kWarpsPerGroup = kGroup / 32;
  const int32_t w_last = static_cast<int32_t>(n_words - 1);
  const int gt = threadIdx.x % kGroup;  // thread within the row's group
  const int grp = threadIdx.x / kGroup;
  __shared__ int32_t part[kWarpsPerBlock];
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
       r0 < rows; r0 += static_cast<int64_t>(gridDim.x) * kRowsPerBlock) {
    const int64_t r = r0 + grp;
    int32_t hits = 0;
    if (r < rows) {
      // padded lanes never count (the reference tests bit 0 for them)
      const int64_t len = clamp_len(b_len[r], lb);
      const uint32_t* wrow = words + r * n_words;
      const int32_t* brow = b + r * lb;
      for (int64_t j = gt; j < len; j += kGroup)
        hits += static_cast<int32_t>(word_bit(wrow, w_last, __ldg(brow + j)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      hits += __shfl_xor_sync(0xffffffffu, hits, off);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = hits;
    __syncthreads();
    if (gt == 0 && r < rows) {
      hits = 0;
#pragma unroll
      for (int w = 0; w < kWarpsPerGroup; ++w)
        hits += part[grp * kWarpsPerGroup + w];
      out[r] = hits;
    }
    __syncthreads();
  }
}

unsigned grid_for(int64_t warps) {
  int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (int64_t{1} << 30)) blocks = int64_t{1} << 30;
  return static_cast<unsigned>(blocks);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// lane_len: (rows,) int32 or null (every lane live).
extern "C" int bitset_member_mask_launch(
    const void* words, int64_t n_rows_words, int64_t n_words,
    const void* row, const void* cand, const void* lane_len, int64_t rows,
    int64_t width, void* found, void* stream) {
  if (rows == 0 || width == 0) return 0;
  const int64_t items = rows * ((width + kSlice - 1) / kSlice);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* rw = static_cast<const int32_t*>(row);
  const auto* c = static_cast<const int32_t*>(cand);
  const auto* ll = static_cast<const int32_t*>(lane_len);
  auto* f = static_cast<uint8_t*>(found);
  if (width % kLanesPerThread == 0 && aligned16(cand) && aligned16(found))
    bitset_member_mask_kernel<true><<<grid_for(items), kThreads, 0, s>>>(
        w, n_rows_words, n_words, rw, c, ll, rows, width, f);
  else
    bitset_member_mask_kernel<false><<<grid_for(items), kThreads, 0, s>>>(
        w, n_rows_words, n_words, rw, c, ll, rows, width, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitset_member_count_launch(
    const void* words, int64_t n_words, const void* b, int64_t rows,
    int64_t lb, const void* b_len, void* out, void* stream) {
  if (rows == 0) return 0;
  bitset_member_count_kernel<<<grid_for(rows * (kGroup / 32)), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const int32_t*>(b), rows, lb,
      static_cast<const int32_t*>(b_len), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
