// The gradient of flash attention (causal, GQA) on the tensor cores through
// warp-level mma.sync, written by hand for Hopper (sm_90a): (dq, dk, dv)
// from q, k, v, the forward's output o, its cotangent do and the
// log-sum-exp the forward saved.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and
// differentiates its plain jnp attention (src/repro/kernels/ops.py,
// flash_attention without Pallas; src/repro/kernels/ref.py,
// flash_attention_ref).  It is the gradient of the forward kernels of
// src/repro/kernels/flash_attention.py, flash_attention_pallas, on the
// forward's "mma" route (flash_attention.cu; kernels/flash_attention.py,
// route()): float32 at any head dim, and bf16 at a head dim that is not a
// multiple of 16.  bf16 at the multiples of 16 runs
// flash_attention_bwd_tc.cu (wgmma).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, flash_attention_bwd_ref.
//
// The contract is the forward's: q, o and do (B, Hq, Tq, D), k and v
// (B, Hkv, Tk, D), f32 or bf16, all alike; any strides for the first three
// dims (the last one contiguous), so the transposed (B, T, H, D) views of
// the caller cost no copy; 1 <= D <= 128; query head h reads KV head
// h / (Hq / Hkv); the queries are the last Tq positions of the Tk stream
// (q_offset = Tk - Tq).  lse float32 (B, Hq, Tq) from the forward: each
// row's log-sum-exp of its scaled scores in log2 units, +inf for a row
// that sees no key.  dq (B, Hq, Tq, D), dk and dv (B, Hkv, Tk, D) are
// written contiguous in the inputs' dtype.
//
// FlashAttention-2's backward in two kernels (three where the dk/dv grid
// is split), with no atomics, so two calls on the same inputs give the
// same bits:
//  * flash_attention_bwd_mma_dq_kernel, one block per (b, hq, query
//    tile), the heaviest causal tiles first: Delta = rowsum(do * o) of
//    its rows, stored to a float32 (B, Hq, Tq) buffer for the second
//    kernel; Q and dO stay in shared memory while the block walks the
//    visible key tiles: S = Q K^T, dP = dO V^T, P = 2^(S scale log2 e -
//    lse), dS = P (dP - Delta), dQ += dS K.  dq is stored times scale.
//  * flash_attention_bwd_mma_dkdv_kernel, one block per (key tile, b,
//    hkv, head split), the first key tiles (the most queries) first: K
//    and V stay in shared memory; the block walks its query heads of the
//    GQA group and, for each, the query tiles on or below the diagonal:
//    S^T = K Q^T and dP^T = V dO^T with keys as rows, P^T and dS^T, then
//    dV += P^T dO and dK += dS^T Q.  dk is stored times scale.
//  * flash_attention_bwd_mma_reduce_kernel, only where the wrapper splits
//    a group's query heads over several dk/dv blocks (a grid below the
//    card's SM count): each block wrote float32 partials of its heads;
//    this sums them in split order.
// So seven products: S and dP in each of the two kernels, then dQ, dK, dV.
//
// A block is eight warps in float32 and four in bf16 (eight in bf16 were
// slower: fewer blocks fit an SM); each warp owns 16 rows of the resident
// tile (queries in the dq kernel, keys in the dk/dv kernel: the M of every
// mma), so a block holds 128 or 64.  The streamed tiles (K and V, or Q and
// dO with their rows' lse and Delta: 32 rows, 64 in bf16 up to D 80) run
// through a two-stage ring of cp.async copies, as wide as the tensors'
// alignment allows (16, 8 or 4 bytes; 2-byte plain loads for a bf16 row
// of odd length or stride: the wrapper's copy_width picks), so the next
// tile loads while this one is multiplied, with one barrier a tile.
// Every operand is staged once, in its own dtype; D is padded to the
// width of the smallest template instance that holds it (32, 64, 80 or
// 128), whose padded columns are zero, and every staged row ends in 16
// bytes of padding, which keeps the fragment loads free of bank
// conflicts.  Every product is one of the forward's two shapes
// (mma_sm80.cuh):
//  * A B^T over D, both operands rows of a shared tile (S, dP, S^T, dP^T);
//  * P B over the streamed or resident rows, P from the registers of an
//    S-shaped accumulator, B a shared tile with D contiguous (dQ = dS K,
//    dV = P^T dO, dK = dS^T Q): the accumulator of an m16n8 product is,
//    element for element, the A fragment of the next one, so P, dS, P^T
//    and dS^T never touch shared memory.
//  * bf16: mma.sync.m16n8k16 with f32 accumulators, fragments by ldmatrix
//    (.trans for the B of the second shape); P and dS are rounded to bf16
//    on their way into the fragment, as the tc backward rounds them.
//  * f32: 3xTF32 on mma.sync.m16n8k8: each operand is split in registers
//    on its way into the fragment as x = hi + lo (both TF32), and a
//    product is lo.hi + hi.lo + hi.hi, float32 accuracy (1xTF32 keeps
//    about 3 decimal digits).  P and dS stay float32 and are split too.
//    The m16n8k8 A fragment holds columns t and t + 4 where the
//    accumulator holds 2t and 2t + 1, so the second shape runs over its
//    rows in that permuted order, as the forward's P V does.  The tensor
//    cores do not round their sums to nearest, an error that grows with
//    the products summed into one accumulator: summed over a GQA group's
//    whole query range, dK and dV landed 2e-4 of their largest |want|
//    from the plain version (the tolerance is 2e-5).  So each call of the
//    second shape sums its tile's products apart and adds them in
//    float32.
//
// Causal: tiles wholly above the diagonal are never loaded (the dq kernel
// stops at the block's last visible key tile, the dk/dv kernel starts at
// the first query tile that sees its keys), a warp skips a tile wholly
// above its own rows, and only tiles that straddle the diagonal, pass Tk
// or pass Tq are masked elementwise (P = 0).  A row that sees no key has
// lse +inf, so its P and dS are 0 and it carries no gradient.
//
// What bounds it on the H100: five products of the causal Tq x Tk x D work
// (S, dP, dV, dK, dQ), 2 B Hq D flops each per visible (query, key) pair.
// In float32 at the forward's f32 path shape (B 4, Hq 32, Hkv 2, T 2048,
// D 128) that is 3.44e11 flops: 2.08 ms as 3xTF32 at 495 TFLOP/s, 5.13 ms
// on FFMA (67 TFLOP/s); the bytes take 0.17 ms.  In bf16 at D 72 with
// stablelm-3b's heads (B 1, Hq = Hkv = 32, T 4096) 1.93e11 flops, 0.195 ms
// at 989 TFLOP/s.  This kernel runs seven products, not five (S and dP
// again in the dq kernel: the price of no atomics), on mma.sync, which
// reaches only part of the tensor cores' rate on Hopper (wgmma is needed
// for all of it), with the 3xTF32 splits as ALU work beside each product.
#include <cmath>

#include "mma_sm80.cuh"

namespace {

constexpr int kStages = 2;  // streamed tiles' ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kDepth = 16;   // mma k: m16n8k16
  static constexpr int kLdExtra = 8;  // row stride = padded D + 8 (16 bytes)
  static constexpr int kWarps = 4;    // a block's warps, 16 resident rows each
  // the dq kernel's blocks an SM must hold, which caps its registers: on
  // one block's cap bf16's D 80 instance ran 13% slower (204 registers,
  // not 166), float32's D 128 one 14% faster (203, not 165)
  static constexpr int kDqBlocks = 3;
};
template <>
struct Traits<float> {
  static constexpr int kDepth = 8;    // m16n8k8 tf32
  static constexpr int kLdExtra = 4;  // row stride = padded D + 4 (16 bytes)
  static constexpr int kWarps = 8;
  static constexpr int kDqBlocks = 1;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows a streamed tile holds: 32, or 64 for bf16 up to D 80, so that the
// two S-shaped accumulators and the two D-wide ones of the dk/dv kernel
// stay in registers.
template <typename T, int DP>
__host__ __device__ constexpr int streamed_rows() {
  return sizeof(T) == 2 && DP <= 80 ? 64 : 32;
}

// acc[j] += A B_j^T over the DP columns: A the 16 rows at `a`, B_j rows
// 8 j .. 8 j + 7 at `b` (both row stride kLd).
template <typename T, int DP, int kNT, int kLd>
__device__ __forceinline__ void product_abt(float (&acc)[kNT][4], const T* a,
                                            const T* b, int lane) {
  constexpr int kDepth = Traits<T>::kDepth;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < DP / kDepth; ++s) {
    if constexpr (sizeof(T) == 2) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (lane & 15) * kLd + 16 * s + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) *
                                kLd + 16 * s + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
      }
    } else {
      uint32_t ah[4], al[4];
      const float* r0 = a + g * kLd + 8 * s + t;
      const float av[4] = {r0[0], r0[8 * kLd], r0[4], r0[8 * kLd + 4]};
      split_tf32(av, ah, al);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* br = b + (8 * j + g) * kLd + 8 * s + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(br[0], bh0, bl0);
        split_tf32(br[4], bh1, bl1);
        mma_3xtf32(acc[j], ah, al, bh0, bl0, bh1, bl1);
      }
    }
  }
}

// acc += P B: P (16 x 8 kNT) in the accumulator layout of product_abt, B
// the 8 kNT rows at `b` (row stride kLd) over the DP columns.
template <typename T, int DP, int kNT, int kLd>
__device__ __forceinline__ void product_pb(float (&acc)[DP / 8][4],
                                           const float (&p)[kNT][4],
                                           const T* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                              pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                              pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                              pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, b + (16 * kk + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                  16 * dp + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
  } else {
    // A columns t and t + 4 are rows 2t and 2t + 1 of each slice of B
    uint32_t ah[kNT][4], al[kNT][4];
#pragma unroll
    for (int kk = 0; kk < kNT; ++kk) {
      const float pv[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      split_tf32(pv, ah[kk], al[kk]);
    }
    // The tensor cores add into their accumulator without float32's
    // round-to-nearest, an error that grows with the products summed into
    // one accumulator (the dk/dv kernel sums a GQA group's whole query
    // range): so this tile's products are summed apart, two n-tiles at a
    // time, and added to acc in float32.
#pragma unroll
    for (int dn0 = 0; dn0 < DP / 8; dn0 += 2) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        const float* br = b + (8 * kk + 2 * t) * kLd + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(br[8 * (dn0 + i)], bh0, bl0);
          split_tf32(br[kLd + 8 * (dn0 + i)], bh1, bl1);
          mma_3xtf32(part[i], ah[kk], al[kk], bh0, bl0, bh1, bl1);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dn0 + i][e] += part[i][e];
    }
  }
}

// Zeroes the padded columns [d, DP) of the block's n_rows staged rows
// once: the copies write only [0, d).
template <typename T, int DP, int kLd, int kThreads>
__device__ __forceinline__ void zero_pad(T* rows, int n_rows, int d,
                                         int tid) {
  const int pad = DP - d;
  for (int i = tid; i < n_rows * pad; i += kThreads) {
    const int r = i / pad;
    if constexpr (sizeof(T) == 2) {
      reinterpret_cast<uint16_t*>(rows)[r * kLd + d + i - r * pad] = 0;
    } else {
      rows[r * kLd + d + i - r * pad] = 0.f;
    }
  }
}

// Stores rows r and r + 8 (i = 0, 1) of a 16 x DP accumulator times `mul`
// to a contiguous (rows, d) matrix at `out`, rows at or past `limit` and
// columns at or past d left out.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[DP / 8][4],
                                           int r, int limit, int d, int t,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r + 8 * i;
    if (row >= limit) continue;
    T* p = out + static_cast<int64_t>(row) * d;
#pragma unroll
    for (int dn = 0; dn < DP / 8; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col < d) store(p + col, acc[dn][2 * i] * mul);
      if (col + 1 < d) store(p + col + 1, acc[dn][2 * i + 1] * mul);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * Traits<T>::kWarps,
                                  Traits<T>::kDqBlocks)
    flash_attention_bwd_mma_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta_out,
    T* __restrict__ dq, int hq, int hkv, int tq, int tk, int d, int n_qb,
    Strides qs, Strides ks, Strides vs, Strides os, Strides dos, float scale,
    int causal, int vec) {
  constexpr int kThreads = 32 * Traits<T>::kWarps;
  constexpr int kRows = 16 * Traits<T>::kWarps;  // queries a block
  constexpr int kBN = streamed_rows<T, DP>();    // keys a streamed tile
  constexpr int kLd = DP + Traits<T>::kLdExtra;
  constexpr int kNT = kBN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd] queries
  T* sdo = sq + kRows * kLd;               // [kRows][kLd] their cotangents
  T* ring = sdo + kRows * kLd;             // stage s: K, then V, [kBN][kLd]

  // heaviest query tiles first: blockIdx.x runs over (b, h) fastest
  const int n_bh = static_cast<int>(gridDim.x) / n_qb;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  const int q0 = qb * kRows, q_offset = tk - tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  if (d < DP)
    zero_pad<T, DP, kLd, kThreads>(sq, 2 * kRows + 2 * kStages * kBN, d,
                                   tid);
  int n_kb = (tk + kBN - 1) / kBN;
  if (causal) {
    const int last = q_offset + q0 + kRows - 1;  // the tile's last position
    n_kb = last < 0 ? 0 : min(n_kb, last / kBN + 1);
  }
  // one group: Q, dO and key tile 0
  const int per_row = d * static_cast<int>(sizeof(T)) / vec;
  stage_rows<T, kRows, kLd, kThreads>(sq, q + b * qs.b + h * qs.h, qs.t, q0,
                                      tq, per_row, vec, tid);
  stage_rows<T, kRows, kLd, kThreads>(sdo, dout + b * dos.b + h * dos.h,
                                      dos.t, q0, tq, per_row, vec, tid);
  if (n_kb > 0) {
    stage_rows<T, kBN, kLd, kThreads>(ring, kp, ks.t, 0, tk, per_row, vec,
                                      tid);
    stage_rows<T, kBN, kLd, kThreads>(ring + kBN * kLd, vp, vs.t, 0, tk,
                                      per_row, vec, tid);
  }
  cp_async_commit();

  // this thread's rows r0 + g and r0 + g + 8: their lse (+inf past Tq) and
  // Delta over the quad's columns t, t + 4, ..., summed over the quad
  const int r0 = q0 + 16 * warp;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    float part = 0.f;
    lse_r[i] = INFINITY;
    if (row < tq) {
      lse_r[i] = lse[static_cast<int64_t>(bh) * tq + row];
      const T* orow = o + b * os.b + h * os.h + row * os.t;
      const T* drow = dout + b * dos.b + h * dos.h + row * dos.t;
      for (int c = t; c < d; c += 4)
        part = fmaf(widen(orow[c]), widen(drow[c]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[i] = part;
    if (t == 0 && row < tq)
      delta_out[static_cast<int64_t>(bh) * tq + row] = part;
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const T* sqw = sq + 16 * warp * kLd;  // this warp's query rows
  const T* sdow = sdo + 16 * warp * kLd;

  for (int kb = 0; kb < n_kb; ++kb) {
    // tile kb has landed and every warp is done with tile kb - 1, whose
    // stage the next tile refills while this one is multiplied
    cp_async_wait<0>();
    __syncthreads();
    if (kb + 1 < n_kb) {
      T* nk = ring + ((kb + 1) % kStages) * 2 * kBN * kLd;
      stage_rows<T, kBN, kLd, kThreads>(nk, kp, ks.t, (kb + 1) * kBN, tk,
                                        per_row, vec, tid);
      stage_rows<T, kBN, kLd, kThreads>(nk + kBN * kLd, vp, vs.t,
                                        (kb + 1) * kBN, tk, per_row, vec,
                                        tid);
    }
    cp_async_commit();

    const int k0 = kb * kBN;
    const T* sk = ring + (kb % kStages) * 2 * kBN * kLd;
    const T* sv = sk + kBN * kLd;
    // a tile wholly above this warp's rows adds nothing
    if (causal && k0 > q_offset + r0 + 15) continue;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    product_abt<T, DP, kNT, kLd>(s, sqw, sk, lane);    // S = Q K^T
    product_abt<T, DP, kNT, kLd>(dp, sdow, sv, lane);  // dP = dO V^T
    const bool edge =
        k0 + kBN > tk || (causal && k0 + kBN - 1 > q_offset + r0);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = fast_exp2(fmaf(s[j][e], scale_log2, -lse_r[i]));
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= tk || (causal && key > q_offset + r0 + g + 8 * i))
            p = 0.f;
        }
        dp[j][e] = p == 0.f ? 0.f : p * (dp[j][e] - delta_r[i]);
      }
    product_pb<T, DP, kNT, kLd>(acc, dp, sk, lane);  // dQ += dS K
  }
  cp_async_wait<0>();
  store_rows<T, DP>(dq + static_cast<int64_t>(bh) * tq * d, acc, r0 + g, tq,
                    d, t, scale);
}

template <typename T, int DP>
__global__ void __launch_bounds__(32 * Traits<T>::kWarps, 1)
    flash_attention_bwd_mma_dkdv_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
        int hq, int hkv, int tq, int tk, int d, int n_bkv, int n_split,
        Strides qs, Strides ks, Strides vs, Strides dos, float scale,
        int causal, int vec) {
  constexpr int kThreads = 32 * Traits<T>::kWarps;
  constexpr int kRows = 16 * Traits<T>::kWarps;  // keys a block
  constexpr int kBN = streamed_rows<T, DP>();    // queries a streamed tile
  constexpr int kLd = DP + Traits<T>::kLdExtra;
  constexpr int kNT = kBN / 8;
  constexpr int kStage = 2 * kBN * kLd;  // Q, then dO
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd] keys
  T* sv = sk + kRows * kLd;                // [kRows][kLd] values
  T* ring = sv + kRows * kLd;              // stage s: Q, then dO, [kBN][kLd]
  // stage s: the lse, then the Delta, of its kBN queries
  float* stats = reinterpret_cast<float*>(ring + kStages * kStage);

  const int per_kb = n_bkv * n_split;
  const int kb = static_cast<int>(blockIdx.x) / per_kb;
  const int rest = static_cast<int>(blockIdx.x) % per_kb;
  const int bkv = rest / n_split, split = rest % n_split;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv, heads = group / n_split;
  const int h0 = kvh * group + split * heads;  // this block's first head
  const int k0 = kb * kRows, q_offset = tk - tq;
  const int n_qt = (tq + kBN - 1) / kBN;
  // the first query tile holding a position at or past k0 (causal)
  const int qt0 = causal ? max(0, k0 - q_offset) / kBN : 0;
  const int nq = max(0, n_qt - qt0);
  const int n_it = heads * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;

  if (d < DP)
    zero_pad<T, DP, kLd, kThreads>(sk, 2 * kRows + 2 * kStages * kBN, d,
                                   tid);
  const int per_row = d * static_cast<int>(sizeof(T)) / vec;
  // iteration it's tile (head h0 + it / nq, query tile qt0 + it % nq) into
  // stage s: Q and dO rows, and the rows' lse and Delta (zero past Tq,
  // where the mask takes over)
  const auto stage_tile = [&](int it, int s) {
    const int h = h0 + it / nq, q0 = (qt0 + it % nq) * kBN;
    T* st = ring + s * kStage;
    stage_rows<T, kBN, kLd, kThreads>(st, q + b * qs.b + h * qs.h, qs.t, q0,
                                      tq, per_row, vec, tid);
    stage_rows<T, kBN, kLd, kThreads>(st + kBN * kLd,
                                      dout + b * dos.b + h * dos.h, dos.t,
                                      q0, tq, per_row, vec, tid);
    if (tid < 2 * kBN) {
      const int i = tid % kBN;
      const bool ok = q0 + i < tq;
      const float* src = (tid < kBN ? lse : delta) +
                         (static_cast<int64_t>(b) * hq + h) * tq +
                         (ok ? q0 + i : 0);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(stats + s * 2 * kBN + tid)),
                   "l"(src), "r"(ok ? 4 : 0));
    }
  };
  // one group: K, V and the first query tile
  stage_rows<T, kRows, kLd, kThreads>(sk, k + b * ks.b + kvh * ks.h, ks.t,
                                      k0, tk, per_row, vec, tid);
  stage_rows<T, kRows, kLd, kThreads>(sv, v + b * vs.b + kvh * vs.h, vs.t,
                                      k0, tk, per_row, vec, tid);
  if (n_it > 0) stage_tile(0, 0);
  cp_async_commit();

  const int kw = k0 + 16 * warp;  // this warp's first key
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  const T* skw = sk + 16 * warp * kLd;  // this warp's key rows
  const T* svw = sv + 16 * warp * kLd;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) stage_tile(it + 1, (it + 1) % kStages);
    cp_async_commit();

    const int q0 = (qt0 + it % nq) * kBN;
    const T* sq = ring + (it % kStages) * kStage;
    const T* sdo = sq + kBN * kLd;
    const float* slse = stats + (it % kStages) * 2 * kBN;
    const float* sdelta = slse + kBN;
    // every query of the tile lies before this warp's keys
    if (causal && kw > q_offset + q0 + kBN - 1) continue;

    float st[kNT][4], dpt[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    product_abt<T, DP, kNT, kLd>(st, skw, sq, lane);    // S^T = K Q^T
    product_abt<T, DP, kNT, kLd>(dpt, svw, sdo, lane);  // dP^T = V dO^T
    const bool edge = q0 + kBN > tq || (causal && kw + 15 > q_offset + q0);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);  // the query in the tile
        float p = fast_exp2(fmaf(st[j][e], scale_log2, -slse[c]));
        if (edge && (q0 + c >= tq ||
                     (causal && kw + g + 8 * (e >> 1) > q_offset + q0 + c)))
          p = 0.f;
        st[j][e] = p;
        dpt[j][e] = p == 0.f ? 0.f : p * (dpt[j][e] - sdelta[c]);
      }
    product_pb<T, DP, kNT, kLd>(dv_acc, st, sdo, lane);  // dV += P^T dO
    product_pb<T, DP, kNT, kLd>(dk_acc, dpt, sq, lane);  // dK += dS^T Q
  }
  cp_async_wait<0>();

  const int64_t base = static_cast<int64_t>(bkv) * tk * d;
  if (n_split == 1) {
    store_rows<T, DP>(dk + base, dk_acc, kw + g, tk, d, t, scale);
    store_rows<T, DP>(dv + base, dv_acc, kw + g, tk, d, t, 1.f);
    return;
  }
  // float32 partials of this split's heads, summed by the reduce kernel
  const int64_t n = static_cast<int64_t>(n_bkv) * tk * d;
  float* pk = part + 2 * split * n + base;
  store_rows<float, DP>(pk, dk_acc, kw + g, tk, d, t, 1.f);
  store_rows<float, DP>(pk + n, dv_acc, kw + g, tk, d, t, 1.f);
}

// dk and dv from the splits' float32 partials (split s: dk at part[2 s n],
// dv at part[(2 s + 1) n]), summed in split order: dk times scale.
template <typename T>
__global__ void flash_attention_bwd_mma_reduce_kernel(
    const float* __restrict__ part, T* __restrict__ dk, T* __restrict__ dv,
    int64_t n, int n_split, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < n_split; ++s) {
      sk += part[2 * s * n + i];
      sv += part[(2 * s + 1) * n + i];
    }
    store(dk + i, sk * scale);
    store(dv + i, sv);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* part;
  int64_t b, hq, hkv, tq, tk, d;
  Strides qs, ks, vs, os, dos;
  int n_split;
  float scale;
  int causal, vec;
};

// The instance for head dims up to DP: the dq kernel, the dk/dv kernel,
// and the reduce kernel where the group is split.
template <typename T, int DP>
int launch(const Args& x, cudaStream_t stream) {
  constexpr int kThreads = 32 * Traits<T>::kWarps;
  constexpr int kRows = 16 * Traits<T>::kWarps;
  constexpr int kBN = streamed_rows<T, DP>();
  constexpr size_t kRow = sizeof(T) * (DP + Traits<T>::kLdExtra);
  const int64_t n_qb = (x.tq + kRows - 1) / kRows;
  const int64_t n_kb = (x.tk + kRows - 1) / kRows;
  const int64_t n_bkv = x.b * x.hkv;
  const int64_t blocks_q = x.b * x.hq * n_qb;
  const int64_t blocks_kv = n_bkv * x.n_split * n_kb;
  if (blocks_q == 0 || blocks_kv == 0) return 0;
  if (blocks_q >= (int64_t{1} << 31) || blocks_kv >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_q = kRow * (2 * kRows + 2 * kStages * kBN);
  const size_t smem_kv = smem_q + sizeof(float) * kStages * 2 * kBN;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_mma_dq_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_mma_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hq = static_cast<int>(x.hq), hkv = static_cast<int>(x.hkv);
  const int tq = static_cast<int>(x.tq), tk = static_cast<int>(x.tk);
  const int d = static_cast<int>(x.d);
  flash_attention_bwd_mma_dq_kernel<T, DP>
      <<<static_cast<unsigned>(blocks_q), kThreads, smem_q, stream>>>(
          static_cast<const T*>(x.q), static_cast<const T*>(x.k),
          static_cast<const T*>(x.v), static_cast<const T*>(x.o),
          static_cast<const T*>(x.dout), x.lse, x.delta,
          static_cast<T*>(x.dq), hq, hkv, tq, tk, d,
          static_cast<int>(n_qb), x.qs, x.ks, x.vs, x.os, x.dos, x.scale,
          x.causal, x.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_mma_dkdv_kernel<T, DP>
      <<<static_cast<unsigned>(blocks_kv), kThreads, smem_kv, stream>>>(
          static_cast<const T*>(x.q), static_cast<const T*>(x.k),
          static_cast<const T*>(x.v), static_cast<const T*>(x.dout), x.lse,
          x.delta, static_cast<T*>(x.dk), static_cast<T*>(x.dv), x.part, hq,
          hkv, tq, tk, d, static_cast<int>(n_bkv), x.n_split, x.qs, x.ks,
          x.vs, x.dos, x.scale, x.causal, x.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || x.n_split == 1) return static_cast<int>(err);
  const int64_t n = n_bkv * x.tk * x.d;
  const int64_t blocks = (n + 255) / 256 < (int64_t{1} << 16)
                             ? (n + 255) / 256
                             : int64_t{1} << 16;
  flash_attention_bwd_mma_reduce_kernel<T>
      <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
          x.part, static_cast<T*>(x.dk), static_cast<T*>(x.dv), n, x.n_split,
          x.scale);
  return static_cast<int>(cudaGetLastError());
}

// the smallest instance that holds d: 32, 64, 80 (stablelm-3b's width,
// and 72) or 128
template <typename T>
int launch_d(const Args& x, cudaStream_t stream) {
  if (x.d <= 32) return launch<T, 32>(x, stream);
  if (x.d <= 64) return launch<T, 64>(x, stream);
  if (x.d <= 80) return launch<T, 80>(x, stream);
  return launch<T, 128>(x, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last dim
// of every input is contiguous.  lse (B, Hq, Tq) float32 from the forward
// (flash_attention_launch's lse); delta (B, Hq, Tq) float32 scratch; dq
// (B, Hq, Tq, D), dk and dv (B, Hkv, Tk, D) contiguous; n_split divides
// Hq / Hkv, and part is float32 scratch of n_split x 2 x (B, Hkv, Tk, D)
// where n_split > 1 (else null).  vec: the bytes one staging copy moves
// (16, 8 or 4; 2 in bf16 only), which must divide the base address of q,
// k, v and do, their strides in bytes and D times the element size
// (kernels/flash_attention.py, copy_width).  The wrapper checks shapes:
// Hq % Hkv == 0, 1 <= D <= 128.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int64_t b, int64_t hq, int64_t hkv, int64_t tq,
    int64_t tk, int64_t d, int64_t q_sb, int64_t q_sh, int64_t q_st,
    int64_t k_sb, int64_t k_sh, int64_t k_st, int64_t v_sb, int64_t v_sh,
    int64_t v_st, int64_t o_sb, int64_t o_sh, int64_t o_st, int64_t do_sb,
    int64_t do_sh, int64_t do_st, int n_split, float scale, int causal,
    int dtype, int vec, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0 || n_split < 1 ||
      (hq / hkv) % n_split != 0 || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  if ((vec != 16 && vec != 8 && vec != 4 && vec != 2) || vec < es ||
      (d * es) % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               static_cast<float*>(part), b, hq, hkv, tq, tk, d,
               Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
               Strides{v_sb, v_sh, v_st}, Strides{o_sb, o_sh, o_st},
               Strides{do_sb, do_sh, do_st}, n_split, scale, causal, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(x, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
