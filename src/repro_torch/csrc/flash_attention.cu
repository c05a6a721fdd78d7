// Flash attention (causal, GQA, online softmax) on the tensor cores through
// warp-level mma.sync, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the TPU kernel body _flash_kernel).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, flash_attention_ref.  It serves what the
// wgmma kernel (flash_attention_tc.cu, bf16 with D a multiple of 16) does
// not take, as kernels/flash_attention.py, route() chooses: float32 at any
// head dim from 1 to 128 (the f32 forward and prefill), and bf16 at head
// dims that are not a multiple of 16.
//
// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), f32 or bf16, read through
// element strides for the first three dims (the last one is contiguous),
// so the (B, T, H, D) -> (B, H, T, D) transpose of the caller costs no
// copy.  Query head h of batch b reads KV head h / (Hq / Hkv) of the same
// batch.  The queries are the last Tq positions of the Tk stream
// (q_offset = Tk - Tq).  Output (B, Hq, Tq, D) contiguous, in q's dtype.
//
// Design: one block of four warps per (b * Hq + h, 128-query tile); each
// warp owns two 16-row m-tiles (the M of an mma), so that each K and V
// fragment it loads (and, in f32, splits) feeds two products.
// The query tile and a two-stage ring of K and V tiles (64 keys in bf16,
// 32 in f32) are staged in shared memory by cp.async, with copies as wide
// as the tensors' alignment allows (16, 8 or 4 bytes; 2-byte plain loads
// for a bf16 row of odd length or odd stride: the wrapper's copy_width
// picks), so the next key tile loads while this one is multiplied, with
// one barrier a tile.  D is padded in shared memory to the width of the
// smallest template instance that holds it (32, 64, 80 or 128), whose
// loops over D then have compile-time bounds; the padded columns are zero,
// so they add nothing to Q.K^T and their P.V columns are never stored.
// Keys past Tk and queries past Tq are zero-filled by the copy.  Every
// staged row ends in 16 bytes of padding (eight bf16 or four floats),
// which keeps every fragment load free of bank conflicts.
//
//  * bf16: mma.sync.m16n8k16 with f32 accumulators; Q, K and V fragments
//    by ldmatrix (V transposed on the way), Q's slice by slice.  The S
//    accumulator of two key n-tiles is, element for element, the A
//    fragment of P.V, so P stays in registers (rounded to bf16, as the tc
//    kernel rounds it).
//  * f32: 3xTF32.  Each operand is split on its way into the fragment as
//    x = hi + lo, hi rounded to TF32 and lo the remainder rounded to TF32,
//    and a product is lo.hi + hi.lo + hi.hi on mma.sync.m16n8k8.tf32: the
//    dropped lo.lo and the roundings leave about 2^-22 of each product,
//    f32 accuracy (1xTF32 would keep about 3 decimal digits).  The split
//    happens in registers, so shared memory holds each operand once.  The
//    m16n8k8 A fragment holds key columns t and t+4 where S holds 2t and
//    2t+1; P.V runs over the keys in that permuted order (V's B fragment
//    reads keys 2t and 2t+1 to match), so P stays in registers here too.
//
// The online softmax is the TPU kernel's: per query row a running max m
// and denominator l, the accumulator rescaled by exp(m_prev - m_new), in
// the log2 domain (scores pre-multiplied by scale * log2 e, ex2.approx).
// The four threads of a quad share a row: the row max is two shuffles; l is
// kept per thread and summed over the quad once, at the end.  Causal: key
// tiles wholly above the block's diagonal are skipped (the TPU kernel's
// `needed` predicate), and after the first tile a warp skips a tile wholly
// above its own rows; inside a tile the masked scores are the finite
// NEG_INF = -1e30 of the TPU kernel, never -inf, so the rescale never
// becomes exp(-inf - -inf) = NaN.  Key 0 lies in the first tile and every
// query sees it, so every row has a real max after the first tile.  Keys
// past Tk get p = 0.  The result is acc / max(l, 1e-30).
//
// What bounds it on the H100: at the f32 path shape (B 4, Hq 32, Hkv 2,
// T 2048, D 128, causal) the work is 137 GFLOP against 285 MB of q, k, v
// and o.  On the CUDA cores (67 TFLOP/s fp32) that is 2.05 ms; as 3xTF32 on
// the tensor cores, three TF32 products of it at 495 TFLOP/s, 0.83 ms.
// mma.sync reaches only part of the tensor cores' rate on Hopper (wgmma
// is needed for all of it), and the splits cost ALU work beside each
// product.  In bf16 at stablelm-3b's prefill shape (D 80 there, 72 for an
// off-grid width) the bound is the bf16 rate: 0.0869 ms at D 80.
#include <cmath>

#include "mma_sm80.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kM = 2;                 // 16-row m-tiles a warp owns
constexpr int kBQ = kWarps * 16 * kM;  // query rows per block
constexpr int kStages = 2;        // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kBK = 64;      // keys per staged tile
  static constexpr int kDepth = 16;   // mma k: m16n8k16
  static constexpr int kLdExtra = 8;  // row stride = padded D + 8 (16 bytes)
};
template <>
struct Traits<float> {
  static constexpr int kBK = 32;
  static constexpr int kDepth = 8;    // m16n8k8 tf32
  static constexpr int kLdExtra = 4;  // row stride = padded D + 4 (16 bytes)
};

// DP: the padded head dim of this instance (32, 64, 80 or 128), a
// multiple of the mma depth; columns [d, DP) are zero in shared memory.
// Every loop over D has compile-time bounds, so each key tile's fragment
// loads and products form one straight block that ptxas can schedule.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int hq, int hkv, int tq,
    int tk, int d, int n_qb, Strides qs, Strides ks, Strides vs,
    float scale_log2, int causal, int vec) {
  using Tr = Traits<T>;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kBK = Tr::kBK;
  constexpr int kLd = DP + Tr::kLdExtra;  // staged row stride, elements
  constexpr int kNT = kBK / 8;            // key n-tiles of S per m-tile
  constexpr int kKS = DP / Tr::kDepth;    // mma k-slices over D
  constexpr int kDT = DP / 8;             // output n-tiles over D
  static_assert(DP % Tr::kDepth == 0 && (!kBf16 || DP % 16 == 0),
                "DP must be a multiple of the mma depth");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [kBQ][kLd]
  T* skv = sq + kBQ * kLd;                 // stage s: K, then V, [kBK][kLd]

  const int bh = blockIdx.x / n_qb;
  const int qb = blockIdx.x % n_qb;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  const int q0 = qb * kBQ;
  const int q_offset = tk - tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // zero the padded columns [d, DP) of every staged row once: the copies
  // write only [0, d)
  if (d < DP) {
    const int pad = DP - d;
    constexpr int kRows = kBQ + 2 * kStages * kBK;
    for (int i = tid; i < kRows * pad; i += kThreads) {
      const int r = i / pad;
      if constexpr (kBf16) {
        reinterpret_cast<uint16_t*>(sq)[r * kLd + d + i - r * pad] = 0;
      } else {
        sq[r * kLd + d + i - r * pad] = 0.f;
      }
    }
  }

  int n_kb = (tk + kBK - 1) / kBK;
  if (causal) {
    // the last key any query of this tile may see is q_offset + q0 + kBQ - 1
    const int last = q_offset + q0 + kBQ - 1;
    // no visible key at all (Tq > Tk): nothing is accumulated and the
    // output is 0, as the TPU kernel skips every key block of such a tile
    n_kb = last < 0 ? 0 : min(n_kb, last / kBK + 1);
  }

  // one group: the query tile and key tile 0
  const int per_row = d * static_cast<int>(sizeof(T)) / vec;
  stage_rows<T, kBQ, kLd, kThreads>(sq, qp, qs.t, q0, tq, per_row, vec,
                                    tid);
  if (n_kb > 0) {
    stage_rows<T, kBK, kLd, kThreads>(skv, kp, ks.t, 0, tk, per_row, vec,
                                      tid);
    stage_rows<T, kBK, kLd, kThreads>(skv + kBK * kLd, vp, vs.t, 0, tk,
                                      per_row, vec, tid);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * kM * warp;  // this warp's first query row
  float m_run[kM][2], l_run[kM][2], acc[kM][kDT][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    m_run[m][0] = m_run[m][1] = kNegInf;
    l_run[m][0] = l_run[m][1] = 0.f;
#pragma unroll
    for (int j = 0; j < kDT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  }
  const T* sqw = sq + 16 * kM * warp * kLd;  // this warp's query rows

  for (int kb = 0; kb < n_kb; ++kb) {
    // tile kb has landed and every warp is done with tile kb - 1, whose
    // stage the next tile refills while this one is multiplied
    cp_async_wait<0>();
    __syncthreads();
    if (kb + 1 < n_kb) {
      T* nk = skv + ((kb + 1) % kStages) * 2 * kBK * kLd;
      stage_rows<T, kBK, kLd, kThreads>(nk, kp, ks.t, (kb + 1) * kBK, tk,
                                        per_row, vec, tid);
      stage_rows<T, kBK, kLd, kThreads>(nk + kBK * kLd, vp, vs.t,
                                        (kb + 1) * kBK, tk, per_row, vec,
                                        tid);
    }
    cp_async_commit();

    const int k0 = kb * kBK;
    const T* sk = skv + (kb % kStages) * 2 * kBK * kLd;
    const T* sv = sk + kBK * kLd;
    // a tile wholly above this warp's rows adds nothing once every row has
    // a real max (after the first tile)
    if (causal && kb > 0 && k0 > q_offset + row0 + 16 * kM - 1) continue;

    float s_acc[kM][kNT][4];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[m][j][e] = 0.f;

    // S = Q K^T, Q's fragments read from shared memory slice by slice
#pragma unroll
    for (int s = 0; s < kKS; ++s) {
      if constexpr (kBf16) {
        uint32_t qf[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m)
          ldmatrix_x4(qf[m], sqw + (16 * m + (lane & 15)) * kLd + 16 * s +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          uint32_t kf[4];
          ldmatrix_x4(kf, sk + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) *
                                   kLd + 16 * s + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_bf16(s_acc[m][2 * jp], qf[m], kf[0], kf[1]);
            mma_bf16(s_acc[m][2 * jp + 1], qf[m], kf[2], kf[3]);
          }
        }
      } else {
        uint32_t ah[kM][4], al[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float* r0 = sqw + (16 * m + g) * kLd + 8 * s + t;
          const float qv[4] = {r0[0], r0[8 * kLd], r0[4], r0[8 * kLd + 4]};
          split_tf32(qv, ah[m], al[m]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = sk + (8 * j + g) * kLd + 8 * s + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[0], bh0, bl0);
          split_tf32(kr[4], bh1, bl1);
#pragma unroll
          for (int m = 0; m < kM; ++m)
            mma_3xtf32(s_acc[m][j], ah[m], al[m], bh0, bl0, bh1, bl1);
        }
      }
    }

    // scale, mask, and the online softmax of rows g and g + 8 of each
    // m-tile
    const bool edge = k0 + kBK > tk ||
                      (causal && k0 + kBK - 1 > q_offset + row0);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s_acc[m][j][e] * scale_log2;
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = q_offset + row0 + 16 * m + g + (e >> 1) * 8;
          if (edge && (key >= tk || (causal && key > qpos))) x = kNegInf;
          s_acc[m][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[m][i], mx[i]);
        alpha[i] = fast_exp2(m_run[m][i] - m_new);
        m_run[m][i] = m_new;
        l_run[m][i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const float p =
              edge && key >= tk
                  ? 0.f : fast_exp2(s_acc[m][j][e] - m_run[m][e >> 1]);
          s_acc[m][j][e] = p;
          l_run[m][e >> 1] += p;
        }
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[m][j][0] *= alpha[0];
        acc[m][j][1] *= alpha[0];
        acc[m][j][2] *= alpha[1];
        acc[m][j][3] *= alpha[1];
      }
    }

    // O += P V, P from the S accumulators
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t pa[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          pa[m][0] = pack_bf16(s_acc[m][2 * kk][0], s_acc[m][2 * kk][1]);
          pa[m][1] = pack_bf16(s_acc[m][2 * kk][2], s_acc[m][2 * kk][3]);
          pa[m][2] = pack_bf16(s_acc[m][2 * kk + 1][0],
                               s_acc[m][2 * kk + 1][1]);
          pa[m][3] = pack_bf16(s_acc[m][2 * kk + 1][2],
                               s_acc[m][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < kDT / 2; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sv + (16 * kk + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * kLd +
                                    16 * dp + (lane >> 4) * 8);
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            mma_bf16(acc[m][2 * dp], pa[m], vf[0], vf[1]);
            mma_bf16(acc[m][2 * dp + 1], pa[m], vf[2], vf[3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        // A columns t and t + 4 are keys 2t and 2t + 1 of this n-tile
        uint32_t ah[kM][4], al[kM][4];
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          const float pv[4] = {s_acc[m][kk][0], s_acc[m][kk][2],
                               s_acc[m][kk][1], s_acc[m][kk][3]};
          split_tf32(pv, ah[m], al[m]);
        }
        const float* vr = sv + (8 * kk + 2 * t) * kLd + g;
#pragma unroll
        for (int dn = 0; dn < kDT; ++dn) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * dn], bh0, bl0);
          split_tf32(vr[kLd + 8 * dn], bh1, bl1);
#pragma unroll
          for (int m = 0; m < kM; ++m)
            mma_3xtf32(acc[m][dn], ah[m], al[m], bh0, bl0, bh1, bl1);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* op = o + (int64_t)bh * tq * d;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[m][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / fmaxf(l, 1e-30f);
      const int r = row0 + 16 * m + g + 8 * i;
      if (r >= tq) continue;
      if (lse != nullptr && t == 0) {
        // the row's log-sum-exp of its scaled scores in log2 units, m + log2
        // l (the quad shares m); +inf for a row that sees no key, tested on
        // its position: the finite mask leaves m and l at garbage there
        const bool sees_key = !causal || q_offset + r >= 0;
        lse[static_cast<int64_t>(bh) * tq + r] =
            sees_key ? m_run[m][i] + log2f(l) : INFINITY;
      }
#pragma unroll
      for (int dn = 0; dn < kDT; ++dn) {
        const int col = 8 * dn + 2 * t;
        if (col < d)
          store(op + (int64_t)r * d + col, acc[m][dn][2 * i] * inv);
        if (col + 1 < d)
          store(op + (int64_t)r * d + col + 1, acc[m][dn][2 * i + 1] * inv);
      }
    }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t b, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
           int64_t d, Strides qs, Strides ks, Strides vs, float scale,
           int causal, int vec, cudaStream_t stream) {
  using Tr = Traits<T>;
  const int64_t n_qb = (tq + kBQ - 1) / kBQ;
  const int64_t blocks = b * hq * n_qb;
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(T) * static_cast<size_t>(DP + Tr::kLdExtra) *
                      (kBQ + 2 * kStages * Tr::kBK);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_mma_kernel<T, DP><<<static_cast<unsigned>(blocks),
                                      kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse,
      static_cast<int>(hq), static_cast<int>(hkv), static_cast<int>(tq),
      static_cast<int>(tk), static_cast<int>(d), static_cast<int>(n_qb), qs,
      ks, vs, scale * kLog2e, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// the smallest instance that holds d: 32, 64, 80 (stablelm-3b's width,
// and 72) or 128
template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t b, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
             int64_t d, Strides qs, Strides ks, Strides vs, float scale,
             int causal, int vec, cudaStream_t stream) {
  const auto run = [&](auto launch) {
    return launch(q, k, v, o, lse, b, hq, hkv, tq, tk, d, qs, ks, vs, scale,
                  causal, vec, stream);
  };
  if (d <= 32) return run(&launch<T, 32>);
  if (d <= 64) return run(&launch<T, 64>);
  if (d <= 80) return run(&launch<T, 80>);
  return run(&launch<T, 128>);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  vec: the
// bytes one staging copy moves (16, 8 or 4; 2 in bf16 only), which must
// divide every tensor's base address, its strides in bytes and D times the
// element size (kernels/flash_attention.py, copy_width).  The wrapper
// checks shapes: Hq % Hkv == 0, 1 <= D <= 128, the last dim contiguous,
// o (B, Hq, Tq, D) contiguous.  lse: null, or float32 (B, Hq, Tq)
// contiguous, which then receives each row's log-sum-exp of its scaled
// scores (log2 units; +inf where no key is visible) for the backward kernel
// (flash_attention_bwd.cu); o is the same with it or without.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int64_t b,
    int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d, int64_t q_sb,
    int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, float scale, int causal,
    int dtype, int vec, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = dtype == 0 ? 4 : 2;
  if ((vec != 16 && vec != 8 && vec != 4 && vec != 2) || vec < es ||
      (d * es) % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, static_cast<float*>(lse), b, hq, hkv,
                           tq, tk, d, qs, ks, vs, scale, causal, vec, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), b,
                                   hq, hkv, tq, tk, d, qs, ks, vs, scale,
                                   causal, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
