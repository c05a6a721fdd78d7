// The gradient of flash attention (causal, GQA), written by hand for Hopper
// (sm_90a): (dq, dk, dv) from q, k, v, the forward's output o and its
// cotangent do.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and
// differentiates its plain jnp attention (src/repro/kernels/ops.py,
// flash_attention without Pallas; src/repro/kernels/ref.py,
// flash_attention_ref).  It is the gradient of the forward kernels of
// src/repro/kernels/flash_attention.py, flash_attention_pallas
// (flash_attention_tc.cu and flash_attention.cu here), so that training
// on the card differentiates the kernel it runs.  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, flash_attention_bwd_ref.
//
// The contract is the forward's: q and o (B, Hq, Tq, D), k and v
// (B, Hkv, Tk, D), do (B, Hq, Tq, D); f32 or bf16, all alike; any strides
// for the first three dims (the last one contiguous), so the transposed
// (B, T, H, D) views of the caller cost no copy; 1 <= D <= 128; query
// head h reads KV head h / (Hq / Hkv); the queries are the last Tq
// positions of the Tk stream (q_offset = Tk - Tq).  dq (B, Hq, Tq, D),
// dk and dv (B, Hkv, Tk, D) are written contiguous in the inputs' dtype.
// A query row that sees no key (causal with Tq > Tk) has output 0 in the
// forward kernels and carries no gradient here.
//
// Design (FlashAttention-2's backward, simple and deterministic: no
// atomics).  All arithmetic is float32 on the CUDA cores: tiles are
// staged to shared memory as float32 (bf16 widened on the way), so
// nothing is rounded between the products, and the only roundings are
// the final stores.  Tiles are 64 rows by D padded to the kernel's
// instance (32, 64, 80 or 128; zero columns past D), rows strided D + 1
// floats so that a column read by 16 threads hits 16 banks.  A block is
// 256 threads as a 16 x 16 grid; thread (ty, tx) owns rows ty + 16a and
// columns tx + 16c (a, c < 4) of a 64 x 64 tile, and rows ty + 16a by
// columns tx + 16e (e < D / 16) of a 64 x D tile.
//
//  * flash_attention_bwd_dq_kernel: one block per (b, hq, 64-query
//    tile).  Pass 1 recomputes each row's log-sum-exp of the scaled
//    scores over the key tiles it sees (online max and sum, log2
//    domain).  Delta = rowsum(do * o).  Pass 2, per key tile: S = Q K^T,
//    P = exp2(S * scale * log2 e - lse), dP = dO V^T, dS = P (dP - Delta)
//    into shared memory, dq += dS K.  dq is written times scale; the
//    log-sum-exp and Delta of every row go to a float32 (B, Hq, Tq)
//    buffer each, for the second kernel.
//  * flash_attention_bwd_dkdv_kernel: one block per (b, hkv, 64-key
//    tile).  K and V stay in shared memory; the block loops over the
//    group's query heads and, for each, the query tiles on or below the
//    diagonal: S and dP again, P and dS into shared memory, then
//    dv += P^T dO and dk += dS^T Q in registers.  The group's sum into
//    one KV head is this loop, so no two blocks write the same row.
//
// Causal: key tiles wholly above a query tile's diagonal are skipped in
// both kernels; inside a tile a key past Tk, a query past Tq, or a key
// above the query's position (q_offset + row) gets P = 0.  A row that
// sees no key gets log-sum-exp +inf, so its P is 0 everywhere.
//
// Where it runs: the backward of the forward's "mma" route
// (kernels/flash_attention.py, route()): float32 at any head dim, and
// bf16 at a head dim that is not a multiple of 16.  bf16 at the multiples
// of 16, every model's training path, runs its redesign for the tensor
// cores, flash_attention_bwd_tc.cu (wgmma, P and dS rounded to bf16, the
// log-sum-exp taken from the forward).
//
// What bounds it on the H100: five products of the causal Tq x Tk x D
// work (S, dP, dV, dK, dQ) against q, k, v, o, do and the three outputs;
// in float32 at the FFMA rate (67 TFLOP/s), in bf16 at the tensor cores'
// 989 TFLOP/s.  This kernel recomputes S and dP in both kernels and the
// scores once more for the log-sum-exp (eight products in all) and runs
// them on the CUDA cores, so in bf16 it sits far above that bound; it
// keeps float32's exact arithmetic (nothing rounded between products)
// for the inputs it serves.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kB = 64;         // query rows and keys per tile
constexpr int kPer = kB / 16;  // rows (and 64-wide columns) a thread owns
constexpr int kPL = kB + 1;    // row stride of a 64 x 64 score tile
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, t;  // element strides of the batch, head and position dims
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows [p0, p0 + kB) of one (T, D) slab (row stride st elements, D
// contiguous) into shared rows of DP + 1 floats; zero past row `limit`
// and past column d.  Neighbouring threads read neighbouring columns.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t st,
                                      int p0, int limit, int d, int tid) {
  constexpr int kLd = DP + 1;
  for (int i = tid; i < kB * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    const int pos = p0 + r;
    dst[r * kLd + c] =
        pos < limit && c < d ? widen(src[static_cast<int64_t>(pos) * st + c])
                             : 0.f;
  }
}

// acc[a][c] = sum over the DP columns of x[ty + 16a] . y[tx + 16c]
template <int DP>
__device__ __forceinline__ void row_dots(float (&acc)[kPer][kPer],
                                         const float* x, const float* y,
                                         int ty, int tx) {
  constexpr int kLd = DP + 1;
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int c = 0; c < kPer; ++c) acc[a][c] = 0.f;
#pragma unroll 8
  for (int j = 0; j < DP; ++j) {
    float xa[kPer], yc[kPer];
#pragma unroll
    for (int a = 0; a < kPer; ++a) xa[a] = x[(ty + 16 * a) * kLd + j];
#pragma unroll
    for (int c = 0; c < kPer; ++c) yc[c] = y[(tx + 16 * c) * kLd + j];
#pragma unroll
    for (int a = 0; a < kPer; ++a)
#pragma unroll
      for (int c = 0; c < kPer; ++c) acc[a][c] += xa[a] * yc[c];
  }
}

// sum of x over the 16 threads of a half-warp (the threads of one row)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// the number of key tiles a causal query tile starting at q0 sees
__device__ __forceinline__ int key_tiles(int tk, int q_offset, int q0,
                                         int causal) {
  int n = (tk + kB - 1) / kB;
  if (causal) {
    const int last = q_offset + q0 + kB - 1;  // the tile's last position
    n = last < 0 ? 0 : min(n, last / kB + 1);
  }
  return n;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int hq,
    int hkv, int tq, int tk, int d, int n_qb, Strides qs, Strides ks,
    Strides vs, Strides os, Strides dos, float scale, int causal) {
  constexpr int kLd = DP + 1;
  constexpr int kCol = DP / 16;
  extern __shared__ float smem[];
  float* sq = smem;             // [kB][kLd] queries
  float* sdo = sq + kB * kLd;   // [kB][kLd] output cotangents
  float* sk = sdo + kB * kLd;   // [kB][kLd] keys
  float* sv = sk + kB * kLd;    // [kB][kLd] values
  float* sds = sv + kB * kLd;   // [kB][kPL] dS

  const int bh = blockIdx.x / n_qb, qb = blockIdx.x % n_qb;
  const int b = bh / hq, h = bh % hq, kvh = h / (hq / hkv);
  const T* qp = q + b * qs.b + h * qs.h;
  const T* op = o + b * os.b + h * os.h;
  const T* dop = dout + b * dos.b + h * dos.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  const int q0 = qb * kB, q_offset = tk - tq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float sl2 = scale * kLog2e;

  stage<T, DP>(sq, qp, qs.t, q0, tq, d, tid);
  stage<T, DP>(sdo, dop, dos.t, q0, tq, d, tid);
  __syncthreads();

  float delta[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int r = ty + 16 * a, pos = q0 + r;
    float acc = 0.f;
    if (pos < tq)
      for (int c = tx; c < d; c += 16)
        acc += sdo[r * kLd + c] * widen(op[static_cast<int64_t>(pos) * os.t +
                                           c]);
    delta[a] = row_sum(acc);
  }

  const int n_kb = key_tiles(tk, q_offset, q0, causal);
  // pass 1: each row's log-sum-exp of its visible scaled scores (log2)
  float m_run[kPer], l_run[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();  // every thread is done with the last key tile
    stage<T, DP>(sk, kp, ks.t, kb * kB, tk, d, tid);
    __syncthreads();
    float s[kPer][kPer];
    row_dots<DP>(s, sq, sk, ty, tx);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int qpos = q_offset + q0 + ty + 16 * a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int key = kb * kB + tx + 16 * c;
        const bool ok = key < tk && (!causal || key <= qpos);
        s[a][c] = ok ? s[a][c] * sl2 : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
      // every thread of the row takes part in the shuffles; a row with no
      // visible key yet keeps l = 0 (its scores are all -inf)
      const float m_new = fmaxf(m_run[a], row_max(mx));
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) sum += exp2f(s[a][c] - m_ref);
      l_run[a] = l_run[a] * exp2f(m_run[a] - m_ref) + row_sum(sum);
      m_run[a] = m_new;
    }
  }
  float lse[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
    lse[a] = l_run[a] > 0.f ? m_run[a] + log2f(l_run[a]) : INFINITY;

  // pass 2: dS per key tile, dq += dS K
  float acc[kPer][kCol];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int e = 0; e < kCol; ++e) acc[a][e] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    __syncthreads();
    stage<T, DP>(sk, kp, ks.t, kb * kB, tk, d, tid);
    stage<T, DP>(sv, vp, vs.t, kb * kB, tk, d, tid);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
    row_dots<DP>(s, sq, sk, ty, tx);
    row_dots<DP>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int a = 0; a < kPer; ++a) {
      const int qpos = q_offset + q0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int key = kb * kB + tx + 16 * c;
        const bool ok = key < tk && (!causal || key <= qpos);
        const float p = ok ? exp2f(s[a][c] * sl2 - lse[a]) : 0.f;
        sds[(ty + 16 * a) * kPL + tx + 16 * c] =
            p == 0.f ? 0.f : p * (dp[a][c] - delta[a]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float kc[kCol];
#pragma unroll
      for (int e = 0; e < kCol; ++e) kc[e] = sk[j * kLd + tx + 16 * e];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const float ds = sds[(ty + 16 * a) * kPL + j];
#pragma unroll
        for (int e = 0; e < kCol; ++e) acc[a][e] += ds * kc[e];
      }
    }
  }

  T* dqp = dq + static_cast<int64_t>(bh) * tq * d;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int pos = q0 + ty + 16 * a;
    if (pos >= tq) continue;
#pragma unroll
    for (int e = 0; e < kCol; ++e) {
      const int c = tx + 16 * e;
      if (c < d) store(dqp + static_cast<int64_t>(pos) * d + c,
                       acc[a][e] * scale);
    }
    if (tx == 0) {
      lse_out[static_cast<int64_t>(bh) * tq + pos] = lse[a];
      delta_out[static_cast<int64_t>(bh) * tq + pos] = delta[a];
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
    const float* __restrict__ lse_in, const float* __restrict__ delta_in,
    int hq, int hkv, int tq, int tk, int d, int n_kb, Strides qs, Strides ks,
    Strides vs, Strides dos, float scale, int causal) {
  constexpr int kLd = DP + 1;
  constexpr int kCol = DP / 16;
  extern __shared__ float smem[];
  float* sk = smem;             // [kB][kLd] keys of this tile
  float* sv = sk + kB * kLd;    // [kB][kLd] values
  float* sq = sv + kB * kLd;    // [kB][kLd] queries of the current tile
  float* sdo = sq + kB * kLd;   // [kB][kLd] their output cotangents
  float* sp = sdo + kB * kLd;   // [kB][kPL] P, query rows by keys
  float* sds = sp + kB * kPL;   // [kB][kPL] dS
  float* slse = sds + kB * kPL; // [kB]
  float* sdelta = slse + kB;    // [kB]

  const int bkv = blockIdx.x / n_kb, kb = blockIdx.x % n_kb;
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const int k0 = kb * kB, q_offset = tk - tq;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float sl2 = scale * kLog2e;

  stage<T, DP>(sk, k + b * ks.b + kvh * ks.h, ks.t, k0, tk, d, tid);
  stage<T, DP>(sv, v + b * vs.b + kvh * vs.h, vs.t, k0, tk, d, tid);

  // the first query tile holding a position at or past k0 (causal)
  const int n_qb = (tq + kB - 1) / kB;
  const int qb0 = causal ? max(0, k0 - q_offset) / kB : 0;

  float dk_acc[kPer][kCol], dv_acc[kPer][kCol];
#pragma unroll
  for (int a = 0; a < kPer; ++a)
#pragma unroll
    for (int e = 0; e < kCol; ++e) dk_acc[a][e] = dv_acc[a][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const int64_t bh = static_cast<int64_t>(b) * hq + h;
    const T* qp = q + b * qs.b + h * qs.h;
    const T* dop = dout + b * dos.b + h * dos.h;
    for (int qb = qb0; qb < n_qb; ++qb) {
      const int q0 = qb * kB;
      __syncthreads();  // every thread is done with the last query tile
      stage<T, DP>(sq, qp, qs.t, q0, tq, d, tid);
      stage<T, DP>(sdo, dop, dos.t, q0, tq, d, tid);
      if (tid < kB) {
        const int pos = q0 + tid;
        slse[tid] = pos < tq ? lse_in[bh * tq + pos] : INFINITY;
        sdelta[tid] = pos < tq ? delta_in[bh * tq + pos] : 0.f;
      }
      __syncthreads();
      float s[kPer][kPer], dp[kPer][kPer];
      row_dots<DP>(s, sq, sk, ty, tx);
      row_dots<DP>(dp, sdo, sv, ty, tx);
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        const int r = ty + 16 * a;
        const int qpos = q_offset + q0 + r;
        const float l = slse[r], dl = sdelta[r];
#pragma unroll
        for (int c = 0; c < kPer; ++c) {
          const int key = k0 + tx + 16 * c;
          const bool ok =
              q0 + r < tq && key < tk && (!causal || key <= qpos);
          const float p = ok ? exp2f(s[a][c] * sl2 - l) : 0.f;
          sp[r * kPL + tx + 16 * c] = p;
          sds[r * kPL + tx + 16 * c] = p == 0.f ? 0.f : p * (dp[a][c] - dl);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kB; ++i) {
        float doc[kCol], qc[kCol];
#pragma unroll
        for (int e = 0; e < kCol; ++e) {
          doc[e] = sdo[i * kLd + tx + 16 * e];
          qc[e] = sq[i * kLd + tx + 16 * e];
        }
#pragma unroll
        for (int a = 0; a < kPer; ++a) {
          const float p = sp[i * kPL + ty + 16 * a];
          const float ds = sds[i * kPL + ty + 16 * a];
#pragma unroll
          for (int e = 0; e < kCol; ++e) {
            dv_acc[a][e] += p * doc[e];
            dk_acc[a][e] += ds * qc[e];
          }
        }
      }
    }
  }

  T* dkp = dk + static_cast<int64_t>(bkv) * tk * d;
  T* dvp = dv + static_cast<int64_t>(bkv) * tk * d;
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= tk) continue;
#pragma unroll
    for (int e = 0; e < kCol; ++e) {
      const int c = tx + 16 * e;
      if (c >= d) continue;
      store(dkp + static_cast<int64_t>(key) * d + c, dk_acc[a][e] * scale);
      store(dvp + static_cast<int64_t>(key) * d + c, dv_acc[a][e]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int64_t b, hq, hkv, tq, tk, d;
  Strides qs, ks, vs, os, dos;
  float scale;
  int causal;
};

template <typename T, int DP>
int launch(const Args& x, cudaStream_t stream) {
  constexpr size_t kTile = sizeof(float) * kB * (DP + 1);
  constexpr size_t kScores = sizeof(float) * kB * kPL;
  const int64_t n_qb = (x.tq + kB - 1) / kB, n_kb = (x.tk + kB - 1) / kB;
  const int64_t blocks_q = x.b * x.hq * n_qb, blocks_k = x.b * x.hkv * n_kb;
  if (blocks_q == 0 || blocks_k == 0) return 0;
  if (blocks_q >= (int64_t{1} << 31) || blocks_k >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_q = 4 * kTile + kScores;
  const size_t smem_k = 4 * kTile + 2 * kScores + 2 * sizeof(float) * kB;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_k));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hq = static_cast<int>(x.hq), hkv = static_cast<int>(x.hkv);
  const int tq = static_cast<int>(x.tq), tk = static_cast<int>(x.tk);
  const int d = static_cast<int>(x.d);
  flash_attention_bwd_dq_kernel<T, DP>
      <<<static_cast<unsigned>(blocks_q), kThreads, smem_q, stream>>>(
          static_cast<const T*>(x.q), static_cast<const T*>(x.k),
          static_cast<const T*>(x.v), static_cast<const T*>(x.o),
          static_cast<const T*>(x.dout), static_cast<T*>(x.dq), x.lse,
          x.delta, hq, hkv, tq, tk, d, static_cast<int>(n_qb), x.qs, x.ks,
          x.vs, x.os, x.dos, x.scale, x.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkdv_kernel<T, DP>
      <<<static_cast<unsigned>(blocks_k), kThreads, smem_k, stream>>>(
          static_cast<const T*>(x.q), static_cast<const T*>(x.k),
          static_cast<const T*>(x.v), static_cast<const T*>(x.dout),
          static_cast<T*>(x.dk), static_cast<T*>(x.dv), x.lse, x.delta, hq,
          hkv, tq, tk, d, static_cast<int>(n_kb), x.qs, x.ks, x.vs, x.dos,
          x.scale, x.causal);
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
// of every input is contiguous.  dq (B, Hq, Tq, D), dk and dv (B, Hkv, Tk,
// D) contiguous; lse and delta float32 (B, Hq, Tq) scratch.  The wrapper
// checks shapes: Hq % Hkv == 0, 1 <= D <= 128.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int64_t b, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d,
    int64_t q_sb, int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh,
    int64_t k_st, int64_t v_sb, int64_t v_sh, int64_t v_st, int64_t o_sb,
    int64_t o_sh, int64_t o_st, int64_t do_sb, int64_t do_sh, int64_t do_st,
    float scale, int causal, int dtype, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args x{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
               static_cast<float*>(delta), b, hq, hkv, tq, tk, d,
               Strides{q_sb, q_sh, q_st}, Strides{k_sb, k_sh, k_st},
               Strides{v_sb, v_sh, v_st}, Strides{o_sb, o_sh, o_st},
               Strides{do_sb, do_sh, do_st}, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(x, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(x, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
