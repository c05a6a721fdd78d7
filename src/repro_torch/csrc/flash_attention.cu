// Flash attention (causal, GQA, online softmax), written by hand for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the TPU kernel body _flash_kernel).  Plain PyTorch version:
// src/repro_torch/kernels/ref.py, flash_attention_ref.  Since the
// tensor-core kernel (flash_attention_tc.cu) took bf16 with head dim 64
// and 128, this one serves float32 and every other head dim (1..128),
// as kernels/flash_attention.py, route() chooses: the f32 forward and
// prefill, and models whose heads are 80 or 16 wide.
//
// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), f32 or bf16, read through
// element strides for the first three dims (the last one is contiguous),
// so the (B, T, H, D) -> (B, H, T, D) transpose of the caller costs no
// copy.  Query head h of batch b reads KV head h / (Hq / Hkv) of the same
// batch.  The queries are the last Tq positions of the Tk stream
// (q_offset = Tk - Tq).  Output (B, Hq, Tq, D) contiguous, in q's dtype.
//
// Design: one block of 256 threads per (b * Hq + h, 64-query tile).  The
// query tile is staged once in shared memory, transposed and in f32; the
// block then walks 64-key tiles of K and V, staged in shared memory in
// f32 (K transposed), and keeps for each query row the running max m, the
// denominator l and an f32 accumulator, as the TPU kernel keeps them in
// VMEM scratch across its sequential key-block grid steps.  Thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows 4ty..4ty+3: it computes
// their scores against keys 4tx..4tx+3 of the tile (a 4 x 4 register
// tile, float4 reads of the transposed tiles), the row max and row sum by
// shuffles across the 16 threads of the row group, and output columns
// DC*tx..DC*tx+DC-1 of the P.V product (P goes through shared memory).
// All math is f32 on the CUDA cores; bf16 is converted when staged.
//
// Causal: key tiles wholly above the diagonal are skipped (the TPU
// kernel's `needed` predicate), and inside a tile the masked scores are
// the finite NEG_INF = -1e30 of the TPU kernel, never -inf, so the rescale
// exp(m_prev - m_new) cannot become exp(-inf - -inf) = NaN.  Key 0 lies in
// the first tile and is visible to every query, so every row has a real
// max after the first tile.  Keys past Tk (a ragged last tile when
// Tk < 64 is not a multiple of 64) get p = 0; query rows past Tq are
// computed on zeros and never stored.  The result is acc / max(l, 1e-30).
//
// What bounds it on the H100: at the main path's shape (B 4, Hq 32, Hkv 2,
// T 2048, D 128, causal) the work is 137 GFLOP against 143 MB of q, k, v
// and o, so the tensor cores' rate bounds it (0.139 ms at 989 TFLOP/s
// bf16).  This kernel runs on the CUDA cores in f32 (67 TFLOP/s at most)
// with one or two blocks per SM (117 KB of shared memory per block at
// D = 128), so it is far from that bound by design; for bf16 at D 64 and
// 128, flash_attention_tc.cu runs the same work on the tensor cores.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // queries per block
constexpr int kBK = 64;       // keys per staged tile
constexpr int kThreads = 256;
constexpr int kLd = 68;       // row stride of the transposed tiles (16 B aligned)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Strides {
  int64_t b, h, t;  // element strides of the batch, head and position dims
};

__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DC: output columns per thread; the tile holds 16 * DC >= D columns.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int hq, int hkv, int tq, int tk, int d, int n_qb,
    Strides qs, Strides ks, Strides vs, float scale, int causal) {
  constexpr int kDv = 16 * DC;
  extern __shared__ float4 smem4[];
  float* q_t = reinterpret_cast<float*>(smem4);  // [d][kLd]   Q tile, transposed
  float* k_t = q_t + d * kLd;                    // [d][kLd]   K tile, transposed
  float* v_s = k_t + d * kLd;                    // [kBK][kDv] V tile
  float* p_t = v_s + kBK * kDv;                  // [kBK][kLd] P, transposed

  const int bh = blockIdx.x / n_qb;
  const int qb = blockIdx.x % n_qb;
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + kvh * ks.h;
  const T* vp = v + b * vs.b + kvh * vs.h;
  const int q0 = qb * kBQ;
  const int q_offset = tk - tq;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    q_t[c * kLd + r] =
        q0 + r < tq ? to_f32(qp[(int64_t)(q0 + r) * qs.t + c]) : 0.f;
  }

  int n_kb = (tk + kBK - 1) / kBK;
  if (causal) {
    // the last key any query of this tile may see is q_offset + q0 + kBQ - 1
    const int last = q_offset + q0 + kBQ - 1;
    // no visible key at all (Tq > Tk): nothing is accumulated and the
    // output is 0, as the TPU kernel skips every key block of such a tile
    n_kb = last < 0 ? 0 : min(n_kb, last / kBK + 1);
  }

  float m_run[4], l_run[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int j = i / d, c = i - j * d;
      const bool ok = k0 + j < tk;
      k_t[c * kLd + j] = ok ? to_f32(kp[(int64_t)(k0 + j) * ks.t + c]) : 0.f;
    }
    for (int i = tid; i < kBK * kDv; i += kThreads) {
      const int j = i / kDv, c = i - j * kDv;
      v_s[i] = (k0 + j < tk && c < d)
                   ? to_f32(vp[(int64_t)(k0 + j) * vs.t + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(q_t + c * kLd + 4 * ty);
      const float4 kk = *reinterpret_cast<const float4*>(k_t + c * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        float x = s[i][j] * scale;
        if (kpos >= tk || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], group_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = k0 + 4 * tx + j < tk;
        p[i][j] = in ? expf(s[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
      l_run[i] = alpha * l_run[i] + group_sum(rs);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_t + (4 * tx + j) * kLd + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(p_t + j * kLd + 4 * ty);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float vv[DC];
      const float* vrow = v_s + j * kDv + DC * tx;
      if constexpr (DC % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DC; c += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vrow + c);
          vv[c] = t4.x; vv[c + 1] = t4.y; vv[c + 2] = t4.z; vv[c + 3] = t4.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = vrow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* op = o + (int64_t)bh * tq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= tq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = DC * tx + c;
      if (col < d) store(op + (int64_t)r * d + col, acc[i][c] / den);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d,
           Strides qs, Strides ks, Strides vs, float scale, int causal,
           cudaStream_t stream) {
  const int64_t n_qb = (tq + kBQ - 1) / kBQ;
  const int64_t blocks = b * hq * n_qb;
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (2 * d * kLd + kBK * 16 * DC + kBK * kLd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<T, DC><<<static_cast<unsigned>(blocks), kThreads,
                                  smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(hq),
      static_cast<int>(hkv), static_cast<int>(tq), static_cast<int>(tk),
      static_cast<int>(d), static_cast<int>(n_qb), qs, ks, vs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int64_t b,
             int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d,
             Strides qs, Strides ks, Strides vs, float scale, int causal,
             cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 2>(q, k, v, o, b, hq, hkv, tq, tk, d, qs, ks, vs, scale,
                        causal, stream);
  if (d <= 64)
    return launch<T, 4>(q, k, v, o, b, hq, hkv, tq, tk, d, qs, ks, vs, scale,
                        causal, stream);
  return launch<T, 8>(q, k, v, o, b, hq, hkv, tq, tk, d, qs, ks, vs, scale,
                      causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  The
// wrapper (kernels/flash_attention.py) checks shapes: Hq % Hkv == 0,
// 1 <= D <= 128, the last dim contiguous, o (B, Hq, Tq, D) contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int64_t b,
    int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d, int64_t q_sb,
    int64_t q_sh, int64_t q_st, int64_t k_sb, int64_t k_sh, int64_t k_st,
    int64_t v_sb, int64_t v_sh, int64_t v_st, float scale, int causal,
    int dtype, void* stream) {
  if (d < 1 || d > 128 || hkv < 1 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, b, hq, hkv, tq, tk, d, qs, ks, vs,
                           scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, b, hq, hkv, tq, tk, d, qs, ks,
                                   vs, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
