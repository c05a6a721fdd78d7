// Flash attention on Hopper's tensor cores (causal, GQA, online softmax):
// bf16 inputs with a head dim that is a multiple of 16 up to 128, written
// by hand for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (the TPU kernel body _flash_kernel), for bf16 with D in {16, 32, ...,
// 128}: the dense transformer's prefill and forward.  float32, and bf16
// at any other head dim, go to the CUDA-core kernel in flash_attention.cu;
// the choice is kernels/flash_attention.py, route().  Plain PyTorch
// version: src/repro_torch/kernels/ref.py, flash_attention_ref.
//
// Head dims: template instances of width D_I = 64, 80 and 128.  A head of
// d runs on the smallest instance with D_I >= d: d 16-64 on 64 (chatglm3's
// heads are 128, stablelm-3b's 80, the reduced configs' 16), 80 on 80,
// 96-128 on 128.  Tiles are sized by 64-column boxes (ceil(D_I / 64) of
// them); the tensor maps take the real d as their innermost extent, so
// TMA fills the columns past d with zeros, which add nothing to Q K^T,
// give zero output columns in P V, and are never stored.  Where d < D_I
// (16-48, 96, 112) a padded variant of the instance stores d columns;
// the others store D_I with no run-time width at all: reading d in the
// epilogue made the D 128 instance 7% slower (its consumers run at the
// 168-register cap).  D_I 80 is two
// boxes, the second zero past column 80: Q K^T runs its five k16 slices,
// P V is one wgmma m64n80k16, whose 80 columns span box 0 and the first
// 16 columns of box 1.
//
// q (B, Hq, Tq, D), k and v (B, Hkv, Tk, D), bf16, read by TMA through
// 4-D tensor maps over (D, T, H, B) with the tensors' own byte strides,
// so prefill's (B, T, H, D) -> (B, H, T, D) transposed views are read in
// place.  Query head h of batch b reads KV head h / (Hq / Hkv).  The
// queries are the last Tq positions of the Tk stream (q_offset = Tk - Tq).
// Output (B, Hq, Tq, D) contiguous bf16.  For training the launcher may
// also take a float32 (B, Hq, Tq) buffer for each row's log-sum-exp of
// its scaled scores, in log2 units (log2 sum_k 2^(s_k scale log2 e),
// +inf for a row that sees no key), which flash_attention_bwd_tc.cu reads
// instead of recomputing it; serving passes null and stores nothing.
//
// What bounds it on the H100: at the main path's shape (B 4, Hq 32,
// Hkv 2, T 2048, D 128, causal) the work is 137.4 GFLOP against 143 MB of
// q, k, v and o, so the tensor cores bound it: 0.139 ms at 989 TFLOP/s
// bf16.  The CUDA-core kernel (flash_attention.cu) reaches about 16
// TFLOP/s there on an H100 80GB HBM3; this one runs both products on the
// tensor cores and overlaps the loads with them.
//
// At stablelm-3b's prefill shape (B 4, Hq = Hkv = 32, T 2048, D 80,
// causal) the work is 85.9 GFLOP against 168 MB: 0.087 ms at 989 TFLOP/s.
// There the softmax, which does not shrink with D, takes a larger share
// of each tile than at D 128.
//
// Design: one block of 384 threads per (128-query tile, b * Hq + h),
// the heaviest causal tiles launched first.  Warps 0-7 are two consumer
// warpgroups of 64 query rows each, warps 8-11 the producer warpgroup;
// setmaxnreg moves registers from the producer (24 a thread) to the
// consumers (240), and one producer thread starts every load:
//  * Q once, and K and V tiles of 128 keys into a ring of three stages,
//    by TMA with 128-byte swizzle (a box is 64 columns, 128 B a row; D_I
//    80 and 128 take two), each stage with a full and an empty mbarrier,
//    so the loads run ahead of the products.
//  * S = Q K^T: wgmma m64n128k16, Q and K from shared memory (both
//    K-major, D contiguous), f32 accumulators in registers.
//  * The online softmax on the accumulator layout: each thread holds
//    two rows; the row max is taken by shuffles over the 4 threads of a
//    row, then one FMA (the scale pre-multiplied by log2 e) and one
//    ex2.approx per score, the running sum kept per thread and reduced
//    once at the end.
//  * O += P V: wgmma m64nDk16 with P from registers (the S accumulator
//    of a 16-key slice, packed to bf16 pairs, is the A-fragment layout)
//    and V from shared memory through the transpose flag (V has D
//    contiguous; the keys are the reduction dim).
//  * Each warpgroup starts tile j's Q K^T and tile j - 1's P V together
//    and waits for the first only, so tile j's softmax runs while P V is
//    still on the tensor cores; the output is rescaled once P V is done.
//    The two warpgroups take turns to start them (named barriers), so one's
//    products run while the other computes its softmax.
// Causal: key tiles wholly above the block's diagonal are never loaded
// (the TPU kernel's `needed` predicate); only tiles that straddle the
// diagonal or pass Tk are masked elementwise, with the TPU kernel's
// finite -1e30, never -inf.  Keys past Tk (TMA fills them with zeros)
// get p = 0; query rows past Tq are computed and never stored.  The
// result is acc / max(l, 1e-30).
//
// Numerics: P is rounded to bf16 before P V, where the TPU kernel keeps
// it in f32; l sums the f32 p; ex2.approx is within 2 ulp of 2^x.  Against
// the plain version the difference stays within the bf16 tolerance (2e-2):
// an output of size 2 to 4 may land one bf16 ulp (1.6e-2) away.
//
// Left for later: persistent blocks (each block now waits for its first
// loads alone on its SM), skipping the rescale where the row max did not
// move, and a TMA store of the output.
#include "wgmma_sm90.cuh"

namespace {

constexpr int kBM = 128;        // query rows per block (2 warpgroups x 64)
constexpr int kBN = 128;        // keys per K/V tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer wg
constexpr float kNegInf = -1e30f;

// Shared-memory tiles of the instance for head dims up to D: whole boxes
// of 64 columns.
template <int D>
struct Layout {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kQ = kBM * kBoxes * kRowBytes;   // Q tile bytes
  static constexpr int kKV = kBN * kBoxes * kRowBytes;  // K (or V) tile
  static constexpr int kStage = 2 * kKV;                // K then V
  static constexpr int kBytes = kQ + kStages * kStage;
};

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma starts
// (barrier 0 is __syncthreads): a warpgroup waits for its turn on its own
// barrier and passes the turn on the other's.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// What the softmax of one warpgroup's tile needs to know of its rows.
struct Tile {
  int qpos0;       // stream position of this thread's row r (r + 8: +8)
  int col0;        // this thread's first column in each 8-column group
  int wg_first;    // stream position of the warpgroup's first row
  int tk;
  int causal;
  float scale_log2;
};

// S = Q K^T of a 128-key tile: D / 16 slices of k16; slice k lies in box
// (column half) k / 4, 32 bytes per slice inside it.  scale_d = 0 on the
// first slice starts the sum.
template <int D>
__device__ __forceinline__ void qk_start(float (&sc)[64], uint32_t qa,
                                         uint32_t k_s) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k % 4) * 32;
    wgmma_ss_n128(sc,
                  desc_b128(qa + (k / 4) * kBM * kRowBytes + off, 16, 1024),
                  desc_b128(k_s + (k / 4) * kBN * kRowBytes + off, 16, 1024),
                  k > 0);
  }
}

// The online softmax of one tile on the accumulator layout, in place:
// scores sc become p = 2^(s * scale * log2 e - m), m (in those scaled
// units) and l move on, alpha is the factor the output rows must be
// rescaled by.  The row max is taken on the raw scores (the scale is
// positive), a masked score is the finite -1e30 once scaled, and one FMA
// scales and shifts each score.  Elementwise masks only where the tile
// passes Tk or straddles the diagonal of this warpgroup's rows.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], int k0,
                                             const Tile& t, float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2]) {
  const bool masked =
      k0 + kBN > t.tk || (t.causal && k0 + kBN - 1 > t.wg_first);
  const float neg = kNegInf / t.scale_log2;  // -1e30 once scaled
  float mx[2] = {neg, neg};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int kpos = k0 + 8 * j + t.col0 + (e & 1);
        const int qpos = t.qpos0 + 8 * (e >> 1);
        if (kpos >= t.tk || (t.causal && kpos > qpos)) sc[4 * j + e] = neg;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
  float shift[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * t.scale_log2);
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
    shift[i] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(sc[4 * j + e], t.scale_log2, shift[e >> 1]));
      if (masked && k0 + 8 * j + t.col0 + (e & 1) >= t.tk) p = 0.f;
      sc[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

// D: the instance's width; kPad: the head dim d is below it (the
// epilogue then stores d columns, a run-time width).
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int d, int hq, int group, int tq, int tk,
    int n_bh, float scale_log2, int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + L::kQ;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  // heaviest query tiles first: blockIdx.x runs over (b, h) fastest
  const int n_qb = static_cast<int>(gridDim.x) / n_bh;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = qb * kBM;
  const int q_offset = tk - tq;
  int n_kb = (tk + kBN - 1) / kBN;
  if (causal) {
    // the last key any query of this tile may see is q_offset + q0 + 127;
    // with none visible (Tq > Tk) nothing is accumulated and the output
    // is 0, as the TPU kernel skips every key block of such a tile
    const int last = q_offset + q0 + kBM - 1;
    n_kb = last < 0 ? 0 : min(n_kb, last / kBN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    // the producer warpgroup gives its registers to the consumers; one
    // thread starts every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(bar_q, L::kQ);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(q_s + c * kBM * kRowBytes, &q_map, bar_q, 64 * c, q0, h,
                    b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(bar_empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t k_s = kv_s + s * L::kStage, v_s = k_s + L::kKV;
        mbar_expect_tx(full, L::kStage);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(k_s + c * kBN * kRowBytes, &k_map, full, 64 * c,
                      kb * kBN, kvh, b);
          tma_load_4d(v_s + c * kBN * kRowBytes, &v_map, full, 64 * c,
                      kb * kBN, kvh, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // a consumer warpgroup: query rows 64 wg .. 64 wg + 63 of the tile.  In
  // the accumulator layout this thread holds rows r and r + 8 (r below),
  // columns 8 j + 2 (lane % 4) + {0, 1} for j = 0 .. N / 8 - 1.
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int row0 = q0 + 64 * wg + r;           // query index of row r
  Tile tile;
  tile.qpos0 = q_offset + row0;                // its stream position
  tile.col0 = 2 * (lane % 4);
  tile.wg_first = q_offset + q0 + 64 * wg;     // first position of the wg
  tile.tk = tk;
  tile.causal = causal;
  tile.scale_log2 = scale_log2;

  float acc[D / 2], sc[64];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  uint32_t pa[8][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2];

  mbar_wait(bar_q, 0);
  const uint32_t qa = q_s + 64 * wg * kRowBytes;
  // warpgroup 0 starts first; each starts n_kb + 1 batches, and the last
  // turn warpgroup 1 would pass on is never waited for
  if (wg == 1 && n_kb > 0) turn_pass(wg);
  if (n_kb > 0) {
    mbar_wait(bar_full, 0);
    turn_wait(wg);
    wgmma_fence();
    qk_start<D>(sc, qa, kv_s);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, 0, tile, m, l, alpha);
    pack_frags<8>(sc, pa);
  }
  // Tile kb's Q K^T and tile kb - 1's P V are started together; the
  // softmax of tile kb runs while P V is still on the tensor cores.
  for (int kb = 1; kb < n_kb; ++kb) {
    mbar_wait(bar_full + 8 * (kb % kStages), (kb / kStages) & 1);
    turn_wait(wg);
    wgmma_fence();
    qk_start<D>(sc, qa, kv_s + (kb % kStages) * L::kStage);
    wgmma_commit();
    rs_product<D, 8>(acc, pa,
                     kv_s + ((kb - 1) % kStages) * L::kStage + L::kKV, kBN);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<1>();  // Q K^T done; P V may still run
    fence_regs(sc);
    softmax_tile(sc, kb * kBN, tile, m, l, alpha);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);  // P's registers stay untouched until P V is done
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((kb - 1) % kStages));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    pack_frags<8>(sc, pa);
  }
  if (n_kb > 0) {
    turn_wait(wg);
    wgmma_fence();
    rs_product<D, 8>(acc, pa,
                     kv_s + ((n_kb - 1) % kStages) * L::kStage + L::kKV,
                     kBN);
    wgmma_commit();
    if (wg == 0) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  if (lse != nullptr && lane % 4 == 0) {
    // each row's log-sum-exp of its scaled scores in log2 units (the
    // convention of flash_attention_bwd.cu's lse buffer): m + log2 l.  A
    // row that sees no key gets +inf, tested on its position and never
    // read off m and l, which the finite -1e30 mask leaves at a garbage
    // value there
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= tq) continue;
      const bool sees_key = !causal || q_offset + row >= 0;
      lse[static_cast<int64_t>(bh) * tq + row] =
          sees_key ? m[i] + log2f(l[i]) : INFINITY;
    }
  }
  // the real columns (d a multiple of 16, so whole 8-column groups)
  const int width = kPad ? d : D;
  __nv_bfloat16* op = o + static_cast<int64_t>(bh) * tq * width;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= tq) continue;
    __nv_bfloat16* orow = op + static_cast<int64_t>(row) * width + tile.col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!kPad || 8 * j < width)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / l[i],
                                  acc[4 * j + 2 * i + 1] / l[i]);
  }
}

// The instance for head dims up to D, run at head dim d <= D (kPad: d <
// D).
template <int D, bool kPad>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int64_t b, int64_t hq, int64_t hkv, int64_t tq, int64_t tk,
           int64_t d,
           const int64_t* q_bs, const int64_t* k_bs, const int64_t* v_bs,
           float scale, int causal, cudaStream_t stream) {
  const int64_t n_qb = (tq + kBM - 1) / kBM;
  const int64_t n_bh = b * hq;
  const int64_t blocks = n_bh * n_qb;
  if (blocks == 0) return 0;
  if (blocks >= (int64_t{1} << 31) || tq >= (int64_t{1} << 31) ||
      tk >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, d, tq, hq, b, q_bs, kBM) ||
      !make_map(&k_map, k, d, tk, hkv, b, k_bs, kBN) ||
      !make_map(&v_map, v, d, tk, hkv, b, v_bs, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = Layout<D>::kBytes + 1024;  // + room to align to 1024
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_tc_kernel<D, kPad><<<static_cast<unsigned>(blocks),
                                       kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse,
      static_cast<int>(d), static_cast<int>(hq), static_cast<int>(hq / hkv),
      static_cast<int>(tq),
      static_cast<int>(tk), static_cast<int>(n_bh), scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, d a multiple of 16 from 16 to 128, run on the instance 64
// (d <= 64), 80 (d 80) or 128 (d 96-128).  Byte strides of the (T, H, B)
// dims of each tensor (the D dim is contiguous); the wrapper
// (kernels/flash_attention.py, tma_geometry) checks that the base is
// 16-byte aligned and every stride a multiple of 16 bytes.  o (B, Hq, Tq,
// D) contiguous.  lse: null, or float32 (B, Hq, Tq) contiguous, which then
// receives each row's log-sum-exp (log2 units; +inf where no key is
// visible) for the backward kernel.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int64_t b, int64_t hq, int64_t hkv, int64_t tq, int64_t tk, int64_t d,
    int64_t q_st, int64_t q_sh, int64_t q_sb, int64_t k_st, int64_t k_sh,
    int64_t k_sb, int64_t v_st, int64_t v_sh, int64_t v_sb, float scale,
    int causal, void* stream) {
  if (hkv < 1 || hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_st, q_sh, q_sb}, ks[3] = {k_st, k_sh, k_sb},
                vs[3] = {v_st, v_sh, v_sb};
  if (d < 16 || d > 128 || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto launch) {
    return launch(q, k, v, o, static_cast<float*>(lse), b, hq, hkv, tq, tk,
                  d, qs, ks, vs, scale, causal, s);
  };
  if (d == 64) return run(&launch<64, false>);
  if (d < 64) return run(&launch<64, true>);
  if (d == 80) return run(&launch<80, false>);
  if (d == 128) return run(&launch<128, false>);
  return run(&launch<128, true>);
}
