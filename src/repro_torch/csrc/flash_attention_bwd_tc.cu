// The gradient of flash attention on Hopper's tensor cores (causal, GQA):
// (dq, dk, dv) from bf16 q, k, v, the forward's output o, its cotangent do
// and the log-sum-exp the forward kernel saved, written by hand for sm_90a.
//
// Replaces no TPU kernel: the JAX package has no backward kernel and
// differentiates its plain attention (src/repro/kernels/ops.py,
// flash_attention without Pallas).  It is the gradient of
// src/repro/kernels/flash_attention.py, flash_attention_pallas, as its
// tensor-core forward (flash_attention_tc.cu) computes it, and takes the
// same inputs: bf16 with a head dim d that is a multiple of 16 up to 128
// (kernels/flash_attention.py, route() == "tc").  float32, and bf16 at
// other head dims, go to the FFMA kernel of flash_attention_bwd.cu.  Plain
// PyTorch version: src/repro_torch/kernels/ref.py, flash_attention_bwd_ref.
//
// The contract: q, o and do (B, Hq, Tq, d), k and v (B, Hkv, Tk, d), read
// by TMA (and o, do by plain loads for Delta) with the tensors' own byte
// strides, so the transformer's (B, T, H, D) -> (B, H, T, D) views cost no
// copy; query head h reads KV head h / (Hq / Hkv); the queries are the
// last Tq positions of the Tk stream (q_offset = Tk - Tq).  lse float32
// (B, Hq, Tq): each row's log-sum-exp of its scaled scores in log2 units,
// log2 sum_k 2^(s_k scale log2 e), +inf for a row that sees no key (the
// convention of flash_attention_bwd.cu, whose dq kernel recomputes it);
// the forward kernel writes it.  dq (B, Hq, Tq, d), dk and dv (B, Hkv, Tk,
// d) are written contiguous in bf16.
//
// FlashAttention-2's backward in three steps, with no atomics, so two
// calls on the same inputs give the same bits:
//  * flash_attention_bwd_tc_dq_kernel, one block per (b, hq, 128-query
//    tile): Delta = rowsum(do * o) for its rows, by plain loads, stored to
//    a float32 (B, Hq, Tq) buffer for the second kernel; Q and dO stay in
//    shared memory and the block walks the visible key tiles of 64:
//    S = Q K^T and dP = dO V^T (wgmma, both operands from shared memory,
//    K-major), P = 2^(S scale log2 e - lse), dS = P (dP - Delta) in
//    registers, rounded to bf16, then dQ += dS K (wgmma, dS from
//    registers, K read transposed).  dq is stored times scale.
//  * flash_attention_bwd_tc_dkdv_kernel, one block per (key tile of 128,
//    b, hkv, head split): K and V stay in shared memory; the block walks
//    its query heads of the GQA group and, for each, the query tiles of
//    64 on or below the diagonal: S^T = K Q^T and dP^T = V dO^T (shared x
//    shared), P^T and dS^T in registers (the lse and Delta of the tile's
//    queries staged beside it), then dV += P^T dO and dK += dS^T Q with P^T
//    and dS^T from registers and dO and Q read transposed.  dk and dv stay
//    in float32 registers and are stored once, dk times scale.
//  * flash_attention_bwd_tc_reduce_kernel, only where the wrapper splits
//    a group's query heads over several dk/dv blocks (a grid below the
//    card's SM count, as chatglm3-6b's 2 KV heads at B 1): each block
//    wrote float32 partials of its heads; this sums them in split order.
// Both big kernels: 384 threads, two consumer warpgroups of 64 rows and a
// producer warpgroup that gives its registers to them (setmaxnreg) and
// whose first warp starts every TMA load: the resident tiles once, the
// streamed ones (K and V, or Q and dO) through a ring of three stages, each
// with a full and an empty mbarrier, so the loads run ahead of the math.
// Tiles are boxes of 64 columns with 128-byte swizzle, as in the forward:
// head dims run on its template instances D_I = 64 (d 16-64), 80 and 128
// (96-128); TMA fills the columns past d with zeros, which add nothing.
//
// Causal: tiles wholly above the diagonal are never loaded (the dq kernel
// stops at the last visible key tile; the dk/dv kernel starts at the first
// query tile that sees its keys); only tiles that straddle the diagonal or
// pass Tk are masked elementwise (P = 0).  A query past Tq has lse +inf
// and Delta 0, so its P and dS are 0; a key past Tk is never stored.  dS
// is 0 wherever P is, so a row that sees no key carries no gradient even
// where the forward left its output undefined.
//
// What bounds it on the H100: the five products of the bound (S, dP, dV,
// dK, dQ), each 2 B Hq d per visible (query, key) pair, at the tensor
// cores' 989 TFLOP/s bf16: 0.217 ms at stablelm-3b's B 1 x T 4096 x 32
// heads of 80.  This kernel runs seven (S and dP once more in the dq
// kernel, the price of no atomics).  What the design does about the five
// faults of the FFMA kernel (flash_attention_bwd.cu):
//  1. every product is a wgmma on the tensor cores (none on FFMA);
//  2. tiles stay bf16 in the swizzled layout wgmma reads, loaded by TMA
//     (no widening to float32 in shared memory);
//  3. the log-sum-exp comes from the forward: seven products, not eight;
//  4. TMA loads through mbarrier rings overlap the math of earlier tiles,
//     and the accumulators live in registers (240 a consumer thread);
//  5. a thin dk/dv grid (B Hkv key tiles below the SM count) splits the
//     group's query heads over blocks, summed in a fixed order.
// Numerics: P and dS are rounded to bf16 before the products that take
// them (FlashAttention-2's choice; the forward already rounds P), the
// accumulators are float32, ex2.approx is within 2 ulp of 2^x.
//
// Left for later: one warpgroup's softmax overlapping the other's products
// in turns (as the forward does), persistent blocks, cluster multicast of
// the shared tiles, dq by atomics (five products) where determinism is not
// asked for.
#include "wgmma_sm90.cuh"

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer wg
constexpr int kStages = 3;   // depth of the streamed tiles' ring
constexpr int kKeysKV = 128;  // dk/dv kernel: keys a block (2 x 64)
constexpr int kQryKV = 64;    // dk/dv kernel: queries a streamed tile
constexpr int kQryQ = 128;    // dq kernel: queries a block (2 x 64)
constexpr int kKeysQ = 64;    // dq kernel: keys a streamed tile

// The dk/dv kernel's shared memory for head dims up to D: K and V resident,
// then the ring of (Q, dO) tiles.
template <int D>
struct KvLayout {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kKV = kKeysKV * kBoxes * kRowBytes;  // K (or V)
  static constexpr int kTile = kQryKV * kBoxes * kRowBytes;  // Q (or dO)
  static constexpr int kStage = 2 * kTile;                   // Q then dO
  static constexpr int kBytes = 2 * kKV + kStages * kStage;
};

// The dq kernel's: Q and dO resident, then the ring of (K, V) tiles.
template <int D>
struct QLayout {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kQ = kQryQ * kBoxes * kRowBytes;     // Q (or dO)
  static constexpr int kTile = kKeysQ * kBoxes * kRowBytes;  // K (or V)
  static constexpr int kStage = 2 * kTile;                   // K then V
  static constexpr int kBytes = 2 * kQ + kStages * kStage;
};

// acc (64 x 64) = A B^T over D columns: A is this warpgroup's 64 rows of a
// tile at `a` whose column boxes lie a_rows rows apart, B the 64 rows of a
// tile at `b` (boxes b_rows rows apart); slice k lies in box k / 4, 32
// bytes per slice inside it, and scale_d = 0 on the first starts the sum.
template <int D>
__device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t a,
                                           int a_rows, uint32_t b,
                                           int b_rows) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k) {
    const uint32_t off = (k % 4) * 32;
    wgmma_ss_n64(acc,
                 desc_b128(a + (k / 4) * a_rows * kRowBytes + off, 16, 1024),
                 desc_b128(b + (k / 4) * b_rows * kRowBytes + off, 16, 1024),
                 k > 0);
  }
}

// Ends the registers' old values before a product restarts them (scale_d
// = 0), so they are not kept alive across the loop.
__device__ __forceinline__ void clear(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = 0.f;
}

// Stores rows row and row + 8 (i = 0, 1) of a 64 x D accumulator, times
// `mul`, to a contiguous bf16 (rows, width) matrix at `out`, the rows at
// or past `limit` left out.
template <int D, bool kPad>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 2],
                                           int row, int limit, int col0,
                                           int width, float mul) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= limit) continue;
    __nv_bfloat16* p = out + static_cast<int64_t>(r) * width + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!kPad || 8 * j < width)
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                  acc[4 * j + 2 * i + 1] * mul);
  }
}

// D: the instance's width; kPad: the head dim d is below it.
template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_tc_dq_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap do_map,
        const __nv_bfloat16* __restrict__ o,
        const __nv_bfloat16* __restrict__ dout,
        const float* __restrict__ lse, float* __restrict__ delta_out,
        __nv_bfloat16* __restrict__ dq, int64_t o_st, int64_t o_sh,
        int64_t o_sb, int64_t do_st, int64_t do_sh, int64_t do_sb, int d,
        int hq, int group, int tq, int tk, int n_bh, float scale,
        int causal) {
  using L = QLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + L::kQ;
  const uint32_t ring = do_s + L::kQ;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  // heaviest query tiles first: blockIdx.x runs over (b, h) fastest
  const int n_qb = static_cast<int>(gridDim.x) / n_bh;
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x) / n_bh;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / hq, h = bh % hq, kvh = h / group;
  const int q0 = qb * kQryQ;
  const int q_offset = tk - tq;
  int n_kb = (tk + kKeysQ - 1) / kKeysQ;
  if (causal) {
    const int last = q_offset + q0 + kQryQ - 1;  // the tile's last position
    n_kb = last < 0 ? 0 : min(n_kb, last / kKeysQ + 1);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(bar_q, 2 * L::kQ);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(q_s + c * kQryQ * kRowBytes, &q_map, bar_q, 64 * c, q0,
                    h, b);
        tma_load_4d(do_s + c * kQryQ * kRowBytes, &do_map, bar_q, 64 * c,
                    q0, h, b);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        // the first pass over the ring finds every stage empty
        mbar_wait(bar_empty + 8 * s, ((kb / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t k_t = ring + s * L::kStage, v_t = k_t + L::kTile;
        mbar_expect_tx(full, L::kStage);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(k_t + c * kKeysQ * kRowBytes, &k_map, full, 64 * c,
                      kb * kKeysQ, kvh, b);
          tma_load_4d(v_t + c * kKeysQ * kRowBytes, &v_map, full, 64 * c,
                      kb * kKeysQ, kvh, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // a consumer warpgroup: query rows 64 wg .. 64 wg + 63 of the tile; in
  // the accumulator layout this thread holds rows r and r + 8, columns
  // 8 j + col0 + {0, 1}
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int row0 = q0 + 64 * wg + r;
  const int qpos0 = q_offset + row0;           // stream position of row r
  const int wg_first = q_offset + q0 + 64 * wg;
  const float scale_log2 = scale * kLog2e;
  const int width = kPad ? d : D;

  // each of this thread's rows: its lse, and Delta = rowsum(do * o) over
  // the 4 threads of the row (a row past Tq: lse +inf, Delta 0)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float part = 0.f;
    lse_r[i] = INFINITY;
    if (row < tq) {
      lse_r[i] = lse[static_cast<int64_t>(bh) * tq + row];
      const __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_st;
      const __nv_bfloat16* drow = dout + b * do_sb + h * do_sh + row * do_st;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (kPad && 8 * j >= width) continue;
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + 8 * j + col0));
        const float2 y = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + 8 * j + col0));
        part = fmaf(x.x, y.x, fmaf(x.y, y.y, part));
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    delta_r[i] = part;
    if (lane % 4 == 0 && row < tq)
      delta_out[static_cast<int64_t>(bh) * tq + row] = part;
  }

  float acc[D / 2], s_acc[32], dp_acc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  uint32_t da[4][4];

  mbar_wait(bar_q, 0);
  const uint32_t qa = q_s + 64 * wg * kRowBytes;
  const uint32_t doa = do_s + 64 * wg * kRowBytes;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const int k0 = kb * kKeysQ;
    const uint32_t k_t = ring + s * L::kStage, v_t = k_t + L::kTile;
    mbar_wait(bar_full + 8 * s, (kb / kStages) & 1);
    clear(s_acc);
    clear(dp_acc);
    wgmma_fence();
    ss_product<D>(s_acc, qa, kQryQ, k_t, kKeysQ);  // S = Q K^T
    wgmma_commit();
    ss_product<D>(dp_acc, doa, kQryQ, v_t, kKeysQ);  // dP = dO V^T
    wgmma_commit();
    const bool masked =
        k0 + kKeysQ > tk || (causal && k0 + kKeysQ - 1 > wg_first);
    wgmma_wait<1>();
    fence_regs(s_acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s_acc[4 * j + e], scale_log2, -lse_r[e >> 1]));
        if (masked) {
          const int key = k0 + 8 * j + col0 + (e & 1);
          if (key >= tk || (causal && key > qpos0 + 8 * (e >> 1))) p = 0.f;
        }
        s_acc[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp_acc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = s_acc[i];
      dp_acc[i] = p == 0.f ? 0.f : p * (dp_acc[i] - delta_r[(i >> 1) & 1]);
    }
    pack_frags<4>(dp_acc, da);
    wgmma_fence();
    rs_product<D, 4>(acc, da, k_t, kKeysQ);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  store_rows<D, kPad>(dq + static_cast<int64_t>(bh) * tq * width, acc, row0,
                      tq, col0, width, scale);
}

template <int D, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_bwd_tc_dkdv_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap do_map,
        const float* __restrict__ lse, const float* __restrict__ delta,
        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
        float* __restrict__ part, int d, int hq, int hkv, int tq, int tk,
        int n_bkv, int n_split, float scale, int causal) {
  using L = KvLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  // each stage's queries: their lse and Delta, beside the Q and dO tiles
  __shared__ float stats[kStages][2][kQryKV];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + L::kKV;
  const uint32_t ring = v_s + L::kKV;
  const uint32_t bar_kv = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);
  const uint32_t bar_empty = smem_u32(&bars[1 + kStages]);

  // the first key tiles see the most queries under the causal mask: they
  // go first; blockIdx.x runs over (b, hkv, split) fastest
  const int per_kb = n_bkv * n_split;
  const int kb = static_cast<int>(blockIdx.x) / per_kb;
  const int rest = static_cast<int>(blockIdx.x) % per_kb;
  const int bkv = rest / n_split, split = rest % n_split;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int group = hq / hkv, heads = group / n_split;
  const int g0 = split * heads;
  const int k0 = kb * kKeysKV;
  const int q_offset = tk - tq;
  const int n_qt = (tq + kQryKV - 1) / kQryKV;
  // the first query tile holding a position at or past k0 (causal)
  const int qt0 = causal ? max(0, k0 - q_offset) / kQryKV : 0;
  const int nq = max(0, n_qt - qt0);
  const int n_it = heads * nq;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == kConsumerWarps) {
      // lane 0 starts the TMA loads; every lane stages two queries' lse
      // and Delta and arrives on the stage's full barrier after them
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(k_s + c * kKeysKV * kRowBytes, &k_map, bar_kv, 64 * c,
                      k0, kvh, b);
          tma_load_4d(v_s + c * kKeysKV * kRowBytes, &v_map, bar_kv, 64 * c,
                      k0, kvh, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        mbar_wait(bar_empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const int h = kvh * group + g0 + it / nq;
        const int q0 = (qt0 + it % nq) * kQryKV;
        const int64_t row = (static_cast<int64_t>(b) * hq + h) * tq;
        for (int i = lane; i < kQryKV; i += 32) {
          const int pos = q0 + i;
          stats[s][0][i] = pos < tq ? lse[row + pos] : INFINITY;
          stats[s][1][i] = pos < tq ? delta[row + pos] : 0.f;
        }
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {
          const uint32_t q_t = ring + s * L::kStage, do_t = q_t + L::kTile;
          mbar_expect_tx(full, L::kStage);
          for (int c = 0; c < L::kBoxes; ++c) {
            tma_load_4d(q_t + c * kQryKV * kRowBytes, &q_map, full, 64 * c,
                        q0, h, b);
            tma_load_4d(do_t + c * kQryKV * kRowBytes, &do_map, full,
                        64 * c, q0, h, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // a consumer warpgroup: keys 64 wg .. 64 wg + 63 of the block; this
  // thread holds key rows r and r + 8 of S^T and dP^T, query columns
  // 8 j + col0 + {0, 1}
  const int wg = warp / 4;
  const int r = 16 * (warp % 4) + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int kw = k0 + 64 * wg;  // the warpgroup's first key
  const int key0 = kw + r;      // this thread's first key
  const float scale_log2 = scale * kLog2e;
  const int width = kPad ? d : D;

  float acc_dk[D / 2], acc_dv[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  uint32_t pa[4][4], da[4][4];

  mbar_wait(bar_kv, 0);
  const uint32_t ka = k_s + 64 * wg * kRowBytes;
  const uint32_t va = v_s + 64 * wg * kRowBytes;
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qt0 + it % nq) * kQryKV;
    const uint32_t q_t = ring + s * L::kStage, do_t = q_t + L::kTile;
    mbar_wait(bar_full + 8 * s, (it / kStages) & 1);
    clear(st);
    clear(dpt);
    wgmma_fence();
    ss_product<D>(st, ka, kKeysKV, q_t, kQryKV);  // S^T = K Q^T
    wgmma_commit();
    ss_product<D>(dpt, va, kKeysKV, do_t, kQryKV);  // dP^T = V dO^T
    wgmma_commit();
    // keys above some query of the tile: mask elementwise
    const bool masked = causal && kw + 63 > q_offset + q0;
    const float* lse_s = stats[s][0];
    const float* delta_s = stats[s][1];
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col0 + (e & 1);
        float p = ex2(fmaf(st[4 * j + e], scale_log2, -lse_s[c]));
        if (masked && key0 + 8 * (e >> 1) > q_offset + q0 + c) p = 0.f;
        st[4 * j + e] = p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = st[4 * j + e];
        const float dl = delta_s[8 * j + col0 + (e & 1)];
        dpt[4 * j + e] = p == 0.f ? 0.f : p * (dpt[4 * j + e] - dl);
      }
    }
    pack_frags<4>(st, pa);
    pack_frags<4>(dpt, da);
    wgmma_fence();
    rs_product<D, 4>(acc_dv, pa, do_t, kQryKV);  // dV += P^T dO
    rs_product<D, 4>(acc_dk, da, q_t, kQryKV);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  const int64_t base = static_cast<int64_t>(bkv) * tk * width;
  if (n_split == 1) {
    store_rows<D, kPad>(dk + base, acc_dk, key0, tk, col0, width, scale);
    store_rows<D, kPad>(dv + base, acc_dv, key0, tk, col0, width, 1.f);
    return;
  }
  // float32 partials of this split's heads, summed by the reduce kernel
  const int64_t n = static_cast<int64_t>(n_bkv) * tk * width;
  float* pk = part + 2 * split * n + base;
  float* pv = pk + n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= tk) continue;
    const int64_t at = static_cast<int64_t>(key) * width + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!kPad || 8 * j < width) {
        *reinterpret_cast<float2*>(pk + at + 8 * j) =
            make_float2(acc_dk[4 * j + 2 * i], acc_dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<float2*>(pv + at + 8 * j) =
            make_float2(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
  }
}

// dk and dv from the splits' float32 partials (split s: dk at part[2 s n],
// dv at part[(2 s + 1) n]), summed in split order: dk times scale.
__global__ void flash_attention_bwd_tc_reduce_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int64_t n, int n_split, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < n_split; ++s) {
      sk += part[2 * s * n + i];
      sv += part[(2 * s + 1) * n + i];
    }
    dk[i] = __float2bfloat16(sk * scale);
    dv[i] = __float2bfloat16(sv);
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  float* part;
  int64_t b, hq, hkv, tq, tk, d;
  const int64_t *qs, *ks, *vs, *os, *dos;  // byte strides of T, H and B
  int n_split;
  float scale;
  int causal;
};

// The instance for head dims up to D, run at head dim d <= D (kPad: d <
// D): the dq kernel, the dk/dv kernel, and the reduce kernel where the
// group is split.
template <int D, bool kPad>
int launch(const Args& x, cudaStream_t stream) {
  const int64_t n_bh = x.b * x.hq, n_bkv = x.b * x.hkv;
  const int64_t blocks_q = n_bh * ((x.tq + kQryQ - 1) / kQryQ);
  const int64_t blocks_kv =
      n_bkv * x.n_split * ((x.tk + kKeysKV - 1) / kKeysKV);
  if (blocks_q == 0 || blocks_kv == 0) return 0;
  if (blocks_q >= (int64_t{1} << 31) || blocks_kv >= (int64_t{1} << 31) ||
      x.tq >= (int64_t{1} << 31) || x.tk >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  // the dq kernel reads Q and dO in 128-row boxes, K and V in 64; the dk/dv
  // kernel the other way round
  CUtensorMap mq[4], mkv[4];
  const void* ptrs[4] = {x.q, x.k, x.v, x.dout};
  const int64_t* strides[4] = {x.qs, x.ks, x.vs, x.dos};
  for (int i = 0; i < 4; ++i) {
    const bool query = i == 0 || i == 3;
    const int64_t t = query ? x.tq : x.tk, h = query ? x.hq : x.hkv;
    if (!make_map(&mq[i], ptrs[i], x.d, t, h, x.b, strides[i],
                  query ? kQryQ : kKeysQ) ||
        !make_map(&mkv[i], ptrs[i], x.d, t, h, x.b, strides[i],
                  query ? kQryKV : kKeysKV))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_q = QLayout<D>::kBytes + 1024;  // + room to align to 1024
  const int smem_kv = KvLayout<D>::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_tc_dq_kernel<D, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_tc_dkdv_kernel<D, kPad>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hq = static_cast<int>(x.hq), hkv = static_cast<int>(x.hkv);
  const int tq = static_cast<int>(x.tq), tk = static_cast<int>(x.tk);
  const int d = static_cast<int>(x.d);
  flash_attention_bwd_tc_dq_kernel<D, kPad>
      <<<static_cast<unsigned>(blocks_q), kThreads, smem_q, stream>>>(
          mq[0], mq[1], mq[2], mq[3],
          static_cast<const __nv_bfloat16*>(x.o),
          static_cast<const __nv_bfloat16*>(x.dout), x.lse, x.delta,
          static_cast<__nv_bfloat16*>(x.dq), x.os[0] / 2, x.os[1] / 2,
          x.os[2] / 2, x.dos[0] / 2, x.dos[1] / 2, x.dos[2] / 2, d, hq,
          hq / hkv, tq, tk, static_cast<int>(n_bh), x.scale, x.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_tc_dkdv_kernel<D, kPad>
      <<<static_cast<unsigned>(blocks_kv), kThreads, smem_kv, stream>>>(
          mkv[0], mkv[1], mkv[2], mkv[3], x.lse, x.delta,
          static_cast<__nv_bfloat16*>(x.dk),
          static_cast<__nv_bfloat16*>(x.dv), x.part, d, hq, hkv, tq, tk,
          static_cast<int>(n_bkv), x.n_split, x.scale, x.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess || x.n_split == 1) return static_cast<int>(err);
  const int64_t n = n_bkv * x.tk * x.d;
  const int64_t blocks =
      (n + 255) / 256 < (int64_t{1} << 16) ? (n + 255) / 256 : int64_t{1} << 16;
  flash_attention_bwd_tc_reduce_kernel<<<static_cast<unsigned>(blocks), 256,
                                         0, stream>>>(
      x.part, static_cast<__nv_bfloat16*>(x.dk),
      static_cast<__nv_bfloat16*>(x.dv), n, x.n_split, x.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, d a multiple of 16 from 16 to 128, run on the instance 64
// (d <= 64), 80 (d 80) or 128 (d 96-128).  Byte strides of the (T, H, B)
// dims of q, k, v, o and do (the D dim contiguous); the wrapper
// (kernels/flash_attention.py, tma_geometry) checks that each base is
// 16-byte aligned and every stride a multiple of 16 bytes.  lse (B, Hq,
// Tq) float32 from the forward; delta (B, Hq, Tq) float32 scratch; dq, dk
// and dv contiguous; n_split divides Hq / Hkv, and part is float32
// scratch of n_split x 2 x (B, Hkv, Tk, d) where n_split > 1 (else null).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int64_t b, int64_t hq, int64_t hkv, int64_t tq,
    int64_t tk, int64_t d, int64_t q_st, int64_t q_sh, int64_t q_sb,
    int64_t k_st, int64_t k_sh, int64_t k_sb, int64_t v_st, int64_t v_sh,
    int64_t v_sb, int64_t o_st, int64_t o_sh, int64_t o_sb, int64_t do_st,
    int64_t do_sh, int64_t do_sb, int n_split, float scale, int causal,
    void* stream) {
  if (hkv < 1 || hq % hkv != 0 || n_split < 1 || (hq / hkv) % n_split != 0 ||
      (n_split > 1 && part == nullptr) || d < 16 || d > 128 || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t qs[3] = {q_st, q_sh, q_sb}, ks[3] = {k_st, k_sh, k_sb},
                vs[3] = {v_st, v_sh, v_sb}, os[3] = {o_st, o_sh, o_sb},
                dos[3] = {do_st, do_sh, do_sb};
  const Args x{q, k, v, o, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               static_cast<float*>(part), b, hq, hkv, tq, tk, d, qs, ks, vs,
               os, dos, n_split, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64, false>(x, s);
  if (d < 64) return launch<64, true>(x, s);
  if (d == 80) return launch<80, false>(x, s);
  if (d == 128) return launch<128, false>(x, s);
  return launch<128, true>(x, s);
}
