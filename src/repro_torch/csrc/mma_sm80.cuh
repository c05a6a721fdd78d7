// Warp-level tensor-core building blocks shared by the mma.sync flash
// kernels (flash_attention.cu, the forward, and flash_attention_bwd.cu, its
// gradient): cp.async staging of strided rows into padded shared-memory
// tiles, ldmatrix, the bf16 m16n8k16 and tf32 m16n8k8 mma.sync shapes, and
// the 3xTF32 split that gives float32 accuracy on the tf32 tensor cores.
// Everything sits in an anonymous namespace, so each source that includes
// it gets its own copy.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  int64_t b, h, t;  // element strides of the batch, head and position dims
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [p0, p0 + kRows) of one (T, D) slab (row stride st elements, D
// contiguous) into shared memory rows of kLd elements, columns [0, d):
// per_row copies of vec bytes a row (16, 8 or 4 by cp.async, 2 by a plain
// load).  Rows at or past `limit` are zero-filled (cp.async with src-size
// 0).  kThreads / kRows threads share a row, so no thread divides.
template <typename T, int kRows, int kLd, int kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t st,
                                           int p0, int limit, int per_row,
                                           int vec, int tid) {
  constexpr int kPerRow = kThreads / kRows;
  static_assert(kPerRow >= 1 && kThreads % kRows == 0, "rows per block");
  const int r = tid / kPerRow;
  const int pos = p0 + r;
  const bool ok = pos < limit;
  const int bytes = ok ? vec : 0;
  // an invalid row reads nothing; its address stays inside the slab
  const char* g = reinterpret_cast<const char*>(src) +
                  (ok ? static_cast<int64_t>(pos) * st * sizeof(T) : 0);
  char* s = reinterpret_cast<char*>(dst + r * kLd);
  for (int c = tid % kPerRow; c < per_row; c += kPerRow) {
    const char* gc = g + c * vec;
    char* sc = s + c * vec;
    if (vec == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(sc)), "l"(gc), "r"(bytes));
    } else if (vec == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                       smem_addr(sc)), "l"(gc), "r"(bytes));
    } else if (vec == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       smem_addr(sc)), "l"(gc), "r"(bytes));
    } else {
      *reinterpret_cast<uint16_t*>(sc) =
          ok ? *reinterpret_cast<const uint16_t*>(gc) : uint16_t{0};
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded (half away from zero) to TF32's 10 mantissa
// bits, and lo = x - hi exactly (Sterbenz), |lo| <= 2^-11 |x|.  The tensor
// cores read the top 10 mantissa bits of a .tf32 operand, so adding half of
// TF32's ulp to lo's bits rounds it there: lo carries x to about 2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c += a.b in 3xTF32 (lo.hi + hi.lo + hi.hi), both split by the caller
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bl0,
                                           uint32_t bh1, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 2^x by the SFU's ex2.approx (2 ulp; -1e30 gives 0): one instruction,
// where exp2f adds range handling around it
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace
