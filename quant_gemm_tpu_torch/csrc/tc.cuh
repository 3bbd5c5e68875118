// Tensor-core building blocks of the kernels on the tensor cores
// (gemm_dequant.cu, flash_prefill.cu, flash_decode.cu, k1.cuh): the
// warp-level bf16 MMA m16n8k16 with float32 accumulation, the int8 MMAs
// m16n8k32 and m16n8k16 with int32 accumulation, ldmatrix, cp.async with zero
// fill, and the exact bf16 split of a float32.  sm_80 and later (built
// for sm_90a).  Plain C interface, no PyTorch headers.
//
// Fragment layout of mma.sync.aligned.m16n8k32 with 8-bit operands, for
// lane l, g = l / 4 and t = l % 4 (each register holds four bytes, the
// lowest k in the low byte):
//   A (16 x 32): a0 = (row g, k 4t..4t+3), a1 = (row g+8, k 4t..4t+3),
//                a2 = (row g, k 16+4t..), a3 = (row g+8, k 16+4t..);
//   B (32 x 8):  b0 = (k 4t..4t+3, col g), b1 = (k 16+4t.., col g);
//   C (16 x 8):  c0, c1 = (row g, col 2t, 2t+1), c2, c3 = (row g+8, ...).
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col (PTX ISA), for
// lane l, g = l / 4 and t = l % 4:
//   A (16 x 16): a0 = (row g, k 2t, 2t+1), a1 = (row g+8, k 2t, 2t+1),
//                a2 = (row g, k 2t+8, 2t+9), a3 = (row g+8, k 2t+8, 2t+9);
//   B (16 x 8):  b0 = (k 2t, 2t+1, col g), b1 = (k 2t+8, 2t+9, col g);
//   C (16 x 8):  c0, c1 = (row g, col 2t, 2t+1), c2, c3 = (row g+8, ...).
// Each register holds two bf16, the lower k (or col) in the low half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace qgt {

// c += a * b, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b (the accumulators start at zero)
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// c = a * b with 8-bit operands (A unsigned, or signed with S8), int32
// accumulators starting at zero: exact
template <bool S8>
__device__ __forceinline__ void mma_s32_zero(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  if constexpr (S8) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(0));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "r"(0));
  }
}

// c = a * b, m16n8k16 with signed 8-bit operands, int32 accumulators
// starting at zero (exact): A a0 = (row g, k 4t..4t+3), a1 = (row g+8,
// k 4t..4t+3), B b0 = (k 4t..4t+3, col g), C as above; the two halves
// of an m16n8k32 fragment, (a0, a1, b0) and (a2, a3, b1)
__device__ __forceinline__ void mma_s8_k16_zero(int (&c)[4], uint32_t a0,
                                                uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(0));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8 and receives (row l / 4, cols 2 (l % 4), +1) of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: lane l receives (rows 2 (l % 4), +1, col l / 4)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 (or 4) bytes global -> shared, asynchronously; only the first
// `bytes` (0 or all) are read, the rest of the destination is zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo + O(2^-16 |x|): hi = bf16(x), lo = bf16(x - hi), for two
// values at once (the low halves hold x0)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

}  // namespace qgt
