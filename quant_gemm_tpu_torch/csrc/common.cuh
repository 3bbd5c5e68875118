// Shared device code of the port's q4_0 x Q8_1 exact kernels
// (gemm_exact.cu, norm_qkv.cu).  Plain C interface, no PyTorch headers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QGT_EXPORT extern "C" __attribute__((visibility("default")))

QGT_EXPORT const char* qgt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace qgt {

constexpr int QK = 32;     // elements per quant block
constexpr int MMAX = 12;   // most activation rows the exact kernels take
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Exact int32 dot of one q4_0 block (16 bytes; byte j = code j | code j+16
// << 4, raw codes 0..15) with its 32 int8 activation codes (a0: codes
// 0..15, a1: codes 16..31): eight dp4a.
__device__ __forceinline__ int dot_q4_0_q8(uint4 w, int4 a0, int4 a1) {
  const unsigned lo = 0x0F0F0F0Fu;
  int s = 0;
  s = __dp4a(static_cast<int>(w.x & lo), a0.x, s);
  s = __dp4a(static_cast<int>(w.y & lo), a0.y, s);
  s = __dp4a(static_cast<int>(w.z & lo), a0.z, s);
  s = __dp4a(static_cast<int>(w.w & lo), a0.w, s);
  s = __dp4a(static_cast<int>((w.x >> 4) & lo), a1.x, s);
  s = __dp4a(static_cast<int>((w.y >> 4) & lo), a1.y, s);
  s = __dp4a(static_cast<int>((w.z >> 4) & lo), a1.z, s);
  s = __dp4a(static_cast<int>((w.w >> 4) & lo), a1.w, s);
  return s;
}

// The golden's per-block epilogue for q4_0: d_w * (d_a * sumi - 8 * s_a),
// each step rounded on its own (no FMA contraction), as in
// gemm_reference.h:175-222.
__device__ __forceinline__ float q4_0_term(float dw, float da, float sa,
                                           int sumi) {
  return __fmul_rn(dw, __fsub_rn(__fmul_rn(da, static_cast<float>(sumi)),
                                 __fmul_rn(8.0f, sa)));
}

// Partial sums acc[c][m] of C[m, n0 + c] over the blocks b = b0, b0 +
// bstride, ... < nb, for NC consecutive weight rows (columns of C), the
// block terms summed in float32 as the TPU kernel sums them.
// Weights: qs uint8 [N, nb*16], d f16 [N, nb].  Activations (global or
// shared memory): qa int8 [M, nb*32], da/sa [M, nb] of ScaleT.
template <int NC, typename ScaleT>
__device__ __forceinline__ void exact_partial(
    const uint8_t* __restrict__ wq, const __half* __restrict__ wd, int n0,
    int N, int nb, const int8_t* qa, const ScaleT* da, const ScaleT* sa,
    int M, int b0, int bstride, float (&acc)[NC][MMAX]) {
  const int K = nb * QK;
  for (int b = b0; b < nb; b += bstride) {
    uint4 w[NC];
    float dw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (n0 + c < N) {
        const size_t row = static_cast<size_t>(n0 + c);
        w[c] = __ldg(reinterpret_cast<const uint4*>(wq + row * nb * 16) + b);
        dw[c] = __half2float(wd[row * nb + b]);
      } else {
        w[c] = make_uint4(0u, 0u, 0u, 0u);
        dw[c] = 0.0f;
      }
    }
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      if (m < M) {
        const int4* ap =
            reinterpret_cast<const int4*>(qa + static_cast<size_t>(m) * K) +
            2 * b;
        const int4 a0 = ap[0];
        const int4 a1 = ap[1];
        const float dam = to_f32(da[m * nb + b]);
        const float sam = to_f32(sa[m * nb + b]);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[c][m] = __fadd_rn(
              acc[c][m], q4_0_term(dw[c], dam, sam, dot_q4_0_q8(w[c], a0, a1)));
      }
    }
  }
}

}  // namespace qgt
