// Shared device code of the port's per-32 exact kernels, q4_0 and q4_k
// weights x Q8_1 activations (gemm_exact.cu, norm_qkv.cu,
// gemm_exact_fused.cu, attn_tail.cu): the in-kernel Q8_1 quantizer, the
// block dot, the block loop and K1's summation order.  Plain C interface,
// no PyTorch headers.
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Sum and max over the 8 lanes of an aligned group (xor 4, 2, 1).
__device__ __forceinline__ int group8_sum_int(int v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Q8_1 of one 32-block held by an aligned group of 8 lanes, 4 values a
// lane (lane j of the group holds elements 4j .. 4j+3), so one warp
// quantizes four blocks at once; every lane of the warp must call it.
// formats/quant.py::quantize_q8_1 step for step, each step rounded on
// its own, so codes and scales are bit-equal to it (max and the integer
// sum do not depend on the order):
//   d = f16(min(amax / 127, 65504)), q = clamp(rint(h * (d > 0 ? 1/d :
//   0)), +-127), s = f16(sat(sum(q) * d)).
// Returns the lane's four codes packed little-endian in an int; d and s
// (floats holding f16 values) go to every lane of the group.  Build
// without fast-math: the divisions and rint are IEEE.
struct Q8_1Code {
  int q4;
  float d;
  float s;
};

__device__ __forceinline__ Q8_1Code quantize_q8_1_block(const float (&h)[4]) {
  const float amax = group8_max(fmaxf(fmaxf(fabsf(h[0]), fabsf(h[1])),
                                      fmaxf(fabsf(h[2]), fabsf(h[3]))));
  const float d = __half2float(
      __float2half_rn(fminf(__fdiv_rn(amax, 127.0f), 65504.0f)));
  const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
  int q4 = 0, sumq = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = static_cast<int>(
        fminf(fmaxf(rintf(__fmul_rn(h[j], inv)), -127.0f), 127.0f));
    sumq += q;
    q4 |= (q & 0xff) << (8 * j);
  }
  sumq = group8_sum_int(sumq);
  const float s = __half2float(__float2half_rn(fminf(
      fmaxf(__fmul_rn(static_cast<float>(sumq), d), -65504.0f), 65504.0f)));
  return {q4, d, s};
}

__device__ __forceinline__ void store_scale(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_scale(__half* p, float v) {
  *p = __float2half_rn(v);  // exact: v holds an f16 value
}

// Q8_1 of the M x K values get(m, i) into codes qa [M, K] and scales da,
// sa [M, K/32] (f16 values as ScaleT), with quantize_q8_1_block: the
// (row, block) pairs in groups of four, warp w of nwarps taking groups
// w, w + nwarps, ...  The values of U groups are fetched before any of
// them is quantized, so that 4 U loads per lane are in flight.
template <int U, typename ScaleT, typename Get>
__device__ __forceinline__ void quantize_rows(Get get, int M, int K,
                                              int8_t* qa, ScaleT* da,
                                              ScaleT* sa, int warp,
                                              int nwarps, int lane) {
  const int nb = K / QK, pairs = M * nb;
  const int sub = lane >> 3, e = (lane & 7) * 4;  // pair in group, element
  for (int g0 = warp; 4 * g0 < pairs; g0 += U * nwarps) {
    float h[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = 4 * (g0 + u * nwarps) + sub;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[u][j] = p < pairs ? get(p / nb, (p % nb) * QK + e + j) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = 4 * (g0 + u * nwarps) + sub;
      if (4 * (g0 + u * nwarps) < pairs) {  // uniform across the warp
        const Q8_1Code c = quantize_q8_1_block(h[u]);
        if (p < pairs) {
          *reinterpret_cast<int*>(qa + (p / nb) * K + (p % nb) * QK + e) =
              c.q4;
          if (e == 0) {
            store_scale(da + p, c.d);
            store_scale(sa + p, c.s);
          }
        }
      }
    }
  }
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

// The per-32 weight formats of the exact kernels: where a block's scales
// are and its epilogue (ref/gemm.py::gemm_wxa8 order, each step rounded
// on its own).
struct Q4_0W {  // d f16 [N, nb]: d_w * (d_a * sumi - 8 * s_a)
  const __half* d;
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(__half2float(d[i]), 0.0f);
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return q4_0_term(w.x, da, sa, sumi);
  }
};

struct Q4_KW {  // effective d', m' f32 [N, nb]: d' * d_a * sumi + m' * s_a
  const float* d;
  const float* m;
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(d[i], m[i]);
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return __fadd_rn(__fmul_rn(__fmul_rn(w.x, da), static_cast<float>(sumi)),
                     __fmul_rn(w.y, sa));
  }
};

// Partial sums acc[c][m] of C[m, n0 + c] over the blocks b = b0, b0 +
// bstride, ... < nb, for NC consecutive weight rows (columns of C) and M
// <= MM rows, the block terms summed in float32 as the TPU kernel sums
// them.  Weights: qs uint8 [N, nb*16] and the scales of format W.
// Activations (global or shared memory): qa int8 [M, nb*32], da/sa
// [M, nb] of ScaleT.
template <int NC, typename ScaleT, typename W, int MM = MMAX>
__device__ __forceinline__ void exact_partial(
    const uint8_t* __restrict__ wq, const W fmt, int n0, int N, int nb,
    const int8_t* qa, const ScaleT* da, const ScaleT* sa, int M, int b0,
    int bstride, float (&acc)[NC][MM]) {
  const int K = nb * QK;
  for (int b = b0; b < nb; b += bstride) {
    uint4 w[NC];
    float2 sw[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (n0 + c < N) {
        const size_t row = static_cast<size_t>(n0 + c);
        w[c] = __ldg(reinterpret_cast<const uint4*>(wq + row * nb * 16) + b);
        sw[c] = fmt.scales(row * nb + b);
      } else {
        w[c] = make_uint4(0u, 0u, 0u, 0u);
        sw[c] = make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) {
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
              acc[c][m], W::term(sw[c], dam, sam, dot_q4_0_q8(w[c], a0, a1)));
      }
    }
  }
}

// K1's summation order, which K6 and K8 keep so that their GEMMs equal
// quantize_q8_1 + K1 bit for bit.  Warps per K1 block: enough that each
// thread keeps at least one K block to itself.
__host__ __device__ constexpr int k1_warps(int nb) {
  return nb >= 128 ? 4 : (nb >= 64 ? 2 : 1);
}

// Barrier over the nthreads threads (whole warps) of group `group`: its
// own named barrier (id group + 1; 0 is __syncthreads), or __syncwarp for
// a single warp.
__device__ __forceinline__ void group_sync(int group, int nthreads) {
  if (nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(nthreads)
                 : "memory");
  }
}

// C[m, n0 + c] (c < NC, m < M <= MM) in K1's order: the nthreads threads
// t = 0 .. nthreads-1 of a group of whole warps split the K blocks
// (exact_partial from b0 = t by nthreads), each warp reduces its partial
// sums with warp_sum into red[t / 32], and after sync() thread t adds
// red[0], red[1], ... in warp order for outputs u = t, t + nthreads, ...
// of the NC * M (c = u / M, m = u % M) and calls emit(c, m, sum), so one
// output always goes to the same thread.  Neither NC nor MM enters an
// output's order: K1 (NC = 4, MM = 12) and a caller with other values
// get the same bits whenever nthreads = 32 * k1_warps(nb).  Rows n0 + c
// >= N are not emitted.  The caller syncs again before red is rewritten.
template <int NC, typename ScaleT, typename W, int MM = MMAX, typename Sync,
          typename Emit>
__device__ __forceinline__ void k1_rows(const uint8_t* __restrict__ wq,
                                        const W fmt, int n0, int N, int nb,
                                        const int8_t* qa, const ScaleT* da,
                                        const ScaleT* sa, int M, int t,
                                        int nthreads, float (*red)[NC][MM],
                                        Sync sync, Emit emit) {
  float acc[NC][MM];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < MM; ++m) acc[c][m] = 0.0f;
  exact_partial<NC, ScaleT, W, MM>(wq, fmt, n0, N, nb, qa, da, sa, M, t,
                                   nthreads, acc);
  const int warp = t >> 5, lane = t & 31;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (m < M) {
        const float v = warp_sum(acc[c][m]);
        if (lane == 0) red[warp][c][m] = v;
      }
    }
  sync();
  for (int u = t; u < NC * M; u += nthreads) {
    const int c = u / M, m = u % M;
    if (n0 + c < N) {
      float s = 0.0f;
      for (int w = 0; w < nthreads / 32; ++w) s += red[w][c][m];
      emit(c, m, s);
    }
  }
}

}  // namespace qgt
