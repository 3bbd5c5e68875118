// Shared device code of the port's per-32 kernels (k1.cuh and the
// kernels on it, gemm_dequant.cu): the in-kernel Q8_1 quantizer, the
// per-32 weight formats (q4_0, q4_1, q5_0, q5_1, q8_0, q4_k, q5_k,
// iq4_xs: their
// scale planes, the golden's epilogue on an exact dot with Q8_1 codes,
// K4's dequantized values), and the warp count of K1's summation order
// (k1_warps).  Plain C interface, no PyTorch headers.
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

// Q8_1 of the M x nblk*32 values of a tile, with quantize_q8_1_block:
// get4(m, j) gives the values j .. j+3 of row m (j % 4 == 0), and put(m,
// b, e, code) takes the four codes e .. e+3 of block b of row m (and the
// block's d and s, which every lane of the block holds).  The (row,
// block) pairs go in groups of four, warp w of nwarps taking groups w, w
// + nwarps, ...  The values of U groups are fetched before any of them is
// quantized, so that U loads per lane are in flight.
template <int U, typename Get4, typename Put>
__device__ __forceinline__ void quantize_each(Get4 get4, int M, int nblk,
                                              Put put, int warp, int nwarps,
                                              int lane) {
  const int pairs = M * nblk;
  const int sub = lane >> 3, e = (lane & 7) * 4;  // pair in group, element
  for (int g0 = warp; 4 * g0 < pairs; g0 += U * nwarps) {
    float h[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = 4 * (g0 + u * nwarps) + sub;
      const float4 v = p < pairs ? get4(p / nblk, (p % nblk) * QK + e)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      h[u][0] = v.x;
      h[u][1] = v.y;
      h[u][2] = v.z;
      h[u][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = 4 * (g0 + u * nwarps) + sub;
      if (4 * (g0 + u * nwarps) < pairs) {  // uniform across the warp
        const Q8_1Code c = quantize_q8_1_block(h[u]);
        if (p < pairs) put(p / nblk, p % nblk, e, c);
      }
    }
  }
}

// quantize_each into codes qa (row m at qa + m * qstride bytes) and scales
// da, sa (row m at m * sstride elements; f16 values as ScaleT).
template <int U, typename ScaleT, typename Get4>
__device__ __forceinline__ void quantize_tile(Get4 get4, int M, int nblk,
                                              int8_t* qa, int qstride,
                                              ScaleT* da, ScaleT* sa,
                                              int sstride, int warp,
                                              int nwarps, int lane) {
  quantize_each<U>(
      get4, M, nblk,
      [&](int m, int b, int e, const Q8_1Code& c) {
        *reinterpret_cast<int*>(qa + m * qstride + b * QK + e) = c.q4;
        if (e == 0) {
          store_scale(da + m * sstride + b, c.d);
          store_scale(sa + m * sstride + b, c.s);
        }
      },
      warp, nwarps, lane);
}

// bit4(b) moves bits 0..3 of b to bit 4 of bytes 0..3 (a q5 code's fifth
// bit beside its low four).
__device__ __forceinline__ unsigned bit4(unsigned b) {
  return ((b & 1u) << 4) | ((b & 2u) << 11) | ((b & 4u) << 18) |
         ((b & 8u) << 25);
}

// The golden's per-block epilogues (ref/gemm.py::gemm_wxa8,
// gemm_reference.h:175-222), each step rounded on its own (no FMA
// contraction): an offset format d_w * (d_a * sumi - off * s_a), a min
// format d_w * d_a * sumi + m_w * s_a, q8_0 d_w * d_a * sumi.
__device__ __forceinline__ float offset_term(float dw, float da, float sa,
                                             int sumi, float off) {
  return __fmul_rn(dw, __fsub_rn(__fmul_rn(da, static_cast<float>(sumi)),
                                 __fmul_rn(off, sa)));
}

__device__ __forceinline__ float q4_0_term(float dw, float da, float sa,
                                           int sumi) {
  return offset_term(dw, da, sa, sumi, 8.0f);
}

__device__ __forceinline__ float min_term(float2 w, float da, float sa,
                                          int sumi) {
  return __fadd_rn(__fmul_rn(__fmul_rn(w.x, da), static_cast<float>(sumi)),
                   __fmul_rn(w.y, sa));
}

// K4's view of a block: the dequantized weights 4 qtr .. 4 qtr + 3 into
// v[0..3] and 16 + 4 qtr .. 16 + 4 qtr + 3 into v[4..7], from the codes
// (raw, 0..31 or signed int8) and the block's (d, m): (q - off) * d or,
// with a min, q * d + m rounded after each step, as the JAX kernels
// dequantize in float32.
__device__ __forceinline__ void q4_codes8(const uint8_t* wq, size_t blk,
                                          int qtr, int (&q)[8]) {
  const uint32_t w =
      __ldg(reinterpret_cast<const uint32_t*>(wq + blk * 16) + qtr);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = (w >> (8 * i)) & 15;
    q[4 + i] = (w >> (8 * i + 4)) & 15;
  }
}

__device__ __forceinline__ void add_bit4(unsigned h, int qtr, int (&q)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] |= ((h >> (4 * qtr + i)) & 1u) << 4;
    q[4 + i] |= ((h >> (16 + 4 * qtr + i)) & 1u) << 4;
  }
}

template <bool MIN>
__device__ __forceinline__ void values8(const int (&q)[8], float2 s,
                                        float off, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = MIN ? __fadd_rn(__fmul_rn(static_cast<float>(q[i]), s.x), s.y)
               : static_cast<float>(q[i] - static_cast<int>(off)) * s.x;
}

// The per-32 weight formats: their scale planes (scales), the golden's
// epilogue on a block's exact dot sumi with the Q8_1 codes (term,
// ref/gemm.py::gemm_wxa8 order) and K4's dequantized values (dequant8).
// Codes: qs [N, nb*16] bytes (q4/q5, the low four bits) or [N, nb*32]
// int8 (q8_0), at wq.
struct Q4W {  // the 4-bit code layout of q4_0, q4_1 and q4_k
  __device__ __forceinline__ static void codes8(const uint8_t* wq,
                                                size_t blk, int qtr,
                                                int (&q)[8]) {
    q4_codes8(wq, blk, qtr, q);
  }
};

// The 4-bit formats take their codes from Q4W (aggregates with their
// scale planes as the only members, so Q4_0W{d} initializes them).
#define QGT_Q4_CODES                                                        \
  __device__ __forceinline__ static void codes8(const uint8_t* wq,          \
                                                size_t blk, int qtr,        \
                                                int (&q)[8]) {              \
    Q4W::codes8(wq, blk, qtr, q);                                           \
  }

struct Q4_0W {  // d f16 [N, nb]: d_w * (d_a * sumi - 8 * s_a)
  const __half* d;
  QGT_Q4_CODES
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(__half2float(d[i]), 0.0f);
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return q4_0_term(w.x, da, sa, sumi);
  }
  static constexpr bool MIN = false;
  static constexpr float OFF = 8.0f;
};

struct Q4_KW {  // effective d', m' f32 [N, nb]: d' * d_a * sumi + m' * s_a
  const float* d;
  const float* m;
  QGT_Q4_CODES
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(d[i], m[i]);
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return min_term(w, da, sa, sumi);
  }
  static constexpr bool MIN = true;
  static constexpr float OFF = 0.0f;
};

struct Q4_1W {  // d, m f16 [N, nb]: d_w * d_a * sumi + m_w * s_a
  const __half* d;
  const __half* m;
  QGT_Q4_CODES
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(__half2float(d[i]), __half2float(m[i]));
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return min_term(w, da, sa, sumi);
  }
  static constexpr bool MIN = true;
  static constexpr float OFF = 0.0f;
};

#undef QGT_Q4_CODES

// q5_0 and q5_1: d (and m) f16 [N, nb], qh u32 [N, nb]; q5_k (a q5_K
// tensor in its effective q5_1 form): d', m' f32 [N, nb], qh u32 [N, nb]
template <bool HAS_MIN, typename S = __half>
struct Q5W {
  const S* d;
  const S* m;
  const unsigned* qh;
  __device__ __forceinline__ void codes8(const uint8_t* wq, size_t blk,
                                         int qtr, int (&q)[8]) const {
    q4_codes8(wq, blk, qtr, q);
    add_bit4(__ldg(qh + blk), qtr, q);
  }
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(to_f32(d[i]), HAS_MIN ? to_f32(m[i]) : 0.0f);
  }
  // q5_0: d_w * (d_a * sumi - 16 * s_a); q5_1, q5_k: d_w * d_a * sumi +
  // m_w * s_a
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return HAS_MIN ? min_term(w, da, sa, sumi)
                   : offset_term(w.x, da, sa, sumi, 16.0f);
  }
  static constexpr bool MIN = HAS_MIN;
  static constexpr float OFF = HAS_MIN ? 0.0f : 16.0f;
};
using Q5_0W = Q5W<false>;
using Q5_1W = Q5W<true>;
using Q5_KW = Q5W<true, float>;

// q8_0: int8 codes [N, nb*32], d f16 [N, nb]; iq4_xs (an IQ4_XS tensor in
// its effective form): the int8 codebook values [N, nb*32], d f32 [N, nb]
// (the per-32 d * (sc - 32)).  Both d_w * d_a * sumi.
template <typename S = __half>
struct Q8W {
  const S* d;
  __device__ __forceinline__ static void codes8(const uint8_t* wq,
                                                size_t blk, int qtr,
                                                int (&q)[8]) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(wq + blk * 32);
    const uint32_t w0 = __ldg(p + qtr), w1 = __ldg(p + 4 + qtr);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q[i] = static_cast<int8_t>((w0 >> (8 * i)) & 0xff);
      q[4 + i] = static_cast<int8_t>((w1 >> (8 * i)) & 0xff);
    }
  }
  __device__ __forceinline__ float2 scales(size_t i) const {
    return make_float2(to_f32(d[i]), 0.0f);
  }
  __device__ __forceinline__ static float term(float2 w, float da, float sa,
                                               int sumi) {
    return __fmul_rn(__fmul_rn(w.x, da), static_cast<float>(sumi));
  }
  static constexpr bool MIN = false;
  static constexpr float OFF = 0.0f;
};
using Q8_0W = Q8W<>;
using IQ4_XSW = Q8W<float>;

// K4: block b of weight row `row`, dequantized values 4 qtr .. +3 and
// 16 + 4 qtr .. +3 of the block into v (see values8).
template <typename W>
__device__ __forceinline__ void dequant8(const W& fmt, const uint8_t* wq,
                                         size_t row, int nb, int b, int qtr,
                                         float (&v)[8]) {
  const size_t blk = row * nb + b;
  int q[8];
  fmt.codes8(wq, blk, qtr, q);
  values8<W::MIN>(q, fmt.scales(blk), W::OFF, v);
}

// K1's summation order (k1.cuh): the warps that split a row's K blocks,
// enough that each virtual thread keeps at least one block to itself.
__host__ __device__ constexpr int k1_warps(int nb) {
  return nb >= 128 ? 4 : (nb >= 64 ? 2 : 1);
}

}  // namespace qgt
