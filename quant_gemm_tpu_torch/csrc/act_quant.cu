// Q8_1 quantization of a float32 activation [M, K] in one launch: the
// codes and f16 scales (quantize_q8_1), or their bf16 fold qs * d
// (quantize_fold_q8_1, the prefill route's K4 operand).
//
// Not a TPU kernel: the counterpart of the one XLA fusion the JAX
// package's standalone quantize compiles to (quant_gemm_tpu/kernels/
// registry.py:148-157), where the port's plain version is about 27
// eager torch ops.  Bits: common.cuh::quantize_q8_1_block, the quantizer
// K1, K2, K6 and K8 share, which is formats/quant.py::quantize_q8_1 step
// for step, so qs, d and s (and the fold, bf16(float(q) * d) rounded to
// nearest even as torch's cast rounds) equal the torch twin bit for bit.
//
// Bound on an H100: bytes -- x read once (4 M K), the codes and two f16
// scales a block written once (M K + 4 M K / 32), or the fold (2 M K).
// Design: quantize_each's layout, one warp per group of four (row, block)
// pairs, a lane holding four consecutive values (one float4 load, one
// 4-byte code store); one group per warp, so every load of the launch is
// in flight at once; no shared memory.  At a decode GEMM's M 8 the
// launch is a few microseconds of latency, not bandwidth.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <bool FOLD>
__global__ void __launch_bounds__(THREADS)
    act_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ qs,
                     __half* __restrict__ d, __half* __restrict__ s,
                     __nv_bfloat16* __restrict__ fold, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * WARPS;
  const int nblk = K / qgt::QK;
  qgt::quantize_each<1>(
      [&](int m, int j) {
        return __ldg(reinterpret_cast<const float4*>(
            x + static_cast<size_t>(m) * K + j));
      },
      M, nblk,
      [&](int m, int b, int e, const qgt::Q8_1Code& c) {
        const size_t at = static_cast<size_t>(m) * K + b * qgt::QK + e;
        if (FOLD) {
          unsigned v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(
                static_cast<float>(static_cast<int8_t>(c.q4 >> (8 * i))),
                c.d)));
          *reinterpret_cast<uint2*>(fold + at) =
              make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
        } else {
          *reinterpret_cast<int*>(qs + at) = c.q4;
          if (e == 0) {
            const size_t sb = static_cast<size_t>(m) * nblk + b;
            d[sb] = __float2half_rn(c.d);  // exact: f16 values
            s[sb] = __float2half_rn(c.s);
          }
        }
      },
      warp, nwarps, lane);
}

int launch(bool fold, const void* x, void* qs, void* d, void* s, void* out,
           int M, int K, void* stream) {
  if (M < 1 || K < qgt::QK || K % qgt::QK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (static_cast<long long>(M) * (K / qgt::QK) + 3) / 4;
  const dim3 grid(static_cast<unsigned>((groups + WARPS - 1) / WARPS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  if (fold)
    act_quant_kernel<true><<<grid, THREADS, 0, st>>>(
        xp, nullptr, nullptr, nullptr, static_cast<__nv_bfloat16*>(out), M,
        K);
  else
    act_quant_kernel<false><<<grid, THREADS, 0, st>>>(
        xp, static_cast<int8_t*>(qs), static_cast<__half*>(d),
        static_cast<__half*>(s), nullptr, M, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Q8_1 of x f32 [M, K] (K % 32 == 0, x 16-byte aligned): codes qs int8
// [M, K], scales d and sums s f16 [M, K/32].
QGT_EXPORT int qgt_quantize_q8_1(const void* x, void* qs, void* d, void* s,
                                 int M, int K, void* stream) {
  return launch(false, x, qs, d, s, nullptr, M, K, stream);
}

// bf16 [M, K] = qs * d of the Q8_1 of x f32 [M, K].
QGT_EXPORT int qgt_quantize_fold_q8_1(const void* x, void* out, int M, int K,
                                      void* stream) {
  return launch(true, x, nullptr, nullptr, nullptr, out, M, K, stream);
}
