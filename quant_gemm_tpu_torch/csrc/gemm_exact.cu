// K1: exact WxA8 decode GEMM, per-32 weights (q4_0, q4_1, q5_0, q5_1,
// q8_0, q4_k, q5_k, iq4_xs) x Q8_1 activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact (bodies _kernel and, for q8_0, _kernel_w8).  C[m, n] =
// sum_b term_b with sumi the exact int32 dot of block b's raw codes
// (4-bit nibbles, 5-bit codes with their qh bit moved in, or q8_0's
// signed bytes) and term_b the golden's per-format epilogue
// (ref/gemm.py::gemm_wxa8): q4_0 d_w(d_a sumi - 8 s_a), q5_0 d_w(d_a sumi
// - 16 s_a), q4_1 / q5_1 / q4_k / q5_k (a q4_K or q5_K tensor's effective
// q4_1 or q5_1 form) d_w d_a sumi + m_w s_a, q8_0 and iq4_xs (an IQ4_XS
// tensor's int8 codebook values with f32 per-32 scales) d_w d_a sumi, each step
// rounded on its own (common.cuh's W::term); the terms are summed in
// float32, as the TPU kernel sums them.
//
// The order of that sum is the old CUDA-core kernel's, bit for bit,
// because K2, K6 and K8 are held bit-equal to quantize_q8_1 + K1 (and
// run this body): with nt = 32 *
// k1_warps(nb) virtual threads, thread t adds the terms of blocks b = t,
// t + nt, ... in turn from 0, each group of 32 threads reduces with
// warp_sum's xor butterfly (lane 0's value), and the groups are added in
// order from 0 (kernels/gemm_exact.py::k1_order replays it).
//
// Bound on an H100: bytes.  At M <= 12 the weight stream (per 32 weights:
// 16 code bytes + 2 d bytes for q4_0, + 2 m for q4_1, + 4 qh for q5_0, +
// 6 for q5_1, 32 + 2 for q8_0, 16 + 8 f32 d' and m' bytes for q4_k, 16 +
// 4 + 8 for q5_k, 32 + 4 for iq4_xs) is everything; the activations are
// a few KB.  Design:
// k1.cuh's body (one int8 mma.sync m16n8k32 per 32-block, the order
// replayed in registers, a persistent grid streaming chunks of 32 blocks
// through a cp.async ring), with the Q8_1 codes and scales STREAMED from
// global memory in each chunk.  The launch reads nothing on the host and
// allocates nothing, so it can be captured in a CUDA graph.
#include "k1.cuh"

namespace {

using qgt::k1::Q8_1Act;

using qgt::k1::Planes;

template <typename W, int MT>
__global__ void __launch_bounds__(qgt::k1::THREADS)
    gemm_exact_kernel(const uint8_t* __restrict__ wq, Planes wp,
                      Q8_1Act act, float* __restrict__ out, int M, int N,
                      int K) {
  qgt::k1::gemm<W, MT, qgt::k1::STREAMED>(wq, wp, act,
                                          qgt::k1::Store{out, N}, M, N, K);
}

template <typename W, int MT>
int launch_mt(const void* wq, Planes wp, Q8_1Act act, void* out, int M,
              int N, int K, cudaStream_t stream) {
  static qgt::k1::Occupancy occ;
  return qgt::k1::launch<W, MT, qgt::k1::STREAMED>(
      gemm_exact_kernel<W, MT>, occ, wq, wp, act, out, M, N, K, stream);
}

template <typename W>
int launch(const void* wq, const void* wd, const void* wm, const void* wqh,
           const void* qa, const void* da, const void* sa, void* out, int M,
           int N, int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || K < qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q8_1Act act{static_cast<const int8_t*>(qa),
                    static_cast<const __half*>(da),
                    static_cast<const __half*>(sa)};
  const Planes wp{{static_cast<const uint8_t*>(wd),
                   static_cast<const uint8_t*>(wm),
                   static_cast<const uint8_t*>(wqh), nullptr}};
  if (M <= 8) return launch_mt<W, 1>(wq, wp, act, out, M, N, K, st);
  return launch_mt<W, 2>(wq, wp, act, out, M, N, K, st);
}

}  // namespace

// out f32 [M, N] = q4_0 W [N, K] (qs uint8 [N, K/2], d f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16 [M, K/32]).
QGT_EXPORT int qgt_gemm_exact_q4_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q4_0W>(wq, wd, nullptr, nullptr, qa, da, sa, out, M, N,
                            K, stream);
}

// out f32 [M, N] = q4_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_1(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q4_1W>(wq, wd, wm, nullptr, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_0 W [N, K] (qs uint8 [N, K/2] low four bits, d f16
//                  [N, K/32], qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_0(const void* wq, const void* wd,
                                   const void* wqh, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q5_0W>(wq, wd, nullptr, wqh, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32],
//                  qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_1(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q5_1W>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q8_0 W [N, K] (qs int8 [N, K], d f16 [N, K/32])
//                  x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q8_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q8_0W>(wq, wd, nullptr, nullptr, qa, da, sa, out, M, N,
                            K, stream);
}

// out f32 [M, N] = iq4_xs W [N, K] (codebook values int8 [N, K], the
//                  per-32 d * (sc - 32) f32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_iq4_xs(const void* wq, const void* wd,
                                     const void* qa, const void* da,
                                     const void* sa, void* out, int M, int N,
                                     int K, void* stream) {
  return launch<qgt::IQ4_XSW>(wq, wd, nullptr, nullptr, qa, da, sa, out, M,
                              N, K, stream);
}

// out f32 [M, N] = q4_k W [N, K] (qs uint8 [N, K/2], effective d', m' f32
//                  [N, K/32]) x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_k(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q4_KW>(wq, wd, wm, nullptr, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_k W [N, K] (qs uint8 [N, K/2] low four bits,
//                  effective d', m' f32 [N, K/32], qh u32 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q5_k(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q5_KW>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K,
                            stream);
}
