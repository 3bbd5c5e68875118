// K6: exact WxA8 decode GEMM with the Q8_1 quantization of the float
// activation inside the kernel, M <= 12, for the per-32 weights without a
// qh plane: q4_0, q4_1, q4_k, q8_0 and iq4_xs (the JAX dispatch keeps
// the q5 forms on quantize + K1).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact_fused (bodies _kernel_fused and, for q8_0, _kernel_w8_fused).
// out = gemm_exact(w, quantize_q8_1(x)) bit for bit, in every form and at
// every shape: the codes come from the shared quantizer
// (common.cuh::quantize_tile, bit-equal to formats/quant.py::
// quantize_q8_1), the scales are held as f16 (exact: they are f16
// values), and the GEMM is K1's own body and order (k1.cuh), only with
// the activation codes made in the kernel.
//
// Bound on an H100: bytes, the weight stream as for K1 plus the M*K*4
// bytes of x.  Design: k1.cuh's body on a persistent grid of clusters of
// 8 blocks.  Each block issues its first weight chunks, then, under those
// loads, quantizes an eighth of x's K blocks and stores the codes in the
// shared memory of all eight blocks, so the codes are RESIDENT in every
// block
// (M*(K+16) code bytes and 4*M*(K/32+8) scale bytes; 37 KB at M 8, K
// 4096).  Where they do not fit beside the ring (M 9-12 above K 8576 to
// 12224 by form, q8_0 at M 8 above K 13376) each chunk's 32 blocks are
// quantized into the ring as the chunk is staged (CHUNKED), which reads x
// once per row tile from L2 instead of once per block; fewer ring stages
// would not make room (k1.cuh).
#include "k1.cuh"

namespace {

using qgt::k1::FloatAct;

using qgt::k1::Planes;

template <typename W, int MT, int MODE>
__global__ void __launch_bounds__(qgt::k1::THREADS)
    gemm_exact_fused_kernel(const uint8_t* __restrict__ wq, Planes wp,
                            FloatAct act, float* __restrict__ out, int M,
                            int N, int K) {
  qgt::k1::gemm<W, MT, MODE>(wq, wp, act, qgt::k1::Store{out, N}, M, N, K);
}

template <typename W, int MT, int MODE>
int launch_mode(const void* wq, const void* wd, const void* wm,
                FloatAct act, void* out, int M, int N, int K,
                cudaStream_t stream) {
  static qgt::k1::Occupancy occ;
  const Planes wp{{static_cast<const uint8_t*>(wd),
                   static_cast<const uint8_t*>(wm), nullptr, nullptr}};
  return qgt::k1::launch<W, MT, MODE>(gemm_exact_fused_kernel<W, MT, MODE>,
                                      occ, wq, wp, act, out, M, N, K,
                                      stream);
}

template <typename W, int MT>
int launch_mt(const void* wq, const void* wd, const void* wm, FloatAct act,
              void* out, int M, int N, int K, cudaStream_t stream) {
  if (qgt::k1::fits_resident<W, MT>(M, K))
    return launch_mode<W, MT, qgt::k1::RESIDENT>(wq, wd, wm, act, out, M, N,
                                                 K, stream);
  return launch_mode<W, MT, qgt::k1::CHUNKED>(wq, wd, wm, act, out, M, N, K,
                                              stream);
}

template <typename W>
int launch(const void* wq, const void* wd, const void* wm, const void* x,
           void* out, int M, int N, int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || K < qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FloatAct act{static_cast<const float*>(x), K};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch_mt<W, 1>(wq, wd, wm, act, out, M, N, K, st);
  return launch_mt<W, 2>(wq, wd, wm, act, out, M, N, K, st);
}

}  // namespace

// out f32 [M, N] = gemm_exact(W, quantize_q8_1(x)), x f32 [M, K] 16-byte
// aligned, W q4_0 (qs uint8 [N, K/2], d f16 [N, K/32], 16-byte aligned).
QGT_EXPORT int qgt_gemm_exact_fused_q4_0(const void* wq, const void* wd,
                                         const void* x, void* out, int M,
                                         int N, int K, void* stream) {
  return launch<qgt::Q4_0W>(wq, wd, nullptr, x, out, M, N, K, stream);
}

// The same for q4_k W (qs uint8 [N, K/2], effective d', m' f32 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q4_k(const void* wq, const void* wd,
                                         const void* wm, const void* x,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  return launch<qgt::Q4_KW>(wq, wd, wm, x, out, M, N, K, stream);
}

// The same for q4_1 W (qs uint8 [N, K/2], d, m f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q4_1(const void* wq, const void* wd,
                                         const void* wm, const void* x,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  return launch<qgt::Q4_1W>(wq, wd, wm, x, out, M, N, K, stream);
}

// The same for q8_0 W (qs int8 [N, K], d f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q8_0(const void* wq, const void* wd,
                                         const void* x, void* out, int M,
                                         int N, int K, void* stream) {
  return launch<qgt::Q8_0W>(wq, wd, nullptr, x, out, M, N, K, stream);
}

// The same for iq4_xs W (codebook values int8 [N, K], d f32 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_iq4_xs(const void* wq, const void* wd,
                                           const void* x, void* out, int M,
                                           int N, int K, void* stream) {
  return launch<qgt::IQ4_XSW>(wq, wd, nullptr, x, out, M, N, K, stream);
}
