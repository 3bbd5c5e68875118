// K2: RMSNorm -> Q8_1 quantize -> exact GEMM on wqkv, one launch, for
// the 4- and 5-bit per-32 weights q4_0, q4_1, q4_k, q5_0, q5_1 and q5_k
// (the JAX kernel's _supported_w formats; it takes no q8_0), M <= 8.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_megalayer.py::
// norm_qkv (body _qkv_kernel, with has_min for q4_1 / q4_k / q5_1 / q5_k
// and has_qh for the q5 family).  Computes rms_norm -> quantize_q8_1 ->
// gemm_exact in float32: the RMSNorm in the op order of ops/rms_norm.py
// (x * rsqrt(mean(x^2) + eps) * w) with the sum of squares in one fixed
// order of this kernel's, the Q8_1 codes with the shared quantizer
// (common.cuh::quantize_tile, bit-equal to quantize_q8_1), and the GEMM
// in K1's order with K1's epilogues (k1.cuh).  So K2 equals quantize_q8_1
// + K1 bit for bit whenever its normalised rows equal the plain
// version's (rows of +-1 with eps 0, say); elsewhere a last-ulp
// difference in the normalised value can move a Q8_1 code across a .5
// rounding tie, and kernel and plain version agree to a tolerance.
//
// Bound on an H100: bytes (the wqkv stream, N*K*9/16 for q4_0, up to
// N*K*7/8 for q5_k's f32 planes).  Design: k1.cuh's body on a persistent
// grid of clusters of 8 blocks.  Each block issues its first weight
// chunks, then, under those loads, normalises and quantizes an eighth of
// the M rows' K blocks and stores the codes in the shared memory of all
// eight blocks, so the codes of x are RESIDENT in every block (CHUNKED,
// each chunk quantized as it is staged, where they do not fit: K above
// 15072 to 18816 by form), and streams its row tiles through the int8
// tensor cores.  The old kernel recomputed the norm and the codes in each of
// its ceil(N/16) blocks (384 at Mistral's wqkv).
#include "k1.cuh"

namespace {

using qgt::k1::NormAct;

using qgt::k1::Planes;

template <typename W, int MODE>
__global__ void __launch_bounds__(qgt::k1::THREADS)
    norm_qkv_kernel(const uint8_t* __restrict__ wq, Planes wp, NormAct act,
                    float* __restrict__ out, int M, int N, int K) {
  qgt::k1::gemm<W, 1, MODE>(wq, wp, act, qgt::k1::Store{out, N}, M, N, K);
}

template <typename W, int MODE>
int launch_mode(const void* wq, const void* wd, const void* wm,
                const void* wqh, NormAct act, void* out, int M, int N, int K,
                cudaStream_t stream) {
  static qgt::k1::Occupancy occ;
  const Planes wp{{static_cast<const uint8_t*>(wd),
                   static_cast<const uint8_t*>(wm),
                   static_cast<const uint8_t*>(wqh), nullptr}};
  return qgt::k1::launch<W, 1, MODE>(norm_qkv_kernel<W, MODE>, occ, wq, wp,
                                     act, out, M, N, K, stream);
}

template <typename W>
int launch(const void* x, const void* nw, float eps, const void* wq,
           const void* wd, const void* wm, const void* wqh, void* out, int M,
           int N, int K, void* stream) {
  if (M < 1 || M > qgt::k1::WARPS || K % qgt::QK || K < qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const NormAct act{static_cast<const float*>(x),
                    static_cast<const float*>(nw), eps, K, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qgt::k1::fits_resident<W, 1>(M, K))
    return launch_mode<W, qgt::k1::RESIDENT>(wq, wd, wm, wqh, act, out, M,
                                             N, K, st);
  return launch_mode<W, qgt::k1::CHUNKED>(wq, wd, wm, wqh, act, out, M, N,
                                          K, st);
}

}  // namespace

// Every entry point: out f32 [M, N] = gemm_exact(W, quantize_q8_1(
// rms_norm(x, nw, eps))), x f32 [M, K] and nw f32 [K] 16-byte aligned,
// W's codes at wq (uint8 [N, K/2], the low four bits for q5) and its
// planes in the order d, m, qh, each 16-byte aligned: f16 d (and m)
// [N, K/32], q4_k and q5_k f32 d' and m', q5 u32 qh [N, K/32].
QGT_EXPORT int qgt_norm_qkv_q4_0(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd, void* out,
                                 int M, int N, int K, void* stream) {
  return launch<qgt::Q4_0W>(x, nw, eps, wq, wd, nullptr, nullptr, out, M, N,
                            K, stream);
}

QGT_EXPORT int qgt_norm_qkv_q4_1(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, void* out, int M, int N,
                                 int K, void* stream) {
  return launch<qgt::Q4_1W>(x, nw, eps, wq, wd, wm, nullptr, out, M, N, K,
                            stream);
}

QGT_EXPORT int qgt_norm_qkv_q4_k(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, void* out, int M, int N,
                                 int K, void* stream) {
  return launch<qgt::Q4_KW>(x, nw, eps, wq, wd, wm, nullptr, out, M, N, K,
                            stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_0(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wqh, void* out, int M, int N,
                                 int K, void* stream) {
  return launch<qgt::Q5_0W>(x, nw, eps, wq, wd, nullptr, wqh, out, M, N, K,
                            stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_1(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, const void* wqh, void* out,
                                 int M, int N, int K, void* stream) {
  return launch<qgt::Q5_1W>(x, nw, eps, wq, wd, wm, wqh, out, M, N, K,
                            stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_k(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, const void* wqh, void* out,
                                 int M, int N, int K, void* stream) {
  return launch<qgt::Q5_KW>(x, nw, eps, wq, wd, wm, wqh, out, M, N, K,
                            stream);
}
