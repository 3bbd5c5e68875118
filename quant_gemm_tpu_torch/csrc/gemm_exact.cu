// K1: exact WxA8 decode GEMM, per-32 weights (q4_0, q4_1, q5_0, q5_1,
// q8_0, q4_k, q5_k) x Q8_1 activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact (bodies _kernel and, for q8_0, _kernel_w8).  C[m, n] =
// sum_b term_b with sumi the exact int32 dot of block b's raw codes (eight
// __dp4a: 4-bit nibbles, 5-bit codes with their qh bit moved in, or q8_0's
// signed bytes) and term_b the golden's per-format epilogue
// (ref/gemm.py::gemm_wxa8): q4_0 d_w(d_a sumi - 8 s_a), q5_0 d_w(d_a sumi
// - 16 s_a), q4_1 / q5_1 / q4_k / q5_k (a q4_K or q5_K tensor's effective
// q4_1 or q5_1 form) d_w d_a sumi + m_w s_a, q8_0 d_w d_a sumi, each step
// rounded on its own; the terms are summed in float32, as the TPU kernel
// sums them.
//
// Bound on an H100: bytes.  At M <= 12 the weight stream (per 32 weights:
// 16 code bytes + 2 d bytes for q4_0, + 2 m for q4_1, + 4 qh for q5_0, +
// 6 for q5_1, 32 + 2 for q8_0, 16 + 8 f32 d' and m' bytes for q4_k, 16 +
// 4 + 8 for q5_k) is everything; the activations are a few KB and stay in
// L1/L2.  Design: a
// block of NW warps owns NC = 4 weight rows and splits their K blocks over
// its threads, so every lane issues 16-byte loads of whole blocks (two for
// q8_0, plus the 4-byte qh word for q5) and the grid has N/4 blocks (8000
// for the 32000-row lm_head, 512 at N = 2048) to cover all SMs; warp
// shuffles and one shared-memory pass reduce the partial sums.  That
// order is common.cuh::k1_rows, which K6 and K8 share.
#include "common.cuh"

namespace {

constexpr int NC = 4;       // weight rows (output columns) per block
constexpr int MAX_WARPS = 4;

template <typename W>
__global__ void gemm_exact_kernel(const uint8_t* __restrict__ wq, const W fmt,
                                  const int8_t* __restrict__ qa,
                                  const __half* __restrict__ da,
                                  const __half* __restrict__ sa,
                                  float* __restrict__ out, int M, int N,
                                  int K) {
  const int n0 = blockIdx.x * NC;
  __shared__ float red[MAX_WARPS][NC][qgt::MMAX];
  qgt::k1_rows<NC, __half, W>(
      wq, fmt, n0, N, K / qgt::QK, qa, da, sa, M, threadIdx.x, blockDim.x,
      red, [] { __syncthreads(); },
      [&](int c, int m, float s) {
        out[static_cast<size_t>(m) * N + n0 + c] = s;
      });
}

template <typename W>
int launch(const void* wq, const W fmt, const void* qa, const void* da,
           const void* sa, void* out, int M, int N, int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwarps = qgt::k1_warps(K / qgt::QK);
  const dim3 grid((N + NC - 1) / NC);
  gemm_exact_kernel<W><<<grid, nwarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wq), fmt, static_cast<const int8_t*>(qa),
      static_cast<const __half*>(da), static_cast<const __half*>(sa),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32 [M, N] = q4_0 W [N, K] (qs uint8 [N, K/2], d f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16 [M, K/32]).
QGT_EXPORT int qgt_gemm_exact_q4_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch(wq, qgt::Q4_0W{static_cast<const __half*>(wd)}, qa, da, sa,
                out, M, N, K, stream);
}

// out f32 [M, N] = q4_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_1(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch(wq,
                qgt::Q4_1W{static_cast<const __half*>(wd),
                           static_cast<const __half*>(wm)},
                qa, da, sa, out, M, N, K, stream);
}

// out f32 [M, N] = q5_0 W [N, K] (qs uint8 [N, K/2] low four bits, d f16
//                  [N, K/32], qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_0(const void* wq, const void* wd,
                                   const void* wqh, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch(wq,
                qgt::Q5_0W{static_cast<const __half*>(wd), nullptr,
                           static_cast<const unsigned*>(wqh)},
                qa, da, sa, out, M, N, K, stream);
}

// out f32 [M, N] = q5_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32],
//                  qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_1(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch(wq,
                qgt::Q5_1W{static_cast<const __half*>(wd),
                           static_cast<const __half*>(wm),
                           static_cast<const unsigned*>(wqh)},
                qa, da, sa, out, M, N, K, stream);
}

// out f32 [M, N] = q8_0 W [N, K] (qs int8 [N, K], d f16 [N, K/32])
//                  x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q8_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch(wq, qgt::Q8_0W{static_cast<const __half*>(wd)}, qa, da, sa,
                out, M, N, K, stream);
}

// out f32 [M, N] = q4_k W [N, K] (qs uint8 [N, K/2], effective d', m' f32
//                  [N, K/32]) x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_k(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch(wq,
                qgt::Q4_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm)},
                qa, da, sa, out, M, N, K, stream);
}

// out f32 [M, N] = q5_k W [N, K] (qs uint8 [N, K/2] low four bits,
//                  effective d', m' f32 [N, K/32], qh u32 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q5_k(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch(wq,
                qgt::Q5_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm),
                           static_cast<const unsigned*>(wqh)},
                qa, da, sa, out, M, N, K, stream);
}
