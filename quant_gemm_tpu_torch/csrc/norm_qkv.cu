// K2: RMSNorm -> Q8_1 quantize -> exact GEMM on wqkv, one launch, for
// the 4- and 5-bit per-32 weights q4_0, q4_1, q4_k, q5_0, q5_1 and q5_k
// (the JAX kernel's _supported_w formats; it takes no q8_0).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_megalayer.py::
// norm_qkv (body _qkv_kernel, with has_min for q4_1 / q4_k / q5_1 / q5_k
// and has_qh for the q5 family).  Computes rms_norm -> quantize_q8_1 ->
// gemm_exact in float32 in the op order of ops/rms_norm.py
// (x * rsqrt(mean(x^2) + eps) * w), with the sum of squares in this
// kernel's own order, and each block term in the golden's per-format
// epilogue (common.cuh: the offset formats d_w (d_a sumi - off s_a), the
// min formats d_w d_a sumi + m_w s_a; the q5 codes take their fifth bit
// from the block's qh word).  A last-ulp difference in the normalised
// value can move a Q8_1 code across a .5 rounding tie, so kernel and
// plain version are compared with a tolerance, not bit for bit.
//
// Bound on an H100: bytes (the wqkv stream, N*K*9/16 for q4_0, up to
// N*K*7/8 for q5_k's f32 planes).  Design: every block recomputes the
// M <= 8 rows' RMSNorm and Q8_1 codes into shared memory (the rows are
// M*K*4 bytes, read from L2), then its warps run the K1 inner loop
// (common.cuh::exact_partial over the format struct W, as K1 and K6 take
// it) on NC weight rows each with the activation codes in shared memory.
// Each block covers NWARPS*NC = 16 weight rows, so the per-block prologue
// is amortised over 16 rows while the grid (160 blocks at N = 2560) still
// spreads over all SMs.
#include "common.cuh"

namespace {

constexpr int NC = 2;        // weight rows per warp
constexpr int NWARPS = 8;    // warps per block
constexpr int MMAX_QKV = 8;  // rows the fused kernel takes

template <typename W>
__global__ void norm_qkv_kernel(const float* __restrict__ x,
                                const float* __restrict__ nw, float eps,
                                const uint8_t* __restrict__ wq, const W fmt,
                                float* __restrict__ out, int M, int N,
                                int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = K / qgt::QK;
  int8_t* qa = reinterpret_cast<int8_t*>(smem);                 // [M, K]
  float* da = reinterpret_cast<float*>(smem + M * K);           // [M, nb]
  float* sa = da + M * nb;                                      // [M, nb]
  float* rinv = sa + M * nb;                                    // [M]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. per-row rsqrt(mean(x^2) + eps), as ops/rms_norm.py orders it
  for (int m = warp; m < M; m += NWARPS) {
    const float* xr = x + static_cast<size_t>(m) * K;
    float s = 0.0f;
#pragma unroll 8
    for (int i = lane; i < K; i += 32) s = __fadd_rn(s, __fmul_rn(xr[i], xr[i]));
    s = qgt::warp_sum(s);
    if (lane == 0)
      rinv[m] = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(K)), eps));
  }
  __syncthreads();

  // 2. h = x * rinv * w, then Q8_1 per 32-block (the shared quantizer)
  qgt::quantize_rows<4>(
      [&](int m, int i) {
        return __fmul_rn(__fmul_rn(x[static_cast<size_t>(m) * K + i], rinv[m]),
                         nw[i]);
      },
      M, K, qa, da, sa, warp, NWARPS, lane);
  __syncthreads();

  // 3. K1's inner loop on this warp's NC rows, lanes split the K blocks
  const int n0 = (blockIdx.x * NWARPS + warp) * NC;
  if (n0 >= N) return;
  float acc[NC][qgt::MMAX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) acc[c][m] = 0.0f;
  qgt::exact_partial<NC, float, W>(wq, fmt, n0, N, nb, qa, da, sa, M, lane,
                                   32, acc);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < MMAX_QKV; ++m) {
      if (m < M) {
        const float v = qgt::warp_sum(acc[c][m]);
        if (lane == c * MMAX_QKV + m && n0 + c < N)
          out[static_cast<size_t>(m) * N + n0 + c] = v;
      }
    }
}

template <typename W>
int launch(const void* x, const void* nw, float eps, const void* wq,
           const W fmt, void* out, int M, int N, int K, void* stream) {
  if (M < 1 || M > MMAX_QKV || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = K / qgt::QK;
  const size_t smem = static_cast<size_t>(M) * K + 2 * sizeof(float) * M * nb +
                      sizeof(float) * M;
  auto kernel = norm_qkv_kernel<W>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_block = NWARPS * NC;
  const dim3 grid((N + per_block - 1) / per_block);
  kernel<<<grid, NWARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(nw), eps,
      static_cast<const uint8_t*>(wq), fmt, static_cast<float*>(out), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}

const __half* h(const void* p) { return static_cast<const __half*>(p); }
const float* fp(const void* p) { return static_cast<const float*>(p); }
const unsigned* up(const void* p) { return static_cast<const unsigned*>(p); }

}  // namespace

// Every entry point: out f32 [M, N] = gemm_exact(W, quantize_q8_1(
// rms_norm(x, nw, eps))), x f32 [M, K], nw f32 [K], W's codes at wq
// (uint8 [N, K/2], the low four bits for q5) and its planes in the order
// d, m, qh: f16 d (and m) [N, K/32], q4_k and q5_k f32 d' and m', q5 u32
// qh [N, K/32].
QGT_EXPORT int qgt_norm_qkv_q4_0(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd, void* out,
                                 int M, int N, int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q4_0W{h(wd)}, out, M, N, K, stream);
}

QGT_EXPORT int qgt_norm_qkv_q4_1(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, void* out, int M, int N,
                                 int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q4_1W{h(wd), h(wm)}, out, M, N, K,
                stream);
}

QGT_EXPORT int qgt_norm_qkv_q4_k(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, void* out, int M, int N,
                                 int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q4_KW{fp(wd), fp(wm)}, out, M, N, K,
                stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_0(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wqh, void* out, int M, int N,
                                 int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q5_0W{h(wd), nullptr, up(wqh)}, out, M,
                N, K, stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_1(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, const void* wqh, void* out,
                                 int M, int N, int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q5_1W{h(wd), h(wm), up(wqh)}, out, M, N,
                K, stream);
}

QGT_EXPORT int qgt_norm_qkv_q5_k(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd,
                                 const void* wm, const void* wqh, void* out,
                                 int M, int N, int K, void* stream) {
  return launch(x, nw, eps, wq, qgt::Q5_KW{fp(wd), fp(wm), up(wqh)}, out, M,
                N, K, stream);
}
