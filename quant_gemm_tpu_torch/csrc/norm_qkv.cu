// K2: RMSNorm -> Q8_1 quantize -> exact q4_0 GEMM on wqkv, one launch.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_megalayer.py::
// norm_qkv (body _qkv_kernel).  Computes rms_norm -> quantize_q8_1 ->
// gemm_exact in float32 in the op order of ops/rms_norm.py
// (x * rsqrt(mean(x^2) + eps) * w), with the sum of squares in this
// kernel's own order.  A last-ulp difference in the normalised value can
// move a Q8_1 code across a .5 rounding tie, so kernel and plain version
// are compared with a tolerance, not bit for bit.
//
// Bound on an H100: bytes (the wqkv stream, N*K*9/16).  Design: every
// block recomputes the M <= 8 rows' RMSNorm and Q8_1 codes into shared
// memory (the rows are M*K*4 bytes, read from L2), then its warps run
// the K1 inner loop on NC weight rows each with the activation codes in
// shared memory.  Each block covers NWARPS*NC = 16 weight rows, so the
// per-block prologue is amortised over 16 rows while the grid (160
// blocks at N = 2560) still spreads over all SMs.
#include "common.cuh"

namespace {

constexpr int NC = 2;        // weight rows per warp
constexpr int NWARPS = 8;    // warps per block
constexpr int MMAX_QKV = 8;  // rows the fused kernel takes

__global__ void norm_qkv_q4_0_kernel(const float* __restrict__ x,
                                     const float* __restrict__ nw, float eps,
                                     const uint8_t* __restrict__ wq,
                                     const __half* __restrict__ wd,
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
    for (int i = lane; i < K; i += 32) s = __fadd_rn(s, __fmul_rn(xr[i], xr[i]));
    s = qgt::warp_sum(s);
    if (lane == 0)
      rinv[m] = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(K)), eps));
  }
  __syncthreads();

  // 2. h = x * rinv * w, then Q8_1 per 32-block: one warp per (row, block)
  for (int p = warp; p < M * nb; p += NWARPS) {
    const int m = p / nb, b = p % nb, i = b * qgt::QK + lane;
    const float h =
        __fmul_rn(__fmul_rn(x[static_cast<size_t>(m) * K + i], rinv[m]), nw[i]);
    const float amax = qgt::warp_max(fabsf(h));
    const float d = __half2float(
        __float2half_rn(fminf(__fdiv_rn(amax, 127.0f), 65504.0f)));
    const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
    const float qf = fminf(fmaxf(rintf(__fmul_rn(h, inv)), -127.0f), 127.0f);
    const int q = static_cast<int>(qf);
    qa[m * K + i] = static_cast<int8_t>(q);
    const int sumq = qgt::warp_sum_int(q);
    if (lane == 0) {
      const float s = fminf(fmaxf(__fmul_rn(static_cast<float>(sumq), d),
                                  -65504.0f), 65504.0f);
      da[m * nb + b] = d;
      sa[m * nb + b] = __half2float(__float2half_rn(s));
    }
  }
  __syncthreads();

  // 3. K1's inner loop on this warp's NC rows, lanes split the K blocks
  const int n0 = (blockIdx.x * NWARPS + warp) * NC;
  if (n0 >= N) return;
  float acc[NC][qgt::MMAX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) acc[c][m] = 0.0f;
  qgt::exact_partial<NC, float>(wq, wd, n0, N, nb, qa, da, sa, M, lane, 32,
                                acc);
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

}  // namespace

// out f32 [M, N] = gemm_exact(W, quantize_q8_1(rms_norm(x, nw, eps))),
// x f32 [M, K], nw f32 [K], W q4_0 (qs uint8 [N, K/2], d f16 [N, K/32]).
QGT_EXPORT int qgt_norm_qkv_q4_0(const void* x, const void* nw, float eps,
                                 const void* wq, const void* wd, void* out,
                                 int M, int N, int K, void* stream) {
  if (M < 1 || M > MMAX_QKV || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = K / qgt::QK;
  const size_t smem = static_cast<size_t>(M) * K + 2 * sizeof(float) * M * nb +
                      sizeof(float) * M;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        norm_qkv_q4_0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int per_block = NWARPS * NC;
  const dim3 grid((N + per_block - 1) / per_block);
  norm_qkv_q4_0_kernel<<<grid, NWARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(nw), eps,
      static_cast<const uint8_t*>(wq), static_cast<const __half*>(wd),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
