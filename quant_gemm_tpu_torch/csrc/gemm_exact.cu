// K1: exact W4A8 decode GEMM, q4_0 weights x Q8_1 activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact (body _kernel).  C[m, n] = sum_b d_w(d_a sumi - 8 s_a), with
// sumi the exact int32 dot of block b's raw codes (eight __dp4a), each
// block's term in the golden's order, and the terms summed in float32, as
// the TPU kernel sums them.
//
// Bound on an H100: bytes.  At M <= 12 the weight stream (N*K/2 code
// bytes + N*K/16 scale bytes) is everything; the activations are a few
// KB and stay in L1/L2.  Design: a block of NW warps owns NC = 4 weight
// rows and splits their K blocks over its threads, so every lane issues
// 16-byte loads of whole q4_0 blocks and the grid has N/4 blocks (8000
// for the 32000-row lm_head, 512 at N = 2048) to cover all SMs; warp
// shuffles and one shared-memory pass reduce the partial sums.
#include "common.cuh"

namespace {

constexpr int NC = 4;       // weight rows (output columns) per block
constexpr int MAX_WARPS = 4;

__global__ void gemm_exact_q4_0_kernel(const uint8_t* __restrict__ wq,
                                       const __half* __restrict__ wd,
                                       const int8_t* __restrict__ qa,
                                       const __half* __restrict__ da,
                                       const __half* __restrict__ sa,
                                       float* __restrict__ out, int M, int N,
                                       int K) {
  const int nb = K / qgt::QK;
  const int n0 = blockIdx.x * NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float acc[NC][qgt::MMAX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) acc[c][m] = 0.0f;

  qgt::exact_partial<NC, __half>(wq, wd, n0, N, nb, qa, da, sa, M,
                                 threadIdx.x, blockDim.x, acc);

  __shared__ float red[MAX_WARPS][NC][qgt::MMAX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) {
      if (m < M) {
        const float v = qgt::warp_sum(acc[c][m]);
        if (lane == 0) red[warp][c][m] = v;
      }
    }
  __syncthreads();
  // NC * M outputs, up to 48: more than one warp's threads
  for (int t = threadIdx.x; t < NC * M; t += blockDim.x) {
    const int c = t / M, m = t % M;
    if (n0 + c < N) {
      float s = 0.0f;
      for (int w = 0; w < nwarps; ++w) s += red[w][c][m];
      out[static_cast<size_t>(m) * N + n0 + c] = s;
    }
  }
}

}  // namespace

// out f32 [M, N] = q4_0 W [N, K] (qs uint8 [N, K/2], d f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16 [M, K/32]).
QGT_EXPORT int qgt_gemm_exact_q4_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = K / qgt::QK;
  // enough warps that each thread keeps at least one block to itself
  const int nwarps = nb >= 128 ? 4 : (nb >= 64 ? 2 : 1);
  const dim3 grid((N + NC - 1) / NC);
  gemm_exact_q4_0_kernel<<<grid, nwarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wq), static_cast<const __half*>(wd),
      static_cast<const int8_t*>(qa), static_cast<const __half*>(da),
      static_cast<const __half*>(sa), static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
