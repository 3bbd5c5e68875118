// K4: dequant GEMM for prefill, bf16 activations x q4_0 weights.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_pallas.py::gemm
// (body _kernel_w4).  C[M, N] = A[M, K] @ ((q - 8) d)[N, K]^T; as in the
// JAX package, a Q8_1 activation is folded to bf16 before the call
// (registry.dispatch).  The products are summed in float32, as the TPU
// kernel accumulates them; the plain version's matmul sums in another
// order.
//
// Bound on an H100: at the prefill chunk the kernel serves (M <= 48) the
// weight stream still dominates (2*M*N*K operations against N*K*9/16
// weight bytes: 170 operations per byte at M = 48, below the ~295 a
// tensor-core product needs to leave the memory bound).  Design: a plain
// shared-memory tiled GEMM on the CUDA cores, the simple first
// version — a BM x BN = 64 x 32 output tile per 128-thread block, one
// 32-deep quant block per K step: the block's 64 bf16 activation rows and
// its 32 weight rows' codes are expanded to float32 in shared memory
// ((q - 8) * d is exact in float32), and each thread accumulates a 4 x 4
// patch with float32 FMA.  Moving the product onto the tensor cores
// (mma/wgmma on bf16 or int8 operands) is later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 32, BK = qgt::QK, THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    gemm_dequant_q4_0_kernel(const __nv_bfloat16* __restrict__ a,
                             const uint8_t* __restrict__ wq,
                             const __half* __restrict__ wd,
                             float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];
  const int nb = K / qgt::QK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b = 0; b < nb; ++b) {
    // activation tile: 64 rows x 32 bf16 = 256 vectors of 8
    for (int v = t; v < BM * BK / 8; v += THREADS) {
      const int row = v / (BK / 8), k8 = (v % (BK / 8)) * 8;
      float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (m0 + row < M) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            a + static_cast<size_t>(m0 + row) * K + b * BK + k8));
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) as[k8 + i][row] = f[i];
    }
    // weight tile: 32 rows x 16 code bytes; thread = (row, 4-byte quarter)
    {
      const int col = t / 4, qtr = t % 4;
      uint32_t w = 0x88888888u;  // codes 8 -> (q - 8) = 0 past N
      float d = 0.0f;
      if (n0 + col < N) {
        const size_t row = static_cast<size_t>(n0 + col);
        w = __ldg(reinterpret_cast<const uint32_t*>(wq + row * nb * 16 +
                                                    b * 16) + qtr);
        d = __half2float(wd[row * nb + b]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int byte = (w >> (8 * i)) & 0xff, j = 4 * qtr + i;
        ws[j][col] = static_cast<float>((byte & 15) - 8) * d;
        ws[j + 16][col] = static_cast<float>((byte >> 4) - 8) * d;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// out f32 [M, N] = A bf16 [M, K] @ dequant(W)^T, W q4_0 (qs uint8
// [N, K/2], d f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_dequant_q4_0(const void* a, const void* wq,
                                     const void* wd, void* out, int M, int N,
                                     int K, void* stream) {
  if (M < 1 || N < 1 || K % qgt::QK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_dequant_q4_0_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(wq),
      static_cast<const __half*>(wd), static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
