// K6: exact WxA8 decode GEMM with the Q8_1 quantization of the float
// activation inside the kernel, M <= 12, for the per-32 weights without a
// qh plane: q4_0, q4_1, q4_k and q8_0 (the JAX dispatch keeps the q5
// forms on quantize + K1).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact_fused (bodies _kernel_fused and, for q8_0, _kernel_w8_fused).
// out = gemm_exact(w, quantize_q8_1(x)) bit for bit, in every form: the
// codes come from the shared quantizer
// (common.cuh, bit-equal to formats/quant.py::quantize_q8_1), the scales
// are held as f16 in shared memory (exact: they are f16 values), and
// every output is summed in K1's order (common.cuh::k1_rows, which K1
// runs too): the same NC = 4 rows per K1 block, the same number of warps
// from nb, the same split of the K blocks over that block's threads, warp
// shuffles, then the warps' sums in warp order.
//
// Bound on an H100: bytes, the weight stream as for K1 plus the M*K*4
// bytes of x.  Design: a persistent grid of about SMs x occupancy
// blocks of 16 warps.  Each block quantizes x once into shared memory
// (M*K codes + 4*M*K/32 scale bytes: 76 KB at M = 12, K = 5632, above
// the 48 KB default), all 16 warps at four blocks a warp, and then
// runs up to 16 warps' worth of K1 blocks ("groups") side by side, each
// group looping over row groups of NC rows with its own named barrier.
// Had each of K1's N/4 blocks quantized x for itself, the lm_head (8000
// blocks) would read some 512 MB from L2 per call against 18 MB of
// weight.
#include "common.cuh"

namespace {

constexpr int NC = 4;             // K1's weight rows per block
constexpr int MAX_THREADS = 512;  // 16 warps per block

template <typename W>
__global__ void __launch_bounds__(MAX_THREADS)
    gemm_exact_fused_kernel(const uint8_t* __restrict__ wq, const W fmt,
                            const float* __restrict__ x,
                            float* __restrict__ out, int M, int N, int K,
                            int gwarps, int per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[MAX_THREADS / 32][NC][qgt::MMAX];
  const int nb = K / qgt::QK;
  int8_t* qa = reinterpret_cast<int8_t*>(smem);          // [M, K]
  __half* da = reinterpret_cast<__half*>(smem + M * K);  // [M, nb]
  __half* sa = da + M * nb;                              // [M, nb]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. Q8_1 of x into shared memory (the shared quantizer)
  qgt::quantize_rows<4>(
      [&](int m, int i) { return x[static_cast<size_t>(m) * K + i]; }, M, K,
      qa, da, sa, warp, blockDim.x >> 5, lane);
  __syncthreads();

  // 2. K1's body, one group of gwarps warps standing for one K1 block;
  //    the block's first per_block groups take part
  const int gthreads = gwarps * 32;
  const int group = threadIdx.x / gthreads, t = threadIdx.x % gthreads;
  const int row_groups = (N + NC - 1) / NC;
  if (group >= per_block) return;
  for (int g = blockIdx.x * per_block + group; g < row_groups;
       g += gridDim.x * per_block) {
    const int n0 = g * NC;
    qgt::k1_rows<NC, __half, W>(
        wq, fmt, n0, N, nb, qa, da, sa, M, t, gthreads, red + group * gwarps,
        [&] { qgt::group_sync(group, gthreads); },
        [&](int c, int m, float s) {
          out[static_cast<size_t>(m) * N + n0 + c] = s;
        });
    qgt::group_sync(group, gthreads);  // red is rewritten next row group
  }
}

template <typename W>
int launch(const void* wq, const W fmt, const void* x, void* out, int M,
           int N, int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = K / qgt::QK;
  const int gwarps = qgt::k1_warps(nb);  // part of K1's summation order
  // codes [M, K] int8, then d and s [M, nb] f16
  const size_t smem = static_cast<size_t>(M) * K +
                      2 * sizeof(__half) * static_cast<size_t>(M) * nb;
  auto kernel = gemm_exact_fused_kernel<W>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // every block has 16 warps for the quantization; of them, as many
  // groups take rows as 16 warps hold, fewer where the row groups would
  // otherwise leave SMs without a block
  const int row_groups = (N + NC - 1) / NC;
  const int most = MAX_THREADS / 32 / gwarps;
  const int per_block =
      row_groups >= most * sms ? most : (row_groups + sms - 1) / sms;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                    MAX_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int need = (row_groups + per_block - 1) / per_block;
  const dim3 grid(need < occ * sms ? need : occ * sms);
  gemm_exact_fused_kernel<W><<<grid, MAX_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wq), fmt, static_cast<const float*>(x),
      static_cast<float*>(out), M, N, K, gwarps, per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32 [M, N] = gemm_exact(W, quantize_q8_1(x)), x f32 [M, K], W q4_0
// (qs uint8 [N, K/2], d f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q4_0(const void* wq, const void* wd,
                                         const void* x, void* out, int M,
                                         int N, int K, void* stream) {
  return launch(wq, qgt::Q4_0W{static_cast<const __half*>(wd)}, x, out, M, N,
                K, stream);
}

// The same for q4_k W (qs uint8 [N, K/2], effective d', m' f32 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q4_k(const void* wq, const void* wd,
                                         const void* wm, const void* x,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  return launch(wq,
                qgt::Q4_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm)},
                x, out, M, N, K, stream);
}

// The same for q4_1 W (qs uint8 [N, K/2], d, m f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q4_1(const void* wq, const void* wd,
                                         const void* wm, const void* x,
                                         void* out, int M, int N, int K,
                                         void* stream) {
  return launch(wq,
                qgt::Q4_1W{static_cast<const __half*>(wd),
                           static_cast<const __half*>(wm)},
                x, out, M, N, K, stream);
}

// The same for q8_0 W (qs int8 [N, K], d f16 [N, K/32]).
QGT_EXPORT int qgt_gemm_exact_fused_q8_0(const void* wq, const void* wd,
                                         const void* x, void* out, int M,
                                         int N, int K, void* stream) {
  return launch(wq, qgt::Q8_0W{static_cast<const __half*>(wd)}, x, out, M, N,
                K, stream);
}
