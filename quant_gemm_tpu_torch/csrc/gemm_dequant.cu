// K4: dequant GEMM for prefill, bf16 or float32 activations x per-32
// weights (q4_0, q4_1, q5_0, q5_1, q8_0, q4_k, q5_k), optionally with the
// activation fake-quantized per 32-block inside the kernel (fused_quant).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_pallas.py::gemm
// (bodies _kernel_w4 and, for q8_0, _kernel_w8).  C[M, N] = A[M, K] @
// W[N, K]^T with W = (q - 8) d (q4_0), (q - 16) d (q5_0), q d (q8_0) or
// q d + m (q4_1, q5_1, and q4_k / q5_k with a q4_K / q5_K tensor's
// effective f32 scale and min: the has_min branch of _kernel_w4); the
// 5-bit codes take their fifth bit from the block's qh word (_kernel_w4's
// has_qh).  A is bf16 (the serving prefill; a Q8_1 activation is folded to
// bf16 before the call, as gemm_pallas.py:554-562 does) or float32 (the
// JAX ladder's pallas_f32, which keeps A in f32).  The products are summed
// in float32, as the TPU kernel accumulates them; the plain version's
// matmul sums in another order.
//
// fused_quant (fq != 0; gemm_pallas.py's fused_quant=True, the body
// _fake_quant_q8): every 32-block of a float A row is fake-quantized in
// the A-tile prologue, d = amax / 127 in float32, inv = d > 0 ? 1/d : 0,
// a' = clamp(rint(a * inv), -127, 127) * d, each step rounded on its own,
// so a' is bit-equal to the plain version's; fq = 2 then rounds a' to
// bf16 (the serving operand type), fq = 1 keeps it float32.  This is not
// Q8_1: d is not rounded to f16 and no s = d * sum(q) is formed.
//
// Bound on an H100: operations at the serving prefill chunk of 128 rows
// (2*M*N*K operations against N*K*9/16 weight bytes: 455 operations per
// byte at M = 128, above the ~295 where the bf16 tensor cores, not the
// memory, become the limit), bytes only below M of about 80.  Design: a
// plain shared-memory tiled GEMM on the CUDA cores, the simple first
// version, far from either bound -- a BM x BN = 64 x 32 output tile per
// 128-thread block, one 32-deep quant block per K step: the block's 64
// activation rows and its 32 weight rows' codes are expanded to float32
// in shared memory (common.cuh::dequant8: (q - off) * d is exact in
// float32; q * d + m is rounded after each step, in the JAX kernel's
// order), and each thread accumulates a 4 x 4 patch with float32 FMA.
// The four threads that load one row's 32-block exchange their amax with
// two shuffles for fused_quant, so it reads A once, as the plain load.
// Moving the product onto the tensor cores (mma/wgmma on bf16 operands)
// is later work.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 32, BK = qgt::QK, THREADS = 128;

// eight consecutive activations as float (16-byte aligned: K % 32 == 0)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}

// _fake_quant_q8 of one 32-block of A held by four consecutive lanes, 8
// values each (every lane of the warp calls it); fq == 2 rounds the
// result to bf16
__device__ __forceinline__ void fake_quant8(float (&f)[8], int fq) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  amax = fmaxf(amax, __shfl_xor_sync(qgt::FULL, amax, 1));
  amax = fmaxf(amax, __shfl_xor_sync(qgt::FULL, amax, 2));
  const float d = __fdiv_rn(amax, 127.0f);
  const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q =
        fminf(fmaxf(rintf(__fmul_rn(f[i], inv)), -127.0f), 127.0f);
    f[i] = __fmul_rn(q, d);
    if (fq == 2) f[i] = __bfloat162float(__float2bfloat16_rn(f[i]));
  }
}

template <typename AT, typename W>
__global__ void __launch_bounds__(THREADS)
    gemm_dequant_kernel(const AT* __restrict__ a,
                        const uint8_t* __restrict__ wq, const W fmt,
                        float* __restrict__ out, int M, int N, int K,
                        int fq) {
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
    // activation tile: 64 rows x 32 values = 256 vectors of 8, lanes 4j
    // .. 4j + 3 of a warp on one row's block (the loop is uniform)
    for (int v = t; v < BM * BK / 8; v += THREADS) {
      const int row = v / (BK / 8), k8 = (v % (BK / 8)) * 8;
      float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (m0 + row < M)
        load8(a + static_cast<size_t>(m0 + row) * K + b * BK + k8, f);
      if (fq) fake_quant8(f, fq);
#pragma unroll
      for (int i = 0; i < 8; ++i) as[k8 + i][row] = f[i];
    }
    // weight tile: 32 rows x 32 values; thread = (row, quarter), the
    // quarter's values 4 qtr .. 4 qtr + 3 and 16 + 4 qtr .. 16 + 4 qtr + 3
    {
      const int col = t / 4, qtr = t % 4;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // past N: every weight is 0
      if (n0 + col < N)
        qgt::dequant8(fmt, wq, static_cast<size_t>(n0 + col), nb, b, qtr, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ws[4 * qtr + i][col] = v[i];
        ws[16 + 4 * qtr + i][col] = v[4 + i];
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

template <typename W>
int launch(const void* a, int a_f32, int fq, const void* wq, const W fmt,
           void* out, int M, int N, int K, void* stream) {
  if (M < 1 || N < 1 || K % qgt::QK || fq < 0 || fq > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  float* o = static_cast<float*>(out);
  if (a_f32)
    gemm_dequant_kernel<float, W><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), w, fmt, o, M, N, K, fq);
  else
    gemm_dequant_kernel<__nv_bfloat16, W><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), w, fmt, o, M, N, K, fq);
  return static_cast<int>(cudaGetLastError());
}

const __half* h(const void* p) { return static_cast<const __half*>(p); }

}  // namespace

// Every entry point: out f32 [M, N] = A' [M, K] @ dequant(W)^T, A bf16
// (a_f32 = 0) or float32 (a_f32 = 1), A' = A (fq = 0) or A fake-quantized
// per 32-block (fq = 1: float32 operand, fq = 2: bf16 operand), W's codes
// at wq (uint8 [N, K/2], q8_0 int8 [N, K]) and its planes (f16 d, m [N,
// K/32]; q4_k and q5_k f32 d', m'; q5 u32 qh [N, K/32]).
QGT_EXPORT int qgt_gemm_dequant_q4_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  return launch(a, a_f32, fq, wq, qgt::Q4_0W{h(wd)}, out, M, N, K, stream);
}

QGT_EXPORT int qgt_gemm_dequant_q4_1(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, void* out, int M, int N,
                                     int K, void* stream) {
  return launch(a, a_f32, fq, wq, qgt::Q4_1W{h(wd), h(wm)}, out, M, N, K,
                stream);
}

QGT_EXPORT int qgt_gemm_dequant_q5_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wqh, void* out, int M, int N,
                                     int K, void* stream) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_0W{h(wd), nullptr, static_cast<const unsigned*>(wqh)},
                out, M, N, K, stream);
}

QGT_EXPORT int qgt_gemm_dequant_q5_1(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, const void* wqh,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_1W{h(wd), h(wm), static_cast<const unsigned*>(wqh)},
                out, M, N, K, stream);
}

QGT_EXPORT int qgt_gemm_dequant_q8_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  return launch(a, a_f32, fq, wq, qgt::Q8_0W{h(wd)}, out, M, N, K, stream);
}

QGT_EXPORT int qgt_gemm_dequant_q4_k(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, void* out, int M, int N,
                                     int K, void* stream) {
  return launch(a, a_f32, fq, wq,
                qgt::Q4_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm)},
                out, M, N, K, stream);
}

QGT_EXPORT int qgt_gemm_dequant_q5_k(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, const void* wqh,
                                     void* out, int M, int N, int K,
                                     void* stream) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm),
                           static_cast<const unsigned*>(wqh)},
                out, M, N, K, stream);
}
