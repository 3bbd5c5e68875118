// K7: exact per-16-scale decode GEMM, q6_K / q3_K / q2_K weights x Q8_1
// activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact_k16 (body _kernel_k16).  Per 16-element sub-block j of the
// K-quant super-blocks, sumi_j is the exact int32 dot of the stored
// shifted int8 weight codes and the int8 activation codes (four __dp4a),
// and
//
//   C[m, n] = sum_j  scp_j * d_a[j/2] * sumi_j  [+ mp_j * (d_a[j/2] * sumq_j)]
//
// with scp = d * sc the exact f32 per-16 scale, d_a the per-32 Q8_1 scale
// and, for q2_K only (HAS_MIN), mp = -dmin * mn and sumq_j the exact sum of
// the sub-block's activation codes.  Each term is formed in that order
// with every step rounded on its own (no FMA contraction) and the terms
// are summed in float32, as the TPU kernel accumulates them.
//
// Bound on an H100: bytes.  At M <= 12 the weight stream is everything:
// per weight 8 bits of code plus 32 bits of scp per 16 (10 bits; q2_K's mp
// adds 2 more), against 6.5625 bits of q6_K on the wire; the activations
// are a few KB and stay in L1/L2.  Design, as K1: a block of up to four
// warps owns NC = 4 weight rows and splits their K over its threads in
// 32-element units (one Q8_1 block, two sub-blocks), so every lane issues
// two 16-byte code loads and one 8-byte scale load per row and unit; warp
// shuffles and one shared-memory pass reduce the partial sums.
#include "common.cuh"

namespace {

constexpr int NC = 4;  // weight rows (output columns) per block
constexpr int MAX_WARPS = 4;

// exact int32 dot of 16 int8 weight codes with 16 int8 activation codes
__device__ __forceinline__ int dot16(int4 w, int4 a) {
  int s = __dp4a(w.x, a.x, 0);
  s = __dp4a(w.y, a.y, s);
  s = __dp4a(w.z, a.z, s);
  return __dp4a(w.w, a.w, s);
}

// exact sum of 16 int8 codes
__device__ __forceinline__ int sum16(int4 a) {
  const int ones = 0x01010101;
  int s = __dp4a(a.x, ones, 0);
  s = __dp4a(a.y, ones, s);
  s = __dp4a(a.z, ones, s);
  return __dp4a(a.w, ones, s);
}

// one sub-block's term: (scp * d_a) * sumi [+ mp * (d_a * sumq)]
template <bool HAS_MIN>
__device__ __forceinline__ float term(float scp, float mp, float da, int sumi,
                                      int sumq) {
  float t = __fmul_rn(__fmul_rn(scp, da), static_cast<float>(sumi));
  if (HAS_MIN)
    t = __fadd_rn(t, __fmul_rn(mp, __fmul_rn(static_cast<float>(sumq), da)));
  return t;
}

template <bool HAS_MIN>
__global__ void gemm_exact_k16_kernel(const int8_t* __restrict__ wq,
                                      const float* __restrict__ scp,
                                      const float* __restrict__ mp,
                                      const int8_t* __restrict__ qa,
                                      const __half* __restrict__ da,
                                      float* __restrict__ out, int M, int N,
                                      int K) {
  const int nu = K / qgt::QK;  // 32-element units (two sub-blocks each)
  const int nj = K / 16;
  const int n0 = blockIdx.x * NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float acc[NC][qgt::MMAX];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) acc[c][m] = 0.0f;

  for (int u = threadIdx.x; u < nu; u += blockDim.x) {
    int4 w0[NC], w1[NC];
    float2 s[NC], z[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      z[c] = make_float2(0.0f, 0.0f);
      if (n0 + c < N) {
        const size_t row = static_cast<size_t>(n0 + c);
        const int4* wp = reinterpret_cast<const int4*>(wq + row * K) + 2 * u;
        w0[c] = __ldg(wp);
        w1[c] = __ldg(wp + 1);
        s[c] = __ldg(reinterpret_cast<const float2*>(scp + row * nj) + u);
        if (HAS_MIN)
          z[c] = __ldg(reinterpret_cast<const float2*>(mp + row * nj) + u);
      } else {
        w0[c] = w1[c] = make_int4(0, 0, 0, 0);
        s[c] = make_float2(0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int m = 0; m < qgt::MMAX; ++m) {
      if (m < M) {
        const int4* ap =
            reinterpret_cast<const int4*>(qa + static_cast<size_t>(m) * K) +
            2 * u;
        const int4 a0 = ap[0];
        const int4 a1 = ap[1];
        const float dam = __half2float(da[m * nu + u]);
        const int q0 = HAS_MIN ? sum16(a0) : 0;
        const int q1 = HAS_MIN ? sum16(a1) : 0;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c][m] = __fadd_rn(acc[c][m], term<HAS_MIN>(s[c].x, z[c].x, dam,
                                                         dot16(w0[c], a0), q0));
          acc[c][m] = __fadd_rn(acc[c][m], term<HAS_MIN>(s[c].y, z[c].y, dam,
                                                         dot16(w1[c], a1), q1));
        }
      }
    }
  }

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
  for (int t = threadIdx.x; t < NC * M; t += blockDim.x) {
    const int c = t / M, m = t % M;
    if (n0 + c < N) {
      float v = 0.0f;
      for (int w = 0; w < nwarps; ++w) v += red[w][c][m];
      out[static_cast<size_t>(m) * N + n0 + c] = v;
    }
  }
}

}  // namespace

// out f32 [M, N] = W [N, K] (qs int8 shifted codes [N, K], scp f32
// [N, K/16], mp f32 [N, K/16] or null) x Q8_1 A [M, K] (qa int8 [M, K],
// da f16 [M, K/32]).  A non-null mp adds q2_K's min term.
QGT_EXPORT int qgt_gemm_exact_k16(const void* wq, const void* scp,
                                  const void* mp, const void* qa,
                                  const void* da, void* out, int M, int N,
                                  int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nu = K / qgt::QK;
  // enough warps that each thread keeps at least one unit to itself
  const int nwarps = nu >= 128 ? 4 : (nu >= 64 ? 2 : 1);
  const dim3 grid((N + NC - 1) / NC);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const int8_t*>(wq);
  const auto* s = static_cast<const float*>(scp);
  const auto* z = static_cast<const float*>(mp);
  const auto* a = static_cast<const int8_t*>(qa);
  const auto* d = static_cast<const __half*>(da);
  auto* o = static_cast<float*>(out);
  if (mp != nullptr)
    gemm_exact_k16_kernel<true><<<grid, nwarps * 32, 0, st>>>(w, s, z, a, d,
                                                              o, M, N, K);
  else
    gemm_exact_k16_kernel<false><<<grid, nwarps * 32, 0, st>>>(w, s, z, a, d,
                                                               o, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
