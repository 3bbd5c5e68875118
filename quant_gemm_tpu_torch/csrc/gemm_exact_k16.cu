// K7: exact per-16-scale decode GEMM, q6_K / q3_K / q2_K weights x Q8_1
// activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact_k16 (body _kernel_k16).  Per 16-element sub-block j of the
// K-quant super-blocks, sumi_j is the exact int32 dot of the stored
// shifted int8 weight codes and the int8 activation codes, and
//
//   C[m, n] = sum_j (scp_j * d_a[j/2]) * sumi_j
//                   [+ mp_j * (sumq_j * d_a[j/2])]
//
// with scp = d * sc the exact f32 per-16 scale (f16 d per 256, int8 sc
// per 16), d_a the per-32 Q8_1 scale and, for q2_K only (HAS_MIN), mp =
// -(dmin * mn) and sumq_j the exact sum of the sub-block's activation
// codes.  Each term is formed in that order with every step rounded on
// its own (no FMA contraction).  The order of the float32 sum: the two
// terms of a 32-block are added first (term_b = t_2b + t_2b+1), and the
// block terms are summed in K1's order (k1.cuh; kernels/gemm_exact.py::
// k1_order replays it, kernels/gemm_exact_k16.py::k16_block_terms gives
// the block terms), fixed whatever the grid, with no atomics.
//
// Bound on an H100: bytes.  At M <= 12 the weight stream is everything:
// per weight 8 bits of code, plus 8 bits of sc per 16 and 16 of d per 256
// (8.5625 bits; q2_K's mn and dmin add as much again), against 6.5625 bits
// of q6_K on the wire; the activations are a few KB.  Design: k1.cuh's
// body (persistent grid, the chunks of 32 blocks of a 32-row tile staged
// through a cp.async ring, ldmatrix), with the Q8_1 codes STREAMED from
// global memory; each 32-block's two sub-blocks take one int8 mma.sync
// m16n8k16 each (the halves of K1's q8_0 fragment), so each accumulator
// is exactly sumi_j; q2_K's sumq_j comes from one more m16n8k16 against
// a fragment of ones.  The launch reads nothing on the host and allocates
// nothing, so it can be captured in a CUDA graph.
#include "k1.cuh"

namespace {

using qgt::k1::K16W;
using qgt::k1::Planes;
using qgt::k1::Q8_1Act;

template <bool MIN, int MT>
__global__ void __launch_bounds__(qgt::k1::THREADS)
    gemm_exact_k16_kernel(const uint8_t* __restrict__ wq, Planes wp,
                          Q8_1Act act, float* __restrict__ out, int M, int N,
                          int K) {
  qgt::k1::gemm<K16W<MIN>, MT, qgt::k1::STREAMED>(
      wq, wp, act, qgt::k1::Store{out, N}, M, N, K);
}

template <bool MIN, int MT>
int launch_mt(const void* wq, Planes wp, Q8_1Act act, void* out, int M,
              int N, int K, cudaStream_t stream) {
  static qgt::k1::Occupancy occ;
  return qgt::k1::launch<K16W<MIN>, MT, qgt::k1::STREAMED>(
      gemm_exact_k16_kernel<MIN, MT>, occ, wq, wp, act, out, M, N, K,
      stream);
}

}  // namespace

// out f32 [M, N] = W [N, K] (qs int8 shifted codes [N, K], d f16
// [N, K/256], sc int8 [N, K/16]; q2_K also dmin f16 [N, K/256] and mn int8
// [N, K/16], else both null; each 16-byte aligned) x Q8_1 A [M, K] (qa
// int8 [M, K], da f16 [M, K/32]).
QGT_EXPORT int qgt_gemm_exact_k16(const void* wq, const void* d,
                                  const void* sc, const void* dmin,
                                  const void* mn, const void* qa,
                                  const void* da, void* out, int M, int N,
                                  int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % 256 || K < 256 || N < 1 ||
      (dmin == nullptr) != (mn == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Q8_1Act act{static_cast<const int8_t*>(qa),
                    static_cast<const __half*>(da), nullptr};
  const Planes wp{{static_cast<const uint8_t*>(sc),
                   static_cast<const uint8_t*>(mn),
                   static_cast<const uint8_t*>(d),
                   static_cast<const uint8_t*>(dmin)}};
  if (dmin != nullptr)
    return M <= 8 ? launch_mt<true, 1>(wq, wp, act, out, M, N, K, st)
                  : launch_mt<true, 2>(wq, wp, act, out, M, N, K, st);
  return M <= 8 ? launch_mt<false, 1>(wq, wp, act, out, M, N, K, st)
                : launch_mt<false, 2>(wq, wp, act, out, M, N, K, st);
}
