// K9: RMSNorm of the rows of a float32 [R, C] matrix.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/rms_norm.py::
// rms_norm_pallas (body _rms_kernel): out[r, :] = x[r, :] * rsqrt(sum(x[r,
// :]^2) / C + eps) * w, in that order, the sum of squares in float32.
// Every step is IEEE-rounded as the plain version's (ops/rms_norm.py::
// rms_norm_pallas_plain) is: each square, the quotient by C, 1 / sqrt as
// the correctly rounded square root and reciprocal (not rsqrtf), so the
// two differ only in the order of the sum of squares.
//
// Bound on an H100: bytes -- x read once and out written once (8 R C
// bytes, and the 4 C of w), at 3.35 TB/s; 3 operations an element.
// Design (rows.cuh): the row plan of ops/rows.py, every row in registers
// (read once, all loads up front), split over a thread-block cluster
// where the rows alone would leave the SMs idle; w is read at the output,
// from L2, one vector at a time like x.
#include "rows.cuh"

namespace {

template <int VW, int HOLD, bool STREAM, bool CL>
__global__ void __launch_bounds__(qgt::rows::BLOCK_MAX)
    rms_norm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, float eps, int R, int C,
                    qgt::rows::Plan p) {
  __shared__ float red[32];
  __shared__ float cred[1];
  constexpr int STEP = HOLD / VW;  // vectors a chunk
  const int nv = (C + VW - 1) / VW;
  const qgt::rows::Ctx c = qgt::rows::ctx<CL>(p, R, nv);
  const size_t off = static_cast<size_t>(c.live ? c.row : 0) * C;
  const float* xr = x + off;
  const int chunks = STREAM ? (p.per + STEP - 1) / STEP : 1;
  float v[HOLD];
  float ss = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    qgt::rows::load<VW>(xr, c, p, k * STEP, 0.0f, v);
    const float part = qgt::rows::tree(
        v, [](float a) { return __fmul_rn(a, a); }, qgt::rows::Add());
    ss = k == 0 ? part : __fadd_rn(ss, part);
  }
  ss = qgt::rows::reduce<CL>(ss, qgt::rows::Add(), p, red, cred);
  if (CL) qgt::rows::cluster_arrive();  // done with the other CTAs' cred
  const float r = __frcp_rn(__fsqrt_rn(
      __fadd_rn(__fdiv_rn(ss, static_cast<float>(C)), eps)));
  for (int k = 0; k < chunks; ++k) {
    if (STREAM) qgt::rows::load<VW>(xr, c, p, k * STEP, 0.0f, v);
    qgt::rows::store<VW>(out + off, c, p, k * STEP, v,
                         [&](int i, float(&e)[VW]) {
                           float wv[VW];
                           if constexpr (VW == 4) {
                             const float4 f = __ldg(
                                 reinterpret_cast<const float4*>(w) + i);
                             wv[0] = f.x, wv[1] = f.y, wv[2] = f.z,
                             wv[3] = f.w;
                           } else {
                             wv[0] = __ldg(w + i);
                           }
#pragma unroll
                           for (int k = 0; k < VW; ++k)
                             e[k] = __fmul_rn(__fmul_rn(e[k], r), wv[k]);
                         });
  }
  if (CL) qgt::rows::cluster_wait();
}

struct Launch {
  const float *x, *w;
  float* out;
  float eps;
  int R, C;
  qgt::rows::Plan p;
  cudaStream_t s;
  template <int VW, int HOLD, bool STREAM, bool CL>
  int run() const {
    return qgt::rows::launch(rms_norm_kernel<VW, HOLD, STREAM, CL>, p, R, s,
                             x, w, out, eps, R, C, p);
  }
};

}  // namespace

// out f32 [R, C] = RMSNorm of x f32 [R, C] with weight w f32 [C], under
// the row plan (tpr, rows, cluster, span, per) and vector width vec of
// ops/rows.py::plan (vec 4: x and w 16-byte aligned, C % 4 == 0).
QGT_EXPORT int qgt_rms_norm(const void* x, const void* w, void* out, int R,
                            int C, float eps, int vec, int tpr, int rows,
                            int cluster, int span, int per, void* stream) {
  const qgt::rows::Plan p{tpr, rows, cluster, span, per};
  if ((vec != 1 && vec != 4) || C < 1 || (vec == 4 && C % 4) ||
      !qgt::rows::valid(p, R, (C + vec - 1) / vec, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{static_cast<const float*>(x), static_cast<const float*>(w),
                 static_cast<float*>(out), eps, R, C, p,
                 static_cast<cudaStream_t>(stream)};
  return qgt::rows::dispatch(l, vec, p);
}
