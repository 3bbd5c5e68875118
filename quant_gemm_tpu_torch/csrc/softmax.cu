// K10: max-subtracted softmax of the rows of a float32 [R, C] matrix.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/softmax.py::softmax_pallas
// (body _softmax_kernel): m = max(x[r, :]), e = exp(x[r, :] - m), out[r,
// :] = e / sum(e), the max and the sum in float32.  expf and the division
// are the accurate ones (no fast-math, no online rescaling), so each e is
// the plain version's and the two differ only in the order of the sum.
//
// Bound on an H100: bytes -- x read once and out written once (8 R C
// bytes) at 3.35 TB/s.  Design (rows.cuh): the row plan of ops/rows.py,
// every row in registers (read once, all loads up front): the max, then e
// in place of x and its sum, then e / s, one read and one write of device
// memory; a decode step's 8 rows of 32000 logits run as 8 clusters of 8
// CTAs.  Rows longer than a full cluster holds stream: three passes
// (max, sum, write) that read the row again from L2.
#include <math.h>

#include "rows.cuh"

namespace {

template <int VW, int HOLD, bool STREAM, bool CL>
__global__ void __launch_bounds__(qgt::rows::BLOCK_MAX)
    softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int R, int C, qgt::rows::Plan p) {
  __shared__ float red[32];
  __shared__ float cred[2];
  constexpr int STEP = HOLD / VW;  // vectors a chunk
  const int nv = (C + VW - 1) / VW;
  const qgt::rows::Ctx c = qgt::rows::ctx<CL>(p, R, nv);
  const size_t off = static_cast<size_t>(c.live ? c.row : 0) * C;
  const float* xr = x + off;
  const int chunks = STREAM ? (p.per + STEP - 1) / STEP : 1;
  const auto ident = [](float a) { return a; };
  float v[HOLD];
  float m = -INFINITY;
  for (int k = 0; k < chunks; ++k) {
    qgt::rows::load<VW>(xr, c, p, k * STEP, -INFINITY, v);
    m = fmaxf(m, qgt::rows::tree(v, ident, qgt::rows::Max()));
  }
  m = qgt::rows::reduce<CL>(m, qgt::rows::Max(), p, red, cred);
  // e = exp(x - m) in place of this thread's elements, 0 in its padding
  const auto ex = [&](int k) {
#pragma unroll
    for (int j = 0; j < STEP; ++j) {
      const bool held = qgt::rows::vec_index(c, p, k * STEP + j) >= 0;
#pragma unroll
      for (int e = 0; e < VW; ++e)
        v[VW * j + e] = held ? expf(__fsub_rn(v[VW * j + e], m)) : 0.0f;
    }
  };
  float s = 0.0f;
  for (int k = 0; k < chunks; ++k) {
    if (STREAM) qgt::rows::load<VW>(xr, c, p, k * STEP, -INFINITY, v);
    ex(k);
    const float part = qgt::rows::tree(v, ident, qgt::rows::Add());
    s = k == 0 ? part : __fadd_rn(s, part);
  }
  s = qgt::rows::reduce<CL>(s, qgt::rows::Add(), p, red, cred + 1);
  if (CL) qgt::rows::cluster_arrive();  // done with the other CTAs' cred
  for (int k = 0; k < chunks; ++k) {
    if (STREAM) {
      qgt::rows::load<VW>(xr, c, p, k * STEP, -INFINITY, v);
      ex(k);
    }
    qgt::rows::store<VW>(out + off, c, p, k * STEP, v,
                         [s](int, float(&e)[VW]) {
#pragma unroll
                           for (int q = 0; q < VW; ++q)
                             e[q] = __fdiv_rn(e[q], s);
                         });
  }
  if (CL) qgt::rows::cluster_wait();
}

struct Launch {
  const float* x;
  float* out;
  int R, C;
  qgt::rows::Plan p;
  cudaStream_t s;
  template <int VW, int HOLD, bool STREAM, bool CL>
  int run() const {
    return qgt::rows::launch(softmax_kernel<VW, HOLD, STREAM, CL>, p, R, s,
                             x, out, R, C, p);
  }
};

}  // namespace

// out f32 [R, C] = softmax of each row of x f32 [R, C], under the row plan
// (tpr, rows, cluster, span, per) and vector width vec of ops/rows.py::
// plan (vec 4: x 16-byte aligned, C % 4 == 0).
QGT_EXPORT int qgt_softmax(const void* x, void* out, int R, int C, int vec,
                           int tpr, int rows, int cluster, int span, int per,
                           void* stream) {
  const qgt::rows::Plan p{tpr, rows, cluster, span, per};
  if ((vec != 1 && vec != 4) || C < 1 || (vec == 4 && C % 4) ||
      !qgt::rows::valid(p, R, (C + vec - 1) / vec, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l{static_cast<const float*>(x), static_cast<float*>(out), R,
                 C, p, static_cast<cudaStream_t>(stream)};
  return qgt::rows::dispatch(l, vec, p);
}
