// K10: max-subtracted softmax of the rows of a float32 [R, C] matrix.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/softmax.py::softmax_pallas
// (body _softmax_kernel): m = max(x[r, :]), e = exp(x[r, :] - m), out[r,
// :] = e / sum(e), the max and the sum in float32 (expf and the division
// are the accurate ones: no fast-math).
//
// Bound on an H100: bytes -- x read once and out written once (8 R C
// bytes) at 3.35 TB/s.  Design (rows.cuh): one warp per row for C <=
// 1024, else one block of 256 threads per row; coalesced scalar loads and
// stores, so a ragged C runs in place.  Three
// passes over the row (max, sum, write); the second and third read it
// again from L1/L2 (128 KB at C = 32000, a decode step's logits), not
// from device memory, and recompute exp rather than store it.
#include <math.h>

#include "rows.cuh"

namespace {

template <bool WARP_ROW>
__global__ void __launch_bounds__(qgt::ROW_THREADS)
    softmax_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int R, int C) {
  __shared__ float red[32];
  const qgt::RowCtx c = qgt::row_ctx<WARP_ROW>();
  if (c.row >= R) return;  // a whole spare warp (WARP_ROW only)
  const float* xr = x + static_cast<size_t>(c.row) * C;
  float m = -INFINITY;
  qgt::for_row(xr, C, c, [&](int, float v) { m = fmaxf(m, v); });
  m = qgt::row_max<WARP_ROW>(m, red);
  float s = 0.0f;
  qgt::for_row(xr, C, c, [&](int, float v) { s += expf(v - m); });
  s = qgt::row_sum<WARP_ROW>(s, red);
  qgt::map_row(xr, out + static_cast<size_t>(c.row) * C, C, c,
               [&](int, float v) { return expf(v - m) / s; });
}

}  // namespace

// out f32 [R, C] = softmax of each row of x f32 [R, C].
QGT_EXPORT int qgt_softmax(const void* x, void* out, int R, int C,
                           void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool warp_row = C <= qgt::WARP_ROW_MAX_C;
  const dim3 grid = qgt::row_grid(R, warp_row);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (warp_row)
    softmax_kernel<true><<<grid, qgt::ROW_THREADS, 0, st>>>(xp, op, R, C);
  else
    softmax_kernel<false><<<grid, qgt::ROW_THREADS, 0, st>>>(xp, op, R, C);
  return static_cast<int>(cudaGetLastError());
}
