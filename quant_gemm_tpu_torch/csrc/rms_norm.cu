// K9: RMSNorm of the rows of a float32 [R, C] matrix.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/rms_norm.py::
// rms_norm_pallas (body _rms_kernel): out[r, :] = x[r, :] * rsqrt(sum(x[r,
// :]^2) / C + eps) * w, in that order, the sum of squares in float32.
//
// Bound on an H100: bytes -- x read once and out written once (8 R C
// bytes, and the 4 C of w), at 3.35 TB/s; a row takes 3 operations an
// element.  Design (rows.cuh): one warp per row for C <= 1024, else one
// block of 256 threads per row (the TPU kernel's 256-row tiles do not
// carry over: a Hopper block holds one row in flight, not a VMEM tile of
// many); coalesced scalar loads and stores, so a ragged C runs in place.
// The second pass reads the row again from L1/L2
// (16 KB at C = 4096), not from device memory.
#include "rows.cuh"

namespace {

template <bool WARP_ROW>
__global__ void __launch_bounds__(qgt::ROW_THREADS)
    rms_norm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, float eps, int R, int C) {
  __shared__ float red[32];
  const qgt::RowCtx c = qgt::row_ctx<WARP_ROW>();
  if (c.row >= R) return;  // a whole spare warp (WARP_ROW only)
  const float* xr = x + static_cast<size_t>(c.row) * C;
  float ss = 0.0f;
  qgt::for_row(xr, C, c, [&](int, float v) { ss = fmaf(v, v, ss); });
  ss = qgt::row_sum<WARP_ROW>(ss, red);
  const float r = rsqrtf(ss / static_cast<float>(C) + eps);
  qgt::map_row(xr, out + static_cast<size_t>(c.row) * C, C, c,
               [&](int i, float v) { return v * r * __ldg(w + i); });
}

}  // namespace

// out f32 [R, C] = RMSNorm of x f32 [R, C] with weight w f32 [C].
QGT_EXPORT int qgt_rms_norm(const void* x, const void* w, void* out, int R,
                            int C, float eps, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool warp_row = C <= qgt::WARP_ROW_MAX_C;
  const dim3 grid = qgt::row_grid(R, warp_row);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  if (warp_row)
    rms_norm_kernel<true><<<grid, qgt::ROW_THREADS, 0, s>>>(xp, wp, op, eps,
                                                            R, C);
  else
    rms_norm_kernel<false><<<grid, qgt::ROW_THREADS, 0, s>>>(xp, wp, op, eps,
                                                             R, C);
  return static_cast<int>(cudaGetLastError());
}
