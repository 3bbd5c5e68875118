// Row-reduction scaffolding of K9 (rms_norm.cu) and K10 (softmax.cu):
// rows of a float32 [R, C] matrix, one warp per row when C <= 1024 (eight
// rows to a block of 256 threads), else one block of 256 threads per row.
// A row is walked one float at a time, consecutive threads on consecutive
// elements (coalesced), so a ragged C needs no padding copy.
#pragma once

#include "common.cuh"

namespace qgt {

constexpr int ROW_THREADS = 256;
constexpr int WARP_ROW_MAX_C = 1024;

// The row this thread works on, its index among the row's threads and
// their count; row >= R for the spare warps of the last block.
struct RowCtx {
  int row, t, nt;
};

template <bool WARP_ROW>
__device__ __forceinline__ RowCtx row_ctx() {
  if (WARP_ROW)
    return {static_cast<int>(blockIdx.x * (ROW_THREADS / 32) +
                             (threadIdx.x >> 5)),
            static_cast<int>(threadIdx.x & 31), 32};
  return {static_cast<int>(blockIdx.x), static_cast<int>(threadIdx.x),
          ROW_THREADS};
}

template <bool WARP_ROW>
__device__ __forceinline__ float row_sum(float v, float* red) {
  return WARP_ROW ? warp_sum(v) : block_sum(v, red);
}

template <bool WARP_ROW>
__device__ __forceinline__ float row_max(float v, float* red) {
  return WARP_ROW ? warp_max(v) : block_max(v, red);
}

// Calls f(i, x[i]) for the elements of a row that this thread owns.
template <typename F>
__device__ __forceinline__ void for_row(const float* xr, int C,
                                        const RowCtx& c, F f) {
  for (int i = c.t; i < C; i += c.nt) f(i, xr[i]);
}

// Writes g(i, x[i]) for the elements of a row that this thread owns.
template <typename G>
__device__ __forceinline__ void map_row(const float* xr, float* outr, int C,
                                        const RowCtx& c, G g) {
  for (int i = c.t; i < C; i += c.nt) outr[i] = g(i, xr[i]);
}

// The grid of a row kernel: one block per row, or per eight rows.
inline dim3 row_grid(int R, bool warp_row) {
  return dim3(warp_row ? (R + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32) : R);
}

}  // namespace qgt
