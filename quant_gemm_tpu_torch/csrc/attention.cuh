// Shared device code of the attention kernels (flash_decode.cu,
// flash_prefill.cu): the slot ranges a ring cache's window covers and the
// split-S merge both kernels launch.  Plain C interface, no PyTorch
// headers.
#pragma once

#include <float.h>

#include "common.cuh"

namespace qgt {

// x mod r in [0, r) for r > 0, also for negative x.
__device__ __forceinline__ int ring_mod(int x, int r) {
  const int m = x % r;
  return m < 0 ? m + r : m;
}

// Cache slots as at most two contiguous ranges [a[0], e[0]) and [a[1],
// e[1]), walked in that order.
struct SlotRanges {
  int a[2], e[2];
};

// The slots of a ring of R slots (token g at slot g mod R) that hold the n
// positions ending at global position p: the modular interval
// [(p - n + 1) mod R, p mod R], which is one range, or two when it wraps
// past slot R - 1 ([r_lo, R) then [0, r_hi]).  Empty for n <= 0, the whole
// ring for n >= R.  So a walk over them visits O(n) slots, not O(R).
__device__ __forceinline__ SlotRanges ring_ranges(int p, int n, int R) {
  SlotRanges r{{0, 0}, {0, 0}};
  if (n <= 0) return r;
  if (n >= R) {
    r.e[0] = R;
    return r;
  }
  const int hi = ring_mod(p, R), lo = ring_mod(p - n + 1, R);
  r.a[0] = lo;
  if (lo <= hi) {
    r.e[0] = hi + 1;
  } else {
    r.e[0] = R;
    r.e[1] = hi + 1;
  }
  return r;
}

// The split-S merge of K3 and K5: out = the pieces of a row combined in
// piece order by running max and sum, M = max m_p, L = sum l_p * exp(m_p
// - M), out = sum o_p * exp(m_p - M) / L (L > 0 guarded), so every call
// gives the same bits.  Pieces: po f32 [bg, ns, rows, HD] unnormalised
// outputs and pml f32 [bg, ns, rows, 2] (max, sum), bg = slot * KV + kv
// head; a piece no row of its tile attends holds max -FLT_MAX and sum 0
// and weighs nothing.  With kcur (K3's current token, bf16 [bg, HD], and
// the unscaled query q f32 [bg, rows, HD]) the token is folded in last,
// as K3's one-piece body folds it.  One warp a row.
template <int HD>
__global__ void __launch_bounds__(256) attn_merge_kernel(
    const float* __restrict__ po, const float* __restrict__ pml,
    float* __restrict__ out, int nrow_all, int rows, int ns,
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ kcur,
    const __nv_bfloat16* __restrict__ vcur, float scale) {
  const int idx = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (idx >= nrow_all) return;
  const int bg = idx / rows, row = idx % rows;
  const size_t first = static_cast<size_t>(bg) * ns * rows + row;
  float mmax = -FLT_MAX;
  for (int p = 0; p < ns; ++p)
    mmax = fmaxf(mmax, pml[(first + static_cast<size_t>(p) * rows) * 2]);
  float l = 0.0f, acc[HD / 32];
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) acc[k] = 0.0f;
  for (int p = 0; p < ns; ++p) {
    const size_t pr = first + static_cast<size_t>(p) * rows;
    const float w = expf(pml[pr * 2] - mmax);
    l += pml[pr * 2 + 1] * w;
#pragma unroll
    for (int k = 0; k < HD / 32; ++k)
      acc[k] += po[pr * HD + lane + 32 * k] * w;
  }
  if (kcur != nullptr) {
    const size_t qr = static_cast<size_t>(idx) * HD;
    const size_t cr = static_cast<size_t>(bg) * HD;
    float d = 0.0f;
#pragma unroll
    for (int k = 0; k < HD / 32; ++k)
      d = fmaf(q[qr + lane + 32 * k] * scale,
               __bfloat162float(kcur[cr + lane + 32 * k]), d);
    const float sc = warp_sum(d);
    const float m_new = fmaxf(mmax, sc);
    const float alpha = expf(mmax - m_new);
    const float pc = expf(sc - m_new);
    l = l * alpha + pc;
#pragma unroll
    for (int k = 0; k < HD / 32; ++k)
      acc[k] = acc[k] * alpha +
               pc * __bfloat162float(vcur[cr + lane + 32 * k]);
  }
  const float ld = l > 0.0f ? l : 1.0f;
  float* o = out + static_cast<size_t>(idx) * HD;
#pragma unroll
  for (int k = 0; k < HD / 32; ++k) o[lane + 32 * k] = acc[k] / ld;
}

// Launch the merge of ns pieces over nrow_all = B * KV * rows rows.
template <int HD>
void attn_merge(const float* po, const float* pml, float* out, int nrow_all,
                int rows, int ns, const float* q, const __nv_bfloat16* kcur,
                const __nv_bfloat16* vcur, float scale, cudaStream_t st) {
  attn_merge_kernel<HD><<<(nrow_all + 7) / 8, 256, 0, st>>>(
      po, pml, out, nrow_all, rows, ns, q, kcur, vcur, scale);
}

}  // namespace qgt
