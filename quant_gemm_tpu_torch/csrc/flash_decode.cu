// K3: flash-decode attention over the stacked KV cache, bf16 or int8.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/attention.py::flash_decode
// (body _kernel): a linear cache or a ring; bf16, or int8 codes with one f32
// scale per (slot, head, token); full causal or a sliding window.  One
// query token per slot; the rep = H/KV query rows of a kv head share every
// K/V tile; per-slot causal length from pos; the current token's k/v (bf16,
// not yet written to the cache, even with the int8 cache) folded in last.
// The wrapper passes one layer's [B, KV, S, hd] view of the stacked cache
// (base pointer and slot stride), so no per-layer copy is made.
//
// Bound on an H100: bytes (each slot's valid K and V rows, and with int8
// their scales, read once).  Design: one block per (slot, kv head) with
// one warp per query row.  The block stages TS = 32 cache rows of K and V
// at a time in shared memory as float32 (attention.cuh); lane j scores row
// j, the warp runs the online-softmax recurrence in registers (running
// max, sum, and hd/32 output dims per lane), all in float32 as the TPU
// kernel computes it; the plain version's dense softmax sums in another
// order.  Int8: the k scale multiplies the scores before the mask, p
// enters the running sum unscaled and p * v_scale the p.V sum.
//
// Slots walked.  Linear cache: [lo, valid) with valid = min(pos, S) (pos +
// 1 without a current token) and lo = max(pos - window + 1, 0) under a
// window, so a stale position of an inactive serving slot never reads out
// of bounds.  Ring of R slots (token g at slot g mod R, only slots < R
// attended): the newest cached token is p_new = valid - 1 and the window
// holds cnt = min(window - 1, pos) cached tokens with a current token
// (min(window, pos + 1) without), the modular interval of cnt slots ending
// at p_new mod R: one or two contiguous ranges (attention.cuh
// ring_ranges), so the walk is O(window), not O(R).  Each element is
// masked by its age (p_new - slot) mod R < cnt, as the TPU kernel masks
// it.  The ranges run oldest first, a tile order other than the linear
// cache's, so the two agree to float32 rounding, not bit for bit.
#include "attention.cuh"

namespace {

using qgt::SlotRanges;
using qgt::TS;

template <int HD, bool Q8>
__global__ void flash_decode_kernel(
    const float* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ pos,
    const __nv_bfloat16* __restrict__ kcur,
    const __nv_bfloat16* __restrict__ vcur, float* __restrict__ out, int KV,
    int rep, int S, long long kv_bstride, long long sc_bstride,
    int has_current, int window, int ring, float scale) {
  constexpr int KP = HD + 1;  // padded K row: lane j reads row j conflict-free
  constexpr int DL = HD / 32;  // output dims per lane
  using Elem = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                // [rep, HD], pre-scaled query rows
  float* kt = qs + rep * HD;      // [TS, KP]
  float* vt = kt + TS * KP;       // [TS, HD]
  float* kst = vt + TS * HD;      // [TS] k scales (int8 cache)
  float* vst = kst + TS;          // [TS] v scales

  const int b = blockIdx.x / KV, g = blockIdx.x % KV;
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = static_cast<size_t>(b) * kv_bstride +
                      static_cast<size_t>(g) * S * HD;
  const Elem* kbase = static_cast<const Elem*>(kc) + head;
  const Elem* vbase = static_cast<const Elem*>(vc) + head;
  const size_t shead = static_cast<size_t>(b) * sc_bstride +
                       static_cast<size_t>(g) * S;
  const float* kscale = Q8 ? ksc + shead : nullptr;
  const float* vscale = Q8 ? vsc + shead : nullptr;

  for (int i = threadIdx.x; i < rep * HD; i += blockDim.x)
    qs[i] = q[(static_cast<size_t>(b) * KV + g) * rep * HD + i] * scale;
  __syncthreads();

  const int p = pos[b];
  SlotRanges walk{{0, 0}, {0, 0}};
  int p_new = 0, cnt = 0;
  if (ring > 0) {
    p_new = p + (has_current ? 0 : 1) - 1;
    cnt = min(window - (has_current ? 1 : 0), p_new + 1);
    walk = qgt::ring_ranges(p_new, cnt, ring);
  } else {
    int valid = p + (has_current ? 0 : 1);
    valid = valid < 0 ? 0 : (valid > S ? S : valid);
    walk.a[0] = window > 0 ? max(p - window + 1, 0) : 0;
    walk.e[0] = valid;
  }

  float m_run = -FLT_MAX, l_run = 0.0f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.0f;

  for (int seg = 0; seg < 2; ++seg) {
    for (int s0 = walk.a[seg]; s0 < walk.e[seg]; s0 += TS) {
      const int n = min(TS, walk.e[seg] - s0);
      __syncthreads();  // previous tile consumed
      qgt::stage_kv<HD, Q8>(kbase, vbase, kscale, vscale, s0, n, kt, KP, vt,
                            kst, vst);
      __syncthreads();
      const bool ok =
          lane < n &&
          (ring <= 0 || qgt::ring_mod(p_new - s0 - lane, ring) < cnt);
      float sc = -FLT_MAX;
      if (ok) {
        float d = 0.0f;
#pragma unroll 16
        for (int t = 0; t < HD; ++t)
          d = fmaf(qs[r * HD + t], kt[lane * KP + t], d);
        sc = Q8 ? d * kst[lane] : d;
      }
      const float m_new = fmaxf(m_run, qgt::warp_max(sc));
      const float alpha = expf(m_run - m_new);
      float pr = ok ? expf(sc - m_new) : 0.0f;
      l_run = l_run * alpha + qgt::warp_sum(pr);
      m_run = m_new;
      if (Q8 && ok) pr *= vst[lane];  // v scale folds into p
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] *= alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(qgt::FULL, pr, j);
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc[i] = fmaf(pj, vt[j * HD + lane + 32 * i], acc[i]);
      }
    }
  }

  if (has_current) {
    const size_t cur = (static_cast<size_t>(b) * KV + g) * HD;
    float d = 0.0f;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      d = fmaf(qs[r * HD + lane + 32 * i],
               __bfloat162float(kcur[cur + lane + 32 * i]), d);
    const float sc = qgt::warp_sum(d);
    const float m_new = fmaxf(m_run, sc);
    const float alpha = expf(m_run - m_new);
    const float pc = expf(sc - m_new);
    l_run = l_run * alpha + pc;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      acc[i] = acc[i] * alpha +
               pc * __bfloat162float(vcur[cur + lane + 32 * i]);
  }
  const float l = l_run > 0.0f ? l_run : 1.0f;
  float* o = out + ((static_cast<size_t>(b) * KV + g) * rep + r) * HD;
#pragma unroll
  for (int i = 0; i < DL; ++i)
    o[lane + 32 * i] = acc[i] / l;
}

template <int HD, bool Q8>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* pos, const void* kcur,
           const void* vcur, void* out, int B, int KV, int rep, int S,
           long long kv_bstride, long long sc_bstride, int has_current,
           int window, int ring, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (rep * HD + TS * (HD + 1) + TS * HD + 2 * TS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<HD, Q8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_kernel<HD, Q8><<<B * KV, rep * 32, smem, stream>>>(
      static_cast<const float*>(q), kc, vc, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos),
      static_cast<const __nv_bfloat16*>(kcur),
      static_cast<const __nv_bfloat16*>(vcur), static_cast<float*>(out), KV,
      rep, S, kv_bstride, sc_bstride, has_current, window, ring, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int quant, const void* q, const void* kc, const void* vc,
              const void* ksc, const void* vsc, const void* pos,
              const void* kcur, const void* vcur, void* out, int B, int KV,
              int rep, int S, long long kv_bstride, long long sc_bstride,
              int has_current, int window, int ring, float scale,
              cudaStream_t st) {
  if (quant)
    return launch<HD, true>(q, kc, vc, ksc, vsc, pos, kcur, vcur, out, B, KV,
                            rep, S, kv_bstride, sc_bstride, has_current,
                            window, ring, scale, st);
  return launch<HD, false>(q, kc, vc, ksc, vsc, pos, kcur, vcur, out, B, KV,
                           rep, S, kv_bstride, sc_bstride, has_current,
                           window, ring, scale, st);
}

}  // namespace

// out f32 [B, KV, rep, hd] = attention of q f32 [B, KV, rep, hd] over one
// layer's cache kc/vc [B, KV, S, hd] (slot b at kc + b * kv_bstride
// elements; bf16, or int8 with quant = 1 and the f32 scales ksc/vsc [B,
// KV, S], slot b at ksc + b * sc_bstride), plus kcur/vcur bf16 [B, KV, 1,
// hd] when has_current is 1.  Linear cache (ring = 0): slots < pos[b]
// (<= pos[b] when has_current is 0) and, with window > 0, > pos[b] -
// window.  Ring (0 < window <= ring <= S): the window's cached tokens at
// slot g mod ring, as the header says.
QGT_EXPORT int qgt_flash_decode(const void* q, const void* kc, const void* vc,
                                const void* ksc, const void* vsc,
                                const void* pos, const void* kcur,
                                const void* vcur, void* out, int B, int KV,
                                int rep, int hd, int S, long long kv_bstride,
                                long long sc_bstride, int has_current,
                                int quant, int window, int ring,
                                float scale, void* stream) {
  if (rep < 1 || rep > 32 || B < 1 || KV < 1 || S < 1 || window < 0 ||
      ring < 0 || ring > S || (ring > 0 && (window < 1 || window > ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd<64>(quant, q, kc, vc, ksc, vsc, pos, kcur, vcur, out, B,
                         KV, rep, S, kv_bstride, sc_bstride, has_current,
                         window, ring, scale, st);
  if (hd == 128)
    return launch_hd<128>(quant, q, kc, vc, ksc, vsc, pos, kcur, vcur, out, B,
                          KV, rep, S, kv_bstride, sc_bstride, has_current,
                          window, ring, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
