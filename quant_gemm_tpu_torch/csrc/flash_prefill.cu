// K5: causal flash-prefill attention over the KV cache, bf16 or int8.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/attention.py::flash_prefill
// (body _kernel_prefill): a linear cache or a ring; bf16, or int8 codes
// with one f32 scale per (slot, head, token); full causal or a sliding
// window.  Query row t*rep + r (T-major: token t, head-group member r) of
// slot b and kv head g sits at position qpos = pos0[b] + t and attends the
// cached tokens at positions <= qpos and, with a window, > qpos - window.
// The cache already holds the chunk's own rows.  The wrapper passes one
// layer's [B, KV, S, hd] view of the stacked cache (base pointer and slot
// stride), so the server's one-slot view of its cache needs no copy either.
//
// Bound on an H100: bytes at the serving shapes (q, the valid K and V rows
// once, out).  Design, simple first: one block per (slot, kv head, tile of
// ROWS = 64 query rows), 8 warps of 8 rows each.  The block stages TS = 32
// cache rows of K and V at a time in shared memory as float32
// (attention.cuh).  Lane j scores slot j for the warp's 8 rows at once
// (one K load feeds 8 FMAs); each row keeps its online-softmax state
// (running max, sum, hd/32 output dims per lane) in registers, all in
// float32 on the CUDA cores, as the TPU kernel computes it; masked slots
// add nothing.  Int8: the k scale multiplies the scores before the mask, p
// enters the running sum unscaled and p * v_scale the p.V sum.  The final
// division guards l > 0.
//
// Slots walked per block, from the oldest position any of its rows attends
// (the window's low bound of its oldest row) to the newest (its newest
// row's).  Linear cache: slot = position, clamped to S - 1 so that no read
// leaves the cache; each element is masked by slot <= qpos (and > qpos -
// window).  Ring of R slots (token g at slot g mod R, only slots < R
// attended; needs window + T <= R): the modular interval of those
// positions, one or two contiguous slot ranges (attention.cuh
// ring_ranges), O(window + ROWS / rep) slots, not O(R).  Each element is
// masked by the global position its slot holds, g = p_cache - (p_cache -
// slot) mod R with p_cache = pos0 + T - 1 the chunk's newest token: g <=
// qpos, g >= 0 and g > qpos - window, as the TPU kernel masks it.  The
// ranges' tile order differs from the linear cache's, so the two agree to
// float32 rounding, not bit for bit.
#include "attention.cuh"

namespace {

using qgt::SlotRanges;
using qgt::TS;
constexpr int ROWS = 64;            // query rows per block
constexpr int WARPS = 8;
constexpr int RW = ROWS / WARPS;    // query rows per warp

template <int HD, bool Q8>
__global__ void __launch_bounds__(WARPS * 32) flash_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ pos0,
    float* __restrict__ out, int KV, int rows, int rep, int S,
    long long kv_bstride, long long sc_bstride, int window, int ring,
    float scale) {
  constexpr int KP = HD + 1;  // padded K row: lane j reads row j conflict-free
  constexpr int DL = HD / 32;  // output dims per lane
  using Elem = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                // [ROWS, HD], pre-scaled query rows
  float* kt = qs + ROWS * HD;     // [TS, KP]
  float* vt = kt + TS * KP;       // [TS, HD]
  float* kst = vt + TS * HD;      // [TS] k scales (int8 cache)
  float* vst = kst + TS;          // [TS] v scales

  const int bg = blockIdx.x, b = bg / KV, g = bg % KV;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, rows - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = static_cast<size_t>(b) * kv_bstride +
                      static_cast<size_t>(g) * S * HD;
  const Elem* kbase = static_cast<const Elem*>(kc) + head;
  const Elem* vbase = static_cast<const Elem*>(vc) + head;
  const size_t shead = static_cast<size_t>(b) * sc_bstride +
                       static_cast<size_t>(g) * S;
  const float* kscale = Q8 ? ksc + shead : nullptr;
  const float* vscale = Q8 ? vsc + shead : nullptr;

  const float* qb = q + (static_cast<size_t>(bg) * rows + row0) * HD;
  for (int i = threadIdx.x; i < ROWS * HD; i += blockDim.x)
    qs[i] = i < nrows * HD ? qb[i] * scale : 0.0f;

  const int p0 = pos0[b];
  const int q_lo = p0 + row0 / rep, q_hi = p0 + (row0 + nrows - 1) / rep;
  const int g_lo = window > 0 ? max(q_lo - window + 1, 0) : 0;
  const int p_cache = p0 + rows / rep - 1;  // the chunk's newest token
  SlotRanges walk{{0, 0}, {0, 0}};
  if (ring > 0) {
    walk = qgt::ring_ranges(q_hi, q_hi - g_lo + 1, ring);
  } else {
    walk.a[0] = g_lo;
    walk.e[0] = min(q_hi, S - 1) + 1;
  }

  int qpos[RW];
  bool live[RW];
  float m_run[RW], l_run[RW], acc[RW][DL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = warp * RW + i;
    live[i] = row < nrows;
    qpos[i] = p0 + (row0 + row) / rep;
    m_run[i] = -FLT_MAX;
    l_run[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < DL; ++k) acc[i][k] = 0.0f;
  }

  for (int seg = 0; seg < 2; ++seg) {
    for (int s0 = walk.a[seg]; s0 < walk.e[seg]; s0 += TS) {
      const int cnt = min(TS, walk.e[seg] - s0);
      __syncthreads();  // previous tile consumed (and the query rows staged)
      qgt::stage_kv<HD, Q8>(kbase, vbase, kscale, vscale, s0, cnt, kt, KP,
                            vt, kst, vst);
      __syncthreads();
      const int s = s0 + lane;
      // the global position slot s holds (the slot itself when linear)
      const int gs = ring > 0 ? p_cache - qgt::ring_mod(p_cache - s, ring) : s;
      float d[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) d[i] = 0.0f;
      if (lane < cnt) {
        const float* qw = qs + warp * RW * HD;
#pragma unroll 8
        for (int t = 0; t < HD; ++t) {
          const float kv = kt[lane * KP + t];
#pragma unroll
          for (int i = 0; i < RW; ++i) d[i] = fmaf(qw[i * HD + t], kv, d[i]);
        }
      }
      const float ksl = Q8 && lane < cnt ? kst[lane] : 1.0f;
      const float vsl = Q8 && lane < cnt ? vst[lane] : 1.0f;
      float pr[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const bool ok = live[i] && lane < cnt && gs >= 0 && gs <= qpos[i] &&
                        (window <= 0 || gs > qpos[i] - window);
        const float sc = ok ? d[i] * ksl : -FLT_MAX;
        const float m_new = fmaxf(m_run[i], qgt::warp_max(sc));
        const float alpha = expf(m_run[i] - m_new);
        const float pv = ok ? expf(sc - m_new) : 0.0f;
        l_run[i] = l_run[i] * alpha + qgt::warp_sum(pv);
        m_run[i] = m_new;
        pr[i] = pv * vsl;  // v scale folds into p (1 for bf16)
#pragma unroll
        for (int k = 0; k < DL; ++k) acc[i][k] *= alpha;
      }
      for (int j = 0; j < cnt; ++j) {
        float vv[DL];
#pragma unroll
        for (int k = 0; k < DL; ++k) vv[k] = vt[j * HD + lane + 32 * k];
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float pj = __shfl_sync(qgt::FULL, pr[i], j);
#pragma unroll
          for (int k = 0; k < DL; ++k) acc[i][k] = fmaf(pj, vv[k], acc[i][k]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (!live[i]) continue;
    const float l = l_run[i] > 0.0f ? l_run[i] : 1.0f;
    float* o = out + (static_cast<size_t>(bg) * rows + row0 + warp * RW + i) *
                         HD;
#pragma unroll
    for (int k = 0; k < DL; ++k) o[lane + 32 * k] = acc[i][k] / l;
  }
}

template <int HD, bool Q8>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* pos0, void* out, int B, int KV,
           int rows, int rep, int S, long long kv_bstride,
           long long sc_bstride, int window, int ring, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (ROWS * HD + TS * (HD + 1) + TS * HD + 2 * TS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<HD, Q8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(B * KV, (rows + ROWS - 1) / ROWS);
  flash_prefill_kernel<HD, Q8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), kc, vc, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos0),
      static_cast<float*>(out), KV, rows, rep, S, kv_bstride, sc_bstride,
      window, ring, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int quant, const void* q, const void* kc, const void* vc,
              const void* ksc, const void* vsc, const void* pos0, void* out,
              int B, int KV, int rows, int rep, int S, long long kv_bstride,
              long long sc_bstride, int window, int ring, float scale,
              cudaStream_t st) {
  if (quant)
    return launch<HD, true>(q, kc, vc, ksc, vsc, pos0, out, B, KV, rows, rep,
                            S, kv_bstride, sc_bstride, window, ring, scale,
                            st);
  return launch<HD, false>(q, kc, vc, ksc, vsc, pos0, out, B, KV, rows, rep,
                           S, kv_bstride, sc_bstride, window, ring, scale,
                           st);
}

}  // namespace

// out f32 [B, KV, rows, hd] = causal attention of q f32 [B, KV, rows, hd]
// (rows = T * rep, T-major) over one layer's cache kc/vc [B, KV, S, hd]
// (slot b at kc + b * kv_bstride elements; bf16, or int8 with quant = 1
// and the f32 scales ksc/vsc [B, KV, S], slot b at ksc + b * sc_bstride):
// row t*rep + r attends positions <= pos0[b] + t and, with window > 0,
// > pos0[b] + t - window; at slot = position in a linear cache (ring = 0),
// at slot = position mod ring in a ring (0 < window, window + T <= ring <=
// S).
QGT_EXPORT int qgt_flash_prefill(const void* q, const void* kc,
                                 const void* vc, const void* ksc,
                                 const void* vsc, const void* pos0, void* out,
                                 int B, int KV, int rows, int rep, int hd,
                                 int S, long long kv_bstride,
                                 long long sc_bstride, int quant, int window,
                                 int ring, float scale, void* stream) {
  if (rep < 1 || rows < 1 || rows % rep || B < 1 || KV < 1 || S < 1 ||
      window < 0 || ring < 0 || ring > S ||
      (ring > 0 && (window < 1 || window + rows / rep > ring)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd<64>(quant, q, kc, vc, ksc, vsc, pos0, out, B, KV, rows,
                         rep, S, kv_bstride, sc_bstride, window, ring, scale,
                         st);
  if (hd == 128)
    return launch_hd<128>(quant, q, kc, vc, ksc, vsc, pos0, out, B, KV, rows,
                          rep, S, kv_bstride, sc_bstride, window, ring, scale,
                         st);
  return static_cast<int>(cudaErrorInvalidValue);
}
