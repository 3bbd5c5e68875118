// K3: flash-decode attention over the stacked bf16 KV cache.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/attention.py::flash_decode
// (body _kernel) for the bf16 cache without window or ring.  One query
// token per slot; the rep = H/KV query rows of a kv head share every K/V
// tile; per-slot causal length from pos; the current token's k/v (not yet
// written to the cache) folded in last; the layer indexed inside the full
// [L, B, KV, S, hd] cache, so no per-layer copy is made.
//
// Bound on an H100: bytes (each slot's valid K and V rows, read once).
// Design: one block per (slot, kv head) with one warp per query row.  The
// block stages TS = 32 cache rows of K and V at a time in shared memory
// as float32 (16-byte loads of 8 bf16); lane j scores row j, the warp
// runs the online-softmax recurrence in registers (running max, sum, and
// hd/32 output dims per lane), all in float32 as the TPU kernel computes
// it; the plain version's dense softmax sums in another order.  The valid
// length is min(pos, S) (pos + 1 without a current token), so a stale
// position of an inactive serving slot can never read out of bounds.
#include <float.h>

#include "common.cuh"

namespace {

constexpr int TS = 32;  // cache rows per tile (one per lane)

template <int HD>
__global__ void flash_decode_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos,
    const __nv_bfloat16* __restrict__ kcur,
    const __nv_bfloat16* __restrict__ vcur, float* __restrict__ out, int B,
    int KV, int rep, int S, int layer, int has_current, float scale) {
  constexpr int KP = HD + 1;  // padded K row: lane j reads row j conflict-free
  constexpr int DL = HD / 32;  // output dims per lane
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                // [rep, HD], pre-scaled query rows
  float* ks = qs + rep * HD;      // [TS, KP]
  float* vs = ks + TS * KP;       // [TS, HD]

  const int b = blockIdx.x / KV, g = blockIdx.x % KV;
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t head = (static_cast<size_t>(layer) * B + b) * KV + g;
  const __nv_bfloat16* kbase = kc + head * S * HD;
  const __nv_bfloat16* vbase = vc + head * S * HD;

  for (int i = threadIdx.x; i < rep * HD; i += blockDim.x)
    qs[i] = q[(static_cast<size_t>(b) * KV + g) * rep * HD + i] * scale;
  __syncthreads();

  int valid = pos[b] + (has_current ? 0 : 1);
  valid = valid < 0 ? 0 : (valid > S ? S : valid);

  float m_run = -FLT_MAX, l_run = 0.0f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.0f;

  for (int s0 = 0; s0 < valid; s0 += TS) {
    const int cnt = min(TS, valid - s0);
    __syncthreads();  // previous tile consumed
    for (int e = threadIdx.x; e < cnt * (HD / 8); e += blockDim.x) {
      const int j = e / (HD / 8), c8 = (e % (HD / 8)) * 8;
      const size_t off = static_cast<size_t>(s0 + j) * HD + c8;
      const uint4 kr = __ldg(reinterpret_cast<const uint4*>(kbase + off));
      const uint4 vr = __ldg(reinterpret_cast<const uint4*>(vbase + off));
      const __nv_bfloat16* kh = reinterpret_cast<const __nv_bfloat16*>(&kr);
      const __nv_bfloat16* vh = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ks[j * KP + c8 + t] = __bfloat162float(kh[t]);
        vs[j * HD + c8 + t] = __bfloat162float(vh[t]);
      }
    }
    __syncthreads();
    float sc = -FLT_MAX;
    if (lane < cnt) {
      float d = 0.0f;
#pragma unroll 16
      for (int t = 0; t < HD; ++t) d = fmaf(qs[r * HD + t], ks[lane * KP + t], d);
      sc = d;
    }
    const float m_new = fmaxf(m_run, qgt::warp_max(sc));
    const float alpha = expf(m_run - m_new);
    const float p = lane < cnt ? expf(sc - m_new) : 0.0f;
    l_run = l_run * alpha + qgt::warp_sum(p);
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
    for (int j = 0; j < cnt; ++j) {
      const float pj = __shfl_sync(qgt::FULL, p, j);
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[i] = fmaf(pj, vs[j * HD + lane + 32 * i], acc[i]);
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

template <int HD>
int launch(const void* q, const void* kc, const void* vc, const void* pos,
           const void* kcur, const void* vcur, void* out, int B, int KV,
           int rep, int S, int layer, int has_current, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (rep * HD + TS * (HD + 1) + TS * HD);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  flash_decode_kernel<HD><<<B * KV, rep * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(pos),
      static_cast<const __nv_bfloat16*>(kcur),
      static_cast<const __nv_bfloat16*>(vcur), static_cast<float*>(out), B,
      KV, rep, S, layer, has_current, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out f32 [B, KV, rep, hd] = attention of q f32 [B, KV, rep, hd] over
// layer `layer` of the bf16 caches [L, B, KV, S, hd], slots < pos[b]
// (<= pos[b] when has_current is 0), plus kcur/vcur bf16 [B, KV, 1, hd].
QGT_EXPORT int qgt_flash_decode_bf16(const void* q, const void* kc,
                                     const void* vc, const void* pos,
                                     const void* kcur, const void* vcur,
                                     void* out, int B, int KV, int rep,
                                     int hd, int S, int layer,
                                     int has_current, float scale,
                                     void* stream) {
  if (rep < 1 || rep > 32 || B < 1 || KV < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, kc, vc, pos, kcur, vcur, out, B, KV, rep, S, layer,
                      has_current, scale, st);
  if (hd == 128)
    return launch<128>(q, kc, vc, pos, kcur, vcur, out, B, KV, rep, S, layer,
                       has_current, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
