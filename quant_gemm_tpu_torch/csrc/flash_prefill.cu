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
// Bound on an H100: at the Mistral-7B ring chunk (T 128, hd 128, window
// 4096) operations, 0.0087 ms of bf16 tensor-core work; bytes at short
// contexts (q, the valid K and V rows once, out).  Design: QK^T and PV on
// the tensor cores (mma.sync m16n8k16 bf16, float32 accumulation), the
// online softmax in float32, split over the slots so the grid fills the
// card.  One block per (slot, kv head, ROWS = 64 query rows, piece of the
// slot interval), four warps of 16 rows.  K and V are exact in bf16 (a
// bf16 cache, or int8 codes converted in shared memory); the pre-scaled
// float32 q and the probabilities p are not, so each enters as hi + lo =
// bf16(x) + bf16(x - hi), two MMAs, and the products match float32 to
// about 2^-16 relative.  Tiles of KT = 64 cache rows are staged with
// cp.async (double-buffered; zero-filled past the piece) and read with
// ldmatrix (.trans for V).  Int8: the k scale multiplies the scores before
// the mask, p enters the running sum unscaled and p * v_scale the PV
// product (the scale folded in before the hi + lo split).  The final
// division guards l > 0.
//
// Slots walked per (slot, kv head, row tile), from the oldest position any
// of its rows attends (the window's low bound of its oldest row) to the
// newest (its newest row's).  Linear cache: slot = position, clamped to
// S - 1 so that no read leaves the cache; each element is masked by slot
// <= qpos (and > qpos - window).  Ring of R slots (token g at slot g mod
// R, only slots < R attended; needs window + T <= R): the modular interval
// of those positions, one or two contiguous slot ranges (attention.cuh
// ring_ranges), O(window + ROWS / rep) slots, not O(R).  Each element is
// masked by the global position its slot holds, g = p_cache - (p_cache -
// slot) mod R with p_cache = pos0 + T - 1 the chunk's newest token: g <=
// qpos, g >= 0 and g > qpos - window, as the TPU kernel masks it.
//
// Split over the slots: the interval (its ranges end to end) is cut into
// gridDim.z pieces of whole tiles (per = ceil(tiles / pieces) tiles each;
// the wrapper's ops/attention.py::prefill_pieces picks the count from
// host-known sizes).  With one piece the block writes out; otherwise
// each piece writes its unnormalised sum and (max, sum) for each row, and
// attention.cuh's attn_merge_kernel (shared with K3) combines the pieces
// in piece order by running max and sum, so every call gives the same
// bits.  A piece that
// no row of its tile attends (the causal bound, pos0 = 0, the window)
// leaves max -FLT_MAX and sum 0 and weighs nothing.  The ranges' tile
// order differs from the linear cache's, so the two agree to float32
// rounding, not bit for bit.
#include <limits.h>

#include "attention.cuh"
#include "tc.cuh"

namespace {

using qgt::SlotRanges;
constexpr int ROWS = 64;  // query rows per block
constexpr int WARPS = 4;  // 16 rows each
constexpr int KT = 64;    // cache rows per tile

// Shared memory: per stage the K and V tile as staged (bf16 rows padded
// to KST bytes, or the raw int8 rows), the global position each row holds
// and (int8) its k and v scale; int8 adds one pair of converted bf16
// tiles after the two stages.
template <int HD, bool Q8>
struct PfSmem {
  static constexpr int KST = HD * 2 + 16;  // bf16 row bytes (odd x 16)
  static constexpr int ROWB = Q8 ? HD : KST;
  static constexpr int K = 0;
  static constexpr int V = K + KT * ROWB;
  static constexpr int GS = V + KT * ROWB;
  static constexpr int KS = GS + KT * 4;
  static constexpr int VS = KS + KT * 4;
  static constexpr int STAGE = VS + KT * 4;
  static constexpr int CK = 2 * STAGE;  // int8: converted K, V
  static constexpr int CV = CK + KT * KST;
  static constexpr int TOTAL = Q8 ? CV + KT * KST : 2 * STAGE;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(qgt::FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(qgt::FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(qgt::FULL, v, 1);
  return v + __shfl_xor_sync(qgt::FULL, v, 2);
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(WARPS * 32) flash_prefill_kernel(
    const float* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ pos0,
    float* __restrict__ out, float* __restrict__ po,
    float* __restrict__ pml, int KV, int rows, int rep, int S,
    long long kv_bstride, long long sc_bstride, int window, int ring,
    float scale) {
  using Sm = PfSmem<HD, Q8>;
  constexpr int KK = HD / 16;   // k16 steps of QK^T
  constexpr int DN = HD / 8;    // n8 tiles of the output
  constexpr int ELT = Q8 ? 1 : 2;
  extern __shared__ __align__(16) uint8_t psm[];

  const int bg = blockIdx.x, b = bg / KV, kvh = bg % KV;
  const int row0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, rows - row0);
  const int ns = gridDim.z, piece = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t head = static_cast<size_t>(b) * kv_bstride +
                      static_cast<size_t>(kvh) * S * HD;
  const uint8_t* kbase = static_cast<const uint8_t*>(kc) + head * ELT;
  const uint8_t* vbase = static_cast<const uint8_t*>(vc) + head * ELT;
  const size_t shead = static_cast<size_t>(b) * sc_bstride +
                       static_cast<size_t>(kvh) * S;
  const float* kscale = Q8 ? ksc + shead : nullptr;
  const float* vscale = Q8 ? vsc + shead : nullptr;

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
  const int L0 = max(walk.e[0] - walk.a[0], 0);
  const int L = L0 + max(walk.e[1] - walk.a[1], 0);
  const int per = ((L + KT - 1) / KT + ns - 1) / ns;  // tiles a piece
  const int u_begin = min(L, piece * per * KT);
  const int u_end = min(L, (piece + 1) * per * KT);
  const int ntile = (u_end - u_begin + KT - 1) / KT;

  // this lane's query fragments, pre-scaled, as hi + lo: rows ra and ra+8
  const int ra = warp * 16 + gq;
  const float* qb = q + (static_cast<size_t>(bg) * rows + row0) * HD;
  uint32_t qhi[KK][4], qlo[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = ra + (f & 1) * 8, col = kk * 16 + (f >> 1) * 8 + 2 * tq;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < nrows)
        v = *reinterpret_cast<const float2*>(qb + static_cast<size_t>(r) * HD +
                                             col);
      qgt::split_bf16(v.x * scale, v.y * scale, qhi[kk][f], qlo[kk][f]);
    }
  int qpos[2];
  float m_run[2], l_run[2], o[DN][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = p0 + (row0 + ra + 8 * r) / rep;
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.0f;
  }
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;

  // tile j of the piece (its slots u_begin + j*KT ..) into stage buf
  auto issue = [&](int j, int buf) {
    uint8_t* st = psm + buf * Sm::STAGE;
    const int u = u_begin + j * KT;
    constexpr int CH = HD * ELT / 16;  // 16-byte chunks a row
    for (int c = tid; c < KT * CH; c += WARPS * 32) {
      const int key = c / CH, ch = c % CH, uu = u + key;
      const bool ok = uu < u_end;
      const int slot = uu < L0 ? walk.a[0] + uu : walk.a[1] + uu - L0;
      const size_t off = ok ? static_cast<size_t>(slot) * HD * ELT + ch * 16
                            : 0;
      qgt::cp_async16(st + Sm::K + key * Sm::ROWB + ch * 16, kbase + off,
                      ok ? 16 : 0);
      qgt::cp_async16(st + Sm::V + key * Sm::ROWB + ch * 16, vbase + off,
                      ok ? 16 : 0);
    }
    for (int key = tid; key < KT; key += WARPS * 32) {
      const int uu = u + key;
      const bool ok = uu < u_end;
      const int slot = uu < L0 ? walk.a[0] + uu : walk.a[1] + uu - L0;
      // the global position slot holds (the slot itself when linear)
      reinterpret_cast<int*>(st + Sm::GS)[key] =
          !ok ? INT_MIN
              : (ring > 0 ? p_cache - qgt::ring_mod(p_cache - slot, ring)
                          : slot);
      if (Q8) {
        reinterpret_cast<float*>(st + Sm::KS)[key] = ok ? kscale[slot] : 0.0f;
        reinterpret_cast<float*>(st + Sm::VS)[key] = ok ? vscale[slot] : 0.0f;
      }
    }
  };

  if (ntile > 0) issue(0, 0);
  qgt::cp_async_commit();
  for (int j = 0; j < ntile; ++j) {
    const int buf = j & 1;
    if (j + 1 < ntile) issue(j + 1, buf ^ 1);
    qgt::cp_async_commit();
    qgt::cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = psm + buf * Sm::STAGE;
    const uint8_t* kt = st + Sm::K;
    const uint8_t* vt = st + Sm::V;
    if constexpr (Q8) {  // int8 codes -> bf16, exact
      uint8_t* ck = psm + Sm::CK;
      uint8_t* cv = psm + Sm::CV;
      for (int c = tid; c < 2 * KT * (HD / 8); c += WARPS * 32) {
        const int which = c / (KT * (HD / 8)), e = c % (KT * (HD / 8));
        const int key = e / (HD / 8), ch = e % (HD / 8);
        const uint2 raw = *reinterpret_cast<const uint2*>(
            (which ? vt : kt) + key * HD + ch * 8);
        const int8_t* r8 = reinterpret_cast<const int8_t*>(&raw);
        uint4 pk;
        pk.x = qgt::pack_bf16(r8[0], r8[1]);
        pk.y = qgt::pack_bf16(r8[2], r8[3]);
        pk.z = qgt::pack_bf16(r8[4], r8[5]);
        pk.w = qgt::pack_bf16(r8[6], r8[7]);
        *reinterpret_cast<uint4*>((which ? cv : ck) + key * Sm::KST +
                                  ch * 16) = pk;
      }
      __syncthreads();
      kt = ck;
      vt = cv;
    }
    const int* gsp = reinterpret_cast<const int*>(st + Sm::GS);
    const float* ksp = reinterpret_cast<const float*>(st + Sm::KS);
    const float* vsp = reinterpret_cast<const float*>(st + Sm::VS);

    // scores: s[n8 tile of keys][c] = q . k
    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int jp = 0; jp < KT / 16; ++jp) {
        uint32_t kb[4];
        qgt::ldmatrix_x4(kb, kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                      Sm::KST +
                                  (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        qgt::mma_bf16(s[2 * jp], qhi[kk], kb[0], kb[1]);
        qgt::mma_bf16(s[2 * jp], qlo[kk], kb[0], kb[1]);
        qgt::mma_bf16(s[2 * jp + 1], qhi[kk], kb[2], kb[3]);
        qgt::mma_bf16(s[2 * jp + 1], qlo[kk], kb[2], kb[3]);
      }

    // online softmax in float32: k scale, mask, running max and sum
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1), r = e >> 1;
        const int gs = gsp[key];
        const bool ok = gs >= 0 && gs <= qpos[r] &&
                        (window <= 0 || gs > qpos[r] - window);
        const float sc = ok ? (Q8 ? s[n][e] * ksp[key] : s[n][e]) : -FLT_MAX;
        s[n][e] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = expf(m_run[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + 2 * tq + (e & 1), r = e >> 1;
        const float p =
            s[n][e] == -FLT_MAX ? 0.0f : expf(s[n][e] - m_new[r]);
        sum[r] += p;
        s[n][e] = Q8 ? p * vsp[key] : p;  // the v scale folds into p
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_run[r] = l_run[r] * alpha[r] + quad_sum(sum[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int d = 0; d < DN; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // o += p . V, p as hi + lo
#pragma unroll
    for (int k2 = 0; k2 < KT / 16; ++k2) {
      uint32_t ph[4], pl[4];
      qgt::split_bf16(s[2 * k2][0], s[2 * k2][1], ph[0], pl[0]);
      qgt::split_bf16(s[2 * k2][2], s[2 * k2][3], ph[1], pl[1]);
      qgt::split_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1], ph[2], pl[2]);
      qgt::split_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        qgt::ldmatrix_x4_trans(
            vb, vt + (k2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                         Sm::KST +
                    (dp * 16 + (lane >> 4) * 8) * 2);
        qgt::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        qgt::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        qgt::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        qgt::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();  // stage buf (and the int8 tiles) are refilled next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= nrows) continue;
    const size_t orow = ns == 1
        ? static_cast<size_t>(bg) * rows + row0 + row
        : (static_cast<size_t>(bg) * ns + piece) * rows + row0 + row;
    float* dst = (ns == 1 ? out : po) + orow * HD;
    // one piece: the normalised row; several: the piece's sums
    const float l = ns > 1 ? 1.0f : (l_run[r] > 0.0f ? l_run[r] : 1.0f);
#pragma unroll
    for (int d = 0; d < DN; ++d)
      *reinterpret_cast<float2*>(dst + d * 8 + 2 * tq) =
          make_float2(o[d][2 * r] / l, o[d][2 * r + 1] / l);
    if (ns > 1 && tq == 0)
      *reinterpret_cast<float2*>(pml + orow * 2) =
          make_float2(m_run[r], l_run[r]);
  }
}

template <int HD, bool Q8>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* pos0, void* out, void* po, void* pml,
           int ns, int B, int KV, int rows, int rep, int S,
           long long kv_bstride, long long sc_bstride, int window, int ring,
           float scale, cudaStream_t stream) {
  constexpr int smem = PfSmem<HD, Q8>::TOTAL;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<HD, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * KV, (rows + ROWS - 1) / ROWS, ns);
  flash_prefill_kernel<HD, Q8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), kc, vc, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos0),
      static_cast<float*>(out), static_cast<float*>(po),
      static_cast<float*>(pml), KV, rows, rep, S, kv_bstride, sc_bstride,
      window, ring, scale);
  if (ns > 1)
    qgt::attn_merge<HD>(static_cast<const float*>(po),
                        static_cast<const float*>(pml),
                        static_cast<float*>(out), B * KV * rows, rows, ns,
                        nullptr, nullptr, nullptr, 0.0f, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int quant, const void* q, const void* kc, const void* vc,
              const void* ksc, const void* vsc, const void* pos0, void* out,
              void* po, void* pml, int ns, int B, int KV, int rows, int rep,
              int S, long long kv_bstride, long long sc_bstride, int window,
              int ring, float scale, cudaStream_t st) {
  if (quant)
    return launch<HD, true>(q, kc, vc, ksc, vsc, pos0, out, po, pml, ns, B,
                            KV, rows, rep, S, kv_bstride, sc_bstride, window,
                            ring, scale, st);
  return launch<HD, false>(q, kc, vc, ksc, vsc, pos0, out, po, pml, ns, B, KV,
                           rows, rep, S, kv_bstride, sc_bstride, window, ring,
                           scale, st);
}

}  // namespace

// out f32 [B, KV, rows, hd] = causal attention of q f32 [B, KV, rows, hd]
// (rows = T * rep, T-major) over one layer's cache kc/vc [B, KV, S, hd]
// (slot b at kc + b * kv_bstride elements; bf16, or int8 with quant = 1
// and the f32 scales ksc/vsc [B, KV, S], slot b at ksc + b * sc_bstride):
// row t*rep + r attends positions <= pos0[b] + t and, with window > 0,
// > pos0[b] + t - window; at slot = position in a linear cache (ring = 0),
// at slot = position mod ring in a ring (0 < window, window + T <= ring <=
// S); ns pieces of the slot interval, with ns > 1 the scratch po f32 [B,
// KV, ns, rows, hd] and pml f32 [B, KV, ns, rows, 2].
QGT_EXPORT int qgt_flash_prefill(const void* q, const void* kc,
                                 const void* vc, const void* ksc,
                                 const void* vsc, const void* pos0, void* out,
                                 void* po, void* pml, int ns, int B, int KV,
                                 int rows, int rep, int hd, int S,
                                 long long kv_bstride, long long sc_bstride,
                                 int quant, int window,
                                 int ring, float scale, void* stream) {
  if (rep < 1 || rows < 1 || rows % rep || B < 1 || KV < 1 || S < 1 ||
      window < 0 || ring < 0 || ring > S ||
      (ring > 0 && (window < 1 || window + rows / rep > ring)) || ns < 1 ||
      (ns > 1 && (!po || !pml)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd<64>(quant, q, kc, vc, ksc, vsc, pos0, out, po, pml, ns,
                         B, KV, rows, rep, S, kv_bstride, sc_bstride, window,
                         ring, scale, st);
  if (hd == 128)
    return launch_hd<128>(quant, q, kc, vc, ksc, vsc, pos0, out, po, pml, ns,
                          B, KV, rows, rep, S, kv_bstride, sc_bstride, window,
                          ring, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
