// K3: flash-decode attention over the stacked KV cache, bf16 or int8.
//
// Replaces the Pallas kernel quant_gemm_tpu/ops/attention.py::flash_decode
// (body _kernel): a linear cache or a ring; bf16, or int8 codes with one
// f32 scale per (slot, head, token); full causal or a sliding window.  One
// query token per slot; the rep = H/KV query rows of a kv head share every
// K/V tile; per-slot causal length from pos; the current token's k/v (bf16,
// not yet written to the cache, even with the int8 cache) folded in last.
// The wrapper passes one layer's [B, KV, S, hd] view of the stacked cache
// (base pointer and slot stride), so no per-layer copy is made.
//
// Bound on an H100: bytes (each slot's valid K and V rows, and with int8
// their scales, read once); at rep = 4 the products are a few percent of
// the bf16 tensor-core rate.  Design, chosen so that the cache is read
// once, as raw bytes, with its loads overlapping the math:
// * split over the walk: each (slot, kv head, 16 query rows)'s interval
//   is cut along its logical order (oldest token first, so a wrapped
//   ring's two ranges split evenly) into gridDim.z pieces of whole tiles
//   (per = ceil(tiles / pieces) tiles each; ops/attention.py::
//   decode_pieces picks the count from host-known sizes, enough for about
//   two blocks per SM).  With one piece the block writes the output and
//   folds the current token itself, one launch; otherwise each piece
//   writes its unnormalised sum and (max, sum) per row and attention.cuh's
//   attn_merge_kernel (shared with K5) combines them in piece order and
//   folds the current token last, so every call gives the same bits.  A
//   piece past its slot's interval writes max -FLT_MAX, sum 0 and exits.
// * raw tiles in a pipeline: tiles of KT = 64 cache rows, K and V as
//   stored (bf16, or the int8 codes and their scales), go to shared
//   memory with cp.async in a ring of STAGES buffers, so the next tiles
//   load while this one is computed; int8 moves half the bytes of bf16.
// * tensor cores, no serial chains: the block's four warps take 16 rows of
//   each tile apiece; QK^T and PV are mma.sync m16n8k16 bf16 with float32
//   accumulation (tc.cuh), the rep query rows in one m16 tile (rows past
//   rep are zero), so every cache element is loaded once for all rows.
//   The pre-scaled float32 q and the probabilities p enter as hi + lo =
//   bf16(x) + bf16(x - hi), two MMAs each, so the products match float32
//   to about 2^-16 relative, as K5's.  bf16 K and V are exact operands
//   (ldmatrix, .trans for V).  Int8 codes become bf16 exactly in
//   registers: each byte goes into a float32 2^23 + (q + 128) by a byte
//   permute, one subtraction gives q, and its high half is q in bf16.  The
//   int8 MMA operands are read so that no transpose is needed: within a
//   warp's 16 rows the scores' columns hold the rows in the order kappa
//   (below), which puts the four rows a lane's PV operand needs at lane
//   offsets t, t+4, t+8, t+12, and each row's hd order is permuted in
//   groups of four, the same in q and K; the output's hd order follows
//   and is undone when it is written.
// * the online softmax in float32 per warp (running max and sum over its
//   rows of each tile), the four warps combined in warp order at the end.
//   Int8: the k scale multiplies the scores before the mask, p enters the
//   running sum unscaled and p * v_scale the PV product.  The final
//   division guards l > 0.  The plain version's dense softmax sums in
//   another order.
//
// Slots walked.  Linear cache: [lo, valid) with valid = min(pos, S) (pos +
// 1 without a current token) and lo = max(pos - window + 1, 0) under a
// window, so a stale position of an inactive serving slot never reads out
// of bounds.  Ring of R slots (token g at slot g mod R, only slots < R
// attended): the newest cached token is p_new = valid - 1 and the window
// holds cnt = min(window - 1, pos) cached tokens with a current token
// (min(window, pos + 1) without), the modular interval of cnt slots ending
// at p_new mod R: one or two contiguous ranges (attention.cuh
// ring_ranges), so the walk is O(window), not O(R); every slot of the
// ranges is in the window, and only rows past the interval's end are
// masked.  The ranges run oldest first, a tile order other than the
// linear cache's, so the two agree to float32 rounding, not bit for bit.
// Nothing here depends on the host knowing pos: the launch reads no
// position and allocates nothing, so it can be captured in a CUDA graph.
#include "attention.cuh"
#include "tc.cuh"

namespace {

using qgt::SlotRanges;
constexpr int WARPS = 4;   // 16 cache rows of each tile apiece
constexpr int KT = 64;     // cache rows per tile
constexpr int QR = 16;     // query rows per block: one m16 tile
constexpr int STAGES = 3;  // tiles in flight

// Shared memory: per stage the K and V tile as stored (bf16 rows padded
// to an odd multiple of 16 bytes for ldmatrix; int8 K rows at HD + 16
// bytes and V rows at HD + 32, which keep the lanes' 4-byte reads free of
// bank conflicts) and (int8) the rows' k and v scales.  After the loop
// the drained stages hold each warp's output rows, (max, sum) per row and
// the current token's score per row.
template <int HD, bool Q8>
struct DecSmem {
  static constexpr int RBK = Q8 ? HD + 16 : 2 * HD + 16;
  static constexpr int RBV = Q8 ? HD + 32 : 2 * HD + 16;
  static constexpr int K = 0;
  static constexpr int V = K + KT * RBK;
  static constexpr int KS = V + KT * RBV;
  static constexpr int VS = KS + KT * 4;
  static constexpr int STAGE = Q8 ? VS + KT * 4 : KS;
  static constexpr int PIPE = STAGES * STAGE;
  static constexpr int EML = WARPS * QR * HD * 4;
  static constexpr int ESC = EML + WARPS * QR * 2 * 4;
  static constexpr int EPI = ESC + QR * 4;
  static constexpr int TOTAL = PIPE > EPI ? PIPE : EPI;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(qgt::FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(qgt::FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(qgt::FULL, v, 1);
  return v + __shfl_xor_sync(qgt::FULL, v, 2);
}

// Byte i of x = (q + 128) of four int8 codes as q in float32, exactly:
// 2^23 + (q + 128) by a byte permute, minus 2^23 + 128.
__device__ __forceinline__ float s8_f32(uint32_t x, int i) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | i)) -
         8388736.0f;
}

// Two float32 holding integers |v| <= 128 as a bf16 pair (a in the low
// half): their high halves, exactly.
__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Cache row of column c of score tile j (c = 0..7, j = 0, 1) in a warp's
// 16 rows, int8 form: kappa(j, c) = c / 2 + 4 (2 j + c % 2), so the p of
// PV's k pair (2t, 2t+1) of tile j is rows t + 8j and t + 8j + 4.
__device__ __forceinline__ int kappa(int j, int c) {
  return (c >> 1) + 4 * (2 * j + (c & 1));
}

template <int HD, bool Q8>
__global__ void __launch_bounds__(WARPS * 32) flash_decode_kernel(
    const float* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const int* __restrict__ pos,
    const __nv_bfloat16* __restrict__ kcur,
    const __nv_bfloat16* __restrict__ vcur, float* __restrict__ out,
    float* __restrict__ po, float* __restrict__ pml, int KV, int rep, int S,
    long long kv_bstride, long long sc_bstride, int has_current, int window,
    int ring, float scale) {
  using Sm = DecSmem<HD, Q8>;
  constexpr int KK = HD / 16;  // k16 steps of QK^T
  constexpr int DN = HD / 8;   // n8 tiles of the output
  constexpr int ELT = Q8 ? 1 : 2;
  constexpr int CH = HD * ELT / 16;  // 16-byte chunks a cache row
  extern __shared__ __align__(16) uint8_t dsm[];

  const int bg = blockIdx.x, b = bg / KV, kvh = bg % KV;
  const int r0 = blockIdx.y * QR, nrows = min(QR, rep - r0);
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

  // the interval, oldest first, as one or two slot ranges
  const int p = pos[b];
  SlotRanges walk{{0, 0}, {0, 0}};
  if (ring > 0) {
    const int p_new = p + (has_current ? 0 : 1) - 1;
    const int cnt = min(window - (has_current ? 1 : 0), p_new + 1);
    walk = qgt::ring_ranges(p_new, cnt, ring);
  } else {
    int valid = p + (has_current ? 0 : 1);
    valid = valid < 0 ? 0 : (valid > S ? S : valid);
    walk.a[0] = window > 0 ? max(p - window + 1, 0) : 0;
    walk.e[0] = valid;
  }
  const int L0 = max(walk.e[0] - walk.a[0], 0);
  const int L = L0 + max(walk.e[1] - walk.a[1], 0);
  const int per = ((L + KT - 1) / KT + ns - 1) / ns;  // tiles a piece
  const int u_begin = min(L, piece * per * KT);
  const int u_end = min(L, (piece + 1) * per * KT);
  const int ntile = (u_end - u_begin + KT - 1) / KT;
  const size_t prow0 = (static_cast<size_t>(bg) * ns + piece) * rep + r0;

  if (ntile == 0 && ns > 1) {  // past the interval: weighs nothing
    for (int i = tid; i < nrows * HD; i += WARPS * 32)
      po[prow0 * HD + i] = 0.0f;
    for (int r = tid; r < nrows; r += WARPS * 32)
      *reinterpret_cast<float2*>(pml + (prow0 + r) * 2) =
          make_float2(-FLT_MAX, 0.0f);
    return;
  }

  // this lane's query fragments, pre-scaled, as hi + lo: rows gq, gq + 8;
  // int8 reads hd 4t .. 4t+3 of each k16 step (k pairs 2t and 2t + 8)
  const float* qb = q + (static_cast<size_t>(bg) * rep + r0) * HD;
  uint32_t qhi[KK][4], qlo[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = gq + (f & 1) * 8;
      const int col = Q8 ? kk * 16 + 4 * tq + (f >> 1) * 2
                         : kk * 16 + (f >> 1) * 8 + 2 * tq;
      float2 v = make_float2(0.0f, 0.0f);
      if (r < nrows)
        v = *reinterpret_cast<const float2*>(qb + static_cast<size_t>(r) * HD +
                                             col);
      qgt::split_bf16(v.x * scale, v.y * scale, qhi[kk][f], qlo[kk][f]);
    }
  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.0f, 0.0f};
  float o[DN][4];
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;

  // tile j of the piece (its rows u_begin + j*KT ..) into stage buf
  auto issue = [&](int j, int buf) {
    uint8_t* st = dsm + buf * Sm::STAGE;
    const int u = u_begin + j * KT;
#pragma unroll
    for (int i = 0; i < KT * CH / (WARPS * 32); ++i) {
      const int c = tid + i * WARPS * 32;
      const int key = c / CH, ch = c % CH, uu = u + key;
      const bool ok = uu < u_end;
      const int slot = uu < L0 ? walk.a[0] + uu : walk.a[1] + uu - L0;
      const size_t off =
          ok ? static_cast<size_t>(slot) * HD * ELT + ch * 16 : 0;
      qgt::cp_async16(st + Sm::K + key * Sm::RBK + ch * 16, kbase + off,
                      ok ? 16 : 0);
      qgt::cp_async16(st + Sm::V + key * Sm::RBV + ch * 16, vbase + off,
                      ok ? 16 : 0);
    }
    if constexpr (Q8) {
      if (tid < KT) {
        const int uu = u + tid;
        const bool ok = uu < u_end;
        const int slot =
            !ok ? 0 : (uu < L0 ? walk.a[0] + uu : walk.a[1] + uu - L0);
        qgt::cp_async4(st + Sm::KS + tid * 4, kscale + slot, ok ? 4 : 0);
        qgt::cp_async4(st + Sm::VS + tid * 4, vscale + slot, ok ? 4 : 0);
      }
    }
  };

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < ntile) issue(j, j);
    qgt::cp_async_commit();
  }
  for (int j = 0; j < ntile; ++j) {
    qgt::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j landed; tile j - 1's buffer is free
    if (j + STAGES - 1 < ntile)
      issue(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    qgt::cp_async_commit();
    const uint8_t* st = dsm + (j % STAGES) * Sm::STAGE;
    const uint8_t* kt = st + Sm::K + warp * 16 * Sm::RBK;
    const uint8_t* vt = st + Sm::V + warp * 16 * Sm::RBV;
    // rows of this warp's 16 still in the piece
    const int nvalid = u_end - (u_begin + j * KT + warp * 16);

    // scores: s[score tile j2][c] = q . k
    float s[2][4];
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j2][e] = 0.0f;
    if constexpr (!Q8) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t kb[4];
        qgt::ldmatrix_x4(kb, kt + ((lane >> 4) * 8 + (lane & 7)) * Sm::RBK +
                                 (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        qgt::mma_bf16(s[0], qhi[kk], kb[0], kb[1]);
        qgt::mma_bf16(s[0], qlo[kk], kb[0], kb[1]);
        qgt::mma_bf16(s[1], qhi[kk], kb[2], kb[3]);
        qgt::mma_bf16(s[1], qlo[kk], kb[2], kb[3]);
      }
    } else {
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {
        const uint8_t* kr = kt + kappa(j2, gq) * Sm::RBK + 4 * tq;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          const uint32_t x =
              *reinterpret_cast<const uint32_t*>(kr + kk * 16) ^ 0x80808080u;
          const uint32_t b0 = bf16_pair(s8_f32(x, 0), s8_f32(x, 1));
          const uint32_t b1 = bf16_pair(s8_f32(x, 2), s8_f32(x, 3));
          qgt::mma_bf16(s[j2], qhi[kk], b0, b1);
          qgt::mma_bf16(s[j2], qlo[kk], b0, b1);
        }
      }
    }

    // online softmax in float32: k scale, mask, running max and sum
    const float* ksp = reinterpret_cast<const float*>(st + Sm::KS) + warp * 16;
    const float* vsp = reinterpret_cast<const float*>(st + Sm::VS) + warp * 16;
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * tq + (e & 1), r = e >> 1;
        const int key = Q8 ? kappa(j2, c) : j2 * 8 + c;
        const float sc = key < nvalid ? (Q8 ? s[j2][e] * ksp[key] : s[j2][e])
                                      : -FLT_MAX;
        s[j2][e] = sc;
        mx[r] = fmaxf(mx[r], sc);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = expf(m_run[r] - m_new[r]);
    }
#pragma unroll
    for (int j2 = 0; j2 < 2; ++j2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * tq + (e & 1), r = e >> 1;
        const float pr =
            s[j2][e] == -FLT_MAX ? 0.0f : expf(s[j2][e] - m_new[r]);
        sum[r] += pr;
        s[j2][e] = Q8 ? pr * vsp[kappa(j2, c)] : pr;  // v scale into p
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

    // o += p . V, p as hi + lo (k pairs 2t of score tile 0, 2t + 8 of 1)
    uint32_t ph[4], pl[4];
    qgt::split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    qgt::split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    qgt::split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    qgt::split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
    if constexpr (!Q8) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        qgt::ldmatrix_x4_trans(
            vb, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * Sm::RBV +
                    (dp * 16 + (lane >> 4) * 8) * 2);
        qgt::mma_bf16(o[2 * dp], ph, vb[0], vb[1]);
        qgt::mma_bf16(o[2 * dp], pl, vb[0], vb[1]);
        qgt::mma_bf16(o[2 * dp + 1], ph, vb[2], vb[3]);
        qgt::mma_bf16(o[2 * dp + 1], pl, vb[2], vb[3]);
      }
    } else {
      // rows t, t+4, t+8, t+12 at hd 32 jj + 4 g .. +3: output tile 4 jj
      // + i, column g, is hd 32 jj + 4 g + i
#pragma unroll
      for (int jj = 0; jj < HD / 32; ++jj) {
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const uint32_t*>(
                     vt + (tq + 4 * r) * Sm::RBV + 32 * jj + 4 * gq) ^
                 0x80808080u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t b0 = bf16_pair(s8_f32(w[0], i), s8_f32(w[1], i));
          const uint32_t b1 = bf16_pair(s8_f32(w[2], i), s8_f32(w[3], i));
          qgt::mma_bf16(o[4 * jj + i], ph, b0, b1);
          qgt::mma_bf16(o[4 * jj + i], pl, b0, b1);
        }
      }
    }
  }
  qgt::cp_async_wait<0>();
  __syncthreads();  // the stages are drained: reuse them

  // each warp's rows (hd order undone), then the warps in warp order
  float* eo = reinterpret_cast<float*>(dsm);
  float* eml = reinterpret_cast<float*>(dsm + Sm::EML);
  float* esc = reinterpret_cast<float*>(dsm + Sm::ESC);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    float* dst = eo + (warp * QR + row) * HD;
#pragma unroll
    for (int d = 0; d < DN; ++d) {
      if constexpr (Q8) {
        const int h = 32 * (d >> 2) + 8 * tq + (d & 3);
        dst[h] = o[d][2 * r];
        dst[h + 4] = o[d][2 * r + 1];
      } else {
        *reinterpret_cast<float2*>(dst + d * 8 + 2 * tq) =
            make_float2(o[d][2 * r], o[d][2 * r + 1]);
      }
    }
    if (tq == 0)
      *reinterpret_cast<float2*>(eml + (warp * QR + row) * 2) =
          make_float2(m_run[r], l_run[r]);
  }
  const bool fold = has_current && ns == 1;
  if (fold) {  // the current token's score of each row, one warp a row
    const size_t cur = static_cast<size_t>(bg) * HD;
    for (int r = warp; r < nrows; r += WARPS) {
      float d = 0.0f;
#pragma unroll
      for (int i = 0; i < HD / 32; ++i)
        d = fmaf(qb[r * HD + lane + 32 * i] * scale,
                 __bfloat162float(kcur[cur + lane + 32 * i]), d);
      d = qgt::warp_sum(d);
      if (lane == 0) esc[r] = d;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * HD; i += WARPS * 32) {
    const int row = i / HD, h = i % HD;
    float mmax = -FLT_MAX;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mmax = fmaxf(mmax, eml[(w * QR + row) * 2]);
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(eml[(w * QR + row) * 2] - mmax);
      l += eml[(w * QR + row) * 2 + 1] * wt;
      acc += eo[(w * QR + row) * HD + h] * wt;
    }
    if (ns > 1) {
      po[(prow0 + row) * HD + h] = acc;
      if (h == 0)
        *reinterpret_cast<float2*>(pml + (prow0 + row) * 2) =
            make_float2(mmax, l);
      continue;
    }
    if (fold) {
      const float sc = esc[row];
      const float m_new = fmaxf(mmax, sc);
      const float a = expf(mmax - m_new);
      const float pc = expf(sc - m_new);
      l = l * a + pc;
      acc = acc * a +
            pc * __bfloat162float(vcur[static_cast<size_t>(bg) * HD + h]);
    }
    out[(static_cast<size_t>(bg) * rep + r0 + row) * HD + h] =
        acc / (l > 0.0f ? l : 1.0f);
  }
}

template <int HD, bool Q8>
int launch(const void* q, const void* kc, const void* vc, const void* ksc,
           const void* vsc, const void* pos, const void* kcur,
           const void* vcur, void* out, void* po, void* pml, int ns, int B,
           int KV, int rep, int S, long long kv_bstride, long long sc_bstride,
           int has_current, int window, int ring, float scale,
           cudaStream_t stream) {
  constexpr int smem = DecSmem<HD, Q8>::TOTAL;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<HD, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * KV, (rep + QR - 1) / QR, ns);
  flash_decode_kernel<HD, Q8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), kc, vc, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(pos),
      static_cast<const __nv_bfloat16*>(kcur),
      static_cast<const __nv_bfloat16*>(vcur), static_cast<float*>(out),
      static_cast<float*>(po), static_cast<float*>(pml), KV, rep, S,
      kv_bstride, sc_bstride, has_current, window, ring, scale);
  if (ns > 1)
    qgt::attn_merge<HD>(static_cast<const float*>(po),
                        static_cast<const float*>(pml),
                        static_cast<float*>(out), B * KV * rep, rep, ns,
                        static_cast<const float*>(q),
                        has_current ? static_cast<const __nv_bfloat16*>(kcur)
                                    : nullptr,
                        static_cast<const __nv_bfloat16*>(vcur), scale,
                        stream);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(int quant, const void* q, const void* kc, const void* vc,
              const void* ksc, const void* vsc, const void* pos,
              const void* kcur, const void* vcur, void* out, void* po,
              void* pml, int ns, int B, int KV, int rep, int S,
              long long kv_bstride, long long sc_bstride, int has_current,
              int window, int ring, float scale, cudaStream_t st) {
  if (quant)
    return launch<HD, true>(q, kc, vc, ksc, vsc, pos, kcur, vcur, out, po,
                            pml, ns, B, KV, rep, S, kv_bstride, sc_bstride,
                            has_current, window, ring, scale, st);
  return launch<HD, false>(q, kc, vc, ksc, vsc, pos, kcur, vcur, out, po,
                           pml, ns, B, KV, rep, S, kv_bstride, sc_bstride,
                           has_current, window, ring, scale, st);
}

}  // namespace

// out f32 [B, KV, rep, hd] = attention of q f32 [B, KV, rep, hd] over one
// layer's cache kc/vc [B, KV, S, hd] (slot b at kc + b * kv_bstride
// elements; bf16, or int8 with quant = 1 and the f32 scales ksc/vsc [B,
// KV, S], slot b at ksc + b * sc_bstride), plus kcur/vcur bf16 [B, KV, 1,
// hd] when has_current is 1.  Linear cache (ring = 0): slots < pos[b]
// (<= pos[b] when has_current is 0) and, with window > 0, > pos[b] -
// window.  Ring (0 < window <= ring <= S): the window's cached tokens at
// slot g mod ring, as the header says.  ns pieces of each interval; with
// ns > 1 the scratch po f32 [B, KV, ns, rep, hd] and pml f32 [B, KV, ns,
// rep, 2], and a second launch merges them.
QGT_EXPORT int qgt_flash_decode(const void* q, const void* kc, const void* vc,
                                const void* ksc, const void* vsc,
                                const void* pos, const void* kcur,
                                const void* vcur, void* out, void* po,
                                void* pml, int ns, int B, int KV, int rep,
                                int hd, int S, long long kv_bstride,
                                long long sc_bstride, int has_current,
                                int quant, int window, int ring,
                                float scale, void* stream) {
  if (rep < 1 || rep > 32 || B < 1 || KV < 1 || S < 1 || window < 0 ||
      ring < 0 || ring > S || (ring > 0 && (window < 1 || window > ring)) ||
      ns < 1 || (ns > 1 && (!po || !pml)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_hd<64>(quant, q, kc, vc, ksc, vsc, pos, kcur, vcur, out, po,
                         pml, ns, B, KV, rep, S, kv_bstride, sc_bstride,
                         has_current, window, ring, scale, st);
  if (hd == 128)
    return launch_hd<128>(quant, q, kc, vc, ksc, vsc, pos, kcur, vcur, out,
                          po, pml, ns, B, KV, rep, S, kv_bstride, sc_bstride,
                          has_current, window, ring, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
