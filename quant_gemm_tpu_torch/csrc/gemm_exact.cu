// K1: exact WxA8 decode GEMM, per-32 weights (q4_0, q4_1, q5_0, q5_1,
// q8_0, q4_k, q5_k) x Q8_1 activations, M <= 12.
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_exact.py::
// gemm_exact (bodies _kernel and, for q8_0, _kernel_w8).  C[m, n] =
// sum_b term_b with sumi the exact int32 dot of block b's raw codes
// (4-bit nibbles, 5-bit codes with their qh bit moved in, or q8_0's
// signed bytes) and term_b the golden's per-format epilogue
// (ref/gemm.py::gemm_wxa8): q4_0 d_w(d_a sumi - 8 s_a), q5_0 d_w(d_a sumi
// - 16 s_a), q4_1 / q5_1 / q4_k / q5_k (a q4_K or q5_K tensor's effective
// q4_1 or q5_1 form) d_w d_a sumi + m_w s_a, q8_0 d_w d_a sumi, each step
// rounded on its own (common.cuh's W::term); the terms are summed in
// float32, as the TPU kernel sums them.
//
// The order of that sum is common.cuh::k1_rows's, bit for bit, because K6
// and K8 keep k1_rows and are held bit-equal to quantize_q8_1 + K1: with
// nt = 32 * k1_warps(nb) virtual threads, thread t adds the terms of
// blocks b = t, t + nt, ... in turn from 0, each group of 32 threads
// reduces with warp_sum's xor butterfly (lane 0's value), and the groups
// are added in order from 0 (kernels/gemm_exact.py::k1_order replays it).
//
// Bound on an H100: bytes.  At M <= 12 the weight stream (per 32 weights:
// 16 code bytes + 2 d bytes for q4_0, + 2 m for q4_1, + 4 qh for q5_0, +
// 6 for q5_1, 32 + 2 for q8_0, 16 + 8 f32 d' and m' bytes for q4_k, 16 +
// 4 + 8 for q5_k) is everything; the activations are a few KB.  Design:
// * one int8 MMA per 32-block: mma.sync m16n8k32 (u8 x s8, s8 x s8 for
//   q8_0) takes 16 weight rows x 8 activation rows (M 9-12: a second n8
//   tile) and gives every sumi exactly.  A lane's A fragment is bytes
//   4t .. 4t+3 of a row's 16 code bytes, which hold codes 4t .. 4t+3 in
//   their low nibbles and 16+4t .. 16+4t+3 in their high ones: exactly
//   its two k groups, so & 0x0F0F0F0F and >> 4 build it (q5 ORs in the
//   fifth bits from qh; q8_0's 32 bytes are the fragment as stored).
//   ldmatrix reads both operands from shared memory.
// * the order replayed in registers: warp_sum's butterfly at offsets 16,
//   8 and 4 adds lanes of one residue mod 4, so a group's 32 virtual
//   threads split into four subtrees of eight.  The four warps of a row
//   tile take the residues: each lane keeps the eight partials of its
//   residue for its four outputs in registers, adds a later run's block
//   of the same thread to its partial (the blocks of a thread in b
//   order), and after the group's last run adds them as the butterfly
//   does; offsets 2 and 1 join the four subtrees, (T0 + T2) + (T1 + T3),
//   through shared memory, and the group goes into the output's sum.  The
//   old body spent 32 lanes x 5 shuffles on every output.
// * the weight stream hidden: a persistent grid (as many blocks as fit,
//   each walking row tiles of 32 rows) streams each tile's K blocks in
//   chunks of 32 (one group's run: blocks r nt + 32 g .. + 31), codes and
//   the scale and qh planes staged with 16-byte cp.async in a ring of
//   three, with the chunk's activations, across tile boundaries, so the
//   next chunks load while this one is computed.  A plane row segment
//   that does not start on 16 bytes (an f16 plane at odd n * nb) is
//   copied from the 16-byte boundary below it and read at its offset.
//   The walk's bookkeeping is a cursor, with no division in the loop; a
//   full chunk takes a body without per-block guards.
// The launch reads nothing on the host and allocates nothing, so it can
// be captured in a CUDA graph.
#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int RT = 2;          // 16-row tiles per block: 32 weight rows
constexpr int ROWS = 16 * RT;
constexpr int WQ = 4;          // warps per row tile: residues of t mod 4
constexpr int WARPS = RT * WQ;  // warp w: row tile w % RT, residue w / RT
constexpr int CB = 32;         // K blocks per chunk (one group's run)
constexpr int STAGES = 3;       // chunks in flight

// What K1 needs of a weight format beyond common.cuh's W: code bytes a
// block, the scale planes' element type, and whether it has a qh plane.
template <typename W>
struct Fmt;
template <>
struct Fmt<qgt::Q4_0W> {
  using S = __half;
  static constexpr int BB = 16;
  static constexpr bool HAS_QH = false;
};
template <>
struct Fmt<qgt::Q4_1W> : Fmt<qgt::Q4_0W> {};
template <>
struct Fmt<qgt::Q4_KW> {
  using S = float;
  static constexpr int BB = 16;
  static constexpr bool HAS_QH = false;
};
template <bool MIN, typename T>
struct Fmt<qgt::Q5W<MIN, T>> {
  using S = T;
  static constexpr int BB = 16;
  static constexpr bool HAS_QH = true;
};
template <>
struct Fmt<qgt::Q8_0W> {
  using S = __half;
  static constexpr int BB = 32;
  static constexpr bool HAS_QH = false;
};

// Row bytes in shared memory: codes at an odd multiple of 16 (ldmatrix
// reads 8 rows without bank conflicts), plane segments with room for a
// 16-byte-aligned start.
__host__ __device__ constexpr int plane_rb(int esize) {
  return CB * esize + 16;
}

template <typename W, int MT>
struct K1Smem {
  using F = Fmt<W>;
  static constexpr int MA = 8 * MT;  // activation rows staged
  static constexpr int WRB = CB * F::BB + 16;
  static constexpr int ARB = CB * 32 + 16;
  static constexpr int PD = plane_rb(sizeof(typename F::S));
  static constexpr int PH = plane_rb(4);
  static constexpr int PA = plane_rb(2);
  static constexpr int WC = 0;
  static constexpr int WD = WC + ROWS * WRB;
  static constexpr int WM = WD + ROWS * PD;
  static constexpr int WH = WM + (W::MIN ? ROWS * PD : 0);
  static constexpr int AC = WH + (F::HAS_QH ? ROWS * PH : 0);
  static constexpr int AD = AC + MA * ARB;
  static constexpr int AS = AD + MA * PA;
  static constexpr int STAGE = AS + MA * PA;
  // each warp's subtree sums of a group: [WQ][ROWS][MA]
  static constexpr int T = STAGES * STAGE;
  static constexpr int TOTAL = T + WQ * ROWS * MA * 4;
};

// Where byte `start` of a plane lands in its staged row segment, which
// begins at the 16-byte boundary at or below it.
__device__ __forceinline__ int plane_offset(size_t start) {
  return static_cast<int>(start & 15);
}

// 16-byte piece `chunk` of the copy of bytes [start, start + nbytes) of a
// plane at g (16-byte aligned base) into dst, from the 16-byte boundary
// at or below start; pieces past the end copy nothing, and dst keeps its
// old bytes there.
__device__ __forceinline__ void copy_plane(uint8_t* dst, const uint8_t* g,
                                           size_t start, int nbytes,
                                           int chunk) {
  const size_t base = start & ~static_cast<size_t>(15);
  const long long rem = static_cast<long long>(start + nbytes) -
                        static_cast<long long>(base + 16 * chunk);
  if (rem > 0)
    qgt::cp_async16(dst + 16 * chunk, g + base + 16 * chunk,
                    rem >= 16 ? 16 : static_cast<int>(rem));
}

// 4 fifth bits (bits 0..3 of x) at bit 4 of bytes 0..3
__device__ __forceinline__ uint32_t bit4x(uint32_t x) {
  return ((x & 15u) * 0x02040810u) & 0x10101010u;
}

// Where a step of a block's walk is: its row tile's first row, its chunk's
// index in the tile, group and run.
struct Cursor {
  int n0, c, g, r;
};

template <typename S>
__device__ __forceinline__ float plane_at(const uint8_t* row, int i) {
  return qgt::to_f32(reinterpret_cast<const S*>(row)[i]);
}

template <typename W, int MT>
__global__ void __launch_bounds__(WARPS * 32) gemm_exact_kernel(
    const uint8_t* __restrict__ wq, const uint8_t* __restrict__ wd,
    const uint8_t* __restrict__ wm, const uint8_t* __restrict__ wqh,
    const int8_t* __restrict__ qa, const __half* __restrict__ da,
    const __half* __restrict__ sa, float* __restrict__ out, int M, int N,
    int K) {
  using F = Fmt<W>;
  using Sm = K1Smem<W, MT>;
  using S = typename F::S;
  constexpr int BB = F::BB;
  constexpr int ES = sizeof(S);
  constexpr int UMAX =  // outputs a thread
      (ROWS * Sm::MA + WARPS * 32 - 1) / (WARPS * 32);
  extern __shared__ __align__(16) uint8_t ksm[];

  const int nb = K / qgt::QK, nt = 32 * qgt::k1_warps(nb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rt = warp % RT, part_id = warp / RT;

  // chunks: group g's runs r = 0, 1, ... (blocks r nt + 32 g ..), groups
  // in order; every group has a block (k1_warps), and runs(g) of them
  const int lnt = nt == 32 ? 5 : (nt == 64 ? 6 : 7);
  auto runs = [&](int g) { return ((nb - 1 - 32 * g) >> lnt) + 1; };
  int nchunk = 0;
  for (int g = 0; g < nt / 32; ++g) nchunk += runs(g);

  // this block's steps: the chunks of row tile blockIdx.x, then of tile
  // blockIdx.x + gridDim.x, ..., so the pipeline runs on across its
  // tiles; a cursor walks them without divisions
  const int ntiles = (N + ROWS - 1) / ROWS;
  const int nstep =
      (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      nchunk;
  Cursor at_issue{static_cast<int>(blockIdx.x) * ROWS, 0, 0, 0};
  Cursor at_step = at_issue;
  auto advance = [&](Cursor& cur) {
    if (++cur.r == runs(cur.g)) {
      cur.r = 0;
      ++cur.g;
    }
    if (++cur.c == nchunk) {
      cur.c = cur.g = cur.r = 0;
      cur.n0 += gridDim.x * ROWS;
    }
  };
  auto issue = [&](int buf) {
    const int n0 = at_issue.n0, g = at_issue.g, r = at_issue.r;
    advance(at_issue);
    const int b0 = (r << lnt) + 32 * g, nblk = min(CB, nb - b0);
    uint8_t* st = ksm + buf * Sm::STAGE;
    constexpr int WCH = CB * BB / 16;  // 16-byte pieces a code row
#pragma unroll
    for (int i = 0; i < (ROWS * WCH + WARPS * 32 - 1) / (WARPS * 32); ++i) {
      const int e = tid + i * WARPS * 32, row = e / WCH, ch = e % WCH;
      if (e >= ROWS * WCH) break;
      const bool ok = n0 + row < N && ch < nblk * BB / 16;
      const size_t off =
          ok ? (static_cast<size_t>(n0 + row) * nb + b0) * BB + ch * 16 : 0;
      qgt::cp_async16(st + Sm::WC + row * Sm::WRB + ch * 16, wq + off,
                      ok ? 16 : 0);
    }
    // plane rows: d (and m, qh) of the 32 weight rows, da and sa of the
    // activation rows
    constexpr int PCH = Sm::PD / 16, HCH = Sm::PH / 16, ACH = Sm::PA / 16;
    for (int e = tid; e < ROWS * PCH; e += WARPS * 32) {
      const int row = e / PCH, ch = e % PCH;
      if (n0 + row >= N) continue;
      const size_t start = (static_cast<size_t>(n0 + row) * nb + b0) * ES;
      copy_plane(st + Sm::WD + row * Sm::PD, wd, start, nblk * ES, ch);
      if constexpr (W::MIN)
        copy_plane(st + Sm::WM + row * Sm::PD, wm, start, nblk * ES, ch);
    }
    if constexpr (F::HAS_QH) {
      for (int e = tid; e < ROWS * HCH; e += WARPS * 32) {
        const int row = e / HCH, ch = e % HCH;
        if (n0 + row >= N) continue;
        const size_t start = (static_cast<size_t>(n0 + row) * nb + b0) * 4;
        copy_plane(st + Sm::WH + row * Sm::PH, wqh, start, nblk * 4, ch);
      }
    }
    constexpr int ACH2 = CB * 32 / 16;
#pragma unroll
    for (int i = 0; i < (Sm::MA * ACH2 + WARPS * 32 - 1) / (WARPS * 32);
         ++i) {
      const int e = tid + i * WARPS * 32, m = e / ACH2, ch = e % ACH2;
      if (e >= Sm::MA * ACH2) break;
      const bool ok = m < M && ch < nblk * 2;
      const size_t off =
          ok ? static_cast<size_t>(m) * K + static_cast<size_t>(b0) * 32 +
                   ch * 16
             : 0;
      qgt::cp_async16(st + Sm::AC + m * Sm::ARB + ch * 16, qa + off,
                      ok ? 16 : 0);
    }
    for (int e = tid; e < Sm::MA * ACH; e += WARPS * 32) {
      const int m = e / ACH, ch = e % ACH;
      if (m >= M) continue;
      const size_t start = (static_cast<size_t>(m) * nb + b0) * 2;
      copy_plane(st + Sm::AD + m * Sm::PA,
                 reinterpret_cast<const uint8_t*>(da), start, nblk * 2, ch);
      copy_plane(st + Sm::AS + m * Sm::PA,
                 reinterpret_cast<const uint8_t*>(sa), start, nblk * 2, ch);
    }
  };

  // the group's 32 virtual threads t = 32 g + v: warp residue p holds
  // the partials of v = p + 4 j (j < 8) for its lane's four outputs (rows
  // gq, gq + 8 x activation rows 2 tq, 2 tq + 1 of each n8 tile)
  float leaf[8][MT][4];
  float sums[UMAX];
#pragma unroll
  for (int k = 0; k < UMAX; ++k) sums[k] = 0.0f;
  float* tsum = reinterpret_cast<float*>(ksm + Sm::T);

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nstep) issue(j);
    qgt::cp_async_commit();
  }
  int buf = 0;  // step % STAGES
  for (int step = 0; step < nstep; ++step) {
    if (step + STAGES - 1 < nstep)
      issue(buf == 0 ? STAGES - 1 : buf - 1);
    qgt::cp_async_commit();
    qgt::cp_async_wait<STAGES - 1>();
    __syncthreads();  // this step's chunk landed
    const int n0 = at_step.n0, c = at_step.c, g = at_step.g, r = at_step.r;
    advance(at_step);
    const int b0 = (r << lnt) + 32 * g, nblk = min(CB, nb - b0);
    const bool last_run = r + 1 == runs(g);
    const uint8_t* st = ksm + buf * Sm::STAGE;
    buf = buf + 1 == STAGES ? 0 : buf + 1;

    // this lane's plane rows: weight rows rt * 16 + gq (+ 8), activation
    // rows 8 mt + 2 tq (+ 1), each at its segment's offset
    const uint8_t* wrow[2];
    const uint8_t* mrow[2];
    const uint8_t* hrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rt * 16 + gq + 8 * h;
      const size_t at = static_cast<size_t>(n0 + row) * nb + b0;
      wrow[h] = st + Sm::WD + row * Sm::PD + plane_offset(at * ES);
      mrow[h] = st + Sm::WM + row * Sm::PD + plane_offset(at * ES);
      hrow[h] = st + Sm::WH + row * Sm::PH + plane_offset(at * 4);
    }
    const uint8_t* drow[MT][2];
    const uint8_t* srow[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * mt + 2 * tq + h;
        drow[mt][h] = st + Sm::AD + m * Sm::PA +
                      plane_offset((static_cast<size_t>(m) * nb + b0) * 2);
        srow[mt][h] = drow[mt][h] + (Sm::AS - Sm::AD);
      }
    if (r == 0) {  // a group starts: its partials from 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) leaf[j][mt][e] = 0.0f;
    }

    const int mat = lane >> 3, r8 = lane & 7;
    // without per-block guards the compiler schedules across blocks
    auto chunk_body = [&](auto full) {
      constexpr bool FULL = decltype(full)::value;
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        // blocks v = p + 4 j for j = 2 jp, 2 jp + 1 of the chunk
        const int va = part_id + 8 * jp, vb = va + 4;
        if (!FULL && va >= nblk) break;  // uniform across the warp
        uint32_t wr[2][4];  // A fragments of the two blocks
        if constexpr (BB == 16) {
          uint32_t R[4];
          qgt::ldmatrix_x4(R, st + Sm::WC +
                                  (rt * 16 + (mat & 1) * 8 + r8) * Sm::WRB +
                                  ((mat >> 1) ? vb : va) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t lo = R[2 * h], hi = R[2 * h + 1];
            wr[h][0] = lo & 0x0F0F0F0Fu;
            wr[h][1] = hi & 0x0F0F0F0Fu;
            wr[h][2] = (lo >> 4) & 0x0F0F0F0Fu;
            wr[h][3] = (hi >> 4) & 0x0F0F0F0Fu;
            if constexpr (F::HAS_QH) {
              const int v = h ? vb : va;
              const uint32_t q0 =
                  reinterpret_cast<const uint32_t*>(hrow[0])[v];
              const uint32_t q1 =
                  reinterpret_cast<const uint32_t*>(hrow[1])[v];
              wr[h][0] |= bit4x(q0 >> (4 * tq));
              wr[h][1] |= bit4x(q1 >> (4 * tq));
              wr[h][2] |= bit4x(q0 >> (16 + 4 * tq));
              wr[h][3] |= bit4x(q1 >> (16 + 4 * tq));
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            qgt::ldmatrix_x4(wr[h], st + Sm::WC +
                                        (rt * 16 + (mat & 1) * 8 + r8) *
                                            Sm::WRB +
                                        (h ? vb : va) * 32 + (mat >> 1) * 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t B[4];
          qgt::ldmatrix_x4(B, st + Sm::AC + (8 * mt + r8) * Sm::ARB +
                                  ((mat >> 1) ? vb : va) * 32 +
                                  (mat & 1) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = h ? vb : va;
            if (!FULL && v >= nblk) break;  // uniform across the warp
            int cs[4];
            qgt::mma_s32_zero<BB == 32>(cs, wr[h], B[2 * h], B[2 * h + 1]);
            float2 sw[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              sw[e] = make_float2(plane_at<S>(wrow[e], v),
                                  W::MIN ? plane_at<S>(mrow[e], v) : 0.0f);
            float dam[2], sam[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              dam[e] = plane_at<__half>(drow[mt][e], v);
              sam[e] = plane_at<__half>(srow[mt][e], v);
            }
            float* lf = leaf[2 * jp + h][mt];
#pragma unroll
            // e: row gq + 8 (e / 2), activation row 2 tq + e % 2
            for (int e = 0; e < 4; ++e)
              lf[e] = __fadd_rn(
                  lf[e], W::term(sw[e >> 1], dam[e & 1], sam[e & 1], cs[e]));
          }
        }
      }
    };
    if (nblk == CB)
      chunk_body(std::true_type{});
    else
      chunk_body(std::false_type{});
    if (last_run) {
      // warp_sum's butterfly, offsets 16, 8, 4, stays within a residue:
      // (v, v + 16), (v, v + 8), (v, v + 4) are leaves (j, j + 4), (j,
      // j + 2), (j, j + 1); this warp's subtree to shared memory
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) x[j] = leaf[j][mt][e];
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] = x[j] + x[j + 4];
          x[0] = x[0] + x[2];
          x[1] = x[1] + x[3];
          const int row = rt * 16 + gq + 8 * (e >> 1);
          const int m = 8 * mt + 2 * tq + (e & 1);
          tsum[(part_id * ROWS + row) * Sm::MA + m] = x[0] + x[1];
        }
    }
    __syncthreads();  // stage free; the subtrees written
    if (last_run) {
      // offsets 2 and 1 join the residues: (T0 + T2) + (T1 + T3), then
      // the group into the output's sum, groups in order
#pragma unroll
      for (int k = 0; k < UMAX; ++k) {
        const int u = tid + k * WARPS * 32;
        if (u < ROWS * M) {
          const int row = u / M, m = u % M;
          const float* tp = tsum + row * Sm::MA + m;
          constexpr int TS = ROWS * Sm::MA;
          sums[k] += (tp[0] + tp[2 * TS]) + (tp[TS] + tp[3 * TS]);
        }
      }
      // tsum is written again only after a later step's barrier
    }
    if (c == nchunk - 1) {  // the tile's last group: its outputs
#pragma unroll
      for (int k = 0; k < UMAX; ++k) {
        const int u = tid + k * WARPS * 32;
        if (u < ROWS * M) {
          const int row = u / M, m = u % M;
          if (n0 + row < N)
            out[static_cast<size_t>(m) * N + n0 + row] = sums[k];
        }
        sums[k] = 0.0f;
      }
    }
  }
}

template <typename W, int MT>
int launch_mt(const void* wq, const void* wd, const void* wm,
              const void* wqh, const void* qa, const void* da, const void* sa,
              void* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int smem = K1Smem<W, MT>::TOTAL;
  auto* kernel = gemm_exact_kernel<W, MT>;
  // a persistent grid: as many blocks as the card holds at once, each
  // walking row tiles blockIdx.x, + gridDim.x, ...; host queries only,
  // once per form
  static int resident = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        WARPS * 32, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int ntiles = (N + ROWS - 1) / ROWS;
  kernel<<<ntiles < resident ? ntiles : resident, WARPS * 32, smem,
           stream>>>(
      static_cast<const uint8_t*>(wq), static_cast<const uint8_t*>(wd),
      static_cast<const uint8_t*>(wm), static_cast<const uint8_t*>(wqh),
      static_cast<const int8_t*>(qa), static_cast<const __half*>(da),
      static_cast<const __half*>(sa), static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch(const void* wq, const void* wd, const void* wm, const void* wqh,
           const void* qa, const void* da, const void* sa, void* out, int M,
           int N, int K, void* stream) {
  if (M < 1 || M > qgt::MMAX || K % qgt::QK || K < qgt::QK || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8)
    return launch_mt<W, 1>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K, st);
  return launch_mt<W, 2>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K, st);
}

}  // namespace

// out f32 [M, N] = q4_0 W [N, K] (qs uint8 [N, K/2], d f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16 [M, K/32]).
QGT_EXPORT int qgt_gemm_exact_q4_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q4_0W>(wq, wd, nullptr, nullptr, qa, da, sa, out, M, N,
                            K, stream);
}

// out f32 [M, N] = q4_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_1(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q4_1W>(wq, wd, wm, nullptr, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_0 W [N, K] (qs uint8 [N, K/2] low four bits, d f16
//                  [N, K/32], qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_0(const void* wq, const void* wd,
                                   const void* wqh, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q5_0W>(wq, wd, nullptr, wqh, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_1 W [N, K] (qs uint8 [N, K/2], d, m f16 [N, K/32],
//                  qh u32 [N, K/32]) x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q5_1(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q5_1W>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q8_0 W [N, K] (qs int8 [N, K], d f16 [N, K/32])
//                  x Q8_1 A [M, K].
QGT_EXPORT int qgt_gemm_exact_q8_0(const void* wq, const void* wd,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q8_0W>(wq, wd, nullptr, nullptr, qa, da, sa, out, M, N,
                            K, stream);
}

// out f32 [M, N] = q4_k W [N, K] (qs uint8 [N, K/2], effective d', m' f32
//                  [N, K/32]) x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q4_k(const void* wq, const void* wd,
                                   const void* wm, const void* qa,
                                   const void* da, const void* sa, void* out,
                                   int M, int N, int K, void* stream) {
  return launch<qgt::Q4_KW>(wq, wd, wm, nullptr, qa, da, sa, out, M, N, K,
                            stream);
}

// out f32 [M, N] = q5_k W [N, K] (qs uint8 [N, K/2] low four bits,
//                  effective d', m' f32 [N, K/32], qh u32 [N, K/32])
//                  x Q8_1 A [M, K] (qa int8, da/sa f16).
QGT_EXPORT int qgt_gemm_exact_q5_k(const void* wq, const void* wd,
                                   const void* wm, const void* wqh,
                                   const void* qa, const void* da,
                                   const void* sa, void* out, int M, int N,
                                   int K, void* stream) {
  return launch<qgt::Q5_KW>(wq, wd, wm, wqh, qa, da, sa, out, M, N, K,
                            stream);
}
