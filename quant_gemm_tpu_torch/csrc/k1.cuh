// K1's exact decode GEMM body on the int8 tensor cores, shared by K1
// (gemm_exact.cu: Q8_1 activations from global memory), K2 (norm_qkv.cu:
// RMSNorm + Q8_1 of a float32 x in the kernel), K6 (gemm_exact_fused.cu:
// Q8_1 of a float32 x in the kernel), K7 (gemm_exact_k16.cu: the per-16
// K-quants) and K8 (attn_tail.cu: three GEMM stages in one launch).
// C[m, n] = sum_b term_b over the 32-blocks b, term_b the golden's
// per-format epilogue on the exact int32 dot sumi (common.cuh's W::term;
// K7: the sum of its two 16-element sub-blocks' terms), summed in float32
// in K1's order (below), so K2, K6 and K8 equal quantize_q8_1 + K1 bit
// for bit whenever their Q8_1 codes equal quantize_q8_1's.
//
// The order: with nt = 32 * k1_warps(nb) virtual threads, thread t adds
// the terms of blocks b = t, t + nt, ... in turn from 0, each group of 32
// threads reduces with warp_sum's xor butterfly (lane 0's value), and the
// groups are added in order from 0 (kernels/gemm_exact.py::k1_order
// replays it).
//
// Design (bound: the weight stream's bytes at M <= 12):
// * one int8 MMA per 32-block: mma.sync m16n8k32 (u8 x s8, s8 x s8 for
//   q8_0) takes 16 weight rows x 8 activation rows (M 9-12: a second n8
//   tile) and gives every sumi exactly.  A lane's A fragment is bytes
//   4t .. 4t+3 of a row's 16 code bytes, which hold codes 4t .. 4t+3 in
//   their low nibbles and 16+4t .. 16+4t+3 in their high ones: exactly
//   its two k groups, so & 0x0F0F0F0F and >> 4 build it (q5 ORs in the
//   fifth bits from qh; q8_0's 32 bytes are the fragment as stored).
//   ldmatrix reads both operands from shared memory.  K7's int8 codes
//   load as q8_0's, and the halves of that fragment feed two m16n8k16
//   MMAs, one per 16-element sub-block, so each gives sumi_j exactly.
// * the order replayed in registers: warp_sum's butterfly at offsets 16,
//   8 and 4 adds lanes of one residue mod 4, so a group's 32 virtual
//   threads split into four subtrees of eight.  The four warps of a row
//   tile take the residues: each lane keeps the eight partials of its
//   residue for its four outputs in registers, adds a later run's block
//   of the same thread to its partial (the blocks of a thread in b
//   order), and after the group's last run adds them as the butterfly
//   does; offsets 2 and 1 join the four subtrees, (T0 + T2) + (T1 + T3),
//   through shared memory, and the group goes into the output's sum.
// * the weight stream hidden: a persistent grid (as many blocks as fit,
//   each walking row tiles of 32 rows) streams each tile's K blocks in
//   chunks of 32 (one group's run: blocks r nt + 32 g .. + 31), codes and
//   the scale planes staged with 16-byte cp.async in a ring of three,
//   across tile boundaries, so the next chunks load while this one is
//   computed.  A plane row segment that does not start on 16 bytes (an
//   f16 plane at odd n * nb) is copied from the 16-byte boundary below it
//   and read at its offset.  The walk's bookkeeping is a cursor, with no
//   division in the loop; a full chunk takes a body without per-block
//   guards.
// * where the activation codes come from (Mode):
//   - STREAMED (K1, K7, K8): the Q8_1 codes and f16 scales in global
//     memory, staged with each chunk in the ring;
//   - RESIDENT (K2, K6): the [M, K] codes are resident
//     in shared memory (rows of K + 16 bytes, an odd multiple of 16, so
//     ldmatrix reads 8 rows without bank conflicts; rows past M read row
//     M - 1, whose outputs are dropped) with f16 scale planes.  The blocks
//     run in clusters of CLUSTER = 8: each normalises and quantizes one
//     eighth of the K blocks and stores the codes in all eight blocks'
//     shared memory (Hopper's distributed shared memory), so a block pays
//     an eighth of the prologue's loads and arithmetic.  A block that
//     made all the codes itself took 9-24 us for it at M 8, K 2048-5632
//     (a chain of memory latencies), about twice K1's time; copying the
//     peers' slices after they were made waited on a round trip per load,
//     where stores do not wait.  Each block's slice of x (and of K2's norm
//     weight) is prefetched into L2, and K2's sums of squares loaded,
//     before its first STAGES - 1 weight chunks are issued; the
//     quantization runs under those chunks' loads (the weights do not
//     depend on x);
//   - CHUNKED (where the resident codes and the ring do not fit one
//     block's 227 KB: at M 9-12 above K 8576 (q8_0) to 12224 (q4_0), at
//     M 8 above K 13376 (q8_0) to 18816): each chunk's 32 blocks are
//     quantized into the ring as the chunk is staged.  Fewer stages would
//     not do: at M 12, K 14336 the resident codes and scales alone take
//     194 KB, and two q4_0 stages bring them past 240 KB.
//   The quantizer is common.cuh::quantize_each (quantize_q8_1 bit for
//   bit).  K2's RMSNorm factor rsqrt(mean(x^2) + eps) comes from one
//   fixed order of the sum of squares: each of the cluster's blocks sums
//   its slice of row m (one warp, lane l the float4s l, l + 32, ...,
//   then warp_sum), and every block adds the slices' sums in rank order
//   (a CHUNKED launch: one slice, the whole row).
// * where the outputs go (Epi): out[m, n] (Store), or K8's epilogues; a
//   row tile is 32 consecutive weight rows, or (Epi::PAIRED, K8's wgu)
//   16 gate rows j .. j + 15 and the 16 up rows j + N/2 .., so that the
//   thread that holds gate output (j, m) holds up output (j, m) too.
//   The order of an output's sum does not depend on its row's place.
// Launches read nothing on the host and allocate nothing (the occupancy
// of a kernel is queried at the first launch of each shared-memory
// size), so a CUDA graph can capture them.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace qgt {
namespace k1 {

constexpr int RT = 2;          // 16-row tiles per block: 32 weight rows
constexpr int ROWS = 16 * RT;
constexpr int WQ = 4;          // warps per row tile: residues of t mod 4
constexpr int WARPS = RT * WQ;  // warp w: row tile w % RT, residue w / RT
constexpr int THREADS = WARPS * 32;
constexpr int CB = 32;         // K blocks per chunk (one group's run)
constexpr int STAGES = 3;       // chunks in flight
constexpr int SMEM_MAX = 232448;  // shared memory one block may take
constexpr int RINV_BYTES = 64;    // K2's row sums and rsqrt factors
constexpr int CLUSTER = 8;  // blocks that share one RESIDENT prologue

enum Mode { STREAMED, RESIDENT, CHUNKED };

// K7's per-16 K-quant formats (q6_K, q3_K: MIN false; q2_K: MIN):
// shifted int8 codes [N, K], per weight row f16 d [K/256] and int8 sc
// [K/16], and for q2_K f16 dmin [K/256] and int8 mn [K/16].  Sub-block j
// of a 32-block of row n adds (scp_j * d_a) * sumi_j [+ mp_j * (sumq_j *
// d_a)], scp_j = d * sc_j and mp_j = -(dmin * mn_j) (exact in float32:
// an f16 times an integer below 256), sumq_j the sum of the sub-block's
// activation codes, each step rounded on its own.
template <bool HAS_MIN>
struct K16W {
  static constexpr bool MIN = HAS_MIN;
};

// What the body needs of a weight format beyond common.cuh's W: code bytes
// a block, the scale planes' element type, whether it has a qh plane, and
// its (up to four) planes: plane i holds es(i) bytes for every per(i)
// K blocks of a weight row (es 0: no plane).  The per-32 formats: d, m
// (min formats) and qh; K7's: sc (two int8 a block), mn (q2_K), d and
// dmin (one f16 a super-block of 8 blocks).
template <typename S_, int BB_, bool MIN, bool QH>
struct Fmt32 {
  using S = S_;
  static constexpr int BB = BB_;
  static constexpr bool HAS_QH = QH;
  static constexpr bool K16 = false;
  __host__ __device__ static constexpr int es(int i) {
    return i == 0 ? static_cast<int>(sizeof(S_))
                  : i == 1 ? (MIN ? static_cast<int>(sizeof(S_)) : 0)
                           : i == 2 ? (QH ? 4 : 0) : 0;
  }
  __host__ __device__ static constexpr int per(int) { return 1; }
};

template <typename W>
struct Fmt;
template <>
struct Fmt<Q4_0W> : Fmt32<__half, 16, false, false> {};
template <>
struct Fmt<Q4_1W> : Fmt32<__half, 16, true, false> {};
template <>
struct Fmt<Q4_KW> : Fmt32<float, 16, true, false> {};
template <bool MIN, typename T>
struct Fmt<Q5W<MIN, T>> : Fmt32<T, 16, MIN, true> {};
template <typename T>
struct Fmt<Q8W<T>> : Fmt32<T, 32, false, false> {};
template <bool MIN>
struct Fmt<K16W<MIN>> {
  using S = __half;
  static constexpr int BB = 32;
  static constexpr bool HAS_QH = false;
  static constexpr bool K16 = true;
  __host__ __device__ static constexpr int es(int i) {
    return i > 3 || ((i == 1 || i == 3) && !MIN) ? 0 : 2;
  }
  __host__ __device__ static constexpr int per(int i) { return i < 2 ? 1 : 8; }
};

// The weight's scale and bit planes in Fmt's order (null where it has
// none), each 16-byte aligned.
struct Planes {
  const uint8_t* p[4];
};

// Row bytes in shared memory: codes at an odd multiple of 16 (ldmatrix
// reads 8 rows without bank conflicts), plane segments with room for a
// 16-byte-aligned start.
__host__ __device__ constexpr int plane_rb(int esize) {
  return CB * esize + 16;
}

// Weight plane i's row bytes in a stage (0: no plane), and the bytes of
// the 32 rows of planes 0 .. i - 1.
template <typename F>
__host__ __device__ constexpr int plane_bytes(int i) {
  return F::es(i) ? (CB / F::per(i) * F::es(i) + 31) / 16 * 16 : 0;
}
template <typename F>
__host__ __device__ constexpr int planes_before(int i) {
  return i == 0 ? 0 : planes_before<F>(i - 1) + ROWS * plane_bytes<F>(i - 1);
}

// The ring of STAGES chunks (weights, and the activations unless they
// are RESIDENT), then the subtree sums of a group: [WQ][ROWS][MA].
template <typename W, int MT, int MODE>
struct Smem {
  using F = Fmt<W>;
  static_assert(!F::K16 || MODE == STREAMED, "K7 streams its activations");
  static constexpr bool STAGED = MODE != RESIDENT;
  static constexpr int MA = 8 * MT;  // activation rows of the MMAs
  static constexpr int WRB = CB * F::BB + 16;
  static constexpr int ARB = CB * 32 + 16;
  static constexpr int PA = plane_rb(2);
  static constexpr int WC = 0;
  // weight plane i's row bytes and offset in a stage
  __host__ __device__ static constexpr int prb(int i) {
    return plane_bytes<F>(i);
  }
  __host__ __device__ static constexpr int wp(int i) {
    return ROWS * WRB + planes_before<F>(i);
  }
  static constexpr int AC = ROWS * WRB + planes_before<F>(4);
  static constexpr int AD = AC + (STAGED ? MA * ARB : 0);
  static constexpr int AS = AD + (STAGED ? MA * PA : 0);
  static constexpr int STAGE = AS + (STAGED && !F::K16 ? MA * PA : 0);
  static constexpr int T = STAGES * STAGE;
  static constexpr int TEND = T + WQ * ROWS * MA * 4;
};

// What follows Smem::TEND, sized at launch: the RESIDENT codes [M, K +
// 16] and f16 scales da, sa [M, ss] (rows of ss = 8 mod 16 elements, so
// the four rows a warp reads at one block fall in four banks), and K2's
// row sums and rsqrt factors.
struct Tail {
  int codes, da, sa, ss, rinv, total;
};

__host__ __device__ inline Tail tail(int tend, int mode, int M, int K) {
  const int res = mode == RESIDENT;
  Tail t;
  t.ss = ((K / QK + 15) & ~15) + 8;
  t.codes = tend;
  t.da = t.codes + (res ? M * (K + 16) : 0);
  t.sa = t.da + (res ? 2 * M * t.ss : 0);
  t.rinv = (t.sa + (res ? 2 * M * t.ss : 0) + 15) & ~15;
  t.total = t.rinv + (mode == STREAMED ? 0 : RINV_BYTES);
  return t;
}

// The CL blocks of a cluster that share a RESIDENT prologue (CL = 1: the
// block alone): block rank r takes the K blocks [slice(r), slice(r + 1)).
template <int CL>
struct Peers {
  __device__ static int rank() {
    if constexpr (CL == 1)
      return 0;
    else
      return static_cast<int>(cooperative_groups::this_cluster().block_rank());
  }
  __device__ static int slice(int r, int nb) { return r * nb / CL; }
  // p's place in the shared memory of block r of the cluster
  template <typename T>
  __device__ static T* at(T* p, int r) {
    if constexpr (CL == 1)
      return p;
    else
      return cooperative_groups::this_cluster().map_shared_rank(p, r);
  }
};

// The two halves of a cluster barrier: no thread leaves wait until every
// thread of the cluster has arrived; what a thread wrote before arrive,
// to its own or a peer's shared memory, is seen after wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

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
    cp_async16(dst + 16 * chunk, g + base + 16 * chunk,
               rem >= 16 ? 16 : static_cast<int>(rem));
}

// 4 fifth bits (bits 0..3 of x) at bit 4 of bytes 0..3
__device__ __forceinline__ uint32_t bit4x(uint32_t x) {
  return ((x & 15u) * 0x02040810u) & 0x10101010u;
}

// Where a step of a block's walk is: its row tile, its chunk's index in
// the tile, group and run.
struct Cursor {
  int tile, c, g, r;
};

template <typename S>
__device__ __forceinline__ float plane_at(const uint8_t* row, int i) {
  return to_f32(reinterpret_cast<const S*>(row)[i]);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// A float4 of data at p (16-byte aligned): through the non-coherent
// cache, or (COH: data written earlier in the same launch, K8) from L2.
template <bool COH>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (COH)
    return __ldcg(reinterpret_cast<const float4*>(p));
  else
    return __ldg(reinterpret_cast<const float4*>(p));
}

// The activation sources.  K1, K7: Q8_1 codes int8 [M, K] and f16 scales
// [M, K/32] in global memory (STREAMED; K7 reads no sa).
struct Q8_1Act {
  const int8_t* qa;
  const __half* da;
  const __half* sa;
};

// K6 and K8: a float32 x [M, K] (16-byte aligned), quantized as it is.
template <bool COH = false>
struct FloatActT {
  static constexpr bool NORM = false;
  const float* x;
  int K;
  template <int CL>
  __device__ __forceinline__ void partial(float*, int, int, int, int) const {}
  template <int CL>
  __device__ __forceinline__ void combine(float*, int, int) {}
  // the 128-byte lines of K blocks [b0, b1) of the M rows into L2, thread
  // t of nt taking lines t, t + nt, ...
  __device__ __forceinline__ void prefetch(int M, int b0, int b1, int t,
                                           int nt) const {
    for (int i = t; i < M * (b1 - b0); i += nt)
      prefetch_l2(x + static_cast<size_t>(i / (b1 - b0)) * K +
                  (b0 + i % (b1 - b0)) * QK);
  }
  __device__ __forceinline__ float4 get4(int m, int i) const {
    return ld4<COH>(x + static_cast<size_t>(m) * K + i);
  }
};
using FloatAct = FloatActT<>;

// K2 and K8: rms_norm(x, nw, eps) of a float32 x [M <= WARPS, K] in
// ops/rms_norm.py's op order, x * rsqrt(mean(x^2) + eps) * nw, each step
// rounded on its own; x and nw 16-byte aligned.
template <bool COH = false>
struct NormActT {
  static constexpr bool NORM = true;
  const float* x;
  const float* nw;
  float eps;
  int K;
  const float* rinv;  // [M] in shared memory, set by combine

  // rsqrt(mean(x^2) + eps) of every row, in one fixed order: block rank
  // r of the CL sums its slice of row m (one warp, lane l the float4s l,
  // l + 32, ... of the slice in turn, then warp_sum) into rv[m]
  // (partial, warp w of nwarps taking rows w, w + nwarps, ...), and once
  // the CL blocks' sums are in, every block adds them in rank order into
  // rv[8 + m] (combine, thread t < M taking row t).
  template <int CL>
  __device__ __forceinline__ void partial(float* rv, int M, int warp,
                                          int nwarps, int lane) const {
    using P = Peers<CL>;
    const int nb = K / QK, me = P::rank();
    const int j0 = P::slice(me, nb) * QK, j1 = P::slice(me + 1, nb) * QK;
    for (int m = warp; m < M; m += nwarps) {
      const float* xr = x + static_cast<size_t>(m) * K;
      float s = 0.0f;
#pragma unroll 8
      for (int j = j0 + 4 * lane; j < j1; j += 128) {
        const float4 v = ld4<COH>(xr + j);
        s = __fadd_rn(s, __fmul_rn(v.x, v.x));
        s = __fadd_rn(s, __fmul_rn(v.y, v.y));
        s = __fadd_rn(s, __fmul_rn(v.z, v.z));
        s = __fadd_rn(s, __fmul_rn(v.w, v.w));
      }
      s = warp_sum(s);
      if (lane == 0) rv[m] = s;
    }
  }
  template <int CL>
  __device__ __forceinline__ void combine(float* rv, int M, int t) {
    using P = Peers<CL>;
    if (t < M) {
      float s = 0.0f;
      for (int r = 0; r < CL; ++r) s = __fadd_rn(s, P::at(rv, r)[t]);
      rv[8 + t] = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(K)), eps));
    }
    rinv = rv + 8;
  }
  // FloatAct's prefetch, and the norm weight's lines of those blocks
  __device__ __forceinline__ void prefetch(int M, int b0, int b1, int t,
                                           int nt) const {
    FloatActT<COH>{x, K}.prefetch(M, b0, b1, t, nt);
    for (int i = t; i < b1 - b0; i += nt)
      prefetch_l2(nw + (b0 + i) * QK);
  }
  __device__ __forceinline__ float4 get4(int m, int i) const {
    const float4 v = ld4<COH>(x + static_cast<size_t>(m) * K + i);
    const float4 w = ld4<false>(nw + i);
    const float r = rinv[m];
    return make_float4(__fmul_rn(__fmul_rn(v.x, r), w.x),
                       __fmul_rn(__fmul_rn(v.y, r), w.y),
                       __fmul_rn(__fmul_rn(v.z, r), w.z),
                       __fmul_rn(__fmul_rn(v.w, r), w.w));
  }
};
using NormAct = NormActT<>;

// The plain epilogue: out[m, n] = the sum, float32 [M, N]; row tile t is
// weight rows 32 t .. 32 t + 31.
struct Store {
  static constexpr bool PAIRED = false;
  float* out;
  int N;
  __device__ static int ntiles(int N) { return (N + ROWS - 1) / ROWS; }
  __device__ static int row(int tile, int r, int) { return tile * ROWS + r; }
  __device__ __forceinline__ void operator()(int n, int m, float v) const {
    out[static_cast<size_t>(m) * N + n] = v;
  }
};

// out [M, N] float32 of the weight (codes wq, planes wp as W's format has
// them) and the activation `act`, run by every thread of a block of
// THREADS threads with Tail(...).total bytes of dynamic shared memory,
// gridDim.x blocks walking the row tiles; each output goes to epi(n, m,
// sum) (Epi::PAIRED: epi(j, m, gate, up) for gate row j and up row j +
// N/2).
template <typename W, int MT, int MODE, typename Act, typename Epi>
__device__ __forceinline__ void gemm(const uint8_t* __restrict__ wq,
                                     const Planes& wp, Act act, Epi epi,
                                     int M, int N, int K) {
  using F = Fmt<W>;
  using Sm = Smem<W, MT, MODE>;
  using S = typename F::S;
  constexpr int BB = F::BB;
  constexpr int UMAX =  // outputs a thread
      Epi::PAIRED ? 2 : (ROWS * Sm::MA + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) uint8_t ksm[];

  const Tail tl = tail(Sm::TEND, MODE, M, K);
  const int nb = K / QK, nt = 32 * k1_warps(nb);
  const int rs = K + 16;  // RESIDENT code row bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rt = warp % RT, part_id = warp / RT;
  const int mat = lane >> 3, r8 = lane & 7;

  // chunks: group g's runs r = 0, 1, ... (blocks r nt + 32 g ..), groups
  // in order; every group has a block (k1_warps), and runs(g) of them
  const int lnt = nt == 32 ? 5 : (nt == 64 ? 6 : 7);
  auto runs = [&](int g) { return ((nb - 1 - 32 * g) >> lnt) + 1; };
  int nchunk = 0;
  for (int g = 0; g < nt / 32; ++g) nchunk += runs(g);

  // this block's steps: the chunks of row tile blockIdx.x, then of tile
  // blockIdx.x + gridDim.x, ..., so the pipeline runs on across its
  // tiles; a cursor walks them without divisions
  const int ntiles = Epi::ntiles(N);
  const int nstep =
      (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      nchunk;
  Cursor at_issue{static_cast<int>(blockIdx.x), 0, 0, 0};
  Cursor at_step = at_issue;
  auto advance = [&](Cursor& cur) {
    if (++cur.r == runs(cur.g)) {
      cur.r = 0;
      ++cur.g;
    }
    if (++cur.c == nchunk) {
      cur.c = cur.g = cur.r = 0;
      cur.tile += gridDim.x;
    }
  };
  // where plane i's segment of weight row n starts, from K block b0
  auto plane_start = [&](auto ic, int n, int b0) {
    constexpr int i = decltype(ic)::value;
    return (static_cast<size_t>(n) * (nb / F::per(i)) + b0 / F::per(i)) *
           F::es(i);
  };
  auto issue = [&](int buf) {
    const int tile = at_issue.tile, g = at_issue.g, r = at_issue.r;
    advance(at_issue);
    const int b0 = (r << lnt) + 32 * g, nblk = min(CB, nb - b0);
    uint8_t* st = ksm + buf * Sm::STAGE;
    constexpr int WCH = CB * BB / 16;  // 16-byte pieces a code row
#pragma unroll
    for (int i = 0; i < (ROWS * WCH + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS, row = e / WCH, ch = e % WCH;
      if (e >= ROWS * WCH) break;
      const int n = Epi::row(tile, row, N);
      const bool ok = n < N && ch < nblk * BB / 16;
      const size_t off =
          ok ? (static_cast<size_t>(n) * nb + b0) * BB + ch * 16 : 0;
      cp_async16(st + Sm::WC + row * Sm::WRB + ch * 16, wq + off,
                 ok ? 16 : 0);
    }
    // plane rows of the 32 weight rows: planes i and i + 1 in one loop
    // where they have one shape (d and m; K7's sc and mn, d and dmin)
    auto stage_planes = [&](auto ic) {
      constexpr int i = decltype(ic)::value;
      constexpr bool PAIR = F::es(i + 1) == F::es(i) &&
                            F::per(i + 1) == F::per(i);
      if constexpr (F::es(i) != 0) {
        constexpr int CH = Sm::prb(i) / 16;
        const int nbytes = (nblk + F::per(i) - 1) / F::per(i) * F::es(i);
        for (int e = tid; e < ROWS * CH; e += THREADS) {
          const int row = e / CH, ch = e % CH;
          const int n = Epi::row(tile, row, N);
          if (n >= N) continue;
          const size_t start = plane_start(ic, n, b0);
          copy_plane(st + Sm::wp(i) + row * Sm::prb(i), wp.p[i], start,
                     nbytes, ch);
          if constexpr (PAIR)
            copy_plane(st + Sm::wp(i + 1) + row * Sm::prb(i + 1),
                       wp.p[i + 1], start, nbytes, ch);
        }
      }
      return PAIR || F::es(i + 1) == 0;
    };
    if (!stage_planes(std::integral_constant<int, 0>{}))
      stage_planes(std::integral_constant<int, 1>{});
    if (!stage_planes(std::integral_constant<int, 2>{}))
      stage_planes(std::integral_constant<int, 3>{});
    if constexpr (MODE == STREAMED) {
      // the chunk's activation codes, da and sa rows
      constexpr int ACH = Sm::PA / 16, ACH2 = CB * 32 / 16;
#pragma unroll
      for (int i = 0; i < (Sm::MA * ACH2 + THREADS - 1) / THREADS; ++i) {
        const int e = tid + i * THREADS, m = e / ACH2, ch = e % ACH2;
        if (e >= Sm::MA * ACH2) break;
        const bool ok = m < M && ch < nblk * 2;
        const size_t off =
            ok ? static_cast<size_t>(m) * K + static_cast<size_t>(b0) * 32 +
                     ch * 16
               : 0;
        cp_async16(st + Sm::AC + m * Sm::ARB + ch * 16, act.qa + off,
                   ok ? 16 : 0);
      }
      for (int e = tid; e < Sm::MA * ACH; e += THREADS) {
        const int m = e / ACH, ch = e % ACH;
        if (m >= M) continue;
        const size_t start = (static_cast<size_t>(m) * nb + b0) * 2;
        copy_plane(st + Sm::AD + m * Sm::PA,
                   reinterpret_cast<const uint8_t*>(act.da), start, nblk * 2,
                   ch);
        if constexpr (!F::K16)
          copy_plane(st + Sm::AS + m * Sm::PA,
                     reinterpret_cast<const uint8_t*>(act.sa), start,
                     nblk * 2, ch);
      }
    } else if constexpr (MODE == CHUNKED) {
      // the chunk's blocks quantized into the stage (plain stores, seen
      // after the barrier of the step that reads them)
      quantize_tile<2>(
          [&](int m, int j) { return act.get4(m, b0 * QK + j); }, M, nblk,
          reinterpret_cast<int8_t*>(st + Sm::AC), Sm::ARB,
          reinterpret_cast<__half*>(st + Sm::AD),
          reinterpret_cast<__half*>(st + Sm::AS), Sm::PA / 2, warp, WARPS,
          lane);
    }
  };
  // thread tid's output k: (row of the tile, activation row), false where
  // it has none
  auto slot = [&](int k, int& row, int& m) {
    if constexpr (Epi::PAIRED) {
      row = tid / M + 16 * k;
      m = tid % M;
      return tid < 16 * M;
    } else {
      const int u = tid + k * THREADS;
      row = u / M;
      m = u % M;
      return u < ROWS * M;
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

  float* rv = reinterpret_cast<float*>(ksm + tl.rinv);
  if constexpr (MODE == CHUNKED) {
    act.template partial<1>(rv, M, warp, WARPS, lane);
    __syncthreads();
    act.template combine<1>(rv, M, tid);
    __syncthreads();
  }
  if constexpr (MODE == RESIDENT) {
    // K2's sums of squares, and this block's slice of x on its way to L2,
    // before the weights' cp.async issue, which stalls while the memory
    // system is full; the cluster barrier's first phase (K2: the slices'
    // sums; K6: every block started, so its shared memory may be written)
    // runs under it
    const int me = Peers<CLUSTER>::rank();
    act.prefetch(M, Peers<CLUSTER>::slice(me, nb),
                 Peers<CLUSTER>::slice(me + 1, nb), tid, THREADS);
    act.template partial<CLUSTER>(rv, M, warp, WARPS, lane);
    cluster_arrive();
  }
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < nstep) issue(j);
    cp_async_commit();
  }
  if constexpr (MODE == RESIDENT) {
    // under the first chunks' loads: each block of the cluster normalises
    // and quantizes its slice of x's K blocks and stores the codes in the
    // shared memory of every block of the cluster (distributed shared
    // memory)
    using P = Peers<CLUSTER>;
    cluster_wait();
    if constexpr (Act::NORM) {
      act.template combine<CLUSTER>(rv, M, tid);
      __syncthreads();  // the rsqrt factors
    }
    const int me = P::rank();
    const int s0 = P::slice(me, nb), s1 = P::slice(me + 1, nb);
    int8_t* codes = reinterpret_cast<int8_t*>(ksm + tl.codes);
    __half* rda = reinterpret_cast<__half*>(ksm + tl.da);
    __half* rsa = reinterpret_cast<__half*>(ksm + tl.sa);
    quantize_each<4>(
        [&](int m, int i) { return act.get4(m, s0 * QK + i); }, M, s1 - s0,
        [&](int m, int b, int e, const Q8_1Code& c) {
          // into every block of the cluster, this one last
          const int at = m * tl.ss + s0 + b;
#pragma unroll
          for (int j = 1; j <= CLUSTER; ++j) {
            const int r = (me + j) % CLUSTER;
            *reinterpret_cast<int*>(P::at(codes, r) + m * rs +
                                    (s0 + b) * QK + e) = c.q4;
            if (e == 0) {
              *P::at(rda + at, r) = __float2half_rn(c.d);
              *P::at(rsa + at, r) = __float2half_rn(c.s);
            }
          }
        },
        warp, WARPS, lane);
    cluster_arrive();  // the codes of every slice in every block
    cluster_wait();
  }
  int buf = 0;  // step % STAGES
  for (int step = 0; step < nstep; ++step) {
    if (step + STAGES - 1 < nstep)
      issue(buf == 0 ? STAGES - 1 : buf - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // this step's chunk landed
    const int tile = at_step.tile, c = at_step.c, g = at_step.g,
              r = at_step.r;
    advance(at_step);
    const int b0 = (r << lnt) + 32 * g, nblk = min(CB, nb - b0);
    const bool last_run = r + 1 == runs(g);
    const uint8_t* st = ksm + buf * Sm::STAGE;
    buf = buf + 1 == STAGES ? 0 : buf + 1;

    // this lane's plane rows: weight rows rt * 16 + gq (+ 8), each at its
    // segment's offset
    const uint8_t* prow[4][2] = {};
    auto plane_rows = [&](auto ic) {
      constexpr int i = decltype(ic)::value;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rt * 16 + gq + 8 * h;
        prow[i][h] = st + Sm::wp(i) + row * Sm::prb(i) +
                     plane_offset(plane_start(ic, Epi::row(tile, row, N), b0));
      }
    };
    plane_rows(std::integral_constant<int, 0>{});
    if constexpr (F::es(1) != 0) plane_rows(std::integral_constant<int, 1>{});
    if constexpr (F::es(2) != 0) plane_rows(std::integral_constant<int, 2>{});
    if constexpr (F::es(3) != 0) plane_rows(std::integral_constant<int, 3>{});
    // the activation code row this lane's ldmatrix reads, and the da / sa
    // rows of its outputs (activation rows 8 mt + 2 tq (+ 1))
    const uint8_t* brow[MT];
    const uint8_t* drow[MT][2];
    const uint8_t* srow[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (MODE == RESIDENT)
        brow[mt] = ksm + tl.codes + min(8 * mt + r8, M - 1) * rs + b0 * 32;
      else
        brow[mt] = st + Sm::AC + (8 * mt + r8) * Sm::ARB;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * mt + 2 * tq + h;
        if constexpr (MODE == RESIDENT) {
          const int at = (min(m, M - 1) * tl.ss + b0) * 2;
          drow[mt][h] = ksm + tl.da + at;
          srow[mt][h] = ksm + tl.sa + at;
        } else {
          drow[mt][h] = st + Sm::AD + m * Sm::PA;
          if constexpr (MODE == STREAMED)
            drow[mt][h] +=
                plane_offset((static_cast<size_t>(m) * nb + b0) * 2);
          srow[mt][h] = drow[mt][h] + (Sm::AS - Sm::AD);
        }
      }
    }
    if (r == 0) {  // a group starts: its partials from 0
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) leaf[j][mt][e] = 0.0f;
    }

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
          ldmatrix_x4(R, st + Sm::WC +
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
                  reinterpret_cast<const uint32_t*>(prow[2][0])[v];
              const uint32_t q1 =
                  reinterpret_cast<const uint32_t*>(prow[2][1])[v];
              wr[h][0] |= bit4x(q0 >> (4 * tq));
              wr[h][1] |= bit4x(q1 >> (4 * tq));
              wr[h][2] |= bit4x(q0 >> (16 + 4 * tq));
              wr[h][3] |= bit4x(q1 >> (16 + 4 * tq));
            }
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldmatrix_x4(wr[h], st + Sm::WC +
                                   (rt * 16 + (mat & 1) * 8 + r8) * Sm::WRB +
                                   (h ? vb : va) * 32 + (mat >> 1) * 16);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t B[4];
          ldmatrix_x4(B, brow[mt] + ((mat >> 1) ? vb : va) * 32 +
                             (mat & 1) * 16);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = h ? vb : va;
            if (!FULL && v >= nblk) break;  // uniform across the warp
            float dam[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dam[e] = plane_at<__half>(drow[mt][e], v);
            float* lf = leaf[2 * jp + h][mt];
            if constexpr (F::K16) {
              // sub-blocks 2v (k 0..15: a0, a1, b0) and 2v + 1 (a2, a3,
              // b1), one m16n8k16 each; q2_K's sumq against ones
              int cs[2][4];
              [[maybe_unused]] int cq[2][4];
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                mma_s8_k16_zero(cs[s], wr[h][2 * s], wr[h][2 * s + 1],
                                B[2 * h + s]);
                if constexpr (W::MIN)
                  mma_s8_k16_zero(cq[s], 0x01010101u, 0x01010101u,
                                  B[2 * h + s]);
              }
              // scp_j = d * sc_j, mp_j = -(dmin * mn_j) of rows gq, gq + 8
              float scp[2][2], mp[2][2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float d = plane_at<__half>(prow[2][e], v >> 3);
                const int8_t* sc =
                    reinterpret_cast<const int8_t*>(prow[0][e]) + 2 * v;
                float dm = 0.0f;
                const int8_t* mn = sc;
                if constexpr (W::MIN) {
                  dm = plane_at<__half>(prow[3][e], v >> 3);
                  mn = reinterpret_cast<const int8_t*>(prow[1][e]) + 2 * v;
                }
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  scp[e][s] = __fmul_rn(d, static_cast<float>(sc[s]));
                  mp[e][s] = W::MIN
                                 ? -__fmul_rn(dm, static_cast<float>(mn[s]))
                                 : 0.0f;
                }
              }
#pragma unroll
              // e: row gq + 8 (e / 2), activation row 2 tq + e % 2
              for (int e = 0; e < 4; ++e) {
                float t[2];
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                  const float da = dam[e & 1];
                  t[s] = __fmul_rn(__fmul_rn(scp[e >> 1][s], da),
                                   static_cast<float>(cs[s][e]));
                  if constexpr (W::MIN)
                    t[s] = __fadd_rn(
                        t[s], __fmul_rn(mp[e >> 1][s],
                                        __fmul_rn(static_cast<float>(
                                                      cq[s][e]),
                                                  da)));
                }
                lf[e] = __fadd_rn(lf[e], __fadd_rn(t[0], t[1]));
              }
            } else {
              int cs[4];
              mma_s32_zero<BB == 32>(cs, wr[h], B[2 * h], B[2 * h + 1]);
              float2 sw[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sw[e] = make_float2(
                    plane_at<S>(prow[0][e], v),
                    W::MIN ? plane_at<S>(prow[1][e], v) : 0.0f);
              float sam[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                sam[e] = plane_at<__half>(srow[mt][e], v);
#pragma unroll
              // e: row gq + 8 (e / 2), activation row 2 tq + e % 2
              for (int e = 0; e < 4; ++e)
                lf[e] = __fadd_rn(lf[e], W::term(sw[e >> 1], dam[e & 1],
                                                 sam[e & 1], cs[e]));
            }
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
        int row, m;
        if (slot(k, row, m)) {
          const float* tp = tsum + row * Sm::MA + m;
          constexpr int TS = ROWS * Sm::MA;
          sums[k] += (tp[0] + tp[2 * TS]) + (tp[TS] + tp[3 * TS]);
        }
      }
      // tsum is written again only after a later step's barrier
    }
    if (c == nchunk - 1) {  // the tile's last group: its outputs
      if constexpr (Epi::PAIRED) {
        int row, m;
        if (slot(0, row, m)) epi(16 * tile + row, m, sums[0], sums[1]);
      } else {
#pragma unroll
        for (int k = 0; k < UMAX; ++k) {
          int row, m;
          if (slot(k, row, m)) {
            const int n = Epi::row(tile, row, N);
            if (n < N) epi(n, m, sums[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < UMAX; ++k) sums[k] = 0.0f;
    }
  }
}

// The weight bytes (codes and planes) of this block's first STAGES - 1
// chunks of the GEMM above, prefetched into L2: K8 issues them before
// the grid barrier in front of a stage, so that the stage's first loads
// need not wait for the device memory.
template <typename W, typename Epi>
__device__ __forceinline__ void prefetch_first(const uint8_t* wq,
                                               const Planes& wp, int N,
                                               int K) {
  using F = Fmt<W>;
  const int nb = K / QK, nt = 32 * k1_warps(nb);
  const int tile = blockIdx.x;
  if (tile >= Epi::ntiles(N)) return;
  int g = 0, r = 0;
  for (int j = 0; j < STAGES - 1; ++j) {
    const int b0 = r * nt + 32 * g;
    if (g >= nt / 32 || b0 >= nb) break;
    const int nblk = min(CB, nb - b0);
    for (int row = threadIdx.x; row < ROWS; row += THREADS) {
      const int n = Epi::row(tile, row, N);
      if (n >= N) continue;
      const uint8_t* p = wq + (static_cast<size_t>(n) * nb + b0) * F::BB;
      for (int o = 0; o < nblk * F::BB; o += 128) prefetch_l2(p + o);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (F::es(i) && wp.p[i] != nullptr)
          prefetch_l2(wp.p[i] + (static_cast<size_t>(n) * (nb / F::per(i)) +
                                 b0 / F::per(i)) * F::es(i));
    }
    // the next chunk of the walk: the group's next run, or the next group
    if (b0 + nt < nb) {
      ++r;
    } else {
      r = 0;
      ++g;
    }
  }
}

// Blocks of one kernel resident at once over the card, for its
// persistent grid (in whole clusters of `cluster` blocks): queried at the
// first launch of each dynamic shared-memory size (a few per model) and
// kept, so later launches make no host query.  One instance per kernel
// instantiation (a static of its launcher).
struct Occupancy {
  int attr = 0;  // the dynamic shared memory the kernel is allowed
  int n = 0;
  int bytes[8];
  int blocks[8];

  template <typename Kernel>
  cudaError_t get(Kernel* kernel, int smem, int cluster, int* out) {
    for (int i = 0; i < n; ++i)
      if (bytes[i] == smem) {
        *out = blocks[i];
        return cudaSuccess;
      }
    cudaError_t e = cudaSuccess;
    if (smem > attr) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      attr = smem;
    }
    if (cluster > 1) {
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = cluster;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(cluster);
      cfg.blockDim = dim3(THREADS);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e != cudaSuccess) return e;
      *out = clusters * cluster;
    } else {
      int dev = 0, sms = 0, per_sm = 0;
      if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
      if (e != cudaSuccess) return e;
      *out = per_sm * sms;
    }
    if (*out < 1) return cudaErrorInvalidConfiguration;
    if (n < 8) {
      bytes[n] = smem;
      blocks[n] = *out;
      ++n;
    }
    return cudaSuccess;
  }
};

// Launch `kernel` (a __global__ (wq, planes, act, out, M, N, K) that runs
// gemm<W, MT, MODE, Act, Store>) as a persistent grid: as many blocks as
// fit at once, at most one a row tile (RESIDENT: in clusters of CLUSTER,
// the last one padded).
template <typename W, int MT, int MODE, typename Act, typename Kernel>
int launch(Kernel* kernel, Occupancy& occ, const void* wq, Planes wp,
           Act act, void* out, int M, int N, int K, cudaStream_t stream) {
  constexpr int CL = MODE == RESIDENT ? CLUSTER : 1;
  const int smem = tail(Smem<W, MT, MODE>::TEND, MODE, M, K).total;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  cudaError_t e = occ.get(kernel, smem, CL, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ntiles = (N + ROWS - 1) / ROWS;
  const int need = (ntiles + CL - 1) / CL * CL;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(need < resident ? need : resident);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(wq), wp,
                         act, static_cast<float*>(out), M, N, K);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// RESIDENT where the whole activation's codes fit beside the ring,
// CHUNKED otherwise.
template <typename W, int MT>
bool fits_resident(int M, int K) {
  return tail(Smem<W, MT, RESIDENT>::TEND, RESIDENT, M, K).total <= SMEM_MAX;
}

}  // namespace k1
}  // namespace qgt
