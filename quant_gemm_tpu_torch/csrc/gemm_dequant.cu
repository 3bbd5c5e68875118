// K4: dequant GEMM for prefill, bf16 or float32 activations x per-32
// weights (q4_0, q4_1, q5_0, q5_1, q8_0, q4_k, q5_k, iq4_xs), optionally
// with the activation fake-quantized per 32-block (fused_quant).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_pallas.py::gemm
// (bodies _kernel_w4 and, for q8_0, _kernel_w8).  C[M, N] = A[M, K] @
// W[N, K]^T with W = (q - 8) d (q4_0), (q - 16) d (q5_0), q d (q8_0, and
// iq4_xs with an IQ4_XS tensor's int8 codebook values and f32 d) or
// q d + m (q4_1, q5_1, and q4_k / q5_k with a q4_K / q5_K tensor's
// effective f32 scale and min: the has_min branch of _kernel_w4); the
// 5-bit codes take their fifth bit from the block's qh word (_kernel_w4's
// has_qh).  A is bf16 (the serving prefill; a Q8_1 activation is folded to
// bf16 before the call, as gemm_pallas.py:554-562 does) or float32 (the
// JAX ladder's pallas_f32, which keeps A in f32).  Products are summed in
// float32, as the TPU kernel accumulates them.
//
// fused_quant (fq != 0; gemm_pallas.py's fused_quant=True, the body
// _fake_quant_q8): every 32-block of a float A row is fake-quantized, d =
// amax / 127 in float32, inv = d > 0 ? 1/d : 0, a' = clamp(rint(a * inv),
// -127, 127) * d, each step rounded on its own, so a' is bit-equal to the
// plain version's; fq = 2 then rounds a' to bf16 (the serving operand
// type), fq = 1 keeps it float32.  This is not Q8_1: d is not rounded to
// f16 and no s = d * sum(q) is formed.
//
// Bound on an H100: operations at the serving prefill chunk of 128 rows
// (2*M*N*K operations against N*K*9/16 q4_0 weight bytes: 455 operations
// per byte at M = 128, above the ~295 where the bf16 tensor cores, not
// the memory, become the limit; Mistral-7B's wgu, N 28672 x K 4096, is
// 0.0304 ms of bf16 tensor-core work), bytes only below M of about 80.
// The float32 forms do three bf16 passes: 3 * 2*M*N*K operations at the
// bf16 rate (Mistral-7B's w_down, M 128, N 4096 x K 14336: 0.0456 ms).
//
// Every form runs on the tensor cores, with exact per-block scaling.
// Every per-32 code is a small integer (q - 8, q - 16, q, the int8 q of
// q8_0, or q4_k / q5_k's 0..31), exact in bf16.  A bf16 operand (A bf16
// with fq = 0, or fq = 2) is one piece; a float32 operand (A float32
// with fq = 0, or fq = 1, from an f32 or a bf16 A) is split into three
// bf16 pieces, hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid),
// with hi + mid + lo == a exactly wherever the pieces stay normal in bf16
// (|a| >= 2^-103 or a == 0): JAX's Precision.HIGHEST, the multi-pass bf16
// product of gemm_pallas.py::_dot, on Hopper.  Each product piece * code
// is exact in a bf16 mma.sync.m16n8k16 with float32 accumulation.  Per
// quant block b the kernel runs the pieces' MMAs (k 0..15, 16..31; lo,
// mid, hi) into one zeroed fragment T_b and folds it in with the block's
// scales: acc = fma(d[n,b], T_b, acc) and, for the min formats, acc =
// fma(m[n,b], sa[m,b], acc) with sa[m,b] the float32 sum of the block's
// unsplit operand values.  The weight is never rounded to bf16, so the
// result differs from the plain version's float32 product only in
// summation order (NMSE ~1e-13).  mma.sync and not wgmma: the scales
// apply after every 32-deep block, which needs the accumulator in
// registers every two k16 steps.  Tile: 64 x 64 outputs per 128-thread
// block, four warps of 64 x 16 (each B fragment converted once serves
// four MMAs a piece, and the three pieces of a float32 operand; on the
// H100 this beat 32 x 32 and 16 x 64 warp tiles, 128-wide block tiles
// and 8-block stages for bf16); stages of TcTile<P>::KB quant blocks (A
// rows of each piece in bf16, the raw code bytes, the qh words, sa)
// double-buffered with cp.async 16-byte copies (zero-filled past M and
// N), the scale planes through registers into shared memory as float32.
// A stage holds 4 quant blocks for one piece and 2 for three, so three
// blocks of two stages fit an SM either way (at most 75,776 bytes a
// block with the float32 forms).  The k order inside an MMA is permuted
// so that lane (g, t) holds elements 4t .. 4t+3 of its row (one 8-byte A
// load, one 4-byte code load covering both k16 steps): the low nibbles of
// bytes 4t .. 4t+3 are elements 4t .. 4t+3, the high nibbles 16 + 4t ..
// 16 + 4t+3.  A code becomes an exact bf16 by OR-ing it into 0x4300 (128
// + q) and subtracting 128 + off (__hsub2); the q5 forms add the fifth
// bit first (common.cuh::bit4); q8_0 converts int8 through float.  Where
// the output tiles do not fill the 132 SMs, K is split into pieces of
// whole quant blocks (grid z; the wrapper's kernels/gemm_dequant.py::
// k4_grid picks the piece length), each piece writes float32 partials,
// and gemm_dequant_kernel_reduce adds them in piece order, so every
// output is the same sum in the same order on every call: K4 stays
// deterministic.  gemm_dequant_kernel_prologue runs first where the
// operand needs it: fq = 2 writes A' in bf16, a float32 operand its three
// planes (of A, or of A' = fake_quant(A) in float32 for fq = 1), the min
// formats get sa.
#include "common.cuh"
#include "tc.cuh"

namespace {

// eight consecutive activations as float (16-byte aligned: K % 32 == 0)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
  f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}

// _fake_quant_q8 of one 32-block of A held by four consecutive lanes, 8
// values each (every lane of the warp calls it); fq == 2 rounds the
// result to bf16
__device__ __forceinline__ void fake_quant8(float (&f)[8], int fq) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(f[i]));
  amax = fmaxf(amax, __shfl_xor_sync(qgt::FULL, amax, 1));
  amax = fmaxf(amax, __shfl_xor_sync(qgt::FULL, amax, 2));
  const float d = __fdiv_rn(amax, 127.0f);
  const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q =
        fminf(fmaxf(rintf(__fmul_rn(f[i], inv)), -127.0f), 127.0f);
    f[i] = __fmul_rn(q, d);
    if (fq == 2) f[i] = __bfloat162float(__float2bfloat16_rn(f[i]));
  }
}

constexpr int TBM = 64, TBN = 64;           // output tile
constexpr int TWARPS = 4, TTHREADS = 32 * TWARPS;
constexpr int WARPS_M = 1;                  // warps along M
constexpr int WTM = TBM / WARPS_M, WTN = TBN * WARPS_M / TWARPS;  // warp tile
constexpr int TI = WTM / 16, TJ = WTN / 8;  // its m16 and n8 tiles
constexpr int TMINB = 3;                    // blocks an SM must hold
constexpr int TSTAGES = 2;                  // stages in flight

// The stage of an operand of P bf16 pieces (1: bf16, 3: float32): KB
// quant blocks, A rows of KB * 64 bytes a piece padded to AST (== 32 mod
// 128: the 8-byte fragment loads of a half-warp hit 16 distinct banks)
template <int P>
struct TcTile {
  static_assert(P == 1 || P == 3, "an operand is one or three bf16 pieces");
  static constexpr int KB = P == 1 ? 4 : 2;
  static constexpr int AST = KB * qgt::QK * 2 + 32;
  // every thread stages the same number of A, code, qh, sa and scale
  // entries (loops of a fixed trip count, which the compiler unrolls)
  static_assert(TBM * KB * qgt::QK * 2 / 16 % TTHREADS == 0 &&
                    TBN * KB * 16 / 16 % TTHREADS == 0 &&
                    TBN * KB % TTHREADS == 0 && TBM * KB % TTHREADS == 0,
                "tile entries must split evenly over the block's threads");
};

// where a format's codes are: bytes per block, and whether a qh plane
// gives the fifth bits
template <typename W>
struct TcFmt {
  static constexpr int BYTES = 16;
  static constexpr bool QH = false;
};
template <typename S>
struct TcFmt<qgt::Q8W<S>> {
  static constexpr int BYTES = 32;
  static constexpr bool QH = false;
};
template <bool HM, typename S>
struct TcFmt<qgt::Q5W<HM, S>> {
  static constexpr int BYTES = 16;
  static constexpr bool QH = true;
};

// shared memory of one stage, in bytes: A [P][TBM][AST], codes
// [TBN][WST], qh [TBN][KB] u32, sa [TBM][KB] f32, d and m [KB][TBN] f32
template <typename W, int P>
struct TcSmem {
  static constexpr int KB = TcTile<P>::KB, AST = TcTile<P>::AST;
  static constexpr int WST = KB * TcFmt<W>::BYTES + 16;  // odd x 16 bytes
  static constexpr int A = 0;
  static constexpr int CODES = A + P * TBM * AST;
  static constexpr int QH = CODES + TBN * WST;
  static constexpr int SA = QH + TBN * KB * 4;
  static constexpr int D = SA + TBM * KB * 4;
  static constexpr int MN = D + KB * TBN * 4;
  static constexpr int STAGE = MN + KB * TBN * 4;
};

// bytes 0, 1 (sel 0x4140) or 2, 3 (0x4342) of x, each a code 0..31, as
// the bf16 pair (code - off) in the MMA's register order
__device__ __forceinline__ uint32_t codes_bf16(uint32_t x, unsigned sel,
                                               uint32_t bias) {
  uint32_t v = __byte_perm(x, 0u, sel) | 0x43004300u;  // 128 + code
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                             *reinterpret_cast<__nv_bfloat162*>(&bias));
  return *reinterpret_cast<uint32_t*>(&r);
}

// two int8 codes (bytes 0, 1 or 2, 3 of x) as a bf16 pair, exact
__device__ __forceinline__ uint32_t int8_bf16(uint32_t x, int shift) {
  return qgt::pack_bf16(static_cast<float>(static_cast<int8_t>(x >> shift)),
                        static_cast<float>(
                            static_cast<int8_t>(x >> (shift + 8))));
}

// Output tile (blockIdx.y, blockIdx.x) over the quant blocks of K piece
// blockIdx.z ([z * chunk, (z + 1) * chunk) of the nb blocks): out [M, N]
// when gridDim.z == 1, else partials part [gridDim.z, M, N].  a: the
// operand's P bf16 planes [P, M, K] (hi, mid, lo); sa: [M, nb] row-block
// sums (min formats).
template <typename W, int P>
__global__ void __launch_bounds__(TTHREADS, TMINB)
    gemm_dequant_kernel_tc(const __nv_bfloat16* __restrict__ a,
                           const uint8_t* __restrict__ wq, const W fmt,
                           const float* __restrict__ sa,
                           float* __restrict__ out, int M, int N, int K,
                           int chunk) {
  using S = TcSmem<W, P>;
  constexpr int TKB = S::KB, AST = S::AST;
  constexpr int BYTES = TcFmt<W>::BYTES;
  constexpr bool QH = TcFmt<W>::QH;
  constexpr bool MIN = W::MIN;
  extern __shared__ __align__(16) uint8_t tsm[];
  const int nb = K / qgt::QK;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  const int kb0 = blockIdx.z * chunk, kb1 = min(nb, kb0 + chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (TWARPS / WARPS_M), wn = warp % (TWARPS / WARPS_M);
  const int nstage = (kb1 - kb0 + TKB - 1) / TKB;
  const uint32_t bias = W::OFF == 0.0f ? 0x43004300u
                        : W::OFF == 8.0f ? 0x43084308u
                                          : 0x43104310u;  // 128 + off

  float acc[TI][TJ][4];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  // this thread's scale pairs of a stage (n, kb) = c / TKB, c % TKB
  constexpr int SP = TBN * TKB / TTHREADS;
  float2 sreg[SP];
  auto fetch_scales = [&](int st) {
    const int bs = kb0 + st * TKB;
#pragma unroll
    for (int u = 0; u < SP; ++u) {
      const int c = tid + TTHREADS * u, n = c / TKB, kb = c % TKB;
      sreg[u] = n0 + n < N && bs + kb < kb1
                    ? fmt.scales(static_cast<size_t>(n0 + n) * nb + bs + kb)
                    : make_float2(0.0f, 0.0f);
    }
  };
  auto store_scales = [&](int buf) {
    float* sd = reinterpret_cast<float*>(tsm + buf * S::STAGE + S::D);
    float* sm = reinterpret_cast<float*>(tsm + buf * S::STAGE + S::MN);
#pragma unroll
    for (int u = 0; u < SP; ++u) {
      const int c = tid + TTHREADS * u, n = c / TKB, kb = c % TKB;
      sd[kb * TBN + n] = sreg[u].x;
      if (MIN) sm[kb * TBN + n] = sreg[u].y;
    }
  };
  // A rows of every piece, code bytes, qh words and sa of stage st into
  // buffer buf
  auto issue = [&](int st, int buf) {
    uint8_t* base = tsm + buf * S::STAGE;
    const int bs = kb0 + st * TKB, nkb = min(TKB, kb1 - bs);
    constexpr int ACH = TKB * qgt::QK * 2 / 16;  // 16-byte chunks a row
#pragma unroll
    for (int p = 0; p < P; ++p) {  // plane p of [P, M, K]
      const __nv_bfloat16* ap = a + p * static_cast<size_t>(M) * K;
#pragma unroll
      for (int u = 0; u < TBM * ACH / TTHREADS; ++u) {
        const int c = tid + TTHREADS * u, row = c / ACH, ch = c % ACH;
        if (ch / 4 < nkb) {
          const bool ok = m0 + row < M;
          const __nv_bfloat16* src =
              ok ? ap + static_cast<size_t>(m0 + row) * K + bs * qgt::QK +
                       ch * 8
                 : a;
          qgt::cp_async16(base + S::A + (p * TBM + row) * AST + ch * 16, src,
                          ok ? 16 : 0);
        }
      }
    }
    constexpr int WCH = TKB * BYTES / 16;
#pragma unroll
    for (int u = 0; u < TBN * WCH / TTHREADS; ++u) {
      const int c = tid + TTHREADS * u, row = c / WCH, ch = c % WCH;
      if (ch * 16 / BYTES < nkb) {
        const bool ok = n0 + row < N;
        const uint8_t* src =
            ok ? wq + static_cast<size_t>(n0 + row) * nb * BYTES +
                     static_cast<size_t>(bs) * BYTES + ch * 16
               : wq;
        qgt::cp_async16(base + S::CODES + row * S::WST + ch * 16, src,
                        ok ? 16 : 0);
      }
    }
    if constexpr (QH) {
#pragma unroll
      for (int u = 0; u < TBN * TKB / TTHREADS; ++u) {
        const int c = tid + TTHREADS * u, r = c / TKB, kb = c % TKB;
        const bool ok = n0 + r < N;
        if (kb < nkb)
          qgt::cp_async4(
              base + S::QH + c * 4,
              ok ? fmt.qh + static_cast<size_t>(n0 + r) * nb + bs + kb
                 : fmt.qh,
              ok ? 4 : 0);
      }
    }
    if (MIN) {
#pragma unroll
      for (int u = 0; u < TBM * TKB / TTHREADS; ++u) {
        const int c = tid + TTHREADS * u, r = c / TKB, kb = c % TKB;
        const bool ok = m0 + r < M;
        if (kb < nkb)
          qgt::cp_async4(
              base + S::SA + c * 4,
              ok ? sa + static_cast<size_t>(m0 + r) * nb + bs + kb : sa,
              ok ? 4 : 0);
      }
    }
  };

  // the A fragments of k16 step s of quant block kb, rows of one piece
  // from base + S::A
  auto load_a = [&](uint32_t(&af)[TI][4], const uint8_t* base, int kb,
                    int s) {
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const uint8_t* ap = base + S::A + (wm * WTM + i * 16 + g) * AST +
                          (kb * qgt::QK + s * 16 + 4 * t) * 2;
      const uint2 lo = *reinterpret_cast<const uint2*>(ap);
      const uint2 hi = *reinterpret_cast<const uint2*>(ap + 8 * AST);
      af[i][0] = lo.x;
      af[i][1] = hi.x;
      af[i][2] = lo.y;
      af[i][3] = hi.y;
    }
  };
  // a B fragment from four codes of the lane's column
  auto b_frag = [&](uint32_t x4, uint32_t& b0, uint32_t& b1) {
    if constexpr (BYTES == 32) {
      b0 = int8_bf16(x4, 0);
      b1 = int8_bf16(x4, 16);
    } else {
      b0 = codes_bf16(x4, 0x4140u, bias);
      b1 = codes_bf16(x4, 0x4342u, bias);
    }
  };

  // stages 0 .. TSTAGES-2 ahead of the loop; stage st + TSTAGES - 1 is
  // issued while stage st is computed
#pragma unroll
  for (int st = 0; st < TSTAGES - 1; ++st) {
    if (st < nstage) {
      issue(st, st);
      fetch_scales(st);
      store_scales(st);
    }
    qgt::cp_async_commit();
  }
  for (int st = 0; st < nstage; ++st) {
    const int buf = st % TSTAGES, ahead = st + TSTAGES - 1;
    if (ahead < nstage) {
      issue(ahead, ahead % TSTAGES);
      fetch_scales(ahead);
    }
    qgt::cp_async_commit();
    qgt::cp_async_wait<TSTAGES - 1>();
    __syncthreads();
    const uint8_t* base = tsm + buf * S::STAGE;
    const float* sd = reinterpret_cast<const float*>(base + S::D);
    const float* sm = reinterpret_cast<const float*>(base + S::MN);
    const float* ssa = reinterpret_cast<const float*>(base + S::SA);
    const int nkb = min(TKB, kb1 - (kb0 + st * TKB));
#pragma unroll
    for (int kb = 0; kb < TKB; ++kb) {
      if (kb >= nkb) break;
      // the codes of this lane's column g of each n8 tile: elements
      // 4t .. 4t+3 (x[j][0]) and 16 + 4t .. 16 + 4t+3 (x[j][1])
      uint32_t x[TJ][2];
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int col = wn * WTN + j * 8 + g;
        const uint8_t* wp = base + S::CODES + col * S::WST + kb * BYTES;
        if constexpr (BYTES == 32) {
          x[j][0] = *reinterpret_cast<const uint32_t*>(wp + 4 * t);
          x[j][1] = *reinterpret_cast<const uint32_t*>(wp + 16 + 4 * t);
        } else {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(wp + 4 * t);
          x[j][0] = w & 0x0F0F0F0Fu;
          x[j][1] = (w >> 4) & 0x0F0F0F0Fu;
          if constexpr (QH) {
            const uint32_t h = reinterpret_cast<const uint32_t*>(
                base + S::QH)[col * TKB + kb];
            x[j][0] |= qgt::bit4(h >> (4 * t));
            x[j][1] |= qgt::bit4(h >> (16 + 4 * t));
          }
        }
      }
      float tb[TI][TJ][4];  // T_b, started by the first MMA
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if constexpr (P == 1) {
          uint32_t af[TI][4];
          load_a(af, base, kb, s);
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            uint32_t b0, b1;
            b_frag(x[j][s], b0, b1);
#pragma unroll
            for (int i = 0; i < TI; ++i) {
              if (s == 0)
                qgt::mma_bf16_zero(tb[i][j], af[i], b0, b1);
              else
                qgt::mma_bf16(tb[i][j], af[i], b0, b1);
            }
          }
        } else {
          // each B fragment converted once for the three pieces, which
          // run smallest first: lo, mid, hi
          uint32_t bf[TJ][2];
#pragma unroll
          for (int j = 0; j < TJ; ++j) b_frag(x[j][s], bf[j][0], bf[j][1]);
#pragma unroll
          for (int p = P - 1; p >= 0; --p) {
            uint32_t af[TI][4];
            load_a(af, base + p * TBM * AST, kb, s);
#pragma unroll
            for (int j = 0; j < TJ; ++j)
#pragma unroll
              for (int i = 0; i < TI; ++i) {
                if (s == 0 && p == P - 1)
                  qgt::mma_bf16_zero(tb[i][j], af[i], bf[j][0], bf[j][1]);
                else
                  qgt::mma_bf16(tb[i][j], af[i], bf[j][0], bf[j][1]);
              }
          }
        }
      }
      // fold the block in with its scales
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int col = wn * WTN + j * 8 + 2 * t;
        const float2 d = *reinterpret_cast<const float2*>(sd + kb * TBN + col);
        float2 mm = make_float2(0.0f, 0.0f);
        if (MIN) mm = *reinterpret_cast<const float2*>(sm + kb * TBN + col);
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          const int r0 = wm * WTM + i * 16 + g;
          acc[i][j][0] = fmaf(d.x, tb[i][j][0], acc[i][j][0]);
          acc[i][j][1] = fmaf(d.y, tb[i][j][1], acc[i][j][1]);
          acc[i][j][2] = fmaf(d.x, tb[i][j][2], acc[i][j][2]);
          acc[i][j][3] = fmaf(d.y, tb[i][j][3], acc[i][j][3]);
          if (MIN) {
            const float s0 = ssa[r0 * TKB + kb], s1 = ssa[(r0 + 8) * TKB + kb];
            acc[i][j][0] = fmaf(mm.x, s0, acc[i][j][0]);
            acc[i][j][1] = fmaf(mm.y, s0, acc[i][j][1]);
            acc[i][j][2] = fmaf(mm.x, s1, acc[i][j][2]);
            acc[i][j][3] = fmaf(mm.y, s1, acc[i][j][3]);
          }
        }
      }
    }
    if (ahead < nstage) store_scales(ahead % TSTAGES);
    __syncthreads();  // buffer buf is refilled by the next iteration's issue
  }

  float* o = out + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm * WTM + i * 16 + g + (r >> 1) * 8;
        const int n = n0 + wn * WTN + j * 8 + 2 * t + (r & 1);
        if (m < M && n < N) o[static_cast<size_t>(m) * N + n] = acc[i][j][r];
      }
}

// The operand pass before the tensor-core body, one lane per 8 values,
// four lanes per 32-block: A' = fake_quant(A) where fq != 0 (rounded to
// bf16 for fq = 2); into a2 the operand's planes: with P = 1 and fq = 2,
// A' in bf16; with P = 3, the pieces hi, mid, lo of A (fq = 0) or A'
// (fq = 1) as planes [3, M, K]; with sa, the block's float32 sum of the
// unsplit operand values (the lane's 8 in order, then the lanes xor 1,
// xor 2), every call in the same order.
template <typename AT>
__global__ void __launch_bounds__(256)
    gemm_dequant_kernel_prologue(const AT* __restrict__ a, int fq, int P,
                                 __nv_bfloat16* __restrict__ a2,
                                 float* __restrict__ sa, int M, int K) {
  const size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = v < static_cast<size_t>(M) * K / 8;
  float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (in) load8(a + v * 8, f);
  if (fq) fake_quant8(f, fq);  // the whole warp takes part
  if (in && a2) {
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = f[i];
    for (int p = 0; p < P; ++p) {  // r: what the pieces so far leave
      uint4 pk;
      float h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h[i] = __bfloat162float(__float2bfloat16_rn(r[i]));
        r[i] = __fsub_rn(r[i], h[i]);  // exact (Sterbenz)
      }
      pk.x = qgt::pack_bf16(h[0], h[1]);
      pk.y = qgt::pack_bf16(h[2], h[3]);
      pk.z = qgt::pack_bf16(h[4], h[5]);
      pk.w = qgt::pack_bf16(h[6], h[7]);
      *reinterpret_cast<uint4*>(a2 + p * static_cast<size_t>(M) * K + v * 8) =
          pk;
    }
  }
  if (sa) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
    s += __shfl_xor_sync(qgt::FULL, s, 1);
    s += __shfl_xor_sync(qgt::FULL, s, 2);
    if (in && (v & 3) == 0) sa[v / 4] = s;
  }
}

// out = the K pieces' partials added in piece order
__global__ void __launch_bounds__(256)
    gemm_dequant_kernel_reduce(const float* __restrict__ part,
                               float* __restrict__ out, size_t mn,
                               int pieces) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < pieces; ++z) s += part[z * mn + i];
    out[i] = s;
  }
}

int blocks_for(size_t n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// The prologue where the operand needs it (fq = 2, P = 3 or a min
// format), the tensor-core body over chunk-block K pieces, the reduce
// when there are several.
template <typename W, int P>
int launch_tc(const void* a, int a_f32, int fq, const void* wq, const W fmt,
              float* out, float* part, float* sa, void* a2, int M, int N,
              int K, int chunk, cudaStream_t s) {
  using S = TcSmem<W, P>;
  const int nb = K / qgt::QK;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pieces = (nb + chunk - 1) / chunk;
  const bool planes = P == 3 || fq == 2;  // the operand is written to a2
  if ((pieces > 1 && !part) || (W::MIN && !sa) || (planes && !a2))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(a);
  if (planes || W::MIN) {
    const size_t lanes = static_cast<size_t>(M) * K / 8;
    const int grid = blocks_for(lanes, 256);
    __nv_bfloat16* a2p = planes ? static_cast<__nv_bfloat16*>(a2) : nullptr;
    float* sap = W::MIN ? sa : nullptr;
    if (a_f32)
      gemm_dequant_kernel_prologue<float><<<grid, 256, 0, s>>>(
          static_cast<const float*>(a), fq, P, a2p, sap, M, K);
    else
      gemm_dequant_kernel_prologue<__nv_bfloat16><<<grid, 256, 0, s>>>(
          op, fq, P, a2p, sap, M, K);
    if (planes) op = a2p;
  }
  constexpr int smem = TSTAGES * S::STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_dequant_kernel_tc<W, P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && P == 3)  // three blocks an SM need the most
    e = cudaFuncSetAttribute(gemm_dequant_kernel_tc<W, P>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, pieces);
  gemm_dequant_kernel_tc<W, P><<<grid, TTHREADS, smem, s>>>(
      op, static_cast<const uint8_t*>(wq), fmt, sa, pieces > 1 ? part : out,
      M, N, K, chunk);
  if (pieces > 1) {
    const size_t mn = static_cast<size_t>(M) * N;
    const int grid_r = blocks_for(mn, 256) < 132 * 8 ? blocks_for(mn, 256)
                                                      : 132 * 8;
    gemm_dequant_kernel_reduce<<<grid_r, 256, 0, s>>>(part, out, mn, pieces);
  }
  return static_cast<int>(cudaGetLastError());
}

// Every form on the tensor cores: a bf16 operand (A bf16 with fq = 0, or
// fq = 2) as one piece, a float32 operand (A float32 with fq = 0, or fq =
// 1) as three.  Scratch: part [pieces, M, N] f32 when K is split, sa [M,
// K/32] f32 for the min formats, a2 bf16 [M, K] for fq = 2 and [3, M, K]
// for a float32 operand.
template <typename W>
int launch(const void* a, int a_f32, int fq, const void* wq, const W fmt,
           void* out, void* part, void* sa, void* a2, int M, int N, int K,
           int chunk, void* stream) {
  if (M < 1 || N < 1 || K % qgt::QK || fq < 0 || fq > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* pp = static_cast<float*>(part);
  float* sp = static_cast<float*>(sa);
  if ((a_f32 && fq == 0) || fq == 1)
    return launch_tc<W, 3>(a, a_f32, fq, wq, fmt, o, pp, sp, a2, M, N, K,
                           chunk, s);
  return launch_tc<W, 1>(a, a_f32, fq, wq, fmt, o, pp, sp, a2, M, N, K, chunk,
                         s);
}

const __half* h(const void* p) { return static_cast<const __half*>(p); }

}  // namespace

// Every entry point: out f32 [M, N] = A' [M, K] @ dequant(W)^T, A bf16
// (a_f32 = 0) or float32 (a_f32 = 1), A' = A (fq = 0) or A fake-quantized
// per 32-block (fq = 1: float32 operand, fq = 2: bf16 operand), W's codes
// at wq (uint8 [N, K/2], q8_0 int8 [N, K]) and its planes (f16 d, m [N,
// K/32]; q4_k and q5_k f32 d', m'; q5 u32 qh [N, K/32]); scratch part,
// sa, a2 and the K piece length chunk (quant blocks) as launch() says.
#define QGT_K4_ARGS                                                       \
  void *out, void *part, void *sa, void *a2, int M, int N, int K, int chunk, \
      void *stream
#define QGT_K4_PASS out, part, sa, a2, M, N, K, chunk, stream

QGT_EXPORT int qgt_gemm_dequant_q4_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq, qgt::Q4_0W{h(wd)}, QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q4_1(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq, qgt::Q4_1W{h(wd), h(wm)}, QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q5_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wqh, QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_0W{h(wd), nullptr, static_cast<const unsigned*>(wqh)},
                QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q5_1(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, const void* wqh,
                                     QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_1W{h(wd), h(wm), static_cast<const unsigned*>(wqh)},
                QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q8_0(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq, qgt::Q8_0W{h(wd)}, QGT_K4_PASS);
}

// iq4_xs: W's codebook values int8 [N, K] (q8_0's layout), d f32 [N,
// K/32] (the per-32 d * (sc - 32) of an IQ4_XS tensor).
QGT_EXPORT int qgt_gemm_dequant_iq4_xs(const void* a, int a_f32, int fq,
                                       const void* wq, const void* wd,
                                       QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq,
                qgt::IQ4_XSW{static_cast<const float*>(wd)}, QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q4_k(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq,
                qgt::Q4_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm)},
                QGT_K4_PASS);
}

QGT_EXPORT int qgt_gemm_dequant_q5_k(const void* a, int a_f32, int fq,
                                     const void* wq, const void* wd,
                                     const void* wm, const void* wqh,
                                     QGT_K4_ARGS) {
  return launch(a, a_f32, fq, wq,
                qgt::Q5_KW{static_cast<const float*>(wd),
                           static_cast<const float*>(wm),
                           static_cast<const unsigned*>(wqh)},
                QGT_K4_PASS);
}
