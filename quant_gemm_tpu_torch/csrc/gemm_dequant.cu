// K4: dequant GEMM for prefill, bf16 or float32 activations x per-32
// weights (q4_0, q4_1, q5_0, q5_1, q8_0, q4_k, q5_k), optionally with the
// activation fake-quantized per 32-block (fused_quant).
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_pallas.py::gemm
// (bodies _kernel_w4 and, for q8_0, _kernel_w8).  C[M, N] = A[M, K] @
// W[N, K]^T with W = (q - 8) d (q4_0), (q - 16) d (q5_0), q d (q8_0) or
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
//
// bf16 operands (A bf16 with fq = 0, or fq = 2): the tensor cores, with
// exact per-block scaling.  Every per-32 code is a small integer (q - 8,
// q - 16, q, or the int8 q of q8_0), exact in bf16, and so is every
// operand value, so each product A * code is exact in a bf16
// mma.sync.m16n8k16 with float32 accumulation.  Per quant block b the
// kernel runs two MMAs (k 0..15, 16..31) into a zeroed fragment T_b and
// folds it in with the block's scales: acc = fma(d[n,b], T_b, acc) and,
// for the min formats, acc = fma(m[n,b], sa[m,b], acc) with sa[m,b] the
// float32 sum of the block's operand values.  The weight is never
// rounded to bf16, so the result differs from the plain version's float32
// product only in summation order (NMSE ~1e-13).  mma.sync and not wgmma:
// the scales apply after every 32-deep block, which needs the accumulator
// in registers every two k16 steps.  Tile: 64 x 64 outputs per 128-thread
// block, four warps of 64 x 16 (each B fragment converted once serves
// four MMAs; on the H100 this beat 32 x 32 and 16 x 64 warp tiles, 128-
// wide block tiles and 8-block stages); stages of 4 quant blocks (A rows in
// bf16, the raw code bytes, the qh words, sa) double-buffered with
// cp.async 16-byte copies (zero-filled past M and N), the scale planes
// through registers into shared memory as float32.  The k order inside
// an MMA is permuted so that lane (g, t) holds elements 4t .. 4t+3 of its
// row (one 8-byte A load, one 4-byte code load covering both k16 steps):
// the low nibbles of bytes 4t .. 4t+3 are elements 4t .. 4t+3, the high
// nibbles 16 + 4t .. 16 + 4t+3.  A code becomes an exact bf16 by OR-ing
// it into 0x4300 (128 + q) and subtracting 128 + off (__hsub2); the q5
// forms add the fifth bit first (common.cuh::bit4); q8_0 converts int8
// through float.  Where the output tiles do not fill the 132 SMs, K is
// split into pieces of whole quant blocks (grid z; the wrapper's
// kernels/gemm_dequant.py::k4_grid picks the piece length), each piece
// writes float32 partials, and gemm_dequant_kernel_reduce adds them in
// piece order, so every output is the same sum in the same order on
// every call: K4 stays deterministic.  gemm_dequant_kernel_prologue runs
// first where the operand needs it: fq = 2 writes A' in bf16, the min
// formats get sa.
//
// float32 operands (A float32 with fq = 0, or fq = 1; only the JAX
// ladder's pallas_f32 and fused_quant rungs reach them): the CUDA-core
// body, a 64 x 32 output tile per 128-thread block, one 32-deep quant
// block per K step, A and W expanded to float32 in shared memory
// (common.cuh::dequant8) and float32 FMA, with the fake quantization in
// its A-tile prologue (two shuffles among the four lanes of a 32-block).
// The tensor cores would need a 3-piece bf16 split of A for float32
// operands, and their bound would first be restated; they stay here.
#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int BM = 64, BN = 32, BK = qgt::QK, THREADS = 128;

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

template <typename AT, typename W>
__global__ void __launch_bounds__(THREADS)
    gemm_dequant_kernel(const AT* __restrict__ a,
                        const uint8_t* __restrict__ wq, const W fmt,
                        float* __restrict__ out, int M, int N, int K,
                        int fq) {
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float ws[BK][BN];
  const int nb = K / qgt::QK;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int t = threadIdx.x, tx = t % 8, ty = t / 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int b = 0; b < nb; ++b) {
    // activation tile: 64 rows x 32 values = 256 vectors of 8, lanes 4j
    // .. 4j + 3 of a warp on one row's block (the loop is uniform)
    for (int v = t; v < BM * BK / 8; v += THREADS) {
      const int row = v / (BK / 8), k8 = (v % (BK / 8)) * 8;
      float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (m0 + row < M)
        load8(a + static_cast<size_t>(m0 + row) * K + b * BK + k8, f);
      if (fq) fake_quant8(f, fq);
#pragma unroll
      for (int i = 0; i < 8; ++i) as[k8 + i][row] = f[i];
    }
    // weight tile: 32 rows x 32 values; thread = (row, quarter), the
    // quarter's values 4 qtr .. 4 qtr + 3 and 16 + 4 qtr .. 16 + 4 qtr + 3
    {
      const int col = t / 4, qtr = t % 4;
      float v[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // past N: every weight is 0
      if (n0 + col < N)
        qgt::dequant8(fmt, wq, static_cast<size_t>(n0 + col), nb, b, qtr, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ws[4 * qtr + i][col] = v[i];
        ws[16 + 4 * qtr + i][col] = v[4 + i];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// ---- the tensor-core body (bf16 operands) ----

constexpr int TBM = 64, TBN = 64, TKB = 4;  // output tile, quant blocks/stage
constexpr int TWARPS = 4, TTHREADS = 32 * TWARPS;
constexpr int WARPS_M = 1;                  // warps along M
constexpr int WTM = TBM / WARPS_M, WTN = TBN * WARPS_M / TWARPS;  // warp tile
constexpr int TI = WTM / 16, TJ = WTN / 8;  // its m16 and n8 tiles
constexpr int TMINB = 3;                    // blocks an SM must hold
constexpr int TSTAGES = 2;                  // stages in flight
// every thread stages the same number of A, code, qh, sa and scale
// entries (loops of a fixed trip count, which the compiler unrolls)
static_assert(TBM * TKB * qgt::QK * 2 / 16 % TTHREADS == 0 &&
                  TBN * TKB * 16 / 16 % TTHREADS == 0 &&
                  TBN * TKB % TTHREADS == 0 && TBM * TKB % TTHREADS == 0,
              "tile entries must split evenly over the block's threads");
constexpr int AST = TKB * qgt::QK * 2 + 32;  // A row bytes (== 32 mod 128)

// where a format's codes are: bytes per block, and whether a qh plane
// gives the fifth bits
template <typename W>
struct TcFmt {
  static constexpr int BYTES = 16;
  static constexpr bool QH = false;
};
template <>
struct TcFmt<qgt::Q8_0W> {
  static constexpr int BYTES = 32;
  static constexpr bool QH = false;
};
template <bool HM, typename S>
struct TcFmt<qgt::Q5W<HM, S>> {
  static constexpr int BYTES = 16;
  static constexpr bool QH = true;
};

// shared memory of one stage, in bytes: A [TBM][AST], codes [TBN][WST],
// qh [TBN][TKB] u32, sa [TBM][TKB] f32, d and m [TKB][TBN] f32
template <typename W>
struct TcSmem {
  static constexpr int WST = TKB * TcFmt<W>::BYTES + 16;  // odd x 16 bytes
  static constexpr int A = 0;
  static constexpr int CODES = A + TBM * AST;
  static constexpr int QH = CODES + TBN * WST;
  static constexpr int SA = QH + TBN * TKB * 4;
  static constexpr int D = SA + TBM * TKB * 4;
  static constexpr int MN = D + TKB * TBN * 4;
  static constexpr int STAGE = MN + TKB * TBN * 4;
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
// when gridDim.z == 1, else partials part [gridDim.z, M, N].  a: bf16
// operand [M, K]; sa: [M, nb] row-block sums (min formats).
template <typename W>
__global__ void __launch_bounds__(TTHREADS, TMINB)
    gemm_dequant_kernel_tc(const __nv_bfloat16* __restrict__ a,
                           const uint8_t* __restrict__ wq, const W fmt,
                           const float* __restrict__ sa,
                           float* __restrict__ out, int M, int N, int K,
                           int chunk) {
  using S = TcSmem<W>;
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
  // A rows, code bytes, qh words and sa of stage st into buffer buf
  auto issue = [&](int st, int buf) {
    uint8_t* base = tsm + buf * S::STAGE;
    const int bs = kb0 + st * TKB, nkb = min(TKB, kb1 - bs);
    constexpr int ACH = TKB * qgt::QK * 2 / 16;  // 16-byte chunks a row
#pragma unroll
    for (int u = 0; u < TBM * ACH / TTHREADS; ++u) {
      const int c = tid + TTHREADS * u, row = c / ACH, ch = c % ACH;
      if (ch / 4 < nkb) {
        const bool ok = m0 + row < M;
        const __nv_bfloat16* src =
            ok ? a + static_cast<size_t>(m0 + row) * K + bs * qgt::QK + ch * 8
               : a;
        qgt::cp_async16(base + S::A + row * AST + ch * 16, src, ok ? 16 : 0);
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
      float tb[TI][TJ][4];  // T_b, started by the first k16 step's MMA
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t af[TI][4];
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
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          uint32_t b0, b1;
          if constexpr (BYTES == 32) {
            b0 = int8_bf16(x[j][s], 0);
            b1 = int8_bf16(x[j][s], 16);
          } else {
            b0 = codes_bf16(x[j][s], 0x4140u, bias);
            b1 = codes_bf16(x[j][s], 0x4342u, bias);
          }
#pragma unroll
          for (int i = 0; i < TI; ++i) {
            if (s == 0)
              qgt::mma_bf16_zero(tb[i][j], af[i], b0, b1);
            else
              qgt::mma_bf16(tb[i][j], af[i], b0, b1);
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
// four lanes per 32-block: with fq = 2, A' = bf16(fake_quant(A)) into a2;
// with sa, the block's float32 sum of the operand values (the lane's 8 in
// order, then the lanes xor 1, xor 2), every call in the same order.
template <typename AT>
__global__ void __launch_bounds__(256)
    gemm_dequant_kernel_prologue(const AT* __restrict__ a, int fq,
                                 __nv_bfloat16* __restrict__ a2,
                                 float* __restrict__ sa, int M, int K) {
  const size_t v = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool in = v < static_cast<size_t>(M) * K / 8;
  float f[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (in) load8(a + v * 8, f);
  if (fq) fake_quant8(f, 2);  // the whole warp takes part
  if (in && a2) {
    uint4 pk;
    pk.x = qgt::pack_bf16(f[0], f[1]);
    pk.y = qgt::pack_bf16(f[2], f[3]);
    pk.z = qgt::pack_bf16(f[4], f[5]);
    pk.w = qgt::pack_bf16(f[6], f[7]);
    *reinterpret_cast<uint4*>(a2 + v * 8) = pk;
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

// the bf16-operand path: prologue (fq = 2 or a min format), the tensor-
// core body over chunk-block K pieces, the reduce when there are several
template <typename W>
int launch_tc(const void* a, int a_f32, int fq, const void* wq, const W fmt,
              float* out, float* part, float* sa, void* a2, int M, int N,
              int K, int chunk, cudaStream_t s) {
  const int nb = K / qgt::QK;
  if (chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pieces = (nb + chunk - 1) / chunk;
  if ((pieces > 1 && !part) || (W::MIN && !sa) || (fq == 2 && !a2))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* op = static_cast<const __nv_bfloat16*>(a);
  if (fq == 2 || W::MIN) {
    const size_t lanes = static_cast<size_t>(M) * K / 8;
    const int grid = blocks_for(lanes, 256);
    __nv_bfloat16* a2p = fq == 2 ? static_cast<__nv_bfloat16*>(a2) : nullptr;
    float* sap = W::MIN ? sa : nullptr;
    if (a_f32)
      gemm_dequant_kernel_prologue<float><<<grid, 256, 0, s>>>(
          static_cast<const float*>(a), fq, a2p, sap, M, K);
    else
      gemm_dequant_kernel_prologue<__nv_bfloat16><<<grid, 256, 0, s>>>(
          op, fq, a2p, sap, M, K);
    if (fq == 2) op = a2p;
  }
  constexpr int smem = TSTAGES * TcSmem<W>::STAGE;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_dequant_kernel_tc<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM, pieces);
  gemm_dequant_kernel_tc<W><<<grid, TTHREADS, smem, s>>>(
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

// The body by operand type: bf16 operands (A bf16 with fq = 0, or fq = 2)
// on the tensor cores; float32 operands (A float32 with fq = 0, or fq =
// 1) on the CUDA-core body.  Scratch (tensor cores only): part [pieces,
// M, N] f32 when K is split, sa [M, K/32] f32 for the min formats, a2
// [M, K] bf16 for fq = 2.
template <typename W>
int launch(const void* a, int a_f32, int fq, const void* wq, const W fmt,
           void* out, void* part, void* sa, void* a2, int M, int N, int K,
           int chunk, void* stream) {
  if (M < 1 || N < 1 || K % qgt::QK || fq < 0 || fq > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* w = static_cast<const uint8_t*>(wq);
  float* o = static_cast<float*>(out);
  if ((!a_f32 && fq == 0) || fq == 2)
    return launch_tc(a, a_f32, fq, wq, fmt, o, static_cast<float*>(part),
                     static_cast<float*>(sa), a2, M, N, K, chunk, s);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (a_f32)
    gemm_dequant_kernel<float, W><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), w, fmt, o, M, N, K, fq);
  else
    gemm_dequant_kernel<__nv_bfloat16, W><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), w, fmt, o, M, N, K, fq);
  return static_cast<int>(cudaGetLastError());
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
