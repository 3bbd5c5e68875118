// K8: the post-attention tail of a decode layer in one launch, q4_0
// weights, M <= 8 rows:
//
//   o  = gemm_exact(wo, q8_1(attn));          xm = x + o
//   gu = gemm_exact(wgu, q8_1(rms_norm(xm, nw, eps)))
//   ff = silu(gu[:, :dff]) * gu[:, dff:]
//   out = xm + gemm_exact(w_down, q8_1(ff))
//
// Replaces the Pallas kernel quant_gemm_tpu/kernels/gemm_megalayer.py::
// attn_tail (body _tail_kernel).  Each GEMM stage equals quantize_q8_1 +
// K1 bit for bit for the same float input, as the JAX kernel promises
// ("bit-identical GEMM stages"): each stage is K1's own body, mode and
// order (k1.cuh, STREAMED) on Q8_1 codes made by the shared quantizer
// (common.cuh::quantize_tile).  RMSNorm and SiLU sum and round in this
// kernel's own float32 order, so a code of the next stage can move
// across a .5 rounding tie against the plain chain: the two agree to a
// tolerance on the layer update out - x, not bit for bit.
//
// Bound on an H100: bytes, the three weights (38.8M q4_0 weights, 21.8 MB
// per TinyLlama-1.1B layer).  Design: one cooperative launch of a
// persistent grid (as many blocks as are resident at once; the launch
// refuses a grid that does not fit) that alternates grid-wide Q8_1 passes
// and GEMM stages on k1.cuh's int8 mma.sync body, with five grid barriers
// (cooperative_groups::this_grid().sync()):
//   q. the codes of attn: every warp of the grid quantizes its share of
//      the M x dim/32 blocks into the scratch codes;
//   1. wo, the codes STREAMED from the scratch (K1's mode); the epilogue
//      writes xm = x + o into the scratch xm;
//   q. every block sums the squares of each row of xm in one fixed order
//      (one warp a row, as K2 on one slice) and quantizes its share of
//      rms_norm(xm) into the scratch codes;
//   2. wgu; a row tile holds 16 gate rows and their 16 up rows (k1.cuh's
//      PAIRED epilogue), so the thread that holds gate output (j, m) holds
//      up output (j, m) too and writes ff = silu(g) * u into the scratch
//      ff with no barrier;
//   q. the codes of ff, as for attn;
//   3. w_down; the epilogue writes out = xm + the stage.
// Why passes and not K2's / K6's cluster prologue (codes resident in
// shared memory, each block of a cluster of 8 quantizing an eighth, a
// design this kernel had first): inside this launch every cluster
// quantizes the whole activation, and on the H100 that prologue took
// most of the wgu and w_down stages' time; in a pass over the grid each
// warp quantizes a few blocks, and the pass and its barrier cost less
// (PERF.md).  Before each barrier in front of a GEMM stage
// every block prefetches into L2 the weight bytes of its first two
// chunks of that stage (which do not depend on the previous one), so the
// barrier and the pass run under that stream.  Data written in the launch
// (the codes, xm, ff) is read back through L2 (cp.async.cg, __ldcg),
// never through the non-coherent path.  The launch reads nothing on the
// host beyond the occupancy query at the first call and allocates
// nothing: the wrapper passes the scratch.
#include "k1.cuh"

namespace {

namespace cg = cooperative_groups;
using qgt::Q4_0W;
using qgt::k1::FloatActT;
using qgt::k1::NormActT;
using qgt::k1::Planes;
using qgt::k1::Q8_1Act;
using qgt::k1::Store;

constexpr int MMAX_TAIL = 8;

struct TailArgs {
  const float* attn;  // [M, dim]
  const float* x;     // [M, dim] residual
  const float* nw;    // [dim] mlp norm weight
  float eps;
  const uint8_t* wo_q;  // q4_0 [dim, dim]: qs, d
  const uint8_t* wo_d;
  const uint8_t* gu_q;  // q4_0 [2 dff, dim]: gate rows, then up rows
  const uint8_t* gu_d;
  const uint8_t* dn_q;  // q4_0 [dim, dff]
  const uint8_t* dn_d;
  float* xm;     // scratch [M, dim]
  float* ff;     // scratch [M, dff]
  int8_t* qa;    // scratch Q8_1 codes [M, K] of the stage's input
  __half* da;    // and its scales [M, K/32]
  __half* sa;
  float* out;  // [M, dim]
  int M, dim, dff;
};

// stages 1 and 3: out[m, n] = add[m, n] + the stage (xm = x + o; out =
// xm + the w_down stage), add read through L2
struct AddEpi {
  static constexpr bool PAIRED = false;
  const float* add;
  float* out;
  int N;
  __device__ static int ntiles(int N) { return Store::ntiles(N); }
  __device__ static int row(int tile, int r, int N) {
    return Store::row(tile, r, N);
  }
  __device__ __forceinline__ void operator()(int n, int m, float v) const {
    const size_t k = static_cast<size_t>(m) * N + n;
    out[k] = __fadd_rn(__ldcg(add + k), v);
  }
};

// stage 2: ff = silu(g) * u = (g * sigmoid(g)) * u (ops/activations.py)
// for gate row j (rows j of tile j / 16) and up row j + N/2
struct GluEpi {
  static constexpr bool PAIRED = true;
  float* ff;
  int dff;
  __device__ static int ntiles(int N) { return N / 32; }
  __device__ static int row(int tile, int r, int N) {
    return r < 16 ? 16 * tile + r : N / 2 + 16 * tile + r - 16;
  }
  __device__ __forceinline__ void operator()(int j, int m, float g,
                                             float u) const {
    const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
    ff[static_cast<size_t>(m) * dff + j] = __fmul_rn(__fmul_rn(g, sg), u);
  }
};

// Q8_1 of the M x K values get4 gives into the scratch codes (rows of K)
// and scales (rows of K/32), the (row, block) pairs split over every warp
// of the grid
template <typename Get4>
__device__ __forceinline__ void quantize_grid(Get4 get4, int M, int K,
                                              int8_t* qa, __half* da,
                                              __half* sa) {
  constexpr int W = qgt::k1::WARPS;
  qgt::quantize_tile<1>(get4, M, K / qgt::QK, qa, K, da, sa, K / qgt::QK,
                        blockIdx.x * W + (threadIdx.x >> 5), gridDim.x * W,
                        threadIdx.x & 31);
}

__global__ void __launch_bounds__(qgt::k1::THREADS)
    attn_tail_kernel(TailArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float rv[16];  // row sums of squares, rsqrt factors
  const int M = a.M, dim = a.dim, dff = a.dff;
  const Planes po{{a.wo_d, nullptr, nullptr, nullptr}};
  const Planes pg{{a.gu_d, nullptr, nullptr, nullptr}};
  const Planes pd{{a.dn_d, nullptr, nullptr, nullptr}};
  const Q8_1Act codes{a.qa, a.da, a.sa};

  qgt::k1::prefetch_first<Q4_0W, AddEpi>(a.wo_q, po, dim, dim);
  const FloatActT<> attn{a.attn, dim};
  quantize_grid([&](int m, int i) { return attn.get4(m, i); }, M, dim, a.qa,
                a.da, a.sa);
  grid.sync();
  qgt::k1::gemm<Q4_0W, 1, qgt::k1::STREAMED>(a.wo_q, po, codes,
                                             AddEpi{a.x, a.xm, dim}, M, dim,
                                             dim);
  qgt::k1::prefetch_first<Q4_0W, GluEpi>(a.gu_q, pg, 2 * dff, dim);
  grid.sync();
  NormActT<true> h{a.xm, a.nw, a.eps, dim, nullptr};
  h.partial<1>(rv, M, threadIdx.x >> 5, qgt::k1::WARPS, threadIdx.x & 31);
  __syncthreads();
  h.combine<1>(rv, M, threadIdx.x);
  __syncthreads();  // the rsqrt factors
  quantize_grid([&](int m, int i) { return h.get4(m, i); }, M, dim, a.qa,
                a.da, a.sa);
  grid.sync();
  qgt::k1::gemm<Q4_0W, 1, qgt::k1::STREAMED>(a.gu_q, pg, codes,
                                             GluEpi{a.ff, dff}, M, 2 * dff,
                                             dim);
  qgt::k1::prefetch_first<Q4_0W, AddEpi>(a.dn_q, pd, dim, dff);
  grid.sync();
  const FloatActT<true> ff{a.ff, dff};
  quantize_grid([&](int m, int i) { return ff.get4(m, i); }, M, dff, a.qa,
                a.da, a.sa);
  grid.sync();
  qgt::k1::gemm<Q4_0W, 1, qgt::k1::STREAMED>(a.dn_q, pd, codes,
                                             AddEpi{a.xm, a.out, dim}, M,
                                             dim, dff);
}

// The scratch: xm, ff, then the codes and scales of the widest input,
// each segment on 16 bytes.
struct Scratch {
  size_t xm, ff, qa, da, sa, total;
};

Scratch scratch(int M, int dim, int dff) {
  auto up16 = [](size_t n) { return (n + 15) & ~static_cast<size_t>(15); };
  const size_t kmax = dim > dff ? dim : dff;
  Scratch s;
  s.xm = 0;
  s.ff = s.xm + up16(4 * static_cast<size_t>(M) * dim);
  s.qa = s.ff + up16(4 * static_cast<size_t>(M) * dff);
  s.da = s.qa + up16(static_cast<size_t>(M) * kmax);
  s.sa = s.da + up16(2 * M * (kmax / qgt::QK));
  s.total = s.sa + up16(2 * M * (kmax / qgt::QK));
  return s;
}

}  // namespace

// Bytes of the scratch buffer qgt_attn_tail_q4_0 takes: xm f32 [M, dim],
// ff f32 [M, dff] and the Q8_1 codes int8 [M, K] and scales f16
// [M, K/32] x 2 of the widest stage input.
QGT_EXPORT int qgt_attn_tail_workspace(int M, int dim, int dff) {
  return static_cast<int>(scratch(M, dim, dff).total);
}

// out f32 [M, dim] = the tail above, attn/x f32 [M, dim], nw f32 [dim]
// (16-byte aligned), q4_0 wo [dim, dim], wgu [2 dff, dim], w_down [dim,
// dff] (qs uint8 [N, K/2], d f16 [N, K/32], 16-byte aligned); ws:
// qgt_attn_tail_workspace bytes, 16-byte aligned.  Returns the launch's
// error where the card refuses the cooperative launch.
QGT_EXPORT int qgt_attn_tail_q4_0(const void* attn, const void* x,
                                  const void* nw, float eps,
                                  const void* wo_q, const void* wo_d,
                                  const void* gu_q, const void* gu_d,
                                  const void* dn_q, const void* dn_d,
                                  void* ws, void* out, int M, int dim,
                                  int dff, void* stream) {
  if (M < 1 || M > MMAX_TAIL || dim < qgt::QK || dff < qgt::QK ||
      dim % qgt::QK || dff % qgt::QK)
    return static_cast<int>(cudaErrorInvalidValue);
  uint8_t* w = static_cast<uint8_t*>(ws);
  const Scratch s = scratch(M, dim, dff);
  TailArgs a;
  a.attn = static_cast<const float*>(attn);
  a.x = static_cast<const float*>(x);
  a.nw = static_cast<const float*>(nw);
  a.eps = eps;
  a.wo_q = static_cast<const uint8_t*>(wo_q);
  a.wo_d = static_cast<const uint8_t*>(wo_d);
  a.gu_q = static_cast<const uint8_t*>(gu_q);
  a.gu_d = static_cast<const uint8_t*>(gu_d);
  a.dn_q = static_cast<const uint8_t*>(dn_q);
  a.dn_d = static_cast<const uint8_t*>(dn_d);
  a.xm = reinterpret_cast<float*>(w + s.xm);
  a.ff = reinterpret_cast<float*>(w + s.ff);
  a.qa = reinterpret_cast<int8_t*>(w + s.qa);
  a.da = reinterpret_cast<__half*>(w + s.da);
  a.sa = reinterpret_cast<__half*>(w + s.sa);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.dim = dim;
  a.dff = dff;

  using qgt::k1::Smem;
  static qgt::k1::Occupancy occ;
  const int smem = qgt::k1::tail(Smem<Q4_0W, 1, qgt::k1::STREAMED>::TEND,
                                 qgt::k1::STREAMED, M, dim)
                       .total;
  int resident = 0;
  cudaError_t e = occ.get(attn_tail_kernel, smem, 1, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeCooperative;
  at[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(resident);
  cfg.blockDim = dim3(qgt::k1::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, attn_tail_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
