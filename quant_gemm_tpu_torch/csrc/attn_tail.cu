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
// ("bit-identical GEMM stages"): the Q8_1 codes come from the shared
// quantizer and every output is summed in K1's order (common.cuh::
// quantize_q8_1_block, k1_rows).  RMSNorm and SiLU sum and round in this
// kernel's own float32 order, so a code of the next stage can move
// across a .5 rounding tie against the plain chain: the two agree to a
// tolerance on the layer update out - x, not bit for bit.
//
// Bound on an H100: bytes, the three weights (38.8M q4_0 weights, 21.8 MB
// per TinyLlama-1.1B layer).  Design: one cooperative launch of SMs x
// occupancy blocks of 16 warps, three grid barriers
// (cooperative_groups::this_grid().sync()); in each stage the block's
// warps form groups of K1's 1, 2 or 4 warps (k1_warps of the stage's K),
// each group K1's block on NC = 2 weight rows at a time (the rows of a
// block do not enter an output's order; two rows and accumulators for 8
// activation rows keep the kernel at 64 registers, two blocks per SM):
//   1. every block quantizes attn into shared memory; the groups take
//      wo's row groups, grid-strided, into the scratch o; sync;
//   2. every block forms xm = x + o, normalises and quantizes it into
//      shared memory; a block task is one 32-column block of ff, 16 row
//      groups: a group takes gate rows j, j+1 and then up rows j+dff,
//      j+dff+1, and the thread that emitted gate output (c, m) emits the
//      up output too, so SiLU*gate needs no barrier; the block
//      quantizes its 32 ff columns straight into the scratch codes; sync;
//   3. every block copies the ff codes (45 KB at M = 8, dff = 5632) into
//      shared memory; the groups take w_down's row groups and add the
//      residual.
// A grid larger than the blocks that can be resident at once would hang
// at a barrier, so the host sizes it from the occupancy and launches
// with cudaLaunchCooperativeKernel, which refuses a grid that does not
// fit.  Data written in the launch (o, the ff codes) is read back with
// __ldcg (L2), never through the non-coherent path.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int NWARPS = 16;  // warps per block
constexpr int NC = 2;       // weight rows per K1 block
constexpr int MMAX_TAIL = 8;

struct TailArgs {
  const float* attn;  // [M, dim]
  const float* x;     // [M, dim] residual
  const float* nw;    // [dim] mlp norm weight
  float eps;
  const uint8_t* wo_q;  // q4_0 [dim, dim]
  const __half* wo_d;
  const uint8_t* gu_q;  // q4_0 [2 dff, dim]: gate rows, then up rows
  const __half* gu_d;
  const uint8_t* dn_q;  // q4_0 [dim, dff]
  const __half* dn_d;
  float* o;        // scratch [M, dim]
  int8_t* fq;      // scratch Q8_1 of ff: codes [M, dff]
  float* fd;       // d [M, dff/32]
  float* fs;       // s [M, dff/32]
  float* out;      // [M, dim]
  int M, dim, dff;
};

// The block's warps as groups of K1 blocks for a stage whose K has nb
// 32-blocks: this thread's group, its index t in it and the group size.
struct Groups {
  int gwarps, gthreads, count, group, t;
  __device__ explicit Groups(int nb)
      : gwarps(qgt::k1_warps(nb)),
        gthreads(gwarps * 32),
        count(NWARPS / gwarps),
        group(threadIdx.x / gthreads),
        t(threadIdx.x % gthreads) {}
  __device__ void sync() const { qgt::group_sync(group, gthreads); }
};

using Red = float (*)[NC][MMAX_TAIL];

// K1's outputs of rows n0 .. n0+NC-1 of the q4_0 weight (wq, wd) [N, K]
// for the activation codes in shared memory, emit(c, m, sum) per output
template <typename Emit>
__device__ __forceinline__ void k1_block(const Groups& g, Red red,
                                         const uint8_t* wq, const __half* wd,
                                         int n0, int N, int nb,
                                         const int8_t* qa, const float* da,
                                         const float* sa, int M, Emit emit) {
  qgt::k1_rows<NC, float, qgt::Q4_0W, MMAX_TAIL>(
      wq, qgt::Q4_0W{wd}, n0, N, nb, qa, da, sa, M, g.t, g.gthreads,
      red + g.group * g.gwarps, [&] { g.sync(); }, emit);
  g.sync();  // red is rewritten by the group's next K1 block
}

__global__ void __launch_bounds__(NWARPS * 32) attn_tail_kernel(TailArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[NWARPS][NC][MMAX_TAIL];
  const int M = a.M, dim = a.dim, dff = a.dff;
  const int nbd = dim / qgt::QK, nbf = dff / qgt::QK;
  const int kmax = dim > dff ? dim : dff;
  int8_t* qa = reinterpret_cast<int8_t*>(smem);                 // [M, K]
  float* da = reinterpret_cast<float*>(smem + M * kmax);        // [M, nb]
  float* sa = da + M * (kmax / qgt::QK);                        // [M, nb]
  float* rinv = sa + M * (kmax / qgt::QK);                      // [M]
  float* ffb = rinv + MMAX_TAIL;                                // [M, 32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // 1. Q8_1 of attn into shared memory, then wo's rows into o
  qgt::quantize_rows<4>(
      [&](int m, int i) { return a.attn[static_cast<size_t>(m) * dim + i]; },
      M, dim, qa, da, sa, warp, NWARPS, lane);
  __syncthreads();
  const Groups gd(nbd);  // stages 1 and 2: K = dim
  for (int r = blockIdx.x * gd.count + gd.group; r < dim / NC;
       r += gridDim.x * gd.count) {
    const int n0 = r * NC;
    k1_block(gd, red, a.wo_q, a.wo_d, n0, dim, nbd, qa, da, sa, M,
             [&](int c, int m, float s) {
               a.o[static_cast<size_t>(m) * dim + n0 + c] = s;
             });
  }
  grid.sync();

  // 2. xm = x + o, RMSNorm (ops/rms_norm.py's steps), Q8_1 into shared
  //    memory; then gate/up rows, SiLU*gate and Q8_1 of ff per 32 columns
  for (int m = warp; m < M; m += NWARPS) {
    float s = 0.0f;
#pragma unroll 8
    for (int i = lane; i < dim; i += 32) {
      const size_t k = static_cast<size_t>(m) * dim + i;
      const float xm = __fadd_rn(a.x[k], __ldcg(a.o + k));
      s = __fadd_rn(s, __fmul_rn(xm, xm));
    }
    s = qgt::warp_sum(s);
    if (lane == 0)
      rinv[m] = rsqrtf(__fadd_rn(__fdiv_rn(s, static_cast<float>(dim)), a.eps));
  }
  __syncthreads();
  qgt::quantize_rows<4>(
      [&](int m, int i) {
        const size_t k = static_cast<size_t>(m) * dim + i;
        const float xm = __fadd_rn(a.x[k], __ldcg(a.o + k));
        return __fmul_rn(__fmul_rn(xm, rinv[m]), a.nw[i]);
      },
      M, dim, qa, da, sa, warp, NWARPS, lane);
  __syncthreads();
  for (int task = blockIdx.x; task < nbf; task += gridDim.x) {
    for (int r = gd.group; r < qgt::QK / NC; r += gd.count) {
      const int j = task * qgt::QK + r * NC;
      float* f = ffb + r * NC;  // f[m * QK + c]: ff column j + c
      k1_block(gd, red, a.gu_q, a.gu_d, j, 2 * dff, nbd, qa, da, sa, M,
               [&](int c, int m, float s) { f[m * qgt::QK + c] = s; });
      k1_block(gd, red, a.gu_q, a.gu_d, j + dff, 2 * dff, nbd, qa, da, sa,
               M, [&](int c, int m, float s) {
                 // silu(g) * u = (g * sigmoid(g)) * u, ops/activations.py
                 const float g = f[m * qgt::QK + c];
                 const float sg = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
                 f[m * qgt::QK + c] = __fmul_rn(__fmul_rn(g, sg), s);
               });
    }
    __syncthreads();
    if (warp < (M + 3) / 4) {  // four rows a warp, one block each
      const int m = 4 * warp + (lane >> 3), e = (lane & 7) * 4;
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = m < M ? ffb[m * qgt::QK + e + j] : 0.0f;
      const qgt::Q8_1Code c = qgt::quantize_q8_1_block(h);
      if (m < M) {
        *reinterpret_cast<int*>(a.fq + static_cast<size_t>(m) * dff +
                                task * qgt::QK + e) = c.q4;
        if (e == 0) {
          a.fd[m * nbf + task] = c.d;
          a.fs[m * nbf + task] = c.s;
        }
      }
    }
    __syncthreads();  // ffb is rewritten by the next task
  }
  grid.sync();

  // 3. the ff codes into shared memory, then w_down's rows + residual
  const int4* src = reinterpret_cast<const int4*>(a.fq);
  int4* dst = reinterpret_cast<int4*>(qa);
  for (int i = threadIdx.x; i < M * dff / 16; i += blockDim.x)
    dst[i] = __ldcg(src + i);
  for (int i = threadIdx.x; i < M * nbf; i += blockDim.x) {
    da[i] = __ldcg(a.fd + i);
    sa[i] = __ldcg(a.fs + i);
  }
  __syncthreads();
  const Groups gf(nbf);  // K = dff
  for (int r = blockIdx.x * gf.count + gf.group; r < dim / NC;
       r += gridDim.x * gf.count) {
    const int n0 = r * NC;
    k1_block(gf, red, a.dn_q, a.dn_d, n0, dim, nbf, qa, da, sa, M,
             [&](int c, int m, float s) {
               const size_t k = static_cast<size_t>(m) * dim + n0 + c;
               a.out[k] = __fadd_rn(__fadd_rn(a.x[k], __ldcg(a.o + k)), s);
             });
  }
}

size_t smem_bytes(int M, int dim, int dff) {
  const size_t kmax = dim > dff ? dim : dff;
  return M * kmax + 2 * sizeof(float) * M * (kmax / qgt::QK) +
         sizeof(float) * (MMAX_TAIL + MMAX_TAIL * qgt::QK);
}

}  // namespace

// Bytes of the scratch buffer qgt_attn_tail_q4_0 takes: o f32 [M, dim],
// the ff codes int8 [M, dff] and their d, s f32 [M, dff/32].
QGT_EXPORT int qgt_attn_tail_workspace(int M, int dim, int dff) {
  return 4 * M * dim + M * dff + 8 * M * (dff / qgt::QK);
}

// out f32 [M, dim] = the tail above, attn/x f32 [M, dim], nw f32 [dim],
// q4_0 wo [dim, dim], wgu [2 dff, dim], w_down [dim, dff] (qs uint8
// [N, K/2], d f16 [N, K/32]); ws: qgt_attn_tail_workspace bytes, 16-byte
// aligned.  Returns cudaErrorNotSupported where the device has no
// cooperative launch, and cudaErrorCooperativeLaunchTooLarge where not
// one block fits on an SM.
QGT_EXPORT int qgt_attn_tail_q4_0(const void* attn, const void* x,
                                  const void* nw, float eps,
                                  const void* wo_q, const void* wo_d,
                                  const void* gu_q, const void* gu_d,
                                  const void* dn_q, const void* dn_d,
                                  void* ws, void* out, int M, int dim,
                                  int dff, void* stream) {
  if (M < 1 || M > MMAX_TAIL || dim < 1 || dff < 1 || dim % qgt::QK ||
      dff % qgt::QK)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(M, dim, dff);
  e = cudaFuncSetAttribute(attn_tail_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, attn_tail_kernel,
                                                    NWARPS * 32, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);

  unsigned char* w = static_cast<unsigned char*>(ws);
  TailArgs a;
  a.attn = static_cast<const float*>(attn);
  a.x = static_cast<const float*>(x);
  a.nw = static_cast<const float*>(nw);
  a.eps = eps;
  a.wo_q = static_cast<const uint8_t*>(wo_q);
  a.wo_d = static_cast<const __half*>(wo_d);
  a.gu_q = static_cast<const uint8_t*>(gu_q);
  a.gu_d = static_cast<const __half*>(gu_d);
  a.dn_q = static_cast<const uint8_t*>(dn_q);
  a.dn_d = static_cast<const __half*>(dn_d);
  a.o = reinterpret_cast<float*>(w);
  a.fq = reinterpret_cast<int8_t*>(w + 4 * M * dim);
  a.fd = reinterpret_cast<float*>(w + 4 * M * dim + M * dff);
  a.fs = a.fd + M * (dff / qgt::QK);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.dim = dim;
  a.dff = dff;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(attn_tail_kernel, dim3(occ * sms),
                                  dim3(NWARPS * 32), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
