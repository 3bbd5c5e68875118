// Row machinery of K9 (rms_norm.cu) and K10 (softmax.cu): the rows of a
// float32 [R, C] matrix under a row plan (ops/rows.py::plan, which the
// wrapper passes in).  Bound on an H100: bytes (each row read once and
// written once); the design keeps every row in registers so that it is
// read from device memory once, and issues all of a thread's loads before
// its first reduction, so a row costs one DRAM round trip, not one per
// loop step.
//
// A row is nv = ceil(C / VW) vectors of VW floats (VW = 4, 16-byte loads,
// where the base is 16-byte aligned and C % 4 == 0; else 1).  It is split
// over `cluster` CTAs of one thread-block cluster (rank k holds vectors
// [k * span, min(nv, (k + 1) * span))), and within a CTA over tpr
// threads: thread t holds vectors k * span + t + j * tpr, j < per.  A
// block holds `rows` whole rows (rows == 1 in a cluster); tpr is a power
// of two up to 32 (a sub-warp or a warp a row) or a multiple of 32 up to
// 1024 (several warps).  A thread holds its per * VW floats in an array
// of HOLD registers, 16 or, where the plan needs more, REGS = 32 (a block
// of 1024 threads has 64 registers a thread); a row longer than a full
// cluster can hold (C > 8 * 1024 * REGS) is streamed in chunks of 16
// floats a thread, read again for each pass.
//
// Every reduction has one fixed order, so every call gives the same bits:
// a thread's HOLD slots (padded with the operation's identity) as a tree,
// first half + second half, down to one; chunks (streamed rows) in order;
// the row's lanes within a warp by xor butterfly (every lane gets the same
// bits); the row's warps in warp order through shared memory; the
// cluster's CTAs in rank order through distributed shared memory.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace qgt {
namespace rows {

constexpr int REGS = 32;         // most floats a thread holds
constexpr int HOLD_MIN = 16;     // floats a thread's array holds at least
constexpr int BLOCK_MAX = 1024;  // threads a block
constexpr int CLUSTER_MAX = 8;   // CTAs a row (portable cluster size)

struct Plan {
  int tpr, rows, cluster, span, per;
};

// The thread's row (live: row < R), its index t among the row's tpr
// threads, its CTA's vectors [v0, v1) of the row.
struct Ctx {
  int row, t, v0, v1;
  bool live;
};

template <bool CL>
__device__ __forceinline__ Ctx ctx(const Plan& p, int R, int nv) {
  Ctx c;
  c.t = static_cast<int>(threadIdx.x) % p.tpr;
  if constexpr (CL) {
    const int rank =
        static_cast<int>(cooperative_groups::this_cluster().block_rank());
    c.row = static_cast<int>(blockIdx.x) / p.cluster;
    c.v0 = rank * p.span;
    c.v1 = min(nv, c.v0 + p.span);
  } else {
    c.row = static_cast<int>(blockIdx.x) * p.rows +
            static_cast<int>(threadIdx.x) / p.tpr;
    c.v0 = 0;
    c.v1 = nv;
  }
  c.live = c.row < R;
  return c;
}

// The row's index of this thread's vector j, or -1 where it holds none.
__device__ __forceinline__ int vec_index(const Ctx& c, const Plan& p, int j) {
  const int i = c.v0 + c.t + j * p.tpr;
  return c.live && j < p.per && i < c.v1 ? i : -1;
}

// Loads this thread's vectors j0 .. j0 + HOLD / VW - 1 of row xr into
// v (slot VW * j + e is element e of vector j0 + j), pad elsewhere; every
// load is issued before any value is used.
template <int VW, int HOLD>
__device__ __forceinline__ void load(const float* __restrict__ xr,
                                     const Ctx& c, const Plan& p, int j0,
                                     float pad, float (&v)[HOLD]) {
#pragma unroll
  for (int j = 0; j < HOLD / VW; ++j) {
    const int i = vec_index(c, p, j0 + j);
    if constexpr (VW == 4) {
      const float4 f = i >= 0 ? __ldg(reinterpret_cast<const float4*>(xr) + i)
                              : make_float4(pad, pad, pad, pad);
      v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z,
      v[4 * j + 3] = f.w;
    } else {
      v[j] = i >= 0 ? __ldg(xr + i) : pad;
    }
  }
}

// Writes this thread's vectors j0 .. of v to row outr, each mapped first
// by g(vector index, its VW values), in place.
template <int VW, int HOLD, typename G>
__device__ __forceinline__ void store(float* __restrict__ outr, const Ctx& c,
                                      const Plan& p, int j0,
                                      const float (&v)[HOLD], G g) {
#pragma unroll
  for (int j = 0; j < HOLD / VW; ++j) {
    const int i = vec_index(c, p, j0 + j);
    if (i < 0) continue;
    float e[VW];
#pragma unroll
    for (int k = 0; k < VW; ++k) e[k] = v[VW * j + k];
    g(i, e);
    if constexpr (VW == 4)
      reinterpret_cast<float4*>(outr)[i] = make_float4(e[0], e[1], e[2], e[3]);
    else
      outr[i] = e[0];
  }
}

// s[i] = op(s[i], s[i + H]) for i < H, then the same for H / 2 .. 1
// (every index a constant, so s stays in registers)
template <int H, int N, typename Op>
__device__ __forceinline__ void fold(float (&s)[N], Op op) {
#pragma unroll
  for (int i = 0; i < H; ++i) s[i] = op(s[i], s[i + H]);
  if constexpr (H > 1) fold<H / 2>(s, op);
}

// The thread's slots reduced as a tree (first half + second half), each
// slot mapped by f first.
template <int HOLD, typename F, typename Op>
__device__ __forceinline__ float tree(const float (&v)[HOLD], F f, Op op) {
  float s[HOLD / 2];
#pragma unroll
  for (int i = 0; i < HOLD / 2; ++i) s[i] = op(f(v[i]), f(v[i + HOLD / 2]));
  fold<HOLD / 4>(s, op);
  return s[0];
}

struct Add {
  __device__ float operator()(float a, float b) const {
    return __fadd_rn(a, b);
  }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// The row's value of a thread's partial v, in every thread of the row:
// the butterfly over the row's lanes, its warps in order (red: 32 floats
// of shared memory), then, in a cluster, its CTAs in rank order (cred:
// this reduction's float in each CTA's shared memory).  Every thread of
// the block (and of the cluster) calls it.
template <bool CL, typename Op>
__device__ __forceinline__ float reduce(float v, Op op, const Plan& p,
                                        float* red, float* cred) {
  const int width = p.tpr < 32 ? p.tpr : 32;
  for (int o = width / 2; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(FULL, v, o));
  if (p.tpr > 32) {
    const int warp = static_cast<int>(threadIdx.x) >> 5, wpr = p.tpr >> 5;
    __syncthreads();  // red may still be read by the last reduction
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int w0 = warp / wpr * wpr;
    v = red[w0];
    for (int i = 1; i < wpr; ++i) v = op(v, red[w0 + i]);
  }
  if constexpr (CL) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    if (threadIdx.x == 0) *cred = v;
    cl.sync();  // release the partials, acquire the others'
    v = *cl.map_shared_rank(cred, 0);
    for (int r = 1; r < p.cluster; ++r)
      v = op(v, *cl.map_shared_rank(cred, r));
  }
  return v;
}

// The two halves of the cluster barrier that keeps every CTA's shared
// memory alive until the cluster's last remote read of it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Whether a plan fits the kernels (ops/rows.py::plan makes only these).
inline bool valid(const Plan& p, int R, int nv, int VW) {
  const bool pow2 = p.tpr >= 1 && p.tpr <= 32 && (p.tpr & (p.tpr - 1)) == 0;
  const bool warps = p.tpr > 32 && p.tpr % 32 == 0 && p.tpr <= BLOCK_MAX;
  const long long block = static_cast<long long>(p.rows) * p.tpr;
  return R >= 1 && nv >= 1 && (pow2 || warps) && p.rows >= 1 &&
         block <= BLOCK_MAX && block % 32 == 0 && p.cluster >= 1 &&
         p.cluster <= CLUSTER_MAX && (p.cluster == 1 || p.rows == 1) &&
         p.span >= 1 &&
         static_cast<long long>(p.span) * p.cluster >= nv &&
         (p.cluster - 1LL) * p.span < nv && p.per >= 1 &&
         static_cast<long long>(p.per) * p.tpr >= p.span &&
         (p.per * VW <= REGS ||
          (p.cluster == CLUSTER_MAX && p.tpr == BLOCK_MAX));
}

// Calls l.run<VW, HOLD, STREAM, CL>() for the plan: HOLD_MIN floats a
// thread where they hold its part of the row, else REGS; a row beyond
// REGS floats a thread streams (in a full cluster) in chunks of HOLD_MIN.
template <int VW, typename L>
int dispatch_vec(const L& l, const Plan& p) {
  const int floats = p.per * VW;
  const bool cl = p.cluster > 1;
  if (floats > REGS) return l.template run<VW, HOLD_MIN, true, true>();
  if (floats > HOLD_MIN)
    return cl ? l.template run<VW, REGS, false, true>()
              : l.template run<VW, REGS, false, false>();
  return cl ? l.template run<VW, HOLD_MIN, false, true>()
            : l.template run<VW, HOLD_MIN, false, false>();
}

template <typename L>
int dispatch(const L& l, int vec, const Plan& p) {
  return vec == 4 ? dispatch_vec<4>(l, p) : dispatch_vec<1>(l, p);
}

// Launches kernel on the plan's grid: rows / block blocks, or R clusters
// of `cluster` CTAs.
template <typename Kernel, typename... Args>
int launch(Kernel* kernel, const Plan& p, int R, cudaStream_t s,
           Args... args) {
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = p.cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster > 1 ? R * p.cluster
                                   : (R + p.rows - 1) / p.rows);
  cfg.blockDim = dim3(p.rows * p.tpr);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = at;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rows
}  // namespace qgt
