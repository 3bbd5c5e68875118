// Shared device code of the attention kernels (flash_decode.cu,
// flash_prefill.cu): staging one tile of cache rows, bf16 or int8, into
// shared memory as float32, and the slot ranges a ring cache's window
// covers.  Plain C interface, no PyTorch headers.
#pragma once

#include <float.h>

#include <type_traits>

#include "common.cuh"

namespace qgt {

constexpr int TS = 32;  // cache rows per tile (one per lane)

// x mod r in [0, r) for r > 0, also for negative x.
__device__ __forceinline__ int ring_mod(int x, int r) {
  const int m = x % r;
  return m < 0 ? m + r : m;
}

// Cache slots as at most two contiguous ranges [a[0], e[0]) and [a[1],
// e[1]), walked in that order.
struct SlotRanges {
  int a[2], e[2];
};

// The slots of a ring of R slots (token g at slot g mod R) that hold the n
// positions ending at global position p: the modular interval
// [(p - n + 1) mod R, p mod R], which is one range, or two when it wraps
// past slot R - 1 ([r_lo, R) then [0, r_hi]).  Empty for n <= 0, the whole
// ring for n >= R.  So a walk over them visits O(n) slots, not O(R).
__device__ __forceinline__ SlotRanges ring_ranges(int p, int n, int R) {
  SlotRanges r{{0, 0}, {0, 0}};
  if (n <= 0) return r;
  if (n >= R) {
    r.e[0] = R;
    return r;
  }
  const int hi = ring_mod(p, R), lo = ring_mod(p - n + 1, R);
  r.a[0] = lo;
  if (lo <= hi) {
    r.e[0] = hi + 1;
  } else {
    r.e[0] = R;
    r.e[1] = hi + 1;
  }
  return r;
}

// Stage cache rows [s0, s0 + cnt) of one head as float32: K into kt with
// row stride kp, V into vt with row stride HD.  Each thread loads 8
// elements of a row at a time (16 bytes of bf16, 8 of int8 codes), so
// both caches spread a tile over as many threads, each storing 8 floats
// per load.  Int8 codes convert exactly; with Q8 the rows' scales go to
// kst/vst (one float each), which the caller applies to the scores and to
// p, as the TPU kernel does, never to the codes.
template <int HD, bool Q8>
__device__ __forceinline__ void stage_kv(const void* kbase, const void* vbase,
                                         const float* kscale,
                                         const float* vscale, int s0, int cnt,
                                         float* kt, int kp, float* vt,
                                         float* kst, float* vst) {
  using Elem = typename std::conditional<Q8, int8_t, __nv_bfloat16>::type;
  using Vec = typename std::conditional<Q8, uint2, uint4>::type;
  constexpr int PER = 8;  // elements per load
  const Elem* kb = static_cast<const Elem*>(kbase);
  const Elem* vb = static_cast<const Elem*>(vbase);
  for (int e = threadIdx.x; e < cnt * (HD / PER); e += blockDim.x) {
    const int j = e / (HD / PER), c = (e % (HD / PER)) * PER;
    const size_t off = static_cast<size_t>(s0 + j) * HD + c;
    const Vec kr = __ldg(reinterpret_cast<const Vec*>(kb + off));
    const Vec vr = __ldg(reinterpret_cast<const Vec*>(vb + off));
    const Elem* kh = reinterpret_cast<const Elem*>(&kr);
    const Elem* vh = reinterpret_cast<const Elem*>(&vr);
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      if constexpr (Q8) {
        kt[j * kp + c + t] = static_cast<float>(kh[t]);
        vt[j * HD + c + t] = static_cast<float>(vh[t]);
      } else {
        kt[j * kp + c + t] = __bfloat162float(kh[t]);
        vt[j * HD + c + t] = __bfloat162float(vh[t]);
      }
    }
  }
  if constexpr (Q8) {
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) {
      kst[j] = kscale[s0 + j];
      vst[j] = vscale[s0 + j];
    }
  }
}

}  // namespace qgt
