// The block-level search over segment starts shared by K1 (expand_seg.cu)
// and K8 (binning.cu): a CTA owns a run of consecutive slots; two warps
// find the run's first and last slots' segments with a 32-ary warp search
// over the nondecreasing segment starts (five rounds of 32 loads where a
// thread-per-slot binary search makes ~20 dependent loads a slot); every
// slot of the run then resolves inside that window, by a binary search
// over the window staged in shared memory (or, where it is too wide, in
// global memory).

#pragma once

#include <cuda_runtime.h>

namespace {

// First index i in [0, n) with seg[i] > v, or n (seg nondecreasing): a
// 32-ary search by the whole warp, the same answer in every lane.
template <typename T>
__device__ __forceinline__ int warp_upper_bound(const T* __restrict__ seg, int n, T v) {
  const int lane = threadIdx.x % 32;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int first = lo + lane * step;
    const int last = min(first + step, hi) - 1;
    const unsigned m = __ballot_sync(0xffffffffu, first < hi && __ldg(seg + last) > v);
    if (m == 0u) return hi;
    const int piece = __ffs(m) - 1;
    hi = min(lo + (piece + 1) * step, hi) - 1;
    lo = lo + piece * step;
  }
  const int q = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, q < hi && __ldg(seg + q) > v);
  return m ? lo + __ffs(m) - 1 : hi;
}

// First index in [lo, hi) with seg(i) > v, or hi (seg nondecreasing).
template <typename Seg, typename T>
__device__ __forceinline__ int upper_bound_in(Seg seg, int lo, int hi, T v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg(mid) > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

}  // namespace
