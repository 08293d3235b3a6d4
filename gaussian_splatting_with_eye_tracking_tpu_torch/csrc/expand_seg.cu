// Column expands of a compact (rows, nc) float32 table into (rows, k):
// out[r, j] = table[r, c(j)]. Two ways to find c(j), one row copy.
//
// K1, expand_seg_launch, replaces the TPU kernel gaussian_splatting_with_
// eye_tracking_tpu/ops/expand.py::_expand_seg_kernel (entry
// expand_rows_by_segments):
//   c = clamp(upper_bound(seg, j) - 1, 0, nc - 1)
// for every output slot j < k, where seg = table[seg_row] holds each
// column's exact-int segment start as float32, nondecreasing, +inf on
// columns that own no slots. Slots past the last segment resolve to the
// last live column (callers mask them); with no live column every slot
// copies column 0.
//
// K6, expand_rows_launch, replaces the TPU kernel gaussian_splatting_with_
// eye_tracking_tpu/ops/expand.py::_expand_kernel (entry expand_rows):
//   c = clamp(ck[j], 0, nc - 1)
// for a given int32 index vector ck (nondecreasing in every caller).
//
// Both are pure copies: bit-exact.
//
// Bound: bytes. K1 writes rows * k * 4 bytes and reads the table once
// (16 x 1.64M x 4 B + 16 x 278k live columns x 4 B ~ 123 MB at the 1080p
// scene, ~37 us at 3.35 TB/s); K6 reads ck as well (4 B a slot more). The
// TPU kernels built a one-hot selection matrix and ran three bf16-limb
// MXU products to move data exactly, over DMA'd column windows.
//
// K1's design for this card: a block-level load-balancing search
// (segsearch.cuh, shared with K8 in binning.cu). Each CTA owns a run of
// K1_RUN (2,048) consecutive slots. Two warps find the run's first and
// last slots' columns with a 32-ary warp search over the seg row (five rounds of 32 loads where a thread-per-slot binary search
// made ~19 dependent loads per slot). The segment starts are
// nondecreasing, so every slot of the run falls in that column window;
// the CTA stages the window's rows (one table column per thread and row,
// coalesced) into shared memory, each thread resolves its two groups of
// 4 consecutive slots there (a binary search for a group's first slot,
// then a forward walk), and writes each output row of a group with one
// 16-byte streaming store (a warp writes 512 contiguous bytes per row,
// marked evict-first: the 105 MB output would otherwise push the table
// out of L2; 4-byte stores where k is not a multiple of 4 and at the end
// of the last run). A window wider than K1_WMAX columns (many one-slot
// columns) or more than K1_ROWS rows takes the same search in global
// memory and copies from there: still exact. A column that owns more
// slots than a run gives a one-column window.
//
// K6 keeps one thread per slot: one coalesced read of ck, then the rows'
// copy with stores coalesced across the warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segsearch.cuh"

namespace {

__device__ __forceinline__ void copy_column(const float* __restrict__ table,
                                            int rows, int nc, int c,
                                            float* __restrict__ out, int k,
                                            int j) {
  for (int r = 0; r < rows; ++r) {
    out[(int64_t)r * k + j] = __ldg(table + (int64_t)r * nc + c);
  }
}

constexpr int K1_THREADS = 256;
constexpr int K1_GROUP = 4;   // consecutive slots of a thread: one float4 per row
constexpr int K1_GROUPS = 2;  // groups per thread, K1_THREADS * K1_GROUP slots apart
constexpr int K1_RUN = K1_THREADS * K1_GROUP * K1_GROUPS;  // slots per CTA
constexpr int K1_ROWS = 16;   // rows staged
constexpr int K1_WMAX = 512;  // columns staged: 32 KB of shared memory, 6 CTAs per SM

__global__ void __launch_bounds__(K1_THREADS, 6)
expand_seg_kernel(const float* __restrict__ table, int rows, int nc, int seg_row,
                  float* __restrict__ out, int k) {
  __shared__ float win[K1_ROWS][K1_WMAX];
  __shared__ int ub[2];
  const float* __restrict__ seg = table + (int64_t)seg_row * nc;
  const int run0 = blockIdx.x * K1_RUN;
  const int run_last = min(run0 + K1_RUN, k) - 1;
  const int warp = threadIdx.x / 32;
  if (warp < 2) {  // floats are exact: k < 2^24
    const int u = warp_upper_bound(seg, nc, (float)(warp == 0 ? run0 : run_last));
    if (threadIdx.x % 32 == 0) ub[warp] = u;
  }
  __syncthreads();
  // every slot j of the run has upper_bound(j) in [u0, u1] and reads a
  // column of [c_lo, c_hi] (c = clamp(upper_bound - 1, 0, nc - 1))
  const int u0 = ub[0], u1 = ub[1];
  const int c_lo = max(u0 - 1, 0);
  const int c_hi = min(max(u1 - 1, 0), nc - 1);
  const int width = c_hi - c_lo + 1;
  if (rows <= K1_ROWS && width <= K1_WMAX) {  // block-uniform
    for (int i = threadIdx.x; i < rows * width; i += K1_THREADS) {
      const int r = i / width, c = i - r * width;
      win[r][c] = __ldg(table + (int64_t)r * nc + c_lo + c);
    }
    __syncthreads();
    const float* wseg = win[seg_row];
    auto sseg = [&](int i) { return wseg[i - c_lo]; };
#pragma unroll
    for (int g = 0; g < K1_GROUPS; ++g) {
      const int j = run0 + g * (K1_THREADS * K1_GROUP) + threadIdx.x * K1_GROUP;
      if (j >= k) break;
      int cols[K1_GROUP];
      int u = upper_bound_in(sseg, u0, u1, (float)j);
#pragma unroll
      for (int q = 0; q < K1_GROUP; ++q) {
        while (u < u1 && sseg(u) <= (float)(j + q)) ++u;
        cols[q] = min(max(u - 1, 0), nc - 1) - c_lo;
      }
      if ((k & 3) == 0 && j + K1_GROUP <= k) {  // 16-byte aligned rows
        for (int r = 0; r < rows; ++r) {
          const float* w = win[r];
          __stcs(reinterpret_cast<float4*>(out + (int64_t)r * k + j),
                 make_float4(w[cols[0]], w[cols[1]], w[cols[2]], w[cols[3]]));
        }
      } else {
        for (int q = 0; q < K1_GROUP && j + q < k; ++q)
          for (int r = 0; r < rows; ++r) __stcs(out + (int64_t)r * k + j + q, win[r][cols[q]]);
      }
    }
    return;
  }
  // the same search in global memory, 4-byte stores
  auto gseg = [&](int i) { return __ldg(seg + i); };
  for (int g = 0; g < K1_GROUPS; ++g) {
    const int j = run0 + g * (K1_THREADS * K1_GROUP) + threadIdx.x * K1_GROUP;
    if (j >= k) break;
    int u = upper_bound_in(gseg, u0, u1, (float)j);
    for (int q = 0; q < K1_GROUP && j + q < k; ++q) {
      while (u < u1 && gseg(u) <= (float)(j + q)) ++u;
      copy_column(table, rows, nc, min(max(u - 1, 0), nc - 1), out, k, j + q);
    }
  }
}

__global__ void expand_rows_kernel(const float* __restrict__ table, int rows,
                                   int nc, const int* __restrict__ ck,
                                   float* __restrict__ out, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  int c = __ldg(ck + j);
  c = c < 0 ? 0 : (c > nc - 1 ? nc - 1 : c);
  copy_column(table, rows, nc, c, out, k, j);
}

}  // namespace

extern "C" int expand_seg_launch(const void* table, int rows, int nc,
                                 int seg_row, void* out, int k,
                                 void* stream) {
  const int blocks = (k + K1_RUN - 1) / K1_RUN;
  expand_seg_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, rows, nc, seg_row, (float*)out, k);
  return (int)cudaGetLastError();
}

extern "C" int expand_rows_launch(const void* table, int rows, int nc,
                                  const void* ck, void* out, int k,
                                  void* stream) {
  const int threads = 256;
  const int blocks = (k + threads - 1) / threads;
  expand_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)table, rows, nc, (const int*)ck, (float*)out, k);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
