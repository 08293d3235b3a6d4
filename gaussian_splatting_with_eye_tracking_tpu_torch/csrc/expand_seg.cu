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
// (16 x 1.64M x 4 B + 16 x 300k x 4 B ~ 124 MB at the 1080p scene, ~37 us
// at 3.35 TB/s); K6 reads ck as well (4 B a slot more). The TPU kernels
// built a one-hot selection matrix and ran three bf16-limb MXU products
// to move data exactly, over DMA'd column windows; here one thread owns
// one output slot, finds its column (K1: binary search over the compact
// seg row, N floats, L2-resident and shared by neighbouring threads; K6:
// one coalesced read of ck), and copies the rows with stores that are
// coalesced across the warp (neighbouring threads write neighbouring j of
// each row). Because the column index is nondecreasing in j, the loads of
// a warp hit the same or adjacent table columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void copy_column(const float* __restrict__ table,
                                            int rows, int nc, int c,
                                            float* __restrict__ out, int k,
                                            int j) {
  for (int r = 0; r < rows; ++r) {
    out[(int64_t)r * k + j] = __ldg(table + (int64_t)r * nc + c);
  }
}

__global__ void expand_seg_kernel(const float* __restrict__ table, int rows,
                                  int nc, int seg_row,
                                  float* __restrict__ out, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const float* seg = table + (int64_t)seg_row * nc;
  const float v = (float)j;  // exact: k < 2^24
  // upper_bound: first index with seg[i] > v
  int lo = 0, hi = nc;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(seg + mid) > v) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  int c = lo - 1;
  c = c < 0 ? 0 : (c > nc - 1 ? nc - 1 : c);
  copy_column(table, rows, nc, c, out, k, j);
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
  const int threads = 256;
  const int blocks = (k + threads - 1) / threads;
  expand_seg_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
