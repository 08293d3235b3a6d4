// Contiguous-segment row sums (K4): out[r, g] = sum of table[r, c] over
// c in [bounds[g], bounds[g+1]).
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// segsum.py::_segsum_kernel (entry segment_sum_bounds): there each block
// of 128 segments contracted a window of the table with a range-test
// one-hot matrix on the MXU, in 3-limb bf16 splits. Here a group of 8
// lanes owns one segment: lane k of the group sums columns b0+k, b0+k+8,
// ... in order, then a 3-step shuffle tree adds the 8 partial sums. Every
// sum is taken in a fixed order, so the result is deterministic; an empty
// segment gives 0. Bounds are clamped to [0, S] as the plain version does.
//
// Bound: bytes (each table column of the segments read once, the (R, N)
// result written once; one add per element read). Neighbouring groups own
// neighbouring segments, so a warp's loads of one row fall on a short
// contiguous run of columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 8;  // lanes per segment
constexpr int MAXR = 16;  // rows the kernel is built for
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ table, int rows, int64_t s,
              const int* __restrict__ bounds, int n, float* __restrict__ out) {
  const int64_t g = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / GROUP;
  const int sub = threadIdx.x % GROUP;
  int64_t b0 = 0, b1 = 0;
  if (g < n) {  // no early return: every lane takes part in the shuffles
    b0 = min(max((int64_t)bounds[g], (int64_t)0), s);
    b1 = min(max((int64_t)bounds[g + 1], (int64_t)0), s);
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int64_t c = b0 + sub; c < b1; c += GROUP) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < rows) acc[r] += table[r * s + c];
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r < rows) {  // rows is uniform over the grid
      float v = acc[r];
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1)
        v += __shfl_down_sync(FULL, v, off, GROUP);
      if (sub == 0 && g < n) out[(int64_t)r * n + g] = v;
    }
  }
}

}  // namespace

extern "C" int segsum_launch(const void* table, int rows, int64_t s,
                             const void* bounds, int n, void* out,
                             void* stream) {
  if (rows < 1 || rows > MAXR) return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)n * GROUP;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  segsum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)table, rows, s, (const int*)bounds, n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
