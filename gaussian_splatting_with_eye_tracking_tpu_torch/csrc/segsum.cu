// Contiguous-segment row sums (K4) and the per-gaussian gradient
// reduction of the train step that runs through the same loop.
//
//   table mode:  out[r, g] = sum of table[r, c] over c in [bounds[g], bounds[g+1])
//   gather mode: out[r, g] = sum of rec[src[j]][r] over j in [bounds[g], bounds[g+1]),
//                src[j] < 0 adding nothing
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// segsum.py::_segsum_kernel (entry segment_sum_bounds): there each block
// of 128 segments contracted a window of the table with a range-test
// one-hot matrix on the MXU, in 3-limb bf16 splits. The gather mode also
// replaces the id-order permutation in front of it (ops/blend.py's
// id_order_table: a zero-filled (9, S + 1) table and a scatter of the
// backward's gradients into it): in training, rec is the backward
// compositor's per-instance gradients, one 48-byte record per sorted
// instance (blend_bwd.cu), and src maps each gaussian-id-order slot to the
// sorted position of its instance (-1 where max_live dropped it), so the
// kernel reads each instance's 9 gradients in two 32-byte sectors where
// it stands and no table is built.
//
// Bound: bytes. Each value of the segments read once (in gather mode: the
// records' 9 floats and src), the bounds read, the (R, N) sums written;
// one add per value. The design follows the segment lengths: the front
// view's 300k gaussians own 1.36M instances in 524,288 training slots,
// 4.9 per non-empty segment (at most 24), and about half the segments
// empty. One lane owns one segment and walks it in slot order, 4 slots at
// a time: their 4 src entries (neighbouring lanes own neighbouring
// segments, so a warp's loads fall on a short run of src), then 4
// independent record gathers of 3 float4 each, in flight together, then
// the adds in slot order. Each sum is taken in a fixed order (slot
// order, so a second launch gives the same bits, with no atomics); an
// empty segment gives 0. A scratch variant that staged each warp's slots
// in shared memory so that all 32 lanes load whatever the lengths ran
// slower on the front view's shapes (more instructions per slot than the
// idle lanes cost). Bounds are clamped to [0, len] as the plain version
// does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;     // slots of a segment in flight per lane
constexpr int MAXR = 12;  // rows per launch
constexpr int REC = 12;   // floats per record (gather mode)

template <bool GATHER>
__global__ void __launch_bounds__(THREADS)
segsum_kernel(const float* __restrict__ values, int rows, int64_t s,
              const int* __restrict__ src, int64_t len,
              const int* __restrict__ bounds, int n, float* __restrict__ out) {
  const int64_t g = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (g >= n) return;
  auto clamp = [len](int b) { return min(max((int64_t)b, (int64_t)0), len); };
  const int64_t end = clamp(bounds[g + 1]);
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int64_t j = clamp(bounds[g]); j < end; j += U) {
    if constexpr (GATHER) {
      int p[U];
#pragma unroll
      for (int i = 0; i < U; ++i) p[i] = j + i < end ? __ldg(src + j + i) : -1;
      float4 v[U][REC / 4];
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const bool ok = p[i] >= 0 && p[i] < s;  // -1: dropped, adds nothing
        const float4* r4 = reinterpret_cast<const float4*>(values + (int64_t)p[i] * REC);
#pragma unroll
        for (int q = 0; q < REC / 4; ++q)
          v[i][q] = (ok && 4 * q < rows) ? __ldg(r4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int q = 0; q < REC / 4; ++q) {
          acc[4 * q] += v[i][q].x;
          acc[4 * q + 1] += v[i][q].y;
          acc[4 * q + 2] += v[i][q].z;
          acc[4 * q + 3] += v[i][q].w;
        }
    } else {
      float v[U][MAXR];
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          v[i][r] = (r < rows && j + i < end) ? __ldg(values + r * s + j + i) : 0.f;
#pragma unroll
      for (int i = 0; i < U; ++i)
#pragma unroll
        for (int r = 0; r < MAXR; ++r) acc[r] += v[i][r];
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
    if (r < rows) out[(int64_t)r * n + g] = acc[r];
}

}  // namespace

// values: table mode (src null) the (rows, s) row-major table, len = s;
// gather mode the (s, 12) records and src (len,) int32. out (rows, n).
extern "C" int segsum_launch(const void* values, int rows, int64_t s,
                             const void* src, int64_t len, const void* bounds,
                             int n, void* out, void* stream) {
  if (rows < 1 || rows > MAXR) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((int64_t)n + THREADS - 1) / THREADS);
  if (src == nullptr)
    segsum_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)values, rows, s, nullptr, s, (const int*)bounds, n, (float*)out);
  else
    segsum_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)values, rows, s, (const int*)src, len, (const int*)bounds, n,
        (float*)out);
  return (int)cudaGetLastError();
}

// CTAs of the gather-mode kernel resident per SM, as the runtime computes
// it.
extern "C" int segsum_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, segsum_kernel<true>, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
