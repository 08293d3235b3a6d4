// Forward tile compositor (K2): front-to-back log-space alpha blending of
// each 32x32 tile's depth-sorted instance range.
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// pallas_blend.py::_fwd_kernel (with _blend_stream_loop and _alpha_terms;
// entry _fwd_call), variant stride=1, n_rounds=0, step=1. Input: the
// (16, kp) feature array, the (T+1) offsets and a launch order (T,) of the
// tiles; output (T, 1024, 8), one row per pixel of the tile in row-major
// order. The chunk loop and what it reproduces exactly are composite.cuh's.
//
// Bound: operations. Each (pixel, in-range instance) pair costs ~10 fp32
// flops for its power and gate test; a pair that passes the log-domain
// gate an exp, and one past the alpha gate a log, an exp and ~11 flops
// more: the special-function units and instruction issue bound it, not
// bytes (~116 MB on the front view). The TPU kernel evaluated a (1024,
// 128) alpha matrix per chunk on the vector unit and ran the transmittance
// recurrence as MXU triangular-matrix products. Here the design cuts the
// instructions:
//   - the exp only after the log-domain pre-test (stage.cuh), so the ~2/3
//     of pairs that fail the gate cost no transcendental; past the gate,
//     w's exp and log(1 - alpha) are the special-function unit's __expf /
//     __logf (2 instructions each, not ~10-20; the gate's exp stays IEEE
//     expf, so the kept set is exact);
//   - compact warp footprints: warp w owns the 16x8 block at column
//     16 (w % 2), row 8 (w / 2) of the tile, lane i its column i % 16 and
//     rows i / 16 + 2j, j = 0..3; a warp skips every instance whose gate
//     extent misses its block (stage.cuh), with no divergence;
//   - heaviest tiles first: blockIdx.x maps through `order`, which the
//     wrapper sorts by descending instance count (one subtraction and one
//     sort of T values: the exact chunk count costs a dozen more small
//     launches on a host-bound path), so the dense centre's tiles start in
//     the first wave instead of setting the tail;
//   - cp.async double-buffered staging by all threads;
//   - 256 threads, ~12 KB of shared memory, at most 64 registers
//     (__launch_bounds__(256, 4)): at least 4 CTAs per SM.

#include "composite.cuh"

namespace {

constexpr int PIX = TILE * TILE;
constexpr int PPT = PIX / THREADS;  // pixels per thread

__global__ void __launch_bounds__(THREADS, 4)
blend_fwd_kernel(const float* __restrict__ feat, int kp,
                 const int* __restrict__ offsets, const int64_t* __restrict__ order,
                 int grid_x, float* __restrict__ out) {
  __shared__ Stage s;
  const int t = (int)order[blockIdx.x];
  const int o = offsets[t];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (warp % 2) * 16 + lane % 16;  // pixel column in the tile
  const int row = (warp / 2) * 8 + lane / 16;   // row of pixel 0; pixel j 2j below
  float px[PPT], py[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    px[j] = (float)((t % grid_x) * TILE + col);
    py[j] = (float)((t / grid_x) * TILE + row + 2 * j);
  }
  composite<PPT>(s, feat, kp, o, offsets[t + 1] - o, 1, false, px, py,
                 out + ((int64_t)t * PIX + row * TILE + col) * OUTC, 2 * TILE);
}

}  // namespace

extern "C" int blend_fwd_launch(const void* feat, int kp, const void* offsets,
                                const void* order, int num_tiles, int grid_x,
                                void* out, void* stream) {
  blend_fwd_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, (const int64_t*)order, grid_x,
      (float*)out);
  return (int)cudaGetLastError();
}

// CTAs of blend_fwd_kernel resident per SM, as the runtime computes it.
extern "C" int blend_fwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_fwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
