// Forward tile compositor (K2): front-to-back log-space alpha blending of
// each 32x32 tile's depth-sorted instance range.
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// pallas_blend.py::_fwd_kernel (with _blend_stream_loop and _alpha_terms;
// entry _fwd_call), variant stride=1, n_rounds=0, step=1. Input: the
// (16, kp) feature array and the (T+1) offsets; output (T, 1024, 8), one
// row per pixel of the tile in row-major order. The chunk loop and what it
// reproduces exactly are composite.cuh's.
//
// Bound: operations. Each (pixel, in-range instance) pair of the chunks a
// tile runs costs ~10 fp32 flops, an exp where power <= 0, and a log, an
// exp and ~11 flops more where it passes the alpha gate; the
// special-function units bound it. The TPU kernel evaluated a
// (1024, 128) alpha matrix per chunk on the vector unit and ran the
// transmittance recurrence as MXU triangular-matrix products; here one
// CTA owns one tile and each of its 256 threads owns 4 pixels, rows
// tid / 32 + 8j of column tid % 32.

#include "composite.cuh"

namespace {

constexpr int PIX = TILE * TILE;
constexpr int PPT = PIX / THREADS;  // pixels per thread

__global__ void __launch_bounds__(THREADS)
blend_fwd_kernel(const float* __restrict__ feat, int kp,
                 const int* __restrict__ offsets, int grid_x,
                 float* __restrict__ out) {
  __shared__ Stage s;
  const int t = blockIdx.x;
  const int o = offsets[t];
  const int ox = (t % grid_x) * TILE;
  const int oy = (t / grid_x) * TILE;
  float px[PPT], py[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {  // pixel p = tid + 256 j of the tile
    px[j] = (float)(ox + threadIdx.x % TILE);
    py[j] = (float)(oy + threadIdx.x / TILE + j * (THREADS / TILE));
  }
  composite<PPT>(s, feat, kp, o, offsets[t + 1] - o, 1, false, px, py,
                 out + ((int64_t)t * PIX + threadIdx.x) * OUTC);
}

}  // namespace

extern "C" int blend_fwd_launch(const void* feat, int kp, const void* offsets,
                                int num_tiles, int grid_x, void* out,
                                void* stream) {
  blend_fwd_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, grid_x, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
