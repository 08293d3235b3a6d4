// Foveated (AMR) forward tile compositors: one AMR round's stride-2
// subgrid (blend_round) and the fused pass over rounds 1..level of each
// tile (blend_levels), with per-level instance-stream decimation.
//
// Replaces the TPU kernels of gaussian_splatting_with_eye_tracking_tpu/
// ops/pallas_blend.py:
//   - blend_round_launch: _fwd_kernel (with _blend_stream_loop and
//     _alpha_terms; entry _fwd_call via blend_round_pallas), variant
//     stride=2 with a cell offset (offx, offy) and a counts override;
//   - blend_levels_launch: _fwd_levels_kernel (entry
//     blend_levels_fused_pallas) with `decimation` and `scale_only`, which
//     also covers _fwd_kernel's n_rounds / step / scale_only variants.
// Inputs as blend_fwd.cu takes them, plus per-tile instance counts (the
// range read is [o, o + counts[t])) and, for blend_levels, per-tile
// levels. Round r (0-based) of a tile at origin (ox, oy) is the 16x16
// subgrid x = ox + 2i + offx_r, y = oy + 2j + offy_r with offsets (0,0),
// (1,1), (1,0), (0,1). blend_round writes (T, 256, 8), blend_levels
// (T, 1024, 8) with round r in rows [256r, 256r + 256) for r < level and
// zero rows above the level. The chunk loop, its decimation and its exit
// over all the rows a tile renders are composite.cuh's.
//
// Bound: operations (transcendentals on the special-function units), as
// for K2. The TPU kernel stacked the rounds on the pixel-row axis of a
// (L*256, 128) alpha matrix and branched on the level with four static
// loop variants. Here one CTA of 256 threads owns one tile: thread i owns
// one cell of the 16x16 subgrid, so its pixel in every round the tile
// renders, and a level-L tile gives each thread L pixels. The chunk loop
// is a template on L (1..4) chosen once per CTA (the level is
// block-uniform), which keeps the per-pixel state in registers; the round
// kernel is the same template with L = 1 and its fixed offset. Staging
// (cp.async, double-buffered), the log-domain pre-test and the per-warp
// gate cull come with the shared loop. The design for this card:
//   - warp w owns the 8 x 4 cells at cell column 8 (w % 2), cell row
//     4 (w / 2) (lane i: column i % 8, row i / 8), a 16 x 8 px box at
//     every level, which the gate cull culls against as K2's 16 x 8 px
//     warps (a warp of 32 consecutive cells would span 32 x 4 px); the
//     output keeps the row-major subgrid layout (row = 16 cy + cx);
//   - blend_levels launches heaviest tiles first: blockIdx.x maps
//     through `order`, sorted by the wrapper by descending level x
//     instances (a level-L tile does L times the pixel work);
//   - at most 64 registers (__launch_bounds__(256, 4)): 4 CTAs per SM on
//     every level's path.

#include "composite.cuh"

namespace {

constexpr int SUBW = TILE / 2;       // subgrid width
constexpr int SUBPIX = SUBW * SUBW;  // pixels per round, one per thread
constexpr int MAX_ROUNDS = 4;
static_assert(SUBPIX == THREADS, "one subgrid cell per thread");

// This thread's subgrid cell: warp w owns the 8 x 4 cells at (8 (w % 2),
// 4 (w / 2)), lane i the cell (i % 8, i / 8) of them.
__device__ __forceinline__ int cell_x() { return (threadIdx.x / 32 % 2) * 8 + threadIdx.x % 8; }
__device__ __forceinline__ int cell_y() { return (threadIdx.x / 64) * 4 + threadIdx.x % 32 / 8; }
__device__ __forceinline__ int cell() { return cell_y() * SUBW + cell_x(); }

// This thread's pixel in each of rounds 0..NR-1 of tile t.
template <int NR>
__device__ __forceinline__ void round_pixels(int t, int grid_x, float (&px)[NR],
                                             float (&py)[NR]) {
  const int ox = (t % grid_x) * TILE + 2 * cell_x();
  const int oy = (t / grid_x) * TILE + 2 * cell_y();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    px[r] = (float)(ox + ((r == 1 || r == 2) ? 1 : 0));
    py[r] = (float)(oy + (r & 1));
  }
}

template <int NR>
__device__ __forceinline__ void levels_tile(
    Stage& s, const float* __restrict__ feat, int kp, int o, int n, int t,
    int grid_x, int step, bool scale_only, float* __restrict__ rows) {
  float px[NR], py[NR];
  round_pixels<NR>(t, grid_x, px, py);
  composite<NR>(s, feat, kp, o, n, step, scale_only, px, py, rows, SUBPIX);
}

__global__ void __launch_bounds__(THREADS, 4)
blend_round_kernel(const float* __restrict__ feat, int kp,
                   const int* __restrict__ offsets,
                   const int* __restrict__ counts, int grid_x, int offx,
                   int offy, float* __restrict__ out) {
  __shared__ Stage s;
  const int t = blockIdx.x;
  float px[1], py[1];
  px[0] = (float)((t % grid_x) * TILE + 2 * cell_x() + offx);
  py[0] = (float)((t / grid_x) * TILE + 2 * cell_y() + offy);
  composite<1>(s, feat, kp, offsets[t], counts[t], 1, false, px, py,
               out + ((int64_t)t * SUBPIX + cell()) * OUTC, SUBPIX);
}

__global__ void __launch_bounds__(THREADS, 4)
blend_levels_kernel(const float* __restrict__ feat, int kp,
                    const int* __restrict__ offsets,
                    const int* __restrict__ counts,
                    const int* __restrict__ levels,
                    const int64_t* __restrict__ order, int grid_x, int4 steps,
                    int scale_only, float* __restrict__ out) {
  __shared__ Stage s;
  const int t = (int)order[blockIdx.x];
  const int o = offsets[t];
  const int n = counts[t];
  const int level = levels[t];  // block-uniform: one branch per CTA
  float* rows = out + ((int64_t)t * MAX_ROUNDS * SUBPIX + cell()) * OUTC;
  const bool so = scale_only != 0;
  int rendered = 0;
  switch (level) {
    case 1:
      levels_tile<1>(s, feat, kp, o, n, t, grid_x, steps.x, so, rows);
      rendered = 1;
      break;
    case 2:
      levels_tile<2>(s, feat, kp, o, n, t, grid_x, steps.y, so, rows);
      rendered = 2;
      break;
    case 3:
      levels_tile<3>(s, feat, kp, o, n, t, grid_x, steps.z, so, rows);
      rendered = 3;
      break;
    case 4:
      levels_tile<4>(s, feat, kp, o, n, t, grid_x, steps.w, so, rows);
      rendered = 4;
      break;
    default:
      break;
  }
  for (int r = rendered; r < MAX_ROUNDS; ++r)
    write_row(rows + (int64_t)r * SUBPIX * OUTC, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
}

}  // namespace

extern "C" int blend_round_launch(const void* feat, int kp, const void* offsets,
                                  const void* counts, int num_tiles, int grid_x,
                                  int offx, int offy, void* out, void* stream) {
  blend_round_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, (const int*)counts, grid_x,
      offx, offy, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int blend_levels_launch(const void* feat, int kp, const void* offsets,
                                   const void* counts, const void* levels,
                                   const void* order, int num_tiles, int grid_x,
                                   int step1, int step2, int step3, int step4,
                                   int scale_only, void* out, void* stream) {
  blend_levels_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, (const int*)counts,
      (const int*)levels, (const int64_t*)order, grid_x,
      make_int4(step1, step2, step3, step4), scale_only, (float*)out);
  return (int)cudaGetLastError();
}

// CTAs of blend_levels_kernel resident per SM, as the runtime computes it.
extern "C" int blend_amr_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_levels_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
