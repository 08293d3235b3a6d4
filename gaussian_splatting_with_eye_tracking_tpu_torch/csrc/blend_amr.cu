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
//   - blend_round launches through one order per 5-step frame, sorted by
//     descending (level, instances): each round's tiles (level >= round)
//     are a prefix of it, heaviest first, and the tiles a round skips
//     (count 0) form a tail whose CTAs write their empty rows and exit
//     without staging or a barrier;
//   - a round with few tiles (the fovea's rounds 3 and 4 hold ~224 and ~56
//     of 2,040 tiles at 1920x1088, under half a wave) is as long as its
//     heaviest tile's serial chunk stream; blend_round_split_kernel<S>
//     splits each tile's chunks over a thread-block cluster of S CTAs
//     and keeps the tile-wide exit after every chunk (round_tile_split);
//   - at most 64 registers (__launch_bounds__(256, 4)): 4 CTAs per SM on
//     every level's path.

#include <cooperative_groups.h>

#include "composite.cuh"

namespace cg = cooperative_groups;

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

// The round's pixel of this thread in tile t.
__device__ __forceinline__ void round_pixel(int t, int grid_x, int offx, int offy,
                                            float (&px)[1], float (&py)[1]) {
  px[0] = (float)((t % grid_x) * TILE + 2 * cell_x() + offx);
  py[0] = (float)((t / grid_x) * TILE + 2 * cell_y() + offy);
}

// A tile the round does not render (count 0): its rows as the chunk loop
// leaves them, written at once (no staging, no barrier).
__device__ __forceinline__ void empty_row(float* __restrict__ row) {
  write_row(row, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f);
}

__global__ void __launch_bounds__(THREADS, 4)
blend_round_kernel(const float* __restrict__ feat, int kp,
                   const int* __restrict__ offsets,
                   const int* __restrict__ counts,
                   const int64_t* __restrict__ order, int grid_x, int offx,
                   int offy, float* __restrict__ out) {
  __shared__ Stage s;
  const int t = (int)order[blockIdx.x];
  const int n = counts[t];
  float* row = out + ((int64_t)t * SUBPIX + cell()) * OUTC;
  if (n <= 0) {  // block-uniform
    empty_row(row);
    return;
  }
  float px[1], py[1];
  round_pixel(t, grid_x, offx, offy, px, py);
  composite<1>(s, feat, kp, offsets[t], n, 1, false, px, py, row, SUBPIX);
}

// The shared memory of the split round kernel.
struct SplitShared {
  Stage s;
  float chunk_log[2][THREADS];  // a chunk's L_c per pixel, by group parity
  float colour[3][THREADS];     // this CTA's kept colour sums
  int warp_alive[2][WARPS];
};

// One round of tile t (count n > 0) split over the S CTAs of this
// cluster. CTA `rank` composites the tile's chunks rank, rank + S,
// rank + 2S, ...: each the same chunk loop as composite<1> (staging,
// pre-test, cull) but with the transmittance counted from the chunk's
// start, so it yields the chunk's colour sum C_c and its total
// log(1 - alpha) L_c for each of the 256 pixels. After each group of S
// chunks the cluster barrier publishes the L_c in shared memory; every
// CTA reads the group's S values of each pixel through distributed shared
// memory and runs the sequential chunk loop's bookkeeping over them in
// chunk order: logT before and after each chunk (the same sums in the
// same order, so logT, final_T and the chunks run are the one-CTA
// kernel's bits) and the tile's exit, the first chunk after which no
// pixel has logT >= ln 1e-4 (a block reduction of the per-pixel alive
// counts: logT never rises, so "alive after chunk q" is a prefix). Chunks
// past the exit are dropped; each kept chunk adds exp(logT before it) *
// C_c. At the end rank 0 sums the S CTAs' colours in rank order and
// writes the rows. A chunk's weights are exp(logT) * exp(local) for the
// one-CTA kernel's exp(logT + local): rgb differs from it by rounding.
template <int S>
__device__ __forceinline__ void round_tile_split(
    SplitShared& sh, cg::cluster_group& cluster, const float* __restrict__ feat, int kp,
    int o, int n, int t, int grid_x, int offx, int offy, float* __restrict__ row) {
  Stage& s = sh.s;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int start = (o / CHUNK) * CHUNK;
  const int n_chunks = (o + n - start + CHUNK - 1) / CHUNK;
  float px[1], py[1];
  round_pixel(t, grid_x, offx, offy, px, py);
  warp_box<1>(s, px, py);
  int c = rank;  // this CTA's chunk of the current group
  if (c < n_chunks) stage_async(s.raw[0], feat, kp, start + c * CHUNK);
  cp_async_wait_all();
  __syncthreads();

  float log_t = 0.f, ar = 0.f, ag = 0.f, ab = 0.f;
  int done = n_chunks;
  int buf = 0;
  for (int g0 = 0; g0 < n_chunks; g0 += S, c += S, buf ^= 1) {
    if (c < n_chunks) {  // CTA-uniform
      if (c + S < n_chunks) stage_async(s.raw[buf ^ 1], feat, kp, start + (c + S) * CHUNK);
      prepare(s, buf, start + c * CHUNK, o, n);
    }
    __syncthreads();
    float cr = 0.f, cg_ = 0.f, cb = 0.f, local = 0.f;
    if (c < n_chunks) {
      const float(&f)[NROW][CHUNK] = s.raw[buf];
#pragma unroll
      for (int q = 0; q < CHUNK / 32; ++q) {
        unsigned bits = warp_bits(s, q);
        while (bits) {
          const int l = q * 32 + __ffs(bits) - 1;
          bits &= bits - 1u;
          const float dx = f[0][l] - px[0];
          const float dy = f[1][l] - py[0];
          const float power = gate_power(s.ha[l], s.nb[l], s.hc[l], dx, dy);
          const float g = power + s.lo[l];
          if (g >= LOG_GATE && power <= 0.f) {
            const float alpha_raw = expf(g);  // IEEE expf: the gate is exact
            if (alpha_raw >= ALPHA_MIN) {
              const float alpha = fminf(ALPHA_MAX, alpha_raw);
              const float w = alpha * __expf(local);
              cr += w * f[5][l];
              cg_ += w * f[6][l];
              cb += w * f[7][l];
              local += __logf(1.f - alpha);
            }
          }
        }
      }
    }
    sh.chunk_log[buf][tid] = local;
    cp_async_wait_all();
    cluster.sync();  // the group's L_c, and the next chunk's copy, are visible

    // the sequential loop's bookkeeping over the group's chunks, in order
    const int ng = min(S, n_chunks - g0);
    float lt = log_t, before = 0.f, after[S];
    int alive = 0;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      after[q] = lt;
      if (q < ng) {
        if (q == rank) before = lt;
        lt += (q == rank) ? local : cluster.map_shared_rank(&sh.chunk_log[buf][0], q)[tid];
        after[q] = lt;
        if (lt >= LOG_T_MIN) alive = q + 1;
      }
    }
    alive = __reduce_max_sync(FULL, alive);
    if (tid % 32 == 0) sh.warp_alive[buf][tid / 32] = alive;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) alive = max(alive, sh.warp_alive[buf][w]);
    // the tile runs chunk g0 + q while it was alive after every chunk
    // before it; it exits after the first chunk past which no pixel is
    const bool exits = alive < ng;
    const int run = exits ? alive + 1 : ng;
    if (rank < run) {
      const float e = expf(before);
      ar += e * cr;
      ag += e * cg_;
      ab += e * cb;
    }
#pragma unroll
    for (int q = 0; q < S; ++q)
      if (q == run - 1) log_t = after[q];
    if (exits) {
      done = g0 + run;
      break;
    }
  }

  sh.colour[0][tid] = ar;
  sh.colour[1][tid] = ag;
  sh.colour[2][tid] = ab;
  cluster.sync();
  if (rank == 0) {
    float r = 0.f, g = 0.f, b = 0.f;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const float* cq = cluster.map_shared_rank(&sh.colour[0][0], q);
      r += cq[tid];
      g += cq[THREADS + tid];
      b += cq[2 * THREADS + tid];
    }
    write_row(row, r, g, b, expf(log_t), (float)done, log_t);
  }
  cluster.sync();  // every CTA's shared memory stays until rank 0 has read it
}

// A round with each tile split over a cluster of S CTAs: cluster q takes
// the tile order[q]. The round's tiles are a prefix of the order; a tile
// it skips (count 0) is written empty by the cluster's first CTA, and the
// others exit at once. (Clusters that each walk a stride of the order,
// as many as fit on the card, ran slower: a heavy tile's cluster then
// also writes a share of the empty tiles after it.)
template <int S>
__global__ void __launch_bounds__(THREADS, 4)
blend_round_split_kernel(const float* __restrict__ feat, int kp,
                         const int* __restrict__ offsets,
                         const int* __restrict__ counts,
                         const int64_t* __restrict__ order, int grid_x, int offx,
                         int offy, float* __restrict__ out) {
  __shared__ SplitShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int t = (int)order[blockIdx.x / S];
  const int n = counts[t];  // cluster-uniform
  float* row = out + ((int64_t)t * SUBPIX + cell()) * OUTC;
  if (n <= 0) {
    if (cluster.block_rank() == 0) empty_row(row);
    return;
  }
  round_tile_split<S>(sh, cluster, feat, kp, offsets[t], n, t, grid_x, offx, offy, row);
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

template <int S>
cudaError_t launch_round_split(const float* feat, int kp, const int* offsets,
                               const int* counts, const int64_t* order, int num_tiles,
                               int grid_x, int offx, int offy, float* out,
                               cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * S);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, blend_round_split_kernel<S>, feat, kp, offsets, counts,
                            order, grid_x, offx, offy, out);
}

extern "C" int blend_round_launch(const void* feat, int kp, const void* offsets,
                                  const void* counts, const void* order, int num_tiles,
                                  int grid_x, int offx, int offy, int split, void* out,
                                  void* stream) {
  const float* f = (const float*)feat;
  const int* off = (const int*)offsets;
  const int* cnt = (const int*)counts;
  const int64_t* ord = (const int64_t*)order;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (split) {
    case 1:
      blend_round_kernel<<<num_tiles, THREADS, 0, st>>>(f, kp, off, cnt, ord, grid_x, offx,
                                                        offy, o);
      break;
    case 2:
      return (int)launch_round_split<2>(f, kp, off, cnt, ord, num_tiles, grid_x, offx, offy, o, st);
    case 4:
      return (int)launch_round_split<4>(f, kp, off, cnt, ord, num_tiles, grid_x, offx, offy, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
