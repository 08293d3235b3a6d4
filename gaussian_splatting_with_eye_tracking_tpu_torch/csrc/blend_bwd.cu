// Backward tile compositor (K3): replays each 32x32 tile's depth-sorted
// instance range back to front and writes every instance's gradients.
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// pallas_blend.py::_bwd_kernel (entry _bwd_call). Inputs: the (16, kp)
// struct-of-arrays feature array [x, y, conic a, b, c, r, g, b, opacity,
// gauss_id, pad...] in depth-sorted CSR order, the (T+1) offsets, a launch
// order (T,) of the tiles, the forward's (T, 1024, 8) output (col 3
// final_T, col 4 chunks_done, col 5 logT) and the (T, 1024, 8) cotangent
// (cols 0-2 dL/dcolor without the background, col 3 dL/dfinal_T). Output
// kp records of 12 floats (48 bytes; segsum.cu's gather reads one in two
// 32-byte sectors): record i holds dL/d[x, y, conic a, b, c, r, g, b,
// opacity] of sorted position i, then 3 zeros. Every record is written:
// zeros where no pixel kept the instance, on chunks past chunks_done and
// outside every tile's range, so the output needs no fill.
// What it reproduces of the TPU kernel:
//   - chunks aligned to GLOBAL multiples of 128, lanes outside [o, o+n)
//     masked through log(op) = -inf, the forward's alpha gate;
//   - chunks at or past chunks_done get zero gradient (they are not
//     replayed; their records are written as zeros);
//   - transmittance rebuilt in log space from the forward's final logT
//     (cur -= log(1 - alpha) walking back), never by division by final_T;
//   - the suffix accumulator S seeded with dL/dT_final * final_T;
//   - d_power = w*G - alpha/(1-alpha)*S on lanes with keep && alpha_raw <
//     0.99 (else 0), with G = dL/dcolor . rgb and w = alpha*T;
//   - d_opacity = sum d_power / op.
// Unlike the TPU kernel it forms sum d_power*dx (and dy, dx^2, dx*dy,
// dy^2) directly per pixel, not from tile-local moment matmuls (expanding
// dx = fx - px around pixel coordinates of ~1e3 would cancel; the TPU
// needed bf16 limb splits for it), and writes each instance at its own
// sorted position: tile ranges are disjoint, so no private per-tile
// regions are needed.
//
// Bound: operations, not bytes (~232 MB on the front view). Each (pixel,
// in-range instance) pair of the chunks before chunks_done costs ~10 fp32
// flops for its power and gate test; each that passes the log-domain gate
// an exp; each kept pair a log, an exp, a division and ~34 flops; each
// instance that a warp hits 9 sums over the warp. The design:
//   - the exp only after the log-domain pre-test (stage.cuh); past the
//     gate, log(1 - alpha), exp(logT) and alpha / (1 - alpha) are the
//     special-function unit's __logf / __expf / __fdividef (the gate's exp
//     stays IEEE expf, so the kept set is exact);
//   - warp w owns the 16x8 block at column 16 (w % 2), row 8 (w / 2) of
//     the tile (lane i: column i % 16, rows i / 16 + 2j, j = 0..3), and
//     walks, back to front, only the instances whose gate extent meets
//     its block (stage.cuh): no pair loop and no reduction for the rest;
//   - a transposed (recursive-halving) warp reduction of the 9 sums: at
//     each xor level a lane sends the half of its values it does not keep,
//     so the first 8 take 4 + 2 + 1 + 2 shuffles and the ninth 5, 14 in
//     all instead of 45, and 8 lanes store their sums to shared memory at
//     once. It runs only where a lane of the warp kept a pair (recorded in
//     a per-warp hit mask); a fixed-order sum over the warps that hit
//     follows. No atomics: the result is deterministic;
//   - heaviest tiles first: blockIdx.x maps through `order`, sorted by the
//     wrapper by descending chunks_done (the forward's, never above
//     n_chunks);
//   - cp.async double-buffered staging: chunk ci-1 loads while chunk ci
//     is replayed;
//   - 256 threads, ~48 KB of shared memory, at most 64 registers
//     (__launch_bounds__(256, 4)): 4 CTAs per SM.

#include "stage.cuh"

namespace {

constexpr int PIX = TILE * TILE;
constexpr int PPT = PIX / THREADS;  // pixels per thread
constexpr int NGRAD = 9;
constexpr int REC = 12;  // floats per output record

__device__ __forceinline__ void store_record(float* __restrict__ dfeat, int id,
                                             const float (&v)[NGRAD]) {
  float4* dst = reinterpret_cast<float4*>(dfeat + (int64_t)id * REC);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  dst[2] = make_float4(v[8], 0.f, 0.f, 0.f);
}

// Sum acc[0..8] over the warp and store the sums to part[0..8]: acc[k] for
// k < 8 lands in lane 4k (lanes 4k..4k+3 hold it), acc[8] in lane 0.
__device__ __forceinline__ void reduce_store(float (&acc)[NGRAD], int lane,
                                             float* part) {
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = u16 ? acc[i] : acc[i + 4];
    const float keep = u16 ? acc[i + 4] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = u8 ? acc[i] : acc[i + 2];
    const float keep = u8 ? acc[i + 2] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
  {
    const float send = u4 ? acc[0] : acc[1];
    const float keep = u4 ? acc[1] : acc[0];
    acc[0] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  acc[0] += __shfl_xor_sync(FULL, acc[0], 2);
  acc[0] += __shfl_xor_sync(FULL, acc[0], 1);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc[8] += __shfl_xor_sync(FULL, acc[8], off);
  if ((lane & 3) == 0) part[lane >> 2] = acc[0];
  if (lane == 0) part[8] = acc[8];
}

__global__ void __launch_bounds__(THREADS, 4)
blend_bwd_kernel(const float* __restrict__ feat, int kp,
                 const int* __restrict__ offsets, const int64_t* __restrict__ order,
                 int grid_x, const float* __restrict__ fwd,
                 const float* __restrict__ cot, float* __restrict__ dfeat) {
  __shared__ Stage s;
  __shared__ float s_part[WARPS][CHUNK][NGRAD];  // per warp, per instance
  __shared__ unsigned s_hit[WARPS][CHUNK / 32];  // which of them were written

  const int t = (int)order[blockIdx.x];
  const int o = offsets[t];
  const int n = offsets[t + 1] - o;
  const int start = (o / CHUNK) * CHUNK;
  const int n_chunks = n > 0 ? (o + n - start + CHUNK - 1) / CHUNK : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = (warp % 2) * 16 + lane % 16;  // pixel column in the tile
  const int row = (warp / 2) * 8 + lane / 16;   // row of pixel 0; pixel j 2j below
  const float* fwd_t = fwd + (int64_t)t * PIX * OUTC;
  const float* cot_t = cot + (int64_t)t * PIX * OUTC;
  const int n_done = min((int)fwd_t[4], n_chunks);  // chunks_done is tile-uniform

  float px[PPT], py[PPT], cur[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = (row + 2 * j) * TILE + col;
    px[j] = (float)((t % grid_x) * TILE + col);
    py[j] = (float)((t / grid_x) * TILE + row + 2 * j);
    const float4 f0 = *reinterpret_cast<const float4*>(fwd_t + (int64_t)p * OUTC);
    const float4 f1 = *reinterpret_cast<const float4*>(fwd_t + (int64_t)p * OUTC + 4);
    const float4 c0 = *reinterpret_cast<const float4*>(cot_t + (int64_t)p * OUTC);
    cur[j] = f1.y;  // logT after the last chunk run
    S[j] = c0.w * f0.w;  // dL/dT_final * final_T
    gr[j] = c0.x;
    gg[j] = c0.y;
    gb[j] = c0.z;
  }

  warp_box<PPT>(s, px, py);
  if (n_done > 0) stage_async(s.raw[(n_done - 1) & 1], feat, kp, start + (n_done - 1) * CHUNK);
  cp_async_wait_all();
  __syncthreads();

  for (int ci = n_done - 1; ci >= 0; --ci) {
    const int buf = ci & 1;
    const int id0 = start + ci * CHUNK;  // < kp: kp is a chunk multiple >= o+n
    if (ci > 0) stage_async(s.raw[buf ^ 1], feat, kp, id0 - CHUNK);
    prepare(s, buf, id0, o, n);
    __syncthreads();

    const float(&f)[NROW][CHUNK] = s.raw[buf];
#pragma unroll
    for (int q = CHUNK / 32 - 1; q >= 0; --q) {
      unsigned bits = warp_bits(s, q);
      unsigned hits = 0u;
      while (bits) {  // warp-uniform: this warp's instances, back to front
        const int b = 31 - __clz(bits);
        bits ^= 1u << b;
        const int l = q * 32 + b;
        const float fx = f[0][l], fy = f[1][l];
        const float ha = s.ha[l], nb = s.nb[l], hc = s.hc[l], lo = s.lo[l];
        const float cr = f[5][l], cg = f[6][l], cb = f[7][l];
        float acc[NGRAD];
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) acc[k] = 0.f;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const float dx = fx - px[j];
          const float dy = fy - py[j];
          const float power = gate_power(ha, nb, hc, dx, dy);
          const float g = power + lo;
          if (g >= LOG_GATE && power <= 0.f) {
            const float alpha_raw = expf(g);  // IEEE expf: the gate is exact
            if (alpha_raw >= ALPHA_MIN) {
              hit = true;
              const float alpha = fminf(ALPHA_MAX, alpha_raw);
              const float om = 1.f - alpha;
              cur[j] -= __logf(om);  // log T before this instance
              const float w = alpha * __expf(cur[j]);
              const float wr = w * gr[j], wg = w * gg[j], wb = w * gb[j];
              const float u = wr * cr + wg * cg + wb * cb;
              const float dpow = alpha_raw < ALPHA_MAX ? u - __fdividef(alpha, om) * S[j] : 0.f;
              S[j] += u;
              acc[0] += dpow;
              acc[1] += dpow * dx;
              acc[2] += dpow * dy;
              acc[3] += dpow * dx * dx;
              acc[4] += dpow * dx * dy;
              acc[5] += dpow * dy * dy;
              acc[6] += wr;
              acc[7] += wg;
              acc[8] += wb;
            }
          }
        }
        if (__any_sync(FULL, hit)) {
          reduce_store(acc, lane, s_part[warp][l]);
          hits |= 1u << b;
        }
      }
      if (lane == 0) s_hit[warp][q] = hits;
    }
    __syncthreads();

    if (threadIdx.x < CHUNK) {
      const int l = threadIdx.x;
      const int id = id0 + l;
      float sum[NGRAD];
#pragma unroll
      for (int k = 0; k < NGRAD; ++k) sum[k] = 0.f;
      bool any = false;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {  // fixed order over the warps that hit
        if ((s_hit[w][l / 32] >> (l % 32)) & 1u) {
          any = true;
#pragma unroll
          for (int k = 0; k < NGRAD; ++k) sum[k] += s_part[w][l][k];
        }
      }
      if (id >= o && id < o + n) {  // only these lanes can be hit (log op = -inf elsewhere)
        float g[NGRAD];
        if (any) {
          const float a = f[2][l], b = f[3][l], c = f[4][l], op = f[8][l];
          const float m0 = sum[0], ex = sum[1], ey = sum[2];
          g[0] = -(a * ex + b * ey);
          g[1] = -(c * ey + b * ex);
          g[2] = -0.5f * sum[3];
          g[3] = -sum[4];
          g[4] = -0.5f * sum[5];
          g[5] = sum[6];
          g[6] = sum[7];
          g[7] = sum[8];
          g[8] = m0 / fmaxf(op, 1e-30f);
        } else {
#pragma unroll
          for (int k = 0; k < NGRAD; ++k) g[k] = 0.f;
        }
        store_record(dfeat, id, g);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // before the next chunk's prepare; publishes its copy
  }

  // zero records: this tile's range past chunks_done, and (spread over the
  // CTAs) the positions outside every tile's range
  float zero[NGRAD];
#pragma unroll
  for (int k = 0; k < NGRAD; ++k) zero[k] = 0.f;
  for (int id = max(o, start + n_done * CHUNK) + threadIdx.x; id < o + n; id += THREADS)
    store_record(dfeat, id, zero);
  const int head = offsets[0], tail = offsets[gridDim.x];
  for (int id = blockIdx.x * THREADS + threadIdx.x; id < head + (kp - tail);
       id += gridDim.x * THREADS)
    store_record(dfeat, id < head ? id : tail + (id - head), zero);
}

}  // namespace

extern "C" int blend_bwd_launch(const void* feat, int kp, const void* offsets,
                                const void* order, int num_tiles, int grid_x,
                                const void* fwd, const void* cot, void* dfeat,
                                void* stream) {
  blend_bwd_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, (const int64_t*)order, grid_x,
      (const float*)fwd, (const float*)cot, (float*)dfeat);
  return (int)cudaGetLastError();
}

// CTAs of blend_bwd_kernel resident per SM, as the runtime computes it.
extern "C" int blend_bwd_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, blend_bwd_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
