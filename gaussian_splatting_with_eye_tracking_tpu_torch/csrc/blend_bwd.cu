// Backward tile compositor (K3): replays each 32x32 tile's depth-sorted
// instance range back to front and writes every instance's gradients.
//
// Replaces the TPU kernel gaussian_splatting_with_eye_tracking_tpu/ops/
// pallas_blend.py::_bwd_kernel (entry _bwd_call). Inputs: the (16, kp)
// struct-of-arrays feature array [x, y, conic a, b, c, r, g, b, opacity,
// gauss_id, pad...] in depth-sorted CSR order, the (T+1) offsets, the
// forward's (T, 1024, 8) output (col 3 final_T, col 4 chunks_done, col 5
// logT) and the (T, 1024, 8) cotangent (cols 0-2 dL/dcolor without the
// background, col 3 dL/dfinal_T). Output (9, kp): at sorted position i of
// each tile's range, dL/d[x, y, conic a, b, c, r, g, b, opacity]; the
// caller zero-fills it, and positions past offsets[T] stay untouched.
// What it reproduces of the TPU kernel:
//   - chunks aligned to GLOBAL multiples of 128, lanes outside [o, o+n)
//     masked through log(op) = -inf, the forward's alpha gate;
//   - chunks at or past chunks_done get zero gradient (they are skipped:
//     the output is zero-filled);
//   - transmittance rebuilt in log space from the forward's final logT
//     (cur -= log(1 - alpha) walking back), never by division by final_T;
//   - the suffix accumulator S seeded with dL/dT_final * final_T;
//   - d_power = w*G - alpha/(1-alpha)*S on lanes with keep && alpha_raw <
//     0.99 (else 0), with G = dL/dcolor . rgb and w = alpha*T;
//   - d_opacity = sum d_power / op.
// Unlike the TPU kernel it forms sum d_power*dx (and dy, dx^2, dx*dy,
// dy^2) directly per pixel, not from tile-local moment matmuls, and writes
// each instance at its own sorted position: tile ranges are disjoint, so
// no private per-tile regions are needed.
//
// Bound: operations (each (pixel, in-range instance) pair costs ~10 fp32
// flops and an exp; each pair that passes the alpha gate a log, an exp,
// a reciprocal and ~30 flops more). One CTA per tile, 256 threads x 4
// pixels; warp w owns the tile's rows 4w..4w+3, so an instance that misses
// those rows is skipped warp-wide. Each chunk's per-instance terms are
// staged in shared memory; each thread walks them back to front in
// registers. The 9 per-instance sums over the tile's 1024 pixels are
// reduced deterministically: a shuffle tree within each warp, then a
// fixed-order sum over the 8 warps in shared memory. No atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int PIX = TILE * TILE;
constexpr int CHUNK = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = PIX / THREADS;  // pixels per thread (rows of its warp)
constexpr int OUTC = 8;
constexpr int NGRAD = 9;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
blend_bwd_kernel(const float* __restrict__ feat, int kp,
                 const int* __restrict__ offsets, int grid_x,
                 const float* __restrict__ fwd, const float* __restrict__ cot,
                 float* __restrict__ dfeat) {
  __shared__ float s_x[CHUNK], s_y[CHUNK], s_ha[CHUNK], s_nb[CHUNK],
      s_hc[CHUNK], s_lo[CHUNK], s_r[CHUNK], s_g[CHUNK], s_b[CHUNK];
  __shared__ float s_part[WARPS][NGRAD][CHUNK];

  const int t = blockIdx.x;
  const int o = offsets[t];
  const int n = offsets[t + 1] - o;
  const int start = (o / CHUNK) * CHUNK;
  const int n_chunks = n > 0 ? (o + n - start + CHUNK - 1) / CHUNK : 0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* fwd_t = fwd + (int64_t)t * PIX * OUTC;
  const float* cot_t = cot + (int64_t)t * PIX * OUTC;
  const int n_done = min((int)fwd_t[4], n_chunks);  // chunks_done is tile-uniform

  float px[PPT], py[PPT], cur[PPT], S[PPT], gr[PPT], gg[PPT], gb[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int row = warp * PPT + j;
    const int p = row * TILE + lane;
    px[j] = (float)((t % grid_x) * TILE + lane);
    py[j] = (float)((t / grid_x) * TILE + row);
    const float* f = fwd_t + (int64_t)p * OUTC;
    const float* c = cot_t + (int64_t)p * OUTC;
    cur[j] = f[5];  // logT after the last chunk run
    S[j] = c[3] * f[3];  // dL/dT_final * final_T
    gr[j] = c[0];
    gg[j] = c[1];
    gb[j] = c[2];
  }

  for (int ci = n_done - 1; ci >= 0; --ci) {
    if (threadIdx.x < CHUNK) {
      const int l = threadIdx.x;
      const int id = start + ci * CHUNK + l;  // < kp: kp is a chunk multiple >= o+n
      const bool valid = id >= o && id < o + n;
      s_x[l] = feat[id];
      s_y[l] = feat[(int64_t)1 * kp + id];
      s_ha[l] = -0.5f * feat[(int64_t)2 * kp + id];
      s_nb[l] = -feat[(int64_t)3 * kp + id];
      s_hc[l] = -0.5f * feat[(int64_t)4 * kp + id];
      s_r[l] = feat[(int64_t)5 * kp + id];
      s_g[l] = feat[(int64_t)6 * kp + id];
      s_b[l] = feat[(int64_t)7 * kp + id];
      s_lo[l] = valid ? logf(feat[(int64_t)8 * kp + id]) : -INFINITY;
    }
    __syncthreads();

    for (int l = CHUNK - 1; l >= 0; --l) {
      const float fx = s_x[l], fy = s_y[l];
      const float ha = s_ha[l], nb = s_nb[l], hc = s_hc[l], lo = s_lo[l];
      const float cr = s_r[l], cg = s_g[l], cb = s_b[l];
      float acc[NGRAD];
#pragma unroll
      for (int k = 0; k < NGRAD; ++k) acc[k] = 0.f;
      bool hit = false;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float dx = fx - px[j];
        const float dy = fy - py[j];
        const float power = (ha * dx + nb * dy) * dx + (hc * dy) * dy;
        if (power <= 0.f) {
          const float alpha_raw = expf(power + lo);
          if (alpha_raw >= ALPHA_MIN) {
            hit = true;
            const float alpha = fminf(ALPHA_MAX, alpha_raw);
            const float om = 1.f - alpha;
            cur[j] -= logf(om);  // log T before this instance
            const float w = alpha * expf(cur[j]);
            const float wr = w * gr[j], wg = w * gg[j], wb = w * gb[j];
            const float u = wr * cr + wg * cg + wb * cb;
            const float dpow = alpha_raw < ALPHA_MAX ? u - alpha / om * S[j] : 0.f;
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
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) acc[k] = warp_sum(acc[k]);
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) s_part[warp][k][l] = acc[k];
      }
    }
    __syncthreads();

    if (threadIdx.x < CHUNK) {
      const int l = threadIdx.x;
      const int id = start + ci * CHUNK + l;
      if (id >= o && id < o + n) {
        float sum[NGRAD];
#pragma unroll
        for (int k = 0; k < NGRAD; ++k) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) v += s_part[w][k][l];
          sum[k] = v;
        }
        const float a = feat[(int64_t)2 * kp + id];
        const float b = feat[(int64_t)3 * kp + id];
        const float c = feat[(int64_t)4 * kp + id];
        const float op = feat[(int64_t)8 * kp + id];
        const float m0 = sum[0], ex = sum[1], ey = sum[2];
        dfeat[id] = -(a * ex + b * ey);
        dfeat[(int64_t)1 * kp + id] = -(c * ey + b * ex);
        dfeat[(int64_t)2 * kp + id] = -0.5f * sum[3];
        dfeat[(int64_t)3 * kp + id] = -sum[4];
        dfeat[(int64_t)4 * kp + id] = -0.5f * sum[5];
        dfeat[(int64_t)5 * kp + id] = sum[6];
        dfeat[(int64_t)6 * kp + id] = sum[7];
        dfeat[(int64_t)7 * kp + id] = sum[8];
        dfeat[(int64_t)8 * kp + id] = m0 / fmaxf(op, 1e-30f);
      }
    }
    __syncthreads();  // before the next chunk overwrites shared memory
  }
}

}  // namespace

extern "C" int blend_bwd_launch(const void* feat, int kp, const void* offsets,
                                int num_tiles, int grid_x, const void* fwd,
                                const void* cot, void* dfeat, void* stream) {
  blend_bwd_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)feat, kp, (const int*)offsets, grid_x, (const float*)fwd,
      (const float*)cot, (float*)dfeat);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
