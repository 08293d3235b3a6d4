// Front-to-back log-space alpha compositing of one 32x32 tile's
// depth-sorted instance range: the chunk loop shared by the forward
// compositors (blend_fwd.cu, blend_amr.cu).
//
// One CTA of THREADS threads owns one tile; each thread owns NR pixels and
// walks each chunk's 128 instances in order (a sequential scan in
// registers). Each chunk's per-instance terms (x, y, -a/2, -b, -c/2,
// log op, rgb) are staged once in shared memory with coalesced loads and
// read back as broadcasts. Input: the (16, kp) struct-of-arrays feature
// array [x, y, conic a, b, c, r, g, b, opacity, gauss_id, pad...] in
// depth-sorted CSR order, kp a multiple of 128. Output per pixel row:
// rgb (no background), exp(logT), chunks run, logT, 0, 0.
//
// What it reproduces exactly of the TPU kernels (ops/pallas_blend.py of
// the JAX package: _blend_stream_loop, _alpha_terms):
//   - chunks are aligned to GLOBAL multiples of 128: start = o/128*128,
//     n_full = n ? ceil((o+n-start)/128) : 0; lanes outside [o, o+n) get
//     log(op) = -inf;
//   - alpha_raw = exp(power + log op), alpha = min(0.99, alpha_raw), kept
//     iff power <= 0 && alpha_raw >= 1/255, with the FMA-chained power;
//   - transmittance stays in log space: w = alpha * exp(logT + local)
//     with local the chunk's exclusive prefix of log(1 - alpha), and
//     logT += the chunk's sum after the chunk;
//   - decimation step > 1 (not scale_only): ceil(n_full/step) chunks run,
//     chunk ci reads lanes start + ci*step*128 + [0, 128) and stands in
//     for rep = min(step, n_full - ci*step) chunks: lom = rep *
//     log(1 - alpha) and, where rep > 1, alpha' = 1 - exp(lom) (not expm1,
//     as the TPU kernel);
//   - scale_only with step > 1: every chunk runs and every lane takes
//     lom = step * log(1 - alpha), alpha' = 1 - exp(lom);
//   - the TILE exits after a whole chunk once the largest logT over all
//     the pixels its threads own is below ln 1e-4 (__syncthreads_or over
//     the block), not per pixel.
// A lane that fails the gate has alpha = 0, so it adds w = 0 and
// log(1 - 0) = 0: skipping its log and second exp changes no value. rep is
// the same for every lane of a chunk, so the compensation adds no
// divergence.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int CHUNK = 128;
constexpr int THREADS = 256;
constexpr int OUTC = 8;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_MIN = -9.210340371976182f;  // ln(1e-4)

struct Stage {
  float x[CHUNK], y[CHUNK], ha[CHUNK], nb[CHUNK], hc[CHUNK], lo[CHUNK],
      r[CHUNK], g[CHUNK], b[CHUNK];
};

__device__ __forceinline__ void write_row(float* __restrict__ row, float r,
                                          float g, float b, float t,
                                          float done, float log_t) {
  float4* dst = reinterpret_cast<float4*>(row);
  dst[0] = make_float4(r, g, b, t);
  dst[1] = make_float4(done, log_t, 0.f, 0.f);
}

// Composite this CTA's tile, instance range [o, o + n), for NR pixels per
// thread at (px[j], py[j]) and write pixel j to rows[j * THREADS * OUTC].
template <int NR>
__device__ __forceinline__ void composite(
    Stage& s, const float* __restrict__ feat, int kp, int o, int n, int step,
    bool scale_only, const float (&px)[NR], const float (&py)[NR],
    float* __restrict__ rows) {
  const int start = (o / CHUNK) * CHUNK;
  const int n_full = n > 0 ? (o + n - start + CHUNK - 1) / CHUNK : 0;
  const bool decimate = step > 1 && !scale_only;
  const int lane_step = decimate ? step : 1;
  const int n_chunks = decimate ? (n_full + step - 1) / step : n_full;

  float log_t[NR], cr[NR], cg[NR], cb[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) log_t[j] = cr[j] = cg[j] = cb[j] = 0.f;

  int ci = 0;
  while (ci < n_chunks) {
    if (threadIdx.x < CHUNK) {
      const int l = threadIdx.x;
      // < kp: (n_chunks - 1) * lane_step < n_full and kp is a chunk
      // multiple >= o + n
      const int id = start + ci * lane_step * CHUNK + l;
      const bool valid = id >= o && id < o + n;
      s.x[l] = feat[id];
      s.y[l] = feat[(int64_t)1 * kp + id];
      s.ha[l] = -0.5f * feat[(int64_t)2 * kp + id];
      s.nb[l] = -feat[(int64_t)3 * kp + id];
      s.hc[l] = -0.5f * feat[(int64_t)4 * kp + id];
      s.r[l] = feat[(int64_t)5 * kp + id];
      s.g[l] = feat[(int64_t)6 * kp + id];
      s.b[l] = feat[(int64_t)7 * kp + id];
      s.lo[l] = valid ? logf(feat[(int64_t)8 * kp + id]) : -INFINITY;
    }
    __syncthreads();

    // chunk-uniform compensation factor: 1 leaves alpha as it is
    const int rep = decimate ? min(step, n_full - ci * step)
                             : (scale_only ? step : 1);
    const float frep = (float)rep;
    float local[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) local[j] = 0.f;
    for (int l = 0; l < CHUNK; ++l) {
      const float fx = s.x[l], fy = s.y[l];
      const float ha = s.ha[l], nb = s.nb[l], hc = s.hc[l], lo = s.lo[l];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float dx = fx - px[j];
        const float dy = fy - py[j];
        const float power = (ha * dx + nb * dy) * dx + (hc * dy) * dy;
        if (power <= 0.f) {
          const float alpha_raw = expf(power + lo);
          if (alpha_raw >= ALPHA_MIN) {
            float alpha = fminf(ALPHA_MAX, alpha_raw);
            float lom = logf(1.f - alpha);
            if (rep > 1) {
              lom *= frep;
              alpha = 1.f - expf(lom);
            }
            const float w = alpha * expf(log_t[j] + local[j]);
            cr[j] += w * s.r[l];
            cg[j] += w * s.g[l];
            cb[j] += w * s.b[l];
            local[j] += lom;
          }
        }
      }
    }
    bool alive = false;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      log_t[j] += local[j];
      alive |= log_t[j] >= LOG_T_MIN;
    }
    ++ci;
    // also the barrier before the next chunk overwrites shared memory
    if (!__syncthreads_or(alive)) break;
  }

#pragma unroll
  for (int j = 0; j < NR; ++j)
    write_row(rows + (int64_t)j * THREADS * OUTC, cr[j], cg[j], cb[j],
              expf(log_t[j]), (float)ci, log_t[j]);
}

}  // namespace
