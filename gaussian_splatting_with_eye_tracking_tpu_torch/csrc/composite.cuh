// Front-to-back log-space alpha compositing of one 32x32 tile's
// depth-sorted instance range: the chunk loop shared by the forward
// compositors (blend_fwd.cu, blend_amr.cu).
//
// One CTA of THREADS threads owns one tile; each thread owns NR pixels and
// walks each chunk's instances in order (a sequential scan in registers).
// Chunks are staged by stage.cuh: cp.async into a double buffer (chunk
// ci+1 loads while chunk ci is composited), the per-instance terms derived
// once, and each warp walks only the instances whose gate extent meets its
// pixel box (the box is reduced once from px/py, so any pixel map gets the
// cull). Each pair tests power + log op against LOG_GATE before its exp;
// a kept pair's log(1 - alpha) and exp(logT + local) are __logf / __expf.
// Input: the (16, kp) struct-of-arrays feature array [x, y, conic a, b, c,
// r, g, b, opacity, gauss_id, pad...] in depth-sorted CSR order, kp a
// multiple of 128. Output per pixel row: rgb (no background), exp(logT),
// chunks run, logT, 0, 0.
//
// What it reproduces exactly of the TPU kernels (ops/pallas_blend.py of
// the JAX package: _blend_stream_loop, _alpha_terms):
//   - chunks are aligned to GLOBAL multiples of 128: start = o/128*128,
//     n_full = n ? ceil((o+n-start)/128) : 0; lanes outside [o, o+n) get
//     log(op) = -inf;
//   - alpha_raw = exp(power + log op), alpha = min(0.99, alpha_raw), kept
//     iff power <= 0 && alpha_raw >= 1/255, with the power rounded as the
//     plain versions round it (stage.cuh's gate_power, no FMA);
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
// A pair that fails the gate has alpha = 0, so it adds w = 0 and
// log(1 - 0) = 0: skipping it (its exp, its log, or the whole instance in
// a culled warp) changes no value. rep is the same for every lane of a
// chunk, so the compensation adds no divergence.
//
// Barriers per chunk: one after prepare (the derived terms and the masks),
// and the exit test, which also publishes the next chunk's copy (each
// thread waits for its own copies just before it).

#pragma once

#include "stage.cuh"

namespace {

__device__ __forceinline__ void write_row(float* __restrict__ row, float r,
                                          float g, float b, float t,
                                          float done, float log_t) {
  float4* dst = reinterpret_cast<float4*>(row);
  dst[0] = make_float4(r, g, b, t);
  dst[1] = make_float4(done, log_t, 0.f, 0.f);
}

// Composite this CTA's tile, instance range [o, o + n), for NR pixels per
// thread at (px[j], py[j]) and write pixel j to rows[j * row_step * OUTC].
template <int NR>
__device__ __forceinline__ void composite(
    Stage& s, const float* __restrict__ feat, int kp, int o, int n, int step,
    bool scale_only, const float (&px)[NR], const float (&py)[NR],
    float* __restrict__ rows, int row_step) {
  const int start = (o / CHUNK) * CHUNK;
  const int n_full = n > 0 ? (o + n - start + CHUNK - 1) / CHUNK : 0;
  const bool decimate = step > 1 && !scale_only;
  const int lane_step = decimate ? step : 1;
  const int n_chunks = decimate ? (n_full + step - 1) / step : n_full;

  float log_t[NR], cr[NR], cg[NR], cb[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) log_t[j] = cr[j] = cg[j] = cb[j] = 0.f;

  warp_box<NR>(s, px, py);
  // < kp: (n_chunks - 1) * lane_step < n_full and kp is a chunk multiple
  // >= o + n
  if (n_chunks > 0) stage_async(s.raw[0], feat, kp, start);
  cp_async_wait_all();
  __syncthreads();

  int ci = 0;
  while (ci < n_chunks) {
    const int buf = ci & 1;
    const int id0 = start + ci * lane_step * CHUNK;
    if (ci + 1 < n_chunks) stage_async(s.raw[buf ^ 1], feat, kp, id0 + lane_step * CHUNK);
    prepare(s, buf, id0, o, n);
    __syncthreads();

    // chunk-uniform compensation factor: 1 leaves alpha as it is
    const int rep = decimate ? min(step, n_full - ci * step)
                             : (scale_only ? step : 1);
    const float frep = (float)rep;
    const float(&f)[NROW][CHUNK] = s.raw[buf];
    float local[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) local[j] = 0.f;
#pragma unroll
    for (int q = 0; q < CHUNK / 32; ++q) {
      unsigned bits = warp_bits(s, q);
      while (bits) {  // warp-uniform: this warp's instances, front to back
        const int l = q * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float fx = f[0][l], fy = f[1][l];
        const float ha = s.ha[l], nb = s.nb[l], hc = s.hc[l], lo = s.lo[l];
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const float dx = fx - px[j];
          const float dy = fy - py[j];
          const float power = gate_power(ha, nb, hc, dx, dy);
          const float g = power + lo;
          if (g >= LOG_GATE && power <= 0.f) {
            const float alpha_raw = expf(g);  // IEEE expf: the gate is exact
            if (alpha_raw >= ALPHA_MIN) {
              float alpha = fminf(ALPHA_MAX, alpha_raw);
              float lom = __logf(1.f - alpha);
              if (rep > 1) {
                lom *= frep;
                alpha = 1.f - __expf(lom);
              }
              const float w = alpha * __expf(log_t[j] + local[j]);
              cr[j] += w * f[5][l];
              cg[j] += w * f[6][l];
              cb[j] += w * f[7][l];
              local[j] += lom;
            }
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
    cp_async_wait_all();
    // also the barrier before the next chunk's prepare and copy
    if (!__syncthreads_or(alive)) break;
  }

#pragma unroll
  for (int j = 0; j < NR; ++j)
    write_row(rows + (int64_t)j * row_step * OUTC, cr[j], cg[j], cb[j],
              expf(log_t[j]), (float)ci, log_t[j]);
}

}  // namespace
