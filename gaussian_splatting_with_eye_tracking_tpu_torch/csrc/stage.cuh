// Chunk staging and the per-warp gate cull shared by the tile compositors
// (composite.cuh's forward loop for blend_fwd.cu / blend_amr.cu, and
// blend_bwd.cu).
//
// A CTA of THREADS threads owns one 32x32 tile and walks its depth-sorted
// instance range in 128-wide chunks. The 9 feature rows of a chunk [x, y,
// conic a, b, c, r, g, b, opacity] (struct-of-arrays, row stride kp, kp a
// multiple of 128, the chunk's first lane a multiple of 128, so every row
// segment is 512-byte aligned) are copied into shared memory with cp.async,
// 16 bytes a thread, into a double buffer: the next chunk's copy is in
// flight while the current one is composited. prepare() then derives, once
// per instance, -a/2, -b, -c/2, log(opacity) (-inf outside the range) and
// the set of warps whose pixel box can hold a pair that passes the alpha
// gate (gate_warps). Each warp ballots that set into a 128-bit mask and
// walks only its own instances: a warp whose box misses an instance's gate
// extent skips it with no pair loop and no reduction.
//
// The gate. A pair is kept iff power <= 0 and expf(power + log op) >=
// 1/255. The compositors test power + log op >= LOG_GATE first: LOG_GATE
// is ln(1/255) less 1e-5, far beyond expf's 2-ulp error, so a pair that
// fails it cannot pass the exact gate and the exp is skipped; a pair that
// passes still takes the exact test. The power is gate_power(): each
// product and sum rounded on its own, in the plain versions' order. nvcc
// would otherwise contract it into FMAs, whose power differs from theirs
// by an ulp now and then; a pair whose alpha sits within that ulp of 1/255
// is then kept on one side only, and the pixel differs by up to 1/255 of
// its transmittance (up to 8.3e-4 on 8 of 8.2M pixels at 3840x2144 on an
// H100; gate_probe.py shows each). With gate_power the kept set is the one
// the plain versions compute on the card.
//
// The extent. With the conic C = [[a, b], [b, c]] and tau = log op +
// ln 255, power + log op >= ln(1/255) is d^T C d <= 2 tau, an ellipse whose
// bounding box has half-widths sqrt(2 tau c / det) and sqrt(2 tau a / det),
// det = ac - b^2 (ops/projection.py's radius formula, from the conic). It
// is computed in double (the products of two floats are exact there) and
// widened against the float32 power's rounding: tau gets 1e-4 more and a
// factor 1 + 1e-3 + 1e-5 kappa, kappa = ac/det the conic's conditioning
// (the power's relative rounding error grows like ~1e-6 kappa); the box
// then gets 1e-2 px plus 1e-6 of the centre's magnitude (the float32
// offsets' rounding). A conic that is not positive definite, or has kappa
// above 1e5, is not culled; tau <= 0 (and the -inf of lanes outside the
// range) culls the instance for every warp. ops/blend.py's gate_box is the
// plain mirror the CPU tests check.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int CHUNK = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int OUTC = 8;
constexpr int NROW = 9;  // feature rows staged
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float LOG_T_MIN = -9.210340371976182f;  // ln(1e-4)
constexpr float LOG_GATE = -5.541263545158426f - 1e-5f;  // ln(1/255) - 1e-5
constexpr double LN255 = 5.541263545158426;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ALL_WARPS = (1u << WARPS) - 1u;

struct Stage {
  float raw[2][NROW][CHUNK];  // cp.async double buffer, feature rows as read
  float ha[CHUNK], nb[CHUNK], hc[CHUNK], lo[CHUNK];  // -a/2, -b, -c/2, log op
  unsigned warps[CHUNK];  // bit w: the instance may pass the gate in warp w
  float4 wbox[WARPS];     // warp w's pixel box: x min, x max, y min, y max
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the chunk whose first lane is id0 into dst (all threads).
__device__ __forceinline__ void stage_async(float (&dst)[NROW][CHUNK],
                                            const float* __restrict__ feat,
                                            int kp, int id0) {
  constexpr int VEC = CHUNK / 4;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < NROW * VEC; v += THREADS) {
    const int row = v / VEC, col = (v % VEC) * 4;
    cp_async16(&dst[row][col], feat + (int64_t)row * kp + id0 + col);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The warps whose pixel box meets the gate extent of an instance at (fx,
// fy) with conic (a, b, c) and log opacity lo (see the note above).
__device__ __forceinline__ unsigned gate_warps(const float4* wbox, float fx,
                                               float fy, float a, float b,
                                               float c, float lo) {
  const double tau = (double)lo + LN255 + 1e-4;
  if (!(tau > 0.0)) return 0u;
  const double da = a, db = b, dc = c;
  const double det = da * dc - db * db;
  const double kappa = da * dc / det;
  if (!(da > 0.0 && dc > 0.0 && det > 0.0 && kappa <= 1e5)) return ALL_WARPS;
  const double k = 2.0 * tau * (1.0 + 1e-3 + 1e-5 * kappa) / det;
  const double hx = sqrt(k * dc) + 1e-2 + 1e-6 * fabs((double)fx);
  const double hy = sqrt(k * da) + 1e-2 + 1e-6 * fabs((double)fy);
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float4 bx = wbox[w];
    if (fx + hx >= bx.x && fx - hx <= bx.y && fy + hy >= bx.z && fy - hy <= bx.w)
      m |= 1u << w;
  }
  return m;
}

// This warp's pixel box over the NR pixels of each lane, into s.wbox (the
// caller's next barrier publishes it).
template <int NR>
__device__ __forceinline__ void warp_box(Stage& s, const float (&px)[NR],
                                         const float (&py)[NR]) {
  float x0 = px[0], x1 = px[0], y0 = py[0], y1 = py[0];
#pragma unroll
  for (int j = 1; j < NR; ++j) {
    x0 = fminf(x0, px[j]);
    x1 = fmaxf(x1, px[j]);
    y0 = fminf(y0, py[j]);
    y1 = fmaxf(y1, py[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(FULL, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(FULL, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(FULL, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(FULL, y1, off));
  }
  if (threadIdx.x % 32 == 0) s.wbox[threadIdx.x / 32] = make_float4(x0, x1, y0, y1);
}

// Derive the per-instance terms of the chunk in s.raw[buf] whose first lane
// is id0; lanes outside [o, o + n) get log op = -inf (threads < CHUNK).
__device__ __forceinline__ void prepare(Stage& s, int buf, int id0, int o, int n) {
  const int l = threadIdx.x;
  if (l < CHUNK) {
    const float(&f)[NROW][CHUNK] = s.raw[buf];
    const int id = id0 + l;
    const float a = f[2][l], b = f[3][l], c = f[4][l];
    const float lo = (id >= o && id < o + n) ? logf(f[8][l]) : -INFINITY;
    s.ha[l] = -0.5f * a;
    s.nb[l] = -b;
    s.hc[l] = -0.5f * c;
    s.lo[l] = lo;
    s.warps[l] = gate_warps(s.wbox, f[0][l], f[1][l], a, b, c, lo);
  }
}

// The power -a/2 dx^2 - b dx dy - c/2 dy^2 as the plain versions round it,
// (ha dx + nb dy) dx + (hc dy) dy, with no FMA contraction (see the gate).
__device__ __forceinline__ float gate_power(float ha, float nb, float hc, float dx,
                                            float dy) {
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(ha, dx), __fmul_rn(nb, dy)), dx),
                   __fmul_rn(__fmul_rn(hc, dy), dy));
}

// This warp's instances among lanes [32q, 32q + 32) of the prepared chunk.
__device__ __forceinline__ unsigned warp_bits(const Stage& s, int q) {
  const int lane = threadIdx.x % 32;
  return __ballot_sync(FULL, (s.warps[q * 32 + lane] >> (threadIdx.x / 32)) & 1u);
}

}  // namespace
