// Per-gaussian preprocess (K7): project, cover, bound and shade every slot
// in one launch. Computes ops/projection.py's preprocess_plain record,
// field for field: the view transform, depth and near cull, the projection
// to pixels; the 3D covariance (quaternion normalised) and its EWA
// projection (1.3 tan clamp, +0.3 px low-pass); det, conic, the 3-sigma
// radius; the opacity-aware extents, cull_thr, the tile rect,
// tiles_touched and radii; the SH colour (+0.5, clamped at 0); the zeroed
// opacity of culled slots.
//
// Two forms of input, one thread map; only the loads differ (the RAW
// template flag). The activated form takes renderer.activated's tensors:
// exp'd scales, sigmoid'd opacities and the (N, 3, K) SH with the bands
// above the state's degree zeroed. The raw form takes the model's own
// parameters (models/gaussian_model.RawGaussians): log-scales, opacity
// logits, and the SH as f_dc (N, 3, 1) and f_rest (N, 3, K-1). It applies
// the activation to each row as it loads it, rounded as torch.exp and
// torch.sigmoid round it on the card, and shades only the bands up to the
// state's degree, reading only their coefficients. So a no-grad view
// writes no activated copy of the model: over 4M slots the activation's
// concatenation and band mask moved ~3.2 GB a view to feed this kernel's
// ~0.64 GB. Both forms give the same record.
//
// Replaces no TPU kernel: the JAX package's preprocess (gaussian_splatting_
// with_eye_tracking_tpu/ops/projection.py) is column math that XLA fuses
// into a few loops. Run op by op in PyTorch it is ~420 elementwise
// launches a view: the served view's largest device cost over 4M slots
// and its largest host cost over 300k.
//
// Bound: bytes. A slot reads its mean, scales, quaternion, opacity and
// mask (45 B) and writes the 68-byte record; a slot that is drawn also
// reads its SH row (3 x K floats, 192 B at SH 3). 4,194,304 slots with
// 1M drawn move ~0.67 GB (~0.2 ms at 3.35 TB/s). What the design does:
//   - one thread per slot, 128 a CTA; the camera's matrices are read from
//     device memory (uniform loads), so no view waits on a copy to the host;
//   - the SH rows are the bulk of the bytes. A warp's 32 rows are
//     contiguous in the (N, 3, K) layout (6 KB at K = 16), and in the raw
//     form in each of f_dc (384 B) and f_rest (5,760 B at K = 16, 16-byte
//     aligned): the warp stages them into shared memory with coalesced
//     16-byte loads, then each lane reads its own row there (an odd row
//     pitch, so no bank conflicts). Only a warp with a slot to shade
//     stages, only such slots evaluate the SH, and only the bands up to
//     sh_degree; below the full degree the raw form stages only those
//     bands' coefficients, one float a lane;
//   - a culled slot (inactive, behind the near plane, det = 0 or no tile
//     touched) gets radii, tiles_touched and opacity 0 and rgb 0, and
//     reads no SH. Its geometry costs 45 B, so it is computed as for any
//     slot: means2d, depths, conics, cull_thr and the rect equal the plain
//     version's on every slot (parallel/sharded.band_local reads a culled
//     slot's rect, gated by its tiles_touched).
//
// Exact integers. The rect, radius and tiles come from ceil, truncation
// and clamps of floats; one ulp can move a rect by a tile and drop or add
// instances. So the file is compiled with -fmad=false (backend.py's
// SOURCE_FLAGS): every product and sum is rounded on its own, in the plain
// version's order, as PyTorch's elementwise kernels round them. The plain
// version's few reductions are written in the order the card's libraries
// take (dot3, norm4, norm3 below); PyTorch's division of a tensor by a
// Python number is a product by its float reciprocal, as here. Casts to
// int truncate, and NaN goes through the clamps as PyTorch lets it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEAR = 0.2f;  // ops/projection.py's NEAR
constexpr float INT_CAST_LIMIT = 1073741824.0f;  // 2^30, as _to_int32

// the SH constants of ops/sh.py, rounded to float as PyTorch rounds them
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;

struct Args {
  const float* means;   // (n, 3)
  const float* scales;  // (n, 3) activated; raw: log-scales
  const float* quats;   // (n, 4) wxyz, not normalised
  const float* opac;    // (n,) activated; raw: logits
  const float* sh;      // (n, 3, K); raw: f_dc (n, 3, 1)
  const float* sh_rest;  // raw: f_rest (n, 3, K - 1), or null where K = 1
  const uint8_t* active;  // (n,) bool, or null
  const float* view;    // (4, 4) row-major, world -> view
  const float* proj;    // (4, 4) row-major, world -> clip
  const float* campos;  // (3,)
  int64_t n;
  int sh_degree;
  float tan_fovx, tan_fovy, scale_modifier;
  int width, height, tile;
  float2* means2d;
  float* depths;
  float* conics;   // (n, 3)
  float* rgb;      // (n, 3)
  float* opac_out;
  int* radii;
  int* tiles;
  int2* rect_min;
  int2* rect_max;
  float* cull_thr;
};

// x w0 + y w1 + z w2 as the card's BLAS computes an entry of (n, 3) @ (3, 3)
// and of (n, 3) @ (3, 4): a chain of fused multiply-adds in k order.
__device__ __forceinline__ float dot3(float x, float y, float z, float w0, float w1,
                                      float w2) {
  return __fmaf_rn(z, w2, __fmaf_rn(y, w1, __fmul_rn(x, w0)));
}

// torch.linalg.vector_norm over a last dimension of 4 on the card: one
// lane per element, squares summed by the warp's shuffle tree.
__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return sqrtf((a * a + c * c) + (b * b + d * d));
}

// ... and of 3: two lanes, the first holding elements 0 and 2.
__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf((a * a + c * c) + b * b);
}

// torch.exp and torch.sigmoid of float32 on the card: ATen's CUDA kernels
// compute std::exp(x) and 1 / (1 + std::exp(-x)), the division IEEE
__device__ __forceinline__ float act_exp(float x) { return expf(x); }
__device__ __forceinline__ float act_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// PyTorch's clamp_min / minimum / clamp: a NaN operand comes out
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return minimum(isnan(x) ? x : (isnan(lo) ? lo : fmaxf(x, lo)), hi);
}

// _to_int32: clamp to +-2^30, then truncate toward zero (NaN gives 0, as
// the card's float -> int conversion gives it)
__device__ __forceinline__ int to_int32(float x) {
  return (int)(isnan(x) ? x : fminf(fmaxf(x, -INT_CAST_LIMIT), INT_CAST_LIMIT));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// ops/ndc_to_pix
__device__ __forceinline__ float ndc_to_pix(float v, int size) {
  return ((v + 1.0f) * (float)size - 1.0f) * 0.5f;
}

// ops/sh.eval_sh of one channel (row: its K coefficients), term for term
__device__ __forceinline__ float eval_sh(int deg, const float* s, float x, float y,
                                         float z) {
  float r = C0 * s[0];
  if (deg > 0) {
    r = ((r - (C1 * y) * s[1]) + (C1 * z) * s[2]) - (C1 * x) * s[3];
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      r = r + (C2_0 * xy) * s[4];
      r = r + (C2_1 * yz) * s[5];
      r = r + (C2_2 * ((2.0f * zz - xx) - yy)) * s[6];
      r = r + (C2_3 * xz) * s[7];
      r = r + (C2_4 * (xx - yy)) * s[8];
      if (deg > 2) {
        r = r + ((C3_0 * y) * (3.0f * xx - yy)) * s[9];
        r = r + ((C3_1 * xy) * z) * s[10];
        r = r + ((C3_2 * y) * ((4.0f * zz - xx) - yy)) * s[11];
        r = r + ((C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy)) * s[12];
        r = r + ((C3_4 * x) * ((4.0f * zz - xx) - yy)) * s[13];
        r = r + ((C3_5 * z) * (xx - yy)) * s[14];
        r = r + ((C3_6 * x) * (xx - 3.0f * yy)) * s[15];
      }
    }
  }
  return clamp_min(r + 0.5f, 0.0f);
}

// Copies nf contiguous floats from src (16-byte aligned) through put(f, v),
// 16 bytes a load, the warp's lanes side by side.
template <class Put>
__device__ __forceinline__ void copy_coalesced(const float* src, int nf, int lane, Put put) {
  for (int q = lane; q < nf / 4; q += 32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + q);
    put(4 * q, v.x);
    put(4 * q + 1, v.y);
    put(4 * q + 2, v.z);
    put(4 * q + 3, v.w);
  }
  for (int f = nf / 4 * 4 + lane; f < nf; f += 32) put(f, __ldg(src + f));
}

// Stages the warp's SH rows (``rows`` of them, from slot ``first``, a
// multiple of 32, so each source below starts 16-byte aligned) into
// ``dst``, a row per lane at ``PITCH`` floats, channel c's coefficient j at
// c * K + j. The activated form copies (n, 3, K) rows whole; the raw form
// puts f_dc at j = 0 and f_rest's coefficients 1 .. (deg + 1)^2 - 1 after it.
template <int K, int PITCH, bool RAW>
__device__ __forceinline__ void stage_sh(const Args& a, int64_t first, int rows, int lane,
                                         float* dst) {
  if constexpr (!RAW) {
    constexpr int ROW = 3 * K;
    copy_coalesced(a.sh + first * ROW, rows * ROW, lane,
                   [&](int f, float v) { dst[(f / ROW) * PITCH + f % ROW] = v; });
  } else {
    const float* dc = a.sh + first * 3;
    for (int f = lane; f < rows * 3; f += 32) dst[(f / 3) * PITCH + (f % 3) * K] = __ldg(dc + f);
    if constexpr (K > 1) {
      constexpr int REST = K - 1;
      const int nc = (a.sh_degree + 1) * (a.sh_degree + 1) - 1;  // coefficients past the DC
      const float* src = a.sh_rest + first * 3 * REST;
      if (nc == REST) {  // every band: whole rows
        copy_coalesced(src, rows * 3 * REST, lane, [&](int f, float v) {
          const int r = f / (3 * REST), e = f % (3 * REST);
          dst[r * PITCH + (e / REST) * K + 1 + e % REST] = v;
        });
      } else {  // the bands up to sh_degree alone, a float a lane
        for (int f = lane; f < rows * 3 * nc; f += 32) {
          const int r = f / (3 * nc), e = f % (3 * nc), c = e / nc, j = e % nc;
          dst[r * PITCH + c * K + 1 + j] = __ldg(src + r * 3 * REST + c * REST + j);
        }
      }
    }
  }
}

template <int K, bool RAW>
__global__ void __launch_bounds__(THREADS)
preprocess_kernel(const Args a) {
  constexpr int ROW = 3 * K;                   // floats of a slot's SH row
  constexpr int PITCH = ROW % 2 ? ROW : ROW + 1;  // odd: lanes on distinct banks
  __shared__ float stage[WARPS][32 * PITCH];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t first = (int64_t)blockIdx.x * THREADS + warp * 32;  // the warp's slot 0
  const int64_t i = first + lane;
  const bool in = i < a.n;
  const float* V = a.view;
  const float* P = a.proj;

  float x = 0.f, y = 0.f, z = 0.f;
  if (in) {
    x = a.means[3 * i];
    y = a.means[3 * i + 1];
    z = a.means[3 * i + 2];
  }
  // view space (ewa_project's t is the same product)
  const float vx = dot3(x, y, z, __ldg(V + 0), __ldg(V + 1), __ldg(V + 2)) + __ldg(V + 3);
  const float vy = dot3(x, y, z, __ldg(V + 4), __ldg(V + 5), __ldg(V + 6)) + __ldg(V + 7);
  const float vz = dot3(x, y, z, __ldg(V + 8), __ldg(V + 9), __ldg(V + 10)) + __ldg(V + 11);
  bool visible = vz > NEAR && (a.active == nullptr || (in && a.active[i] != 0));

  // projection to NDC, then pixels
  const float h0 = dot3(x, y, z, __ldg(P + 0), __ldg(P + 1), __ldg(P + 2)) + __ldg(P + 3);
  const float h1 = dot3(x, y, z, __ldg(P + 4), __ldg(P + 5), __ldg(P + 6)) + __ldg(P + 7);
  float pw = dot3(x, y, z, __ldg(P + 12), __ldg(P + 13), __ldg(P + 14)) + __ldg(P + 15);
  pw = visible ? pw + 1e-7f : 1.0f;
  const float mean_x = ndc_to_pix(h0 / pw, a.width);
  const float mean_y = ndc_to_pix(h1 / pw, a.height);

  // build_cov3d: R diag(s^2) R^T, the quaternion normalised first
  float qr = 1.f, qx = 0.f, qy = 0.f, qz = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, op = 0.f;
  if (in) {
    qr = a.quats[4 * i];
    qx = a.quats[4 * i + 1];
    qy = a.quats[4 * i + 2];
    qz = a.quats[4 * i + 3];
    s0 = a.scales[3 * i];
    s1 = a.scales[3 * i + 1];
    s2 = a.scales[3 * i + 2];
    op = a.opac[i];
    if (RAW) {
      s0 = act_exp(s0);
      s1 = act_exp(s1);
      s2 = act_exp(s2);
      op = act_sigmoid(op);
    }
  }
  const float qn = norm4(qr, qx, qy, qz);
  qr = qr / qn;
  qx = qx / qn;
  qy = qy / qn;
  qz = qz / qn;
  const float R00 = 1.f - 2.f * (qy * qy + qz * qz), R01 = 2.f * (qx * qy - qr * qz),
              R02 = 2.f * (qx * qz + qr * qy);
  const float R10 = 2.f * (qx * qy + qr * qz), R11 = 1.f - 2.f * (qx * qx + qz * qz),
              R12 = 2.f * (qy * qz - qr * qx);
  const float R20 = 2.f * (qx * qz - qr * qy), R21 = 2.f * (qy * qz + qr * qx),
              R22 = 1.f - 2.f * (qx * qx + qy * qy);
  s0 = a.scale_modifier * s0;
  s1 = a.scale_modifier * s1;
  s2 = a.scale_modifier * s2;
  const float u0 = s0 * s0, u1 = s1 * s1, u2 = s2 * s2;
  const float v00 = R00 * R00 * u0 + R01 * R01 * u1 + R02 * R02 * u2;
  const float v01 = R00 * R10 * u0 + R01 * R11 * u1 + R02 * R12 * u2;
  const float v02 = R00 * R20 * u0 + R01 * R21 * u1 + R02 * R22 * u2;
  const float v11 = R10 * R10 * u0 + R11 * R11 * u1 + R12 * R12 * u2;
  const float v12 = R10 * R20 * u0 + R11 * R21 * u1 + R12 * R22 * u2;
  const float v22 = R20 * R20 * u0 + R21 * R21 * u1 + R22 * R22 * u2;

  // ewa_project
  const float limx = 1.3f * a.tan_fovx, limy = 1.3f * a.tan_fovy;
  const float tz = fabsf(vz) < 1e-4f ? 1e-4f : vz;
  const float tx = clamp(vx / tz, -limx, limx) * tz;
  const float ty = clamp(vy / tz, -limy, limy) * tz;
  const float inv_z = 1.0f / tz;
  const float inv_z2 = inv_z * inv_z;
  float W[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) W[r][c] = __ldg(V + 4 * r + c);
  float A[3][3];  // A = W V
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    A[r][0] = W[r][0] * v00 + W[r][1] * v01 + W[r][2] * v02;
    A[r][1] = W[r][0] * v01 + W[r][1] * v11 + W[r][2] * v12;
    A[r][2] = W[r][0] * v02 + W[r][1] * v12 + W[r][2] * v22;
  }
  auto m = [&](int r, int l) {
    return A[r][0] * W[l][0] + A[r][1] * W[l][1] + A[r][2] * W[l][2];
  };
  const float m00 = m(0, 0), m01 = m(0, 1), m02 = m(0, 2);
  const float m11 = m(1, 1), m12 = m(1, 2), m22 = m(2, 2);
  const float focal_x = (1.0f / (2.0f * a.tan_fovx)) * (float)a.width;
  const float focal_y = (1.0f / (2.0f * a.tan_fovy)) * (float)a.height;
  const float j00 = focal_x * inv_z;
  const float j02 = -focal_x * tx * inv_z2;
  const float j11 = focal_y * inv_z;
  const float j12 = -focal_y * ty * inv_z2;
  const float ca = j00 * (j00 * m00 + j02 * m02) + j02 * (j00 * m02 + j02 * m22) + 0.3f;
  const float cb = j00 * (j11 * m01 + j12 * m02) + j02 * (j11 * m12 + j12 * m22);
  const float cc = j11 * (j11 * m11 + j12 * m12) + j12 * (j11 * m12 + j12 * m22) + 0.3f;

  // det, conic, radius = ceil(3 sqrt(max eigenvalue))
  const float det = ca * cc - cb * cb;
  visible = visible && det != 0.0f;
  const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float mid = 0.5f * (ca + cc);
  const float disc = sqrtf(clamp_min(mid * mid - det, 0.1f));
  const float lambda_max = mid + disc;
  const float radius = ceilf(3.0f * sqrtf(clamp_min(lambda_max, 0.0f)));

  // opacity-aware extents, capped at the radius; the tile rect
  const float ln_op = logf(clamp_min(255.0f * op, 1.0f));
  float ext_x = ceilf(sqrtf(clamp_min(2.0f * ca * ln_op, 1e-12f)));
  float ext_y = ceilf(sqrtf(clamp_min(2.0f * cc * ln_op, 1e-12f)));
  ext_x = minimum(ext_x, radius);
  ext_y = minimum(ext_y, radius);
  const float inv_tile = 1.0f / (float)a.tile;
  const int grid_x = (a.width + a.tile - 1) / a.tile;
  const int grid_y = (a.height + a.tile - 1) / a.tile;
  const int rx0 = clampi(to_int32((mean_x - ext_x) * inv_tile), 0, grid_x);
  const int ry0 = clampi(to_int32((mean_y - ext_y) * inv_tile), 0, grid_y);
  const int rx1 = clampi(
      to_int32((((mean_x + ext_x) + (float)a.tile) - 1.0f) * inv_tile), 0, grid_x);
  const int ry1 = clampi(
      to_int32((((mean_y + ext_y) + (float)a.tile) - 1.0f) * inv_tile), 0, grid_y);
  const int tiles = (rx1 - rx0) * (ry1 - ry0);
  visible = visible && tiles > 0;

  // the SH colour of the slots that are drawn, from the warp's staged rows
  float r = 0.f, g = 0.f, b = 0.f;
  if (__ballot_sync(FULL, in && visible)) {
    const int64_t left = a.n - first;
    float* dst = stage[warp];
    stage_sh<K, PITCH, RAW>(a, first, (int)(left < 32 ? left : 32), lane, dst);
    __syncwarp();
    if (in && visible) {
      const float dx = x - __ldg(a.campos), dy = y - __ldg(a.campos + 1),
                  dz = z - __ldg(a.campos + 2);
      const float dn = norm3(dx, dy, dz);
      const float ux = dx / dn, uy = dy / dn, uz = dz / dn;
      const float* row = dst + lane * PITCH;
      r = eval_sh(a.sh_degree, row, ux, uy, uz);
      g = eval_sh(a.sh_degree, row + K, ux, uy, uz);
      b = eval_sh(a.sh_degree, row + 2 * K, ux, uy, uz);
    }
  }
  if (!in) return;

  a.means2d[i] = make_float2(mean_x, mean_y);
  a.depths[i] = vz;
  a.conics[3 * i] = cc * inv_det;
  a.conics[3 * i + 1] = -cb * inv_det;
  a.conics[3 * i + 2] = ca * inv_det;
  a.rgb[3 * i] = r;
  a.rgb[3 * i + 1] = g;
  a.rgb[3 * i + 2] = b;
  a.opac_out[i] = visible ? op : 0.0f;
  a.radii[i] = visible ? to_int32(radius) : 0;
  a.tiles[i] = visible ? tiles : 0;
  a.rect_min[i] = make_int2(rx0, ry0);
  a.rect_max[i] = make_int2(rx1, ry1);
  a.cull_thr[i] = ln_op;
}

template <int K>
cudaError_t launch(const Args& a, bool raw, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
  if (raw)
    preprocess_kernel<K, true><<<blocks, THREADS, 0, stream>>>(a);
  else
    preprocess_kernel<K, false><<<blocks, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

__global__ void activation_kernel(const float* x, float* e, float* s, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    e[i] = act_exp(x[i]);
    s[i] = act_sigmoid(x[i]);
  }
}

}  // namespace

// k: SH coefficients per channel (1, 4, 9 or 16); sh_degree <= 3 with
// (sh_degree + 1)^2 <= k. raw = 0: the activated form, sh (n, 3, k)
// 16-byte aligned, sh_rest null. raw = 1: scales and opac the raw log-scales
// and logits, sh f_dc (n, 3, 1), sh_rest f_rest (n, 3, k - 1) 16-byte
// aligned (null where k = 1). Outputs as Preprocessed lays them out,
// contiguous.
extern "C" int preprocess_launch(
    const void* means, const void* scales, const void* quats, const void* opac,
    const void* sh, const void* sh_rest, const void* active, int64_t n, int k, int sh_degree,
    int raw, const void* view, const void* proj, const void* campos, float tan_fovx,
    float tan_fovy, int width, int height, int tile, float scale_modifier, void* means2d,
    void* depths, void* conics, void* rgb, void* opac_out, void* radii, void* tiles,
    void* rect_min, void* rect_max, void* cull_thr, void* stream) {
  if (n <= 0 || sh_degree < 0 || sh_degree > 3 || (sh_degree + 1) * (sh_degree + 1) > k ||
      tile < 1 || (raw ? (k > 1 && (sh_rest == nullptr || ((uintptr_t)sh_rest & 15)))
                       : ((uintptr_t)sh & 15)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)means, (const float*)scales, (const float*)quats,
               (const float*)opac, (const float*)sh, (const float*)sh_rest,
               (const uint8_t*)active,
               (const float*)view, (const float*)proj, (const float*)campos,
               n, sh_degree, tan_fovx, tan_fovy, scale_modifier, width, height, tile,
               (float2*)means2d, (float*)depths, (float*)conics, (float*)rgb,
               (float*)opac_out, (int*)radii, (int*)tiles, (int2*)rect_min,
               (int2*)rect_max, (float*)cull_thr};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch<1>(a, raw != 0, s);
    case 4: return (int)launch<4>(a, raw != 0, s);
    case 9: return (int)launch<9>(a, raw != 0, s);
    case 16: return (int)launch<16>(a, raw != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The raw form's activation alone, for checking against torch.exp and
// torch.sigmoid: e = exp(x), s = sigmoid(x) over n floats.
extern "C" int preprocess_activation_launch(const void* x, void* e, void* s, int64_t n,
                                            void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  activation_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)e, (float*)s, n);
  return (int)cudaGetLastError();
}

// CTAs of the SH-3 kernel's raw form (the served view's) resident per SM,
// as the runtime computes it.
extern "C" int preprocess_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, preprocess_kernel<16, true>, THREADS, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
