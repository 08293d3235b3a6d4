// Tile binning (K8): from the preprocessed gaussians to the compositors'
// depth-sorted instance list, in one pipeline over the kept pairs.
//
// Computes ops/binning.py's build_sorted_instances_plain, field for field:
// every (gaussian, tile) pair of each gaussian's tile rect (the
// enumeration, max_instances slots in gaussian order), the exact
// ellipse-vs-tile cull (_tile_ellipse_kept) and, where given, the gaze
// decimation (gaze_decimation_keep); the kept pairs sorted by (tile,
// depth), gaussians of equal depth in id order; each gaussian's kept
// range in id order (gauss_start / gauss_count), each sorted instance's
// place in it (id_pos), the tiles' CSR offsets, the counters; and the
// compositors' (16, kp) struct-of-arrays rows [x, y, conic a, b, c, r, g,
// b, opacity, gauss_id] with `lead` empty lanes first and zero lanes past
// the listed instances (rows 10-15 are not written: no compositor reads
// them).
//
// Replaces no TPU kernel: the JAX package's build_sorted_instances is XLA
// ops around the expand kernel K1 (_expand_seg_kernel). Run op by op in
// PyTorch it is ~235 launches over the whole capacity: K1 wrote 16 rows of
// every slot, the cull ran as ~60 tensor ops, a stable sort of 64-bit
// keys with 64-bit values took every slot, two argsorts compacted the
// gaussians. K1 stays, as that JAX kernel's counterpart.
//
// Bound: bytes. Read the gaussians' attributes (~1M live of 4M slots),
// write and sort the pairs' 12-byte (key, value) records, gather each
// listed instance's attributes into 10 rows. At the 1M scene's 6M kept
// pairs in 2^23 slots that is ~1 GB, ~0.3 ms at 3.35 TB/s; the sort's
// passes are most of it. The pipeline (one stream, no synchronisation,
// no allocation: the wrapper hands in one workspace):
//   1. tiles_partials / tiles_scan: the exclusive sum of tiles_touched in
//      int64, kept as each gaussian's first slot clipped to the capacity
//      (seg, int32) and the total;
//   2. cull: a CTA owns a run of RUN (2,048) slots and finds each slot's
//      gaussian by the block-level search over seg (segsearch.cuh, K1's);
//      each warp culls 32 consecutive slots and ballots them into one
//      word of a kept bitmask; a CTA count per run;
//   3. kept_scan: one CTA scans the runs' counts; the counters and the
//      overflow flag;
//   4. emit: each kept slot writes its key (tile << 32 | the depth's bits
//      as an order-preserving unsigned) and its kept-order index at that
//      index, the count of kept slots before it (gaussian-id order, no
//      atomics); every other slot a sentinel key past the kept ones;
//   5. cub::DeviceRadixSort::SortPairs on the key's significant bits
//      (32 + bits of num_tiles) over the capacity, stable: equal depths
//      keep id order, as the plain version's stable rank of depth does;
//   6. layout (a second call, after the caller has its lane offset): each
//      lane reads its sorted value and writes the feature rows, gauss_id,
//      tile_id, id_pos and the CSR offsets at tile boundaries; other CTAs
//      write gauss_start / gauss_count from the bitmask's prefix counts.
//
// Exact arithmetic. The cull decides which pairs exist, so it is compiled
// with -fmad=false (backend.py's SOURCE_FLAGS) and written op for op as
// the plain version's tensor ops round it: each product, sum and quotient
// rounded on its own, PyTorch's scalars rounded to float, minimum and
// maximum passing NaN on. Integer tile decoding mirrors the plain
// version's packed rect (grids under 1024 tiles a side).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_load.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>

#include "segsearch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RUN = 2048;               // slots per CTA of cull / emit
constexpr int RUN_STEPS = RUN / THREADS;  // slots per thread
constexpr int RUN_WORDS = RUN / 32;     // bitmask words per run
constexpr int WMAX = 2048;              // segment starts staged per run (8 KB)
constexpr int SCAN_ITEMS = 16;          // tiles_touched per thread of the scan
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;
constexpr int KSCAN_THREADS = 1024;     // kept_scan's one CTA
constexpr int KSCAN_ITEMS = 4;
constexpr unsigned FULL = 0xffffffffu;

// PyTorch's scalars as its float kernels take them
constexpr float THR_MIN = (float)1e-20;
constexpr float CONIC_MIN = (float)1e-12;
constexpr float KEEP_Q = (float)(1.0 + 1e-4);

struct Inputs {
  const float2* means2d;
  const float* conics;  // (N, 3)
  const float* rgb;     // (N, 3)
  const float* opac;
  const int* tiles;
  const int2* rect_min;
  const int2* rect_max;
  const float* cull_thr;
  const float* depths;
  int n;
};

struct Gaze {
  const float* xy;     // (2,) or null: no decimation
  const float* radii;  // (3,)
  int steps[4];
};

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp_min(x, lo): NaN stays NaN
__device__ __forceinline__ float tclamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

// ops/binning.py's _tile_ellipse_kept for one pair, op for op.
__device__ __forceinline__ bool tile_ellipse_kept(int tx, int ty, float cx, float cy,
                                                  float ca, float cb, float cc, float thr,
                                                  int tile_px) {
  // the plain version clamps cull_thr at 0 (compact_table), then at 1e-20
  const float inv_thr = 1.0f / tclamp_min(tclamp_min(thr, 0.0f), THR_MIN);
  ca = ca * inv_thr;
  cb = cb * inv_thr;
  cc = cc * inv_thr;
  const float x0 = (float)(tx * tile_px) - cx;
  const float y0 = (float)(ty * tile_px) - cy;
  const float x1 = x0 + (float)(tile_px - 1);
  const float y1 = y0 + (float)(tile_px - 1);
  auto q_at = [&](float dx, float dy) {
    return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
  };
  const float cc_s = cc > CONIC_MIN ? cc : CONIC_MIN;
  const float ca_s = ca > CONIC_MIN ? ca : CONIC_MIN;
  const float ncb = -cb;
  const float dy_l = tmin(tmax(ncb * x0 / cc_s, y0), y1);
  const float dy_r = tmin(tmax(ncb * x1 / cc_s, y0), y1);
  const float dx_b = tmin(tmax(ncb * y0 / ca_s, x0), x1);
  const float dx_t = tmin(tmax(ncb * y1 / ca_s, x0), x1);
  const float q_edges = tmin(tmin(q_at(x0, dy_l), q_at(x1, dy_r)),
                             tmin(q_at(dx_b, y0), q_at(dx_t, y1)));
  const float q_corners = tmin(tmin(q_at(x0, y0), q_at(x1, y0)),
                               tmin(q_at(x0, y1), q_at(x1, y1)));
  const bool inside = (x0 <= 0.0f) & (x1 >= 0.0f) & (y0 <= 0.0f) & (y1 >= 0.0f);
  const float qmin = inside ? 0.0f : tmin(q_edges, q_corners);
  return qmin <= KEEP_Q;
}

// ops/binning.py's gaze_decimation_keep for one pair.
__device__ __forceinline__ bool gaze_keep(const Gaze& gz, int tx, int ty, int gid,
                                          int tile_px) {
  const float half = (float)tile_px / 2.0f;
  const float cx = (float)tx * (float)tile_px + half - gz.xy[0];
  const float cy = (float)ty * (float)tile_px + half - gz.xy[1];
  const float d2 = cx * cx + cy * cy;
  const float r0 = gz.radii[0], r1 = gz.radii[1], r2 = gz.radii[2];
  const int lvl = 4 - ((d2 > r0 * r0) + (d2 > r1 * r1) + (d2 > r2 * r2));
  const int s = gz.steps[lvl - 1];
  const int st = s > 1 ? s : 1;
  return gid % st == (ty * 797 + tx) % st;
}

// The tile of slot k of gaussian g (its r-th rect pair), as the plain
// version decodes it from the packed rect (rect_min.x * 1024 + width).
__device__ __forceinline__ void pair_tile(const Inputs& in, int g, int r, int& tx, int& ty) {
  const int2 rmin = in.rect_min[g];
  const int rectp = rmin.x * 1024 + max(in.rect_max[g].x - rmin.x, 1);
  const int w = max(rectp & 1023, 1);
  tx = (rectp >> 10) + r % w;
  ty = rmin.y + r / w;
}

// Depth bits whose unsigned order is the float order (-0 as +0, every NaN
// last), below the tile in the sort key.
__device__ __forceinline__ unsigned depth_bits(float d) {
  if (d != d) return FULL;
  if (d == 0.0f) d = 0.0f;
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The run's window of segment starts and the search of a slot's gaussian.
struct Window {
  int u0, u1, c_lo;
  bool staged;
  const int* seg;
  const int* win;

  // the gaussian of enumeration slot k of the run, and its first slot
  __device__ __forceinline__ int gauss_of(int k, int& first) const {
    int u;
    if (staged) {
      auto s = [&](int i) { return win[i - c_lo]; };
      u = upper_bound_in(s, u0, u1, k);
      first = win[u - 1 - c_lo];
    } else {
      auto s = [&](int i) { return __ldg(seg + i); };
      u = upper_bound_in(s, u0, u1, k);
      first = __ldg(seg + u - 1);
    }
    return u - 1;
  }
};

// Every slot of [run0, run_last] lies in the window: two warps search
// seg (n entries), the CTA stages the window when it fits in `win`.
__device__ __forceinline__ Window run_window(const int* __restrict__ seg, int n, int run0,
                                             int run_last, int* win, int* ub) {
  const int warp = threadIdx.x / 32;
  if (warp < 2) {
    const int u = warp_upper_bound(seg, n, warp == 0 ? run0 : run_last);
    if (threadIdx.x % 32 == 0) ub[warp] = u;
  }
  __syncthreads();
  Window w;
  w.u0 = ub[0];
  w.u1 = ub[1];
  w.c_lo = w.u0 - 1;  // >= 0: seg[0] = 0 <= run0
  const int width = w.u1 - w.c_lo;
  w.staged = width <= WMAX;
  w.seg = seg;
  w.win = win;
  if (w.staged) {
    for (int i = threadIdx.x; i < width; i += THREADS) win[i] = __ldg(seg + w.c_lo + i);
    __syncthreads();
  }
  return w;
}

// 1. Per CTA of SCAN_TILE gaussians: the sum of their tiles_touched.
__global__ void __launch_bounds__(THREADS)
tiles_partials_kernel(const int* __restrict__ tiles, int n, long long* __restrict__ partials) {
  using Reduce = cub::BlockReduce<long long, THREADS>;
  __shared__ typename Reduce::TempStorage tmp;
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  long long sum = 0;
  for (int m = 0; m < SCAN_ITEMS; ++m) {
    const int64_t g = base + m * THREADS + threadIdx.x;
    if (g < n) sum += __ldg(tiles + g);
  }
  sum = Reduce(tmp).Sum(sum);
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// 1. seg[g] = min(exclusive sum of tiles_touched, k), seg[n] = min(total,
// k), total in int64. Each CTA adds up the partials before it.
__global__ void __launch_bounds__(THREADS)
tiles_scan_kernel(const int* __restrict__ tiles, int n, const long long* __restrict__ partials,
                  int k, int* __restrict__ seg, long long* __restrict__ total) {
  using Load = cub::BlockLoad<int, THREADS, SCAN_ITEMS, cub::BLOCK_LOAD_TRANSPOSE>;
  using Reduce = cub::BlockReduce<long long, THREADS>;
  using Scan = cub::BlockScan<long long, THREADS>;
  __shared__ union {
    typename Load::TempStorage load;
    typename Reduce::TempStorage reduce;
    typename Scan::TempStorage scan;
  } tmp;
  __shared__ long long block_prefix;
  long long before = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += THREADS) before += partials[i];
  before = Reduce(tmp.reduce).Sum(before);
  if (threadIdx.x == 0) block_prefix = before;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  const int valid = (int)min((int64_t)SCAN_TILE, (int64_t)n - base);
  int items[SCAN_ITEMS];
  Load(tmp.load).Load(tiles + base, items, valid, 0);
  __syncthreads();
  long long own = 0;
#pragma unroll
  for (int m = 0; m < SCAN_ITEMS; ++m) own += items[m];
  long long run;
  Scan(tmp.scan).ExclusiveSum(own, run);
  run += block_prefix;
  const long long cap = k;
#pragma unroll
  for (int m = 0; m < SCAN_ITEMS; ++m) {
    const int64_t g = base + (int64_t)threadIdx.x * SCAN_ITEMS + m;
    if (g < n) {
      seg[g] = (int)min(run, cap);
      run += items[m];
      if (g == n - 1) {
        seg[n] = (int)min(run, cap);
        *total = run;
      }
    }
  }
}

// 2. The kept bitmask of every slot of the run (bit l of word q: slot
// run0 + 32 q + l) and the run's kept count.
__global__ void __launch_bounds__(THREADS)
cull_kernel(Inputs in, const int* __restrict__ seg, int k, int tile_px, Gaze gz,
            unsigned* __restrict__ words, int* __restrict__ counts) {
  __shared__ int win[WMAX];
  __shared__ int ub[2];
  __shared__ int warp_kept[WARPS];
  const int run0 = blockIdx.x * RUN;
  const int kend = __ldg(seg + in.n);  // valid slots: k < min(total, capacity)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int kept_total = 0;
  if (run0 < kend) {  // block-uniform
    const Window w = run_window(seg, in.n, run0, min(run0 + RUN, kend) - 1, win, ub);
    for (int it = 0; it < RUN_STEPS; ++it) {
      const int slot = run0 + it * THREADS + threadIdx.x;
      bool kept = false;
      if (slot < kend) {
        int first;
        const int g = w.gauss_of(slot, first);
        int tx, ty;
        pair_tile(in, g, slot - first, tx, ty);
        const float2 m = in.means2d[g];
        kept = tile_ellipse_kept(tx, ty, m.x, m.y, in.conics[3 * g], in.conics[3 * g + 1],
                                 in.conics[3 * g + 2], in.cull_thr[g], tile_px);
        if (kept && gz.xy != nullptr) kept = gaze_keep(gz, tx, ty, g, tile_px);
      }
      const unsigned word = __ballot_sync(FULL, kept);
      if (lane == 0) {
        words[(int64_t)blockIdx.x * RUN_WORDS + it * WARPS + warp] = word;
        kept_total += __popc(word);
      }
    }
  } else if (lane == 0) {
    for (int it = 0; it < RUN_STEPS; ++it)
      words[(int64_t)blockIdx.x * RUN_WORDS + it * WARPS + warp] = 0u;
  }
  if (lane == 0) warp_kept[warp] = kept_total;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int i = 0; i < WARPS; ++i) sum += warp_kept[i];
    counts[blockIdx.x] = sum;
  }
}

// 3. The runs' exclusive prefix of kept counts, the kept total and the
// counters: num_instances, num_enumerated (int32 of the int64 total, as
// the plain version casts it) and overflow.
__global__ void __launch_bounds__(KSCAN_THREADS)
kept_scan_kernel(const int* __restrict__ counts, int runs, const long long* __restrict__ total,
                 int k, int max_live, int* __restrict__ prefix, int* __restrict__ n_kept,
                 int* __restrict__ num_instances, int* __restrict__ num_enumerated,
                 unsigned char* __restrict__ overflow) {
  using Scan = cub::BlockScan<int, KSCAN_THREADS>;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (int base = 0; base < runs; base += KSCAN_THREADS * KSCAN_ITEMS) {
    int items[KSCAN_ITEMS];
    int own = 0;
#pragma unroll
    for (int m = 0; m < KSCAN_ITEMS; ++m) {
      const int i = base + threadIdx.x * KSCAN_ITEMS + m;
      items[m] = i < runs ? counts[i] : 0;
      own += items[m];
    }
    int run, aggregate;
    Scan(tmp).ExclusiveSum(own, run, aggregate);
    __syncthreads();
    run += carry;
#pragma unroll
    for (int m = 0; m < KSCAN_ITEMS; ++m) {
      const int i = base + threadIdx.x * KSCAN_ITEMS + m;
      if (i < runs) prefix[i] = run;
      run += items[m];
    }
    carry += aggregate;
  }
  if (threadIdx.x == 0) {
    const long long t = *total;
    *n_kept = carry;
    *num_instances = carry;
    *num_enumerated = (int)t;
    *overflow = (t > (long long)k || carry > max_live) ? 1 : 0;
  }
}

// 4. Each slot's key and value at its place: kept slot -> the count of
// kept slots before it, any other -> past the kept ones. Also the words'
// exclusive kept prefix (for gauss_start) and the values (the identity:
// the value at place i is i, the kept-order index).
__global__ void __launch_bounds__(THREADS)
emit_kernel(Inputs in, const int* __restrict__ seg, int k, int grid_x,
            unsigned long long sentinel, const unsigned* __restrict__ words,
            const int* __restrict__ prefix, const int* __restrict__ n_kept_p,
            int* __restrict__ word_prefix, unsigned long long* __restrict__ keys,
            unsigned* __restrict__ vals, int* __restrict__ gid) {
  __shared__ int win[WMAX];
  __shared__ int ub[2];
  __shared__ unsigned wsm[RUN_WORDS];
  __shared__ int wpre[RUN_WORDS];
  const int run0 = blockIdx.x * RUN;
  const int kend = __ldg(seg + in.n);
  const int n_kept = *n_kept_p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {  // RUN_WORDS = 64: two words a lane
    const unsigned a = words[(int64_t)blockIdx.x * RUN_WORDS + 2 * lane];
    const unsigned b = words[(int64_t)blockIdx.x * RUN_WORDS + 2 * lane + 1];
    const int pa = __popc(a), pb = __popc(b);
    int incl = pa + pb;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int excl = prefix[blockIdx.x] + incl - pa - pb;
    wsm[2 * lane] = a;
    wsm[2 * lane + 1] = b;
    wpre[2 * lane] = excl;
    wpre[2 * lane + 1] = excl + pa;
    word_prefix[(int64_t)blockIdx.x * RUN_WORDS + 2 * lane] = excl;
    word_prefix[(int64_t)blockIdx.x * RUN_WORDS + 2 * lane + 1] = excl + pa;
  }
  __syncthreads();
  Window w{};
  const bool any_valid = run0 < kend;  // block-uniform
  if (any_valid) w = run_window(seg, in.n, run0, min(run0 + RUN, kend) - 1, win, ub);
  const unsigned below = (1u << lane) - 1u;
  for (int it = 0; it < RUN_STEPS; ++it) {
    const int slot = run0 + it * THREADS + threadIdx.x;
    if (slot >= k) break;
    const int q = it * WARPS + warp;
    const unsigned word = wsm[q];
    const int kc = wpre[q] + __popc(word & below);
    if ((word >> lane) & 1u) {
      int first;
      const int g = w.gauss_of(slot, first);
      int tx, ty;
      pair_tile(in, g, slot - first, tx, ty);
      const unsigned long long tile = (unsigned long long)(ty * grid_x + tx);
      keys[kc] = (tile << 32) | depth_bits(in.depths[g]);
      gid[kc] = g;
    } else {
      keys[n_kept + (slot - kc)] = sentinel;
    }
    vals[slot] = (unsigned)slot;
  }
}

// kept slots before slot s (s <= k)
__device__ __forceinline__ int kept_before(int s, int k, int n_kept,
                                           const unsigned* __restrict__ words,
                                           const int* __restrict__ word_prefix) {
  if (s >= k) return n_kept;
  const unsigned below = (1u << (s & 31)) - 1u;
  return word_prefix[s >> 5] + __popc(words[s >> 5] & below);
}

struct Layout {
  const unsigned long long* keys;  // sorted
  const unsigned* vals;            // sorted: kept-order index
  const int* gid;                  // kept-order index -> gaussian
  const unsigned* words;
  const int* word_prefix;
  const int* seg;
  const int* n_kept;
  int k, max_live, lead, kp, num_tiles;
  int64_t lanes;  // lane threads: max(kp, lead + max_live + 1)
  int lane_blocks;
  float* feat;  // (16, kp)
  int* gauss_id;
  int* tile_id;
  long long* id_pos;
  int* offsets;  // (num_tiles + 1,)
  int* gauss_start;
  int* gauss_count;
};

// 6. Lanes: the feature rows, gauss_id, tile_id, id_pos and the offsets at
// tile boundaries; the CTAs past lane_blocks: gauss_start / gauss_count.
__global__ void __launch_bounds__(THREADS) layout_kernel(Inputs in, Layout lo) {
  if ((int)blockIdx.x >= lo.lane_blocks) {
    const int64_t g = (int64_t)(blockIdx.x - lo.lane_blocks) * THREADS + threadIdx.x;
    if (g >= in.n) return;
    const int n_kept = *lo.n_kept;
    const int a = kept_before(__ldg(lo.seg + g), lo.k, n_kept, lo.words, lo.word_prefix);
    const int b = kept_before(__ldg(lo.seg + g + 1), lo.k, n_kept, lo.words, lo.word_prefix);
    lo.gauss_start[g] = a;
    lo.gauss_count[g] = b - a;
    return;
  }
  const int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (j >= lo.lanes) return;
  const int64_t lane = j - lo.lead;  // sorted position
  const int num_tiles = lo.num_tiles;
  int tile = num_tiles;
  if (lane >= 0 && lane < lo.max_live) tile = (int)(lo.keys[lane] >> 32);
  if (j < lo.kp) {
    float f[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tile < num_tiles) {
      const int g = lo.gid[lo.vals[lane]];
      const float2 m = in.means2d[g];
      f[0] = m.x;
      f[1] = m.y;
      f[2] = in.conics[3 * g];
      f[3] = in.conics[3 * g + 1];
      f[4] = in.conics[3 * g + 2];
      f[5] = in.rgb[3 * g];
      f[6] = in.rgb[3 * g + 1];
      f[7] = in.rgb[3 * g + 2];
      f[8] = in.opac[g];
      f[9] = (float)g;
    }
#pragma unroll
    for (int r = 0; r < 10; ++r) lo.feat[(int64_t)r * lo.kp + j] = f[r];
  }
  if (lane < 0 || lane > lo.max_live) return;
  if (lane < lo.max_live) {
    const bool kept = tile < num_tiles;
    const unsigned i = lo.vals[lane];
    lo.gauss_id[lane] = kept ? lo.gid[i] : 0;
    lo.tile_id[lane] = tile;
    lo.id_pos[lane] = kept ? (long long)i : (long long)lo.k;
  }
  // offsets[t] = the first position whose tile is >= t: position `lane`
  // owns the tiles after the previous position's, up to its own (the
  // virtual position max_live owns the rest)
  const int prev = lane > 0 ? (int)(lo.keys[lane - 1] >> 32) : -1;
  const int last = lane < lo.max_live ? tile : num_tiles;
  for (int t = prev + 1; t <= last; ++t) lo.offsets[t] = (int)lane;
}

// The workspace: every buffer 256-byte aligned, CUB's sort storage last
// (from `temp` to the end of the workspace).
struct Work {
  size_t keys0, keys1, vals0, vals1, gid, words, word_prefix, counts, prefix, seg, partials,
      total, n_kept, temp;
};

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// The offsets for n gaussians and a capacity of k slots.
Work work_layout(int n, int k) {
  const size_t runs = (size_t)(k + RUN - 1) / RUN;
  const size_t parts = (size_t)(n + SCAN_TILE - 1) / SCAN_TILE;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += align_up(bytes);
    return here;
  };
  Work w;
  w.keys0 = take((size_t)k * 8);
  w.keys1 = take((size_t)k * 8);
  w.vals0 = take((size_t)k * 4);
  w.vals1 = take((size_t)k * 4);
  w.gid = take((size_t)k * 4);
  w.words = take(runs * RUN_WORDS * 4);
  w.word_prefix = take(runs * RUN_WORDS * 4);
  w.counts = take(runs * 4);
  w.prefix = take(runs * 4);
  w.seg = take(((size_t)n + 1) * 4);
  w.partials = take(parts * 8);
  w.total = take(8);
  w.n_kept = take(4);
  w.temp = at;
  return w;
}

template <typename T>
T* at(void* base, size_t offset) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + offset);
}

Inputs make_inputs(const void* means2d, const void* conics, const void* rgb, const void* opac,
                   const void* tiles, const void* rect_min, const void* rect_max,
                   const void* cull_thr, const void* depths, int n) {
  return Inputs{(const float2*)means2d, (const float*)conics, (const float*)rgb,
                (const float*)opac, (const int*)tiles, (const int2*)rect_min,
                (const int2*)rect_max, (const float*)cull_thr, (const float*)depths, n};
}

}  // namespace

// Bytes of the workspace that binning_sort_launch and binning_layout_launch
// share for n gaussians, a capacity of k slots and sort keys of end_bit
// bits; a negative CUDA error code if CUB refuses the sort.
extern "C" long long binning_workspace_bytes(int n, int k, int end_bit) {
  cub::DoubleBuffer<unsigned long long> dk(nullptr, nullptr);
  cub::DoubleBuffer<unsigned> dv(nullptr, nullptr);
  size_t temp = 0;
  const cudaError_t err =
      cub::DeviceRadixSort::SortPairs(nullptr, temp, dk, dv, k, 0, end_bit);
  if (err != cudaSuccess) return -(long long)err;
  return (long long)(work_layout(n, k).temp + align_up(temp));
}

// Steps 1-5 on `stream`: the counters into num_instances (int32),
// num_enumerated (int32) and overflow (bool); the sorted pairs in the
// workspace, in the buffer that *selector (host int) names for
// binning_layout_launch. gaze_xy null: no decimation.
extern "C" int binning_sort_launch(
    const void* means2d, const void* conics, const void* rgb, const void* opac,
    const void* tiles, const void* rect_min, const void* rect_max, const void* cull_thr,
    const void* depths, int n, int k, int max_live, int grid_x, int num_tiles, int tile_px,
    int end_bit, const void* gaze_xy, const void* gaze_radii, int step1, int step2, int step3,
    int step4, void* ws, long long ws_bytes, void* num_instances, void* num_enumerated,
    void* overflow, int* selector, void* stream) {
  if (n <= 0 || k <= 0 || max_live < 0 || max_live > k || grid_x <= 0 || grid_x >= 1024 ||
      num_tiles <= 0 || tile_px <= 0 || end_bit <= 32 || end_bit > 64 ||
      (num_tiles >> (end_bit - 32)) != 0)
    return (int)cudaErrorInvalidValue;
  const Work w = work_layout(n, k);
  if ((long long)w.temp >= ws_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Inputs in = make_inputs(means2d, conics, rgb, opac, tiles, rect_min, rect_max,
                                cull_thr, depths, n);
  const Gaze gz{(const float*)gaze_xy, (const float*)gaze_radii, {step1, step2, step3, step4}};
  const int parts = (n + SCAN_TILE - 1) / SCAN_TILE;
  const int runs = (k + RUN - 1) / RUN;
  int* seg = at<int>(ws, w.seg);
  long long* total = at<long long>(ws, w.total);
  int* n_kept = at<int>(ws, w.n_kept);
  tiles_partials_kernel<<<parts, THREADS, 0, st>>>(in.tiles, n, at<long long>(ws, w.partials));
  tiles_scan_kernel<<<parts, THREADS, 0, st>>>(in.tiles, n, at<long long>(ws, w.partials), k,
                                               seg, total);
  cull_kernel<<<runs, THREADS, 0, st>>>(in, seg, k, tile_px, gz, at<unsigned>(ws, w.words),
                                        at<int>(ws, w.counts));
  kept_scan_kernel<<<1, KSCAN_THREADS, 0, st>>>(
      at<int>(ws, w.counts), runs, total, k, max_live, at<int>(ws, w.prefix), n_kept,
      (int*)num_instances, (int*)num_enumerated, (unsigned char*)overflow);
  const unsigned long long sentinel = ((unsigned long long)num_tiles << 32) | FULL;
  emit_kernel<<<runs, THREADS, 0, st>>>(
      in, seg, k, grid_x, sentinel, at<unsigned>(ws, w.words), at<int>(ws, w.prefix),
      n_kept, at<int>(ws, w.word_prefix), at<unsigned long long>(ws, w.keys0),
      at<unsigned>(ws, w.vals0), at<int>(ws, w.gid));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cub::DoubleBuffer<unsigned long long> dk(at<unsigned long long>(ws, w.keys0),
                                           at<unsigned long long>(ws, w.keys1));
  cub::DoubleBuffer<unsigned> dv(at<unsigned>(ws, w.vals0), at<unsigned>(ws, w.vals1));
  size_t temp_bytes = (size_t)ws_bytes - w.temp;
  err = cub::DeviceRadixSort::SortPairs(at<void>(ws, w.temp), temp_bytes, dk, dv, k, 0,
                                        end_bit, st);
  if (err != cudaSuccess) return (int)err;
  if (dk.selector != dv.selector) return (int)cudaErrorInvalidValue;
  *selector = dk.selector;
  return (int)cudaGetLastError();
}

// Step 6 on `stream`, after binning_sort_launch on the same workspace:
// feat (16, kp) float32 with `lead` empty lanes first (rows 0-9 written),
// gauss_id / tile_id (max_live,) int32, id_pos (max_live,) int64, offsets
// (num_tiles + 1,) int32, gauss_start / gauss_count (n,) int32.
extern "C" int binning_layout_launch(
    const void* means2d, const void* conics, const void* rgb, const void* opac,
    const void* tiles, const void* rect_min, const void* rect_max, const void* cull_thr,
    const void* depths, int n, int k, int max_live, int num_tiles, int selector, int lead, int kp, void* ws, long long ws_bytes, void* feat, void* gauss_id, void* tile_id,
    void* id_pos, void* offsets, void* gauss_start, void* gauss_count, void* stream) {
  if (n <= 0 || k <= 0 || max_live < 0 || max_live > k || lead < 0 ||
      (long long)kp < (long long)lead + max_live || (selector != 0 && selector != 1))
    return (int)cudaErrorInvalidValue;
  const Work w = work_layout(n, k);
  if ((long long)w.temp >= ws_bytes) return (int)cudaErrorInvalidValue;
  const Inputs in = make_inputs(means2d, conics, rgb, opac, tiles, rect_min, rect_max,
                                cull_thr, depths, n);
  Layout lo;
  lo.keys = at<unsigned long long>(ws, selector ? w.keys1 : w.keys0);
  lo.vals = at<unsigned>(ws, selector ? w.vals1 : w.vals0);
  lo.gid = at<int>(ws, w.gid);
  lo.words = at<unsigned>(ws, w.words);
  lo.word_prefix = at<int>(ws, w.word_prefix);
  lo.seg = at<int>(ws, w.seg);
  lo.n_kept = at<int>(ws, w.n_kept);
  lo.k = k;
  lo.max_live = max_live;
  lo.lead = lead;
  lo.kp = kp;
  lo.num_tiles = num_tiles;
  lo.lanes = max((int64_t)kp, (int64_t)lead + max_live + 1);
  lo.lane_blocks = (int)((lo.lanes + THREADS - 1) / THREADS);
  lo.feat = (float*)feat;
  lo.gauss_id = (int*)gauss_id;
  lo.tile_id = (int*)tile_id;
  lo.id_pos = (long long*)id_pos;
  lo.offsets = (int*)offsets;
  lo.gauss_start = (int*)gauss_start;
  lo.gauss_count = (int*)gauss_count;
  const int blocks = lo.lane_blocks + (n + THREADS - 1) / THREADS;
  layout_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(in, lo);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
