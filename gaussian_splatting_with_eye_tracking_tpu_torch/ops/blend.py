"""Per-tile alpha compositing, forward (kernel K2), the foveated forward
compositors (K2's AMR variants and K5) and backward (kernel K3), the
differentiable splat around them, and image assembly.

Port of ``gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py``:
the constants, ``_feat_soa_from_rows``, the forward tile compositor
``_fwd_kernel`` with ``_blend_stream_loop`` (``blend_fwd``: stride=1,
n_rounds=0, step=1; ``blend_round``: one AMR round's stride-2 subgrid, as
``blend_round_pallas``; ``blend_levels``: rounds 1..level per tile with
per-level decimation and ``scale_only``, as ``_fwd_levels_kernel`` /
``blend_levels_fused_pallas``, which also carries the ``n_rounds`` /
``step`` variants), the backward tile compositor ``_bwd_kernel``,
``splat_pallas`` with ``_blend_fwd`` / ``_blend_bwd`` /
``_segment_reduce_grads`` (as the autograd Function ``Splat``),
``_assemble_tiles`` and ``render_tiles_pallas``. On CUDA tensors
``blend_fwd``, ``blend_round`` / ``blend_levels`` and ``blend_bwd`` launch
``csrc/blend_fwd.cu``, ``csrc/blend_amr.cu`` and ``csrc/blend_bwd.cu``; on
CPU tensors they run the ``*_plain`` versions.

Semantics shared by both versions (and the TPU kernels):

- tile t composites its depth-sorted CSR range [o, o+n) of the (16, K')
  SoA feature array in chunks aligned to GLOBAL multiples of ``chunk``:
  start = floor(o/chunk)*chunk, n_chunks = ceil((o+n-start)/chunk) if n
  else 0; lanes outside [o, o+n) are masked through log(op) = -inf;
- alpha_raw = exp(power + log op), alpha = min(0.99, alpha_raw), kept iff
  power <= 0 and alpha_raw >= 1/255;
- transmittance in log space: w = alpha * exp(logT + exclusive prefix of
  log(1-alpha)), logT += the chunk's sum;
- after each whole chunk the TILE exits once max(logT) < ln 1e-4, the
  max over every row the tile renders (all rounds of a foveated tile);
- foveated decimation: a tile's stream may run every step-th chunk with
  its log(1-alpha) scaled (see ``_stream_plain``);
- forward output (T, P, 8) per pixel: rgb (no background), exp(logT),
  chunks_done, logT, 0, 0;
- backward: chunks replayed back to front from the forward's logT (never
  by division by final_T), the suffix accumulator seeded with
  dL/dT_final * final_T, zero gradient on chunks at or past chunks_done,
  d_power gated by keep & alpha_raw < 0.99, d_opacity = sum d_power / op;
  gradients of instance i are written at its sorted position i.

The TPU kernels' MXU scans and moment matmuls, bf16 limb splits, private
per-tile gradient regions and TUNE knobs were TPU workarounds and are not
ported. The CUDA compositors launch the tiles heaviest first
(``tile_order``) and skip, per warp, the instances whose gate extent
(``gate_box``) misses the warp's pixels; neither changes a value.
"""

from __future__ import annotations

import ctypes
import math

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as binning_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import segsum

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LOG_T_MIN = math.log(1e-4)  # the tile exits once every pixel's T < 1e-4
# the CUDA compositors' pre-test before the exp (csrc/stage.cuh): a pair
# with power + log op below it cannot pass the alpha gate
LOG_GATE = math.log(ALPHA_MIN) - 1e-5

FEAT = 16  # SoA rows (10 used)
GID_ROW = 9  # feature row carrying the gaussian id (exact in f32 < 2^24)
OUTC = 8  # output columns per pixel: r, g, b, final_T, chunks_done, logT, 0, 0
NGRAD = 9  # per-instance gradient rows: x, y, conic a, b, c, r, g, b, opacity

TILE = 32  # the port's tile and chunk sizes; the CUDA kernel is built for them
CHUNK = 128

BLEND_FWD = backend.CudaKernel(
    "blend_fwd", "blend_fwd", "blend_fwd_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)

BLEND_BWD = backend.CudaKernel(
    "blend_bwd", "blend_bwd", "blend_bwd_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
)

BLEND_ROUND = backend.CudaKernel(
    "blend_round", "blend_amr", "blend_round_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p],
)
# CTAs that ``blend_round`` may split a tile over (a thread-block cluster;
# 1 is one CTA per tile)
ROUND_SPLITS = (1, 2, 4)

BLEND_LEVELS = backend.CudaKernel(
    "blend_levels", "blend_amr", "blend_levels_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)

# tiles composited together by the plain versions (bounds their (B, P,
# chunk) temporaries to ~134 MB / ~34 MB each at P = 1024, chunk = 128)
_PLAIN_TILE_BATCH = 256
_PLAIN_BWD_TILE_BATCH = 64


def feat_soa_from_rows(feat_rows: torch.Tensor, chunk: int, lead: int = 0) -> torch.Tensor:
    """(10, K) sorted feature rows -> (FEAT, K') with zero rows 10..15 and
    lanes zero-padded to a chunk multiple (aligned chunk reads may touch
    the pad), after ``lead`` zero lanes. Port of ``_feat_soa_from_rows``."""
    k = feat_rows.shape[1]
    pad = (-(k + lead)) % chunk
    return torch.nn.functional.pad(feat_rows, (lead, pad, 0, FEAT - feat_rows.shape[0]))


def _chunk_ranges(offsets: torch.Tensor, chunk: int, counts: torch.Tensor | None = None):
    """Per tile: range start o, instance count n (``counts`` where given,
    else the CSR range's length), aligned chunk start and chunk count."""
    o = offsets[:-1].to(torch.int64)
    n = offsets[1:].to(torch.int64) - o if counts is None else counts.to(torch.int64)
    start = (o // chunk) * chunk
    n_chunks = torch.where(n > 0, (o + n - start + chunk - 1) // chunk,
                           torch.zeros_like(n))
    return o, n, start, n_chunks


def _tile_pixels(t: torch.Tensor, grid_x: int, tile: int, stride: int = 1,
                 offx: int = 0, offy: int = 0):
    """(B, (tile/stride)^2) float32 pixel coordinates of tiles ``t``: the
    subgrid x = ox + stride*i + offx, y = oy + stride*j + offy, row-major.
    stride 1 is the whole tile; stride 2 with a cell offset is an AMR
    round. Port of ``_pixel_coords``."""
    pw = tile // stride
    pix = torch.arange(pw * pw, device=t.device)
    px = ((t % grid_x) * tile)[:, None] + ((pix % pw) * stride + offx)[None, :]
    py = ((t // grid_x) * tile)[:, None] + ((pix // pw) * stride + offy)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


# AMR round r (1..4) -> its pixel's offset in each 2x2 cell: (0,0), (1,1),
# (1,0), (0,1)
ROUND_OFFX = (0, 1, 1, 0)
ROUND_OFFY = (0, 1, 0, 1)


def _tile_pixels_rounds(t: torch.Tensor, grid_x: int, tile: int, n_rounds: int):
    """Rounds 1..n_rounds' stride-2 subgrids stacked on the pixel axis:
    round r+1 in columns [r*sub, (r+1)*sub), sub = (tile/2)^2. Port of
    ``_pixel_coords_rounds``."""
    parts = [_tile_pixels(t, grid_x, tile, 2, ROUND_OFFX[r], ROUND_OFFY[r])
             for r in range(n_rounds)]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def tile_order(work: torch.Tensor) -> torch.Tensor:
    """(T,) int64 launch order of the tiles for the CUDA compositors: by
    descending ``work`` per tile, ties in tile order, so that the heaviest
    tiles start in the first wave. The outputs do not depend on it."""
    return torch.argsort(work, descending=True, stable=True)


def levels_order(counts: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """``blend_levels``' launch order: ``tile_order`` of level x instances
    per tile (a level-L tile composites L pixels per thread)."""
    return tile_order(levels * counts)


def round_order(counts: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """The 5-step frame's launch order of the tiles for all four
    ``blend_round`` launches: by descending (level, instances), ties in
    tile order. Round r renders the tiles at level >= r, so each round's
    tiles are a prefix of this one order, heaviest first among equal
    levels, and the tiles it skips form the tail."""
    return tile_order(levels.to(torch.int64) << 32 | counts.to(torch.int64))


def gate_box(x, y, a, b, c, opacity):
    """Plain mirror of the CUDA compositors' per-instance gate extent
    (``gate_warps`` in csrc/stage.cuh), in float64: (x0, x1, y0, y1) of the
    box that holds every pixel at which an instance with centre (x, y),
    conic (a, b, c) and ``opacity`` (float32 tensors) can pass the alpha
    gate. An empty box (x0 > x1) where no pixel can; an infinite one where
    the conic is not culled (not positive definite, or conditioning
    ac/det above 1e5). See stage.cuh for the margins."""
    lo = torch.log(opacity).double()
    x, y, a, b, c = (v.double() for v in (x, y, a, b, c))
    tau = lo - math.log(ALPHA_MIN) + 1e-4
    det = a * c - b * b
    kappa = a * c / det
    k = 2.0 * tau * (1.0 + 1e-3 + 1e-5 * kappa) / det
    hx = torch.sqrt(k * c) + 1e-2 + 1e-6 * x.abs()
    hy = torch.sqrt(k * a) + 1e-2 + 1e-6 * y.abs()
    cull = (a > 0) & (c > 0) & (det > 0) & (kappa <= 1e5)
    hx = torch.where(cull, hx, math.inf)
    hy = torch.where(cull, hy, math.inf)
    empty = ~(tau > 0)
    hx = torch.where(empty, -math.inf, hx)
    hy = torch.where(empty, -math.inf, hy)
    return x - hx, x + hx, y - hy, y + hy


def _alpha_terms(f, valid, px, py):
    """Feature rows f (9, B, C) of a chunk, lane mask (B, C) and pixel
    coordinates (B, P) -> dx, dy, power, power + log op, alpha_raw, keep
    and the gated, clamped alpha, each (B, P, C)."""
    logop = torch.where(valid, torch.log(f[8]), torch.full_like(f[8], -math.inf))
    hca, ncb, hcc = -0.5 * f[2], -f[3], -0.5 * f[4]
    dx = f[0][:, None, :] - px[:, :, None]
    dy = f[1][:, None, :] - py[:, :, None]
    power = (hca[:, None, :] * dx + ncb[:, None, :] * dy) * dx \
        + (hcc[:, None, :] * dy) * dy
    log_alpha = power + logop[:, None, :]
    alpha_raw = torch.exp(log_alpha)
    keep = (power <= 0.0) & (alpha_raw >= ALPHA_MIN)
    alpha = torch.where(keep, torch.clamp_max(alpha_raw, ALPHA_MAX),
                        torch.zeros_like(alpha_raw))
    return dx, dy, power, log_alpha, alpha_raw, keep, alpha


def _count_work(work: dict, valid, power, log_alpha, keep, pixels: int):
    """Add a chunk's (pixel, in-range instance) pairs ("lanes"), those with
    power <= 0 ("exp_lanes"), those with power <= 0 that pass the
    log-domain pre-test power + log op >= LOG_GATE ("gate_lanes": the exps
    the CUDA compositors run) and those that pass the alpha gate
    ("kept")."""
    exp_lanes = valid[:, None, :] & (power <= 0.0)
    for key, n_pairs in (("lanes", int(valid.sum()) * pixels),
                         ("exp_lanes", int(exp_lanes.sum())),
                         ("gate_lanes", int((exp_lanes & (log_alpha >= LOG_GATE)).sum())),
                         ("kept", int(keep.sum()))):
        work[key] = work.get(key, 0) + n_pairs


def blend_fwd_plain(feat_soa: torch.Tensor, offsets: torch.Tensor,
                    grid_x: int, grid_y: int, tile: int = TILE,
                    chunk: int = CHUNK, work: dict | None = None) -> torch.Tensor:
    """Plain PyTorch forward compositor, vectorized over batches of tiles
    and looping over the chunk index. See the module docstring for the
    semantics; returns (T, tile*tile, OUTC) float32. ``tile`` and ``chunk``
    other than the port's serve the comparison with the JAX package.

    If ``work`` is a dict, the data-dependent work of this input is added to
    it, over the chunks the tiles run: "lanes", the (pixel, in-range
    instance) pairs; "exp_lanes", those of them with power <= 0; "kept",
    the pairs that pass the alpha gate."""
    num_tiles = grid_x * grid_y
    out = torch.zeros((num_tiles, tile * tile, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    ranges = _chunk_ranges(offsets, chunk)
    for b0 in range(0, num_tiles, _PLAIN_TILE_BATCH):
        t = torch.arange(b0, min(b0 + _PLAIN_TILE_BATCH, num_tiles), device=feat_soa.device)
        _stream_plain(feat_soa, [r[t] for r in ranges], *_tile_pixels(t, grid_x, tile),
                      chunk, out, t, work=work)
    return out


def _stream_plain(feat_soa, ranges, px, py, chunk, out, t, step=1, scale_only=False,
                  work=None, amr_work=False):
    """Composite the tiles ``t`` (ranges = their o, n, start, n_chunks) at
    pixels px, py (B, P) and write rows [0, P) of ``out[t]``: rgb,
    exp(logT), chunks run, logT. The chunk loop of the module docstring,
    with ``_blend_stream_loop``'s decimation: ``step`` > 1 runs every
    step-th chunk, ceil(n_chunks/step) of them, each standing in for rep =
    min(step, n_chunks - ci*step) chunks (log(1-alpha) scaled by rep, alpha
    = 1 - exp of it where rep > 1); with ``scale_only`` every chunk runs
    and every log(1-alpha) is scaled by ``step``. ``amr_work`` also counts
    "staged" (in-range instances staged, one log of opacity each) and
    "rescaled" (kept pairs whose alpha is recomputed)."""
    dev = feat_soa.device
    kp = feat_soa.shape[1]
    pixels = px.shape[1]
    o, n, start, nch_full = ranges
    decimate = step > 1 and not scale_only
    dma_step = step if decimate else 1
    nch = (nch_full + step - 1) // step if decimate else nch_full
    lane = torch.arange(chunk, device=dev)
    nb = px.shape[0]
    log_t = torch.zeros((nb, pixels), dtype=torch.float32, device=dev)
    rgb = torch.zeros((nb, pixels, 3), dtype=torch.float32, device=dev)
    done = torch.zeros(nb, dtype=torch.int64, device=dev)
    alive = nch > 0
    for ci in range(int(nch.max()) if nb else 0):
        run = alive & (ci < nch)
        if not bool(run.any()):
            break
        ids = start[:, None] + ci * dma_step * chunk + lane[None, :]  # (B, C)
        f = feat_soa[:9, ids.clamp_max(kp - 1)]  # (9, B, C)
        valid = run[:, None] & (ids >= o[:, None]) & (ids < (o + n)[:, None])
        _, _, power, log_alpha, alpha_raw, keep, alpha = _alpha_terms(f, valid, px, py)
        if work is not None:
            _count_work(work, valid, power, log_alpha, keep, pixels)
        lom = torch.log(1.0 - alpha)
        rescaled = None
        if step > 1:  # this chunk's lanes each stand in for rep instances
            rep = (torch.full_like(nch_full, step) if scale_only
                   else torch.clamp_max(nch_full - ci * step, step))
            rep = rep.to(torch.float32)[:, None, None]
            lom = lom * rep
            alpha = torch.where(rep > 1, 1.0 - torch.exp(lom), alpha)
            rescaled = keep & (rep > 1)
        if work is not None and amr_work:
            work["staged"] = work.get("staged", 0) + int(valid.sum())
            work["rescaled"] = work.get("rescaled", 0) + (
                0 if rescaled is None else int(rescaled.sum()))
        csum = torch.cumsum(lom, dim=-1)
        excl = torch.nn.functional.pad(csum[..., :-1], (1, 0))
        w = alpha * torch.exp(log_t[..., None] + excl)
        rgb = rgb + torch.bmm(w, f[5:8].permute(1, 2, 0))
        log_t = log_t + csum[..., -1]
        done = done + run.to(torch.int64)
        alive = run & ~(log_t.max(dim=-1).values < LOG_T_MIN)
    out[t, :pixels, 0:3] = rgb
    out[t, :pixels, 3] = torch.exp(log_t)
    out[t, :pixels, 4] = done[:, None].to(torch.float32)
    out[t, :pixels, 5] = log_t


@tracing.spanned("gs.composite")
def blend_fwd(feat_soa: torch.Tensor, offsets: torch.Tensor, grid_x: int,
              grid_y: int) -> torch.Tensor:
    """Forward tile compositor: feat_soa (FEAT, K') float32 with K' a
    multiple of CHUNK, offsets (T+1,) int32 CSR ranges into it. Returns
    (T, TILE*TILE, OUTC)."""
    if feat_soa.device.type == "cpu":
        return blend_fwd_plain(feat_soa, offsets, grid_x, grid_y)
    backend.check_cuda_tensor("feat_soa", feat_soa, torch.float32)
    backend.check_cuda_tensor("offsets", offsets, torch.int32)
    backend.check_aligned("feat_soa", feat_soa)
    num_tiles = grid_x * grid_y
    if feat_soa.shape[0] != FEAT or feat_soa.shape[1] % CHUNK:
        raise ValueError(f"feat_soa shape {tuple(feat_soa.shape)} is not "
                         f"({FEAT}, multiple of {CHUNK})")
    if offsets.shape != (num_tiles + 1,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != ({num_tiles + 1},)")
    out = torch.empty((num_tiles, TILE * TILE, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    if num_tiles > 0:
        order = tile_order(offsets[1:] - offsets[:-1])  # instances per tile
        BLEND_FWD(feat_soa.data_ptr(), feat_soa.shape[1], offsets.data_ptr(),
                  order.data_ptr(), num_tiles, grid_x, out.data_ptr(),
                  backend.stream_ptr(feat_soa))
    return out


def blend_round_plain(feat_soa: torch.Tensor, offsets: torch.Tensor, grid_x: int,
                      grid_y: int, *, offx: int, offy: int,
                      counts_override: torch.Tensor | None = None, tile: int = TILE,
                      chunk: int = CHUNK, work: dict | None = None) -> torch.Tensor:
    """Plain PyTorch compositing of one AMR round: each tile's stride-2
    subgrid at cell offset (offx, offy), rows in row-major subgrid order.
    ``counts_override`` (T,) replaces the CSR range lengths (0 skips a
    tile). Returns (T, (tile/2)^2, OUTC) as ``blend_fwd_plain`` lays it
    out. Port of ``blend_round_pallas`` (``_fwd_call`` with stride=2)."""
    num_tiles = grid_x * grid_y
    out = torch.zeros((num_tiles, (tile // 2) ** 2, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    ranges = _chunk_ranges(offsets, chunk, counts_override)
    for b0 in range(0, num_tiles, _PLAIN_TILE_BATCH):
        t = torch.arange(b0, min(b0 + _PLAIN_TILE_BATCH, num_tiles), device=feat_soa.device)
        _stream_plain(feat_soa, [r[t] for r in ranges],
                      *_tile_pixels(t, grid_x, tile, 2, offx, offy), chunk, out, t,
                      work=work, amr_work=True)
    return out


def blend_levels_plain(feat_soa: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
                       levels: torch.Tensor, grid_x: int, grid_y: int, *,
                       decimation=(1, 1, 1, 1), scale_only: bool = False,
                       tile: int = TILE, chunk: int = CHUNK,
                       work: dict | None = None) -> torch.Tensor:
    """Plain PyTorch fused foveated compositing: a tile at level L in 1..4
    composites rounds 1..L in one pass over its instances (``counts`` of
    them from its offset), its stream decimated by ``decimation[L-1]`` (see
    ``_stream_plain``; ``scale_only`` for a stream that binning already
    thinned). Returns (T, 4*sub, OUTC), sub = (tile/2)^2: rows [r*sub,
    (r+1)*sub) hold round r+1 for r < L, columns rgb, final_T, chunks run,
    logT; rows above the tile's level are zero. Port of
    ``blend_levels_fused_pallas`` as its interpret path computes it."""
    num_tiles = grid_x * grid_y
    out = torch.zeros((num_tiles, 4 * (tile // 2) ** 2, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    ranges = _chunk_ranges(offsets, chunk, counts)
    for lvl in range(1, 5):
        tiles = torch.nonzero(levels == lvl).flatten()
        for b0 in range(0, tiles.shape[0], _PLAIN_TILE_BATCH):
            t = tiles[b0:b0 + _PLAIN_TILE_BATCH]
            _stream_plain(feat_soa, [r[t] for r in ranges],
                          *_tile_pixels_rounds(t, grid_x, tile, lvl), chunk, out, t,
                          step=int(decimation[lvl - 1]), scale_only=scale_only,
                          work=work, amr_work=True)
    return out


def _check_amr_inputs(feat_soa, offsets, counts, num_tiles, levels=None):
    for name, x, dtype in (("feat_soa", feat_soa, torch.float32),
                           ("offsets", offsets, torch.int32),
                           ("counts", counts, torch.int32),
                           ("levels", levels, torch.int32)):
        if x is not None:
            backend.check_cuda_tensor(name, x, dtype)
    backend.check_aligned("feat_soa", feat_soa)
    if feat_soa.shape[0] != FEAT or feat_soa.shape[1] % CHUNK:
        raise ValueError(f"feat_soa shape {tuple(feat_soa.shape)} is not "
                         f"({FEAT}, multiple of {CHUNK})")
    if offsets.shape != (num_tiles + 1,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != ({num_tiles + 1},)")
    for name, x in (("counts", counts), ("levels", levels)):
        if x is not None and x.shape != (num_tiles,):
            raise ValueError(f"{name} shape {tuple(x.shape)} != ({num_tiles},)")


@tracing.spanned("gs.composite")
def blend_round(feat_soa: torch.Tensor, offsets: torch.Tensor, grid_x: int, grid_y: int,
                *, offx: int, offy: int, counts_override: torch.Tensor | None = None,
                order: torch.Tensor | None = None, split: int = 1) -> torch.Tensor:
    """One AMR round on TILE x TILE tiles: inputs as ``blend_fwd`` takes
    them, the cell offset, and optional per-tile counts (int, (T,)).
    Returns (T, (TILE/2)^2, OUTC); see ``blend_round_plain``. On CUDA the
    tiles launch in ``order`` ((T,) int64, a permutation of the tiles;
    by default ``tile_order`` of the counts, one sort) and each tile with a
    nonzero count is composited by ``split`` CTAs (one of ``ROUND_SPLITS``;
    a thread-block cluster above 1). Neither changes final_T, the chunks
    run or logT; rgb moves by rounding only."""
    if counts_override is None:
        counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    else:
        counts = counts_override.to(torch.int32).contiguous()
    if feat_soa.device.type == "cpu":
        return blend_round_plain(feat_soa, offsets, grid_x, grid_y, offx=offx, offy=offy,
                                 counts_override=counts)
    num_tiles = grid_x * grid_y
    _check_amr_inputs(feat_soa, offsets, counts, num_tiles)
    if offx not in (0, 1) or offy not in (0, 1):
        raise ValueError(f"cell offset ({offx}, {offy}) is not in {{0, 1}}^2")
    if split not in ROUND_SPLITS:
        raise ValueError(f"split {split} is not one of {ROUND_SPLITS}")
    if order is None:
        order = tile_order(counts)
    backend.check_cuda_tensor("order", order, torch.int64)
    if order.shape != (num_tiles,):
        raise ValueError(f"order shape {tuple(order.shape)} != ({num_tiles},)")
    out = torch.empty((num_tiles, (TILE // 2) ** 2, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    if num_tiles > 0:
        BLEND_ROUND(feat_soa.data_ptr(), feat_soa.shape[1], offsets.data_ptr(),
                    counts.data_ptr(), order.data_ptr(), num_tiles, grid_x, offx, offy, split,
                    out.data_ptr(), backend.stream_ptr(feat_soa))
    return out


@tracing.spanned("gs.composite")
def blend_levels(feat_soa: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
                 levels: torch.Tensor, grid_x: int, grid_y: int, *,
                 decimation=(1, 1, 1, 1), scale_only: bool = False) -> torch.Tensor:
    """Fused foveated compositing on TILE x TILE tiles, one pass per tile
    over rounds 1..level: inputs as ``blend_fwd`` takes them plus per-tile
    counts and levels (int, (T,)) and four per-level decimation steps.
    Returns (T, 4*(TILE/2)^2, OUTC); see ``blend_levels_plain``."""
    counts = counts.to(torch.int32).contiguous()
    levels = levels.to(torch.int32).contiguous()
    decimation = tuple(int(d) for d in decimation)
    if len(decimation) != 4 or min(decimation) < 1:
        raise ValueError(f"decimation {decimation} is not four steps >= 1")
    if feat_soa.device.type == "cpu":
        return blend_levels_plain(feat_soa, offsets, counts, levels, grid_x, grid_y,
                                  decimation=decimation, scale_only=scale_only)
    num_tiles = grid_x * grid_y
    _check_amr_inputs(feat_soa, offsets, counts, num_tiles, levels)
    out = torch.empty((num_tiles, 4 * (TILE // 2) ** 2, OUTC), dtype=torch.float32,
                      device=feat_soa.device)
    if num_tiles > 0:
        order = levels_order(counts, levels)
        BLEND_LEVELS(feat_soa.data_ptr(), feat_soa.shape[1], offsets.data_ptr(),
                     counts.data_ptr(), levels.data_ptr(), order.data_ptr(), num_tiles,
                     grid_x, *decimation, int(scale_only), out.data_ptr(),
                     backend.stream_ptr(feat_soa))
    return out


def blend_rounds_fused(feat_soa: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
                       n_rounds: int, grid_x: int, grid_y: int) -> torch.Tensor:
    """Rounds 1..n_rounds of every tile in one pass (``counts`` gates the
    tiles): ``blend_levels`` with every level n_rounds. Returns (T,
    n_rounds*(TILE/2)^2, OUTC). Port of ``blend_rounds_fused_pallas``."""
    levels = torch.full((grid_x * grid_y,), n_rounds, dtype=torch.int32,
                        device=feat_soa.device)
    out = blend_levels(feat_soa, offsets, counts, levels, grid_x, grid_y)
    return out[:, :n_rounds * (TILE // 2) ** 2]


def _suffix_incl(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the last axis."""
    return torch.flip(torch.cumsum(torch.flip(x, [-1]), dim=-1), [-1])


def blend_bwd_plain(feat_soa: torch.Tensor, offsets: torch.Tensor,
                    fwd_out: torch.Tensor, cot: torch.Tensor, grid_x: int,
                    grid_y: int, tile: int = TILE, chunk: int = CHUNK,
                    work: dict | None = None) -> torch.Tensor:
    """Plain PyTorch backward compositor, vectorized over batches of tiles
    and looping over the chunk index from the back. ``fwd_out`` is the
    forward's (T, P, OUTC) output, ``cot`` its cotangent (cols 0-2
    dL/dcolor without the background, col 3 dL/dfinal_T). Returns
    (NGRAD, K') float32: at each tile's sorted positions [o, o+n) the
    instance's dL/d[x, y, conic a, b, c, r, g, b, opacity], zero on chunks
    at or past ``chunks_done`` and outside every range.

    If ``work`` is a dict, the work the backward runs is added to it as
    ``blend_fwd_plain`` counts it, over the chunks before chunks_done."""
    dev = feat_soa.device
    num_tiles = grid_x * grid_y
    pixels = tile * tile
    kp = feat_soa.shape[1]
    dfeat = torch.zeros((NGRAD, kp), dtype=torch.float32, device=dev)
    o_all, n_all, start_all, nch_all = _chunk_ranges(offsets, chunk)
    done_all = torch.minimum(fwd_out[:, 0, 4].to(torch.int64), nch_all)
    lane = torch.arange(chunk, device=dev)
    for b0 in range(0, num_tiles, _PLAIN_BWD_TILE_BATCH):
        t = torch.arange(b0, min(b0 + _PLAIN_BWD_TILE_BATCH, num_tiles), device=dev)
        o, n, start, done = o_all[t], n_all[t], start_all[t], done_all[t]
        px, py = _tile_pixels(t, grid_x, tile)
        cur = fwd_out[t, :, 5]  # logT after the last chunk run, (B, P)
        s_acc = cot[t, :, 3] * fwd_out[t, :, 3]  # dL/dT_final * final_T
        g = cot[t, :, 0:3]  # (B, P, 3)
        for ci in range(int(done.max()) - 1, -1, -1):
            ids = start[:, None] + ci * chunk + lane[None, :]  # (B, C)
            f = feat_soa[:9, ids.clamp_max(kp - 1)]  # (9, B, C)
            valid = (ci < done)[:, None] & (ids >= o[:, None]) & (ids < (o + n)[:, None])
            dx, dy, power, log_alpha, alpha_raw, keep, alpha = _alpha_terms(f, valid, px, py)
            if work is not None:
                _count_work(work, valid, power, log_alpha, keep, pixels)
            om = 1.0 - alpha
            rsum = _suffix_incl(torch.log(om))  # sum over j >= i of log(1 - alpha_j)
            w = alpha * torch.exp(cur[..., None] - rsum)
            u = w * torch.bmm(g, f[5:8].permute(1, 0, 2))  # w * (dL/dcolor . rgb)
            s_i = s_acc[..., None] + (_suffix_incl(u) - u)
            dpow = torch.where(keep & (alpha_raw < ALPHA_MAX), u - alpha / om * s_i,
                               torch.zeros_like(u))
            e = [(dpow * m).sum(dim=1) for m in (dx, dy, dx * dx, dx * dy, dy * dy)]
            wrgb = torch.bmm(g.transpose(1, 2), w)  # (B, 3, C)
            a, b, c = f[2], f[3], f[4]
            grads = torch.stack([
                -(a * e[0] + b * e[1]), -(c * e[1] + b * e[0]),
                -0.5 * e[2], -e[3], -0.5 * e[4],
                wrgb[:, 0], wrgb[:, 1], wrgb[:, 2],
                dpow.sum(dim=1) / torch.clamp_min(f[8], 1e-30),
            ])  # (NGRAD, B, C)
            dfeat[:, ids[valid]] = grads[:, valid]
            s_acc = s_acc + u.sum(dim=-1)
            cur = cur - rsum[..., 0]
    return dfeat


def blend_bwd(feat_soa: torch.Tensor, offsets: torch.Tensor, fwd_out: torch.Tensor,
              cot: torch.Tensor, grid_x: int, grid_y: int) -> torch.Tensor:
    """Backward tile compositor on TILE x TILE tiles and CHUNK-wide chunks:
    feat_soa and offsets as ``blend_fwd`` takes them, ``fwd_out`` its
    output and ``cot`` that output's cotangent, both (T, TILE*TILE, OUTC)
    float32. Returns (NGRAD, K') per-instance gradients at sorted
    positions; see ``blend_bwd_plain``. On CUDA the result is a view of
    (K', segsum.REC) records (``segsum.record_rows``), the layout
    ``segment_reduce_grads`` gathers from."""
    if feat_soa.device.type == "cpu":
        return blend_bwd_plain(feat_soa, offsets, fwd_out, cot, grid_x, grid_y)
    for name, x, dtype in (("feat_soa", feat_soa, torch.float32),
                           ("offsets", offsets, torch.int32),
                           ("fwd_out", fwd_out, torch.float32),
                           ("cot", cot, torch.float32)):
        backend.check_cuda_tensor(name, x, dtype)
        if dtype == torch.float32:
            backend.check_aligned(name, x)
    num_tiles = grid_x * grid_y
    if feat_soa.shape[0] != FEAT or feat_soa.shape[1] % CHUNK:
        raise ValueError(f"feat_soa shape {tuple(feat_soa.shape)} is not "
                         f"({FEAT}, multiple of {CHUNK})")
    if offsets.shape != (num_tiles + 1,):
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != ({num_tiles + 1},)")
    for name, x in (("fwd_out", fwd_out), ("cot", cot)):
        if x.shape != (num_tiles, TILE * TILE, OUTC):
            raise ValueError(f"{name} shape {tuple(x.shape)} != "
                             f"({num_tiles}, {TILE * TILE}, {OUTC})")
    # the kernel writes every record, zeros included
    storage = segsum.records(feat_soa.shape[1], feat_soa.device)
    if num_tiles > 0:
        order = tile_order(fwd_out[:, 0, 4])  # chunks the forward ran
        BLEND_BWD(feat_soa.data_ptr(), feat_soa.shape[1], offsets.data_ptr(),
                  order.data_ptr(), num_tiles, grid_x, fwd_out.data_ptr(), cot.data_ptr(),
                  storage.data_ptr(), backend.stream_ptr(feat_soa))
    else:
        storage.zero_()
    return segsum.record_rows(storage, NGRAD)


def segment_reduce_grads(dfeat: torch.Tensor, id_pos: torch.Tensor,
                         gauss_start: torch.Tensor, gauss_count: torch.Tensor,
                         max_instances: int, lane_offset: int = 0) -> torch.Tensor:
    """Per-gaussian sums (NGRAD, N) of the per-instance gradients.

    Port of ``_segment_reduce_grads``. The JAX function sorts the gradient
    columns by their gaussian-id tag; here gaussian g sums the id-order
    slots [gauss_start[g], gauss_start[g] + gauss_count[g]), each slot
    reading the sorted instance that ``id_pos`` (``binning.SortedInstances``)
    put there (``id_order_source``), in one gather-and-sum launch of K4
    (``segsum.segment_sum_gather``). Where no instance was dropped for
    ``max_live`` these are JAX's bounds ``min(gauss_start ‖ last,
    n_live)``; where some were, their slots add nothing, so each gaussian
    still sums exactly its own rendered instances. ``lane_offset``: the
    sorted instances sit that many lanes into ``dfeat``."""
    src = id_order_source(id_pos, max_instances)
    if lane_offset:
        src = torch.where(src >= 0, src + lane_offset, src)
    return segsum.segment_sum_gather(dfeat, src, id_order_bounds(gauss_start, gauss_count))


def id_order_source(id_pos: torch.Tensor, max_instances: int) -> torch.Tensor:
    """(max_instances,) int32: for each gaussian-id-order slot the sorted
    position of its instance, -1 where none was kept (dropped for
    ``max_live``, or past the kept instances). The inverse of ``id_pos``,
    by one scatter (its trash slot ``max_instances`` is cut off)."""
    src = torch.full((max_instances + 1,), -1, dtype=torch.int32, device=id_pos.device)
    src[id_pos] = torch.arange(id_pos.shape[0], dtype=torch.int32, device=id_pos.device)
    return src[:max_instances]


def id_order_bounds(gauss_start: torch.Tensor, gauss_count: torch.Tensor) -> torch.Tensor:
    """The (N+1,) int32 segment bounds gauss_start ‖ last of the id order."""
    if gauss_start.numel():
        last = gauss_start[-1:] + gauss_count[-1:]
    else:
        last = gauss_start.new_zeros(1)
    return torch.cat([gauss_start, last]).to(torch.int32)


def id_order_table(dfeat, id_pos, gauss_start, gauss_count, max_instances):
    """The per-instance gradients moved to gaussian-id order as a table,
    (NGRAD, max_instances + 1) with the trash column last, and the id
    order's bounds: the inputs of ``segsum.segment_sum_bounds`` for the
    same sums as ``segment_reduce_grads`` (the profilers time this route
    beside it)."""
    table = dfeat.new_zeros((dfeat.shape[0], max_instances + 1))
    table[:, id_pos] = dfeat[:, :id_pos.shape[0]]
    return table, id_order_bounds(gauss_start, gauss_count)


class Splat(torch.autograd.Function):
    """Differentiable binning + tile compositing: the ``splat_pallas``
    contract. Forward: ``build_sorted_instances`` (K1) and K2; returns
    (tiles (T, P, OUTC), num_instances, num_enumerated, overflow).
    Backward: K3 and the per-gaussian gather-and-sum (K4); returns
    d xy, d conic, d rgb, d opacity per gaussian (nothing for the binning
    inputs tiles_touched, rect_min, rect_max, cull_thr and depths).

    ``lane_offset``, if given, maps the live instance count to a number of
    empty lanes put before the sorted instances: a band of a larger image
    (``parallel/sharded.py``) then aligns its chunks as the whole image's
    list does, so the tile exit falls where it falls there."""

    @staticmethod
    def forward(ctx, xy, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
                cull_thr, depths, grid_x, grid_y, max_instances, max_live, lane_offset=None):
        with tracing.span("gs.binning"):
            si = binning_ops.build_sorted_instances(
                xy, conics, rgb, opacities, tiles_touched, rect_min, rect_max,
                cull_thr, depths, grid_x, grid_y, max_instances, tile_px=TILE,
                max_live=max_live,
            )
            b = si.binning
            lead = 0 if lane_offset is None else lane_offset(b.num_instances)
            feat_soa = feat_soa_from_rows(si.feat_rows, CHUNK, lead)
            offsets = b.offsets + lead if lead else b.offsets
        tiles = blend_fwd(feat_soa, offsets, grid_x, grid_y)
        ctx.save_for_backward(feat_soa, offsets, tiles, b.gauss_start,
                              b.gauss_count, si.id_pos)
        ctx.grid = (grid_x, grid_y)
        ctx.max_instances = max_instances
        ctx.lead = lead
        ctx.mark_non_differentiable(b.num_instances, b.num_enumerated, b.overflow)
        return tiles, b.num_instances, b.num_enumerated, b.overflow

    @staticmethod
    def backward(ctx, g_tiles, *_):
        feat_soa, offsets, tiles, gauss_start, gauss_count, id_pos = ctx.saved_tensors
        dfeat = blend_bwd(feat_soa, offsets, tiles, g_tiles.contiguous(), *ctx.grid)
        seg = segment_reduce_grads(dfeat, id_pos, gauss_start, gauss_count,
                                   ctx.max_instances, ctx.lead)
        return (seg[0:2].T, seg[2:5].T, seg[5:8].T, seg[8],
                None, None, None, None, None, None, None, None, None, None)


@tracing.spanned("gs.assemble")
def assemble_tiles(tiles, grid_x, grid_y, tile, bg):
    """(T, P, OUTC) tiles -> color (3, H', W') with the background added
    through final_T, and final_t (H', W'), H' = grid_y*tile. Port of
    ``_assemble_tiles``."""
    color = tiles[:, :, 0:3]
    final_t = tiles[:, :, 3]
    color = color + final_t[:, :, None] * bg[None, None, :]
    color = color.reshape(grid_y, grid_x, tile, tile, 3)
    color = color.permute(4, 0, 2, 1, 3).reshape(3, grid_y * tile, grid_x * tile)
    final_t = final_t.reshape(grid_y, grid_x, tile, tile)
    final_t = final_t.permute(0, 2, 1, 3).reshape(grid_y * tile, grid_x * tile)
    return color, final_t


def render_tiles(prep, xy, grid_x, grid_y, bg, max_instances, max_live, lane_offset=None):
    """Full-image differentiable renderer from a Preprocessed bundle (``xy``
    passed separately, as in the JAX package, so that a screen-space
    offset can ride on it) on TILE x TILE tiles. Returns (color, final_t,
    aux) with aux = (num_instances, num_enumerated, overflow). Port of
    ``render_tiles_pallas``; ``lane_offset`` as ``Splat`` takes it."""
    tiles, num_instances, num_enumerated, overflow = Splat.apply(
        xy, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
        prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths,
        grid_x, grid_y, max_instances, max_live, lane_offset)
    color, final_t = assemble_tiles(tiles, grid_x, grid_y, TILE, bg)
    return color, final_t, (num_instances, num_enumerated, overflow)
