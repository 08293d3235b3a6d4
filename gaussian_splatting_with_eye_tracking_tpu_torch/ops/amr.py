"""AMR (adaptive mesh refinement) foveated rendering, forward only.

Port of ``gaussian_splatting_with_eye_tracking_tpu/ops/amr.py``:

- per-tile refinement levels 1..4 from the tile's instance count, binned
  at the 25/50/90th percentiles (``assign_levels``), or capped and floored
  by eccentricity rings around a gaze point (``gaze_levels``);
- each 32x32 tile is four interleaved 16x16 pixel subgrids ("rounds") at
  cell offsets (0,0), (1,1), (1,0), (0,1); a level-L tile renders rounds
  1..L and fills the others by copying the level's source pixel ((0,0)
  for L <= 2, (1,1) above);
- the 5-step protocol (``render_amr``): step 0 preprocesses, bins and
  assigns levels (``fovea_step0``), steps 1..4 render round k for the
  tiles at level >= k (``fovea_step_render``, one ``blend.blend_round``
  launch each), then ``interpolate``;
- the fused frame (``render_amr_fused``): one ``blend.blend_levels``
  launch renders rounds 1..level of every tile in one pass over its
  instances, optionally decimating coarse tiles' streams
  (``decimation``) or dropping their instances at binning time
  (``predecimate``, ``binning.gaze_decimation_keep``).

The 5-step frame's rounds take JAX's ``impl`` switch: ``"kernels"`` (the
default; also ``"auto"``) is ``blend.blend_round``, the CUDA kernel on CUDA
tensors and its plain version on CPU tensors; ``"jnp"`` is the oracle,
``tile_blend.render_tiles_jnp`` on the round's stride-2 subgrid with the
gated tiles' counts (no early stop). The fused frame has no oracle, as in
JAX. All tiles are ``blend.TILE`` pixels square and chunks ``blend.CHUNK``
wide.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as binning_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend, tile_blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import (
    CameraParams,
    preprocess,
)

TILE = blend.TILE
# round r (1..4) -> pixel offset (x, y) within each 2x2 cell
ROUND_OFFSET = {r: (blend.ROUND_OFFX[r - 1], blend.ROUND_OFFY[r - 1]) for r in range(1, 5)}
# level L -> offset of the source pixel that fills the rounds it skips
LEVEL_FILL_OFFSET = {1: (0, 0), 2: (0, 0), 3: (1, 1), 4: (1, 1)}
# CTAs per tile of each round's ``blend.blend_round`` launch
ROUND_SPLIT = (1, 1, 2, 4)


class AMRState(NamedTuple):
    """The carry between the protocol's steps."""

    xy: torch.Tensor  # (N, 2) screen positions
    conics: torch.Tensor  # (N, 3)
    rgb: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N,)
    gauss_id: torch.Tensor  # (K,) sorted instance list
    feat_soa: torch.Tensor  # (FEAT, K') sorted SoA rows for the compositors
    offsets: torch.Tensor  # (T+1,) int32
    tile_levels: torch.Tensor  # (T,) int32 target level 1..4
    tile_levels_last: torch.Tensor  # (T,) int32 level already rendered (0 init)
    color: torch.Tensor  # (3, H', W') accumulated image (pre-crop)
    final_t: torch.Tensor  # (H', W')
    num_instances: torch.Tensor
    num_enumerated: torch.Tensor  # () int32 rect pairs before the ellipse cull
    overflow: torch.Tensor
    # the 5-step frame's tile launch order (``blend.round_order``), made by
    # its first round and reused by the other three
    round_order: Optional[torch.Tensor] = None


def _grid(cam: CameraParams):
    return -(-cam.width // TILE), -(-cam.height // TILE)


def assign_levels(counts: torch.Tensor, percentiles=(0.25, 0.5, 0.9),
                  max_levels: int = 4) -> torch.Tensor:
    """Percentile-binned levels: counts <= q25 -> 1, <= q50 -> 2, <= q90
    -> 3, else 4, with q_p the sorted counts at index int(p*n) computed in
    float32 as the JAX function does."""
    srt = torch.sort(counts).values
    n = counts.shape[0]
    level = torch.ones_like(counts)
    for p in percentiles:
        thr = srt[min(int(np.float32(p) * np.float32(n)), n - 1)]
        level = level + (counts > thr).to(counts.dtype)
    return torch.clamp_max(level, max_levels)


def gaze_levels(tile_levels: torch.Tensor, grid_x: int, grid_y: int,
                gaze_xy: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """Gaze override: tiles whose centre lies within radii[0] of the gaze
    point (pixels) render at level 4; outside radii[i] the level is capped
    at 3-i; beyond the last ring it is 1. Squared distances, as
    ``binning.gaze_decimation_keep`` tests the same rings."""
    t = torch.arange(grid_x * grid_y, device=tile_levels.device)
    cx = ((t % grid_x) * TILE).to(torch.float32) + TILE / 2.0
    cy = ((t // grid_x) * TILE).to(torch.float32) + TILE / 2.0
    dx, dy = cx - gaze_xy[0], cy - gaze_xy[1]
    d2 = dx * dx + dy * dy
    r2 = radii * radii
    # the JAX sum of ring indicators, term for term (radii out of order
    # give the same caps there as here)
    cap = (4 * (d2 <= r2[0]).to(torch.int32)
           + 3 * ((d2 > r2[0]) & (d2 <= r2[1])).to(torch.int32)
           + 2 * ((d2 > r2[1]) & (d2 <= r2[2])).to(torch.int32)
           + (d2 > r2[2]).to(torch.int32))
    boosted = torch.where(d2 <= r2[0], 4, torch.minimum(tile_levels, cap))
    return boosted.to(torch.int32)


def _as_f32(x, device):
    return None if x is None else torch.as_tensor(x, dtype=torch.float32, device=device)


def fovea_step0(means3d, scales, quats, opacities, sh, sh_degree, cam: CameraParams, *,
                max_instances: int = 1 << 20, active_mask=None, gaze_xy=None,
                gaze_radii=None, percentiles=(0.25, 0.5, 0.9),
                predecimate=None) -> AMRState:
    """Step 0: preprocess, bin (no ``max_live``: every kept instance is
    listed) and assign levels; nothing is rendered.

    ``predecimate`` (four per-level steps; needs the gaze) drops coarse
    tiles' instances at binning time; the levels are then the pure gaze
    rings, so that each tile's survival ratio is its compensation
    exponent."""
    dev = means3d.device
    grid_x, grid_y = _grid(cam)
    gaze_xy, gaze_radii = _as_f32(gaze_xy, dev), _as_f32(gaze_radii, dev)
    prep = preprocess(means3d, scales, quats, opacities, sh, sh_degree, cam,
                      tile=TILE, active_mask=active_mask)
    gaze_decim = None
    if predecimate is not None:
        if gaze_xy is None or gaze_radii is None:
            raise ValueError("predecimate requires gaze_xy and gaze_radii")
        gaze_decim = (gaze_xy, gaze_radii, tuple(int(s) for s in predecimate))
    with tracing.span("gs.binning"):
        si = binning_ops.build_sorted_instances(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, grid_x, grid_y,
            max_instances, tile_px=TILE, gaze_decim=gaze_decim)
        b = si.binning
        feat_soa = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)
    with tracing.span("gs.levels"):
        if predecimate is not None:
            levels = gaze_levels(torch.full((grid_x * grid_y,), 4, dtype=torch.int32,
                                            device=dev), grid_x, grid_y, gaze_xy, gaze_radii)
        else:
            levels = assign_levels(b.offsets[1:] - b.offsets[:-1], percentiles)
            if gaze_xy is not None:
                levels = gaze_levels(levels, grid_x, grid_y, gaze_xy, gaze_radii)
        levels = levels.to(torch.int32)
    return AMRState(
        xy=prep.means2d, conics=prep.conics, rgb=prep.rgb, opacities=prep.opacities,
        gauss_id=b.gauss_id, feat_soa=feat_soa,
        offsets=b.offsets, tile_levels=levels, tile_levels_last=torch.zeros_like(levels),
        color=torch.zeros((3, grid_y * TILE, grid_x * TILE), device=dev),
        final_t=torch.ones((grid_y * TILE, grid_x * TILE), device=dev),
        num_instances=b.num_instances, num_enumerated=b.num_enumerated, overflow=b.overflow,
    )


def _subgrid_image(rows: torch.Tensor, grid_x: int, grid_y: int):
    """(T, 256, OUTC) round rows -> color (3, H'/2, W'/2), final_t."""
    pw = TILE // 2
    color = rows[:, :, 0:3].reshape(grid_y, grid_x, pw, pw, 3)
    color = color.permute(4, 0, 2, 1, 3).reshape(3, grid_y * pw, grid_x * pw)
    final_t = rows[:, :, 3].reshape(grid_y, grid_x, pw, pw)
    final_t = final_t.permute(0, 2, 1, 3).reshape(grid_y * pw, grid_x * pw)
    return color, final_t


def _level_map(tile_levels: torch.Tensor, grid_x: int, grid_y: int) -> torch.Tensor:
    """(H'/2, W'/2) level of each subgrid pixel's tile."""
    pw = TILE // 2
    return tile_levels.reshape(grid_y, grid_x).repeat_interleave(pw, 0).repeat_interleave(pw, 1)


def fovea_step_render(state: AMRState, rnd: int, grid_x: int, grid_y: int, *,
                      impl: str = "kernels", max_per_tile: int = 1024) -> AMRState:
    """Step k (1..4): render round k for the tiles at level >= k and merge
    it into the image (through strided views of a copy of it). With the
    kernels the tiles launch in one order per frame (``blend.round_order``,
    sorted by the first round to run), each round's tiles a prefix of it;
    round k splits each tile over ``ROUND_SPLIT[k - 1]`` CTAs. ``"jnp"``
    renders the round with the oracle, each tile's instances capped at
    ``max_per_tile``."""
    offx, offy = ROUND_OFFSET[rnd]
    gate = state.tile_levels >= rnd
    counts = state.offsets[1:] - state.offsets[:-1]
    gated_counts = torch.where(gate, counts, 0)
    order = state.round_order
    if impl == "jnp":
        color_r, final_t_r = tile_blend.render_tiles_jnp(
            state.xy, state.conics, state.rgb, state.opacities, state.gauss_id, state.offsets,
            grid_x, grid_y, TILE, torch.zeros(3, device=state.xy.device),
            max_per_tile=max_per_tile, stride=2, offx=offx, offy=offy, counts=gated_counts)
    elif impl in ("kernels", "auto"):
        if order is None:
            order = blend.round_order(counts, state.tile_levels)
        rows = blend.blend_round(state.feat_soa, state.offsets, grid_x, grid_y, offx=offx,
                                 offy=offy, counts_override=gated_counts, order=order,
                                 split=ROUND_SPLIT[rnd - 1])
        color_r, final_t_r = _subgrid_image(rows, grid_x, grid_y)
    else:
        raise ValueError(f"fovea_step_render: impl {impl!r} is not kernels, auto or jnp")
    gate_px = _level_map(gate, grid_x, grid_y)
    color, final_t = state.color.clone(), state.final_t.clone()
    cur_c, cur_t = color[:, offy::2, offx::2], final_t[offy::2, offx::2]
    cur_c.copy_(torch.where(gate_px[None], color_r, cur_c))
    cur_t.copy_(torch.where(gate_px, final_t_r, cur_t))
    levels_last = torch.where(gate, torch.clamp_min(state.tile_levels_last, rnd),
                              state.tile_levels_last)
    return state._replace(color=color, final_t=final_t,
                          tile_levels_last=levels_last.to(torch.int32), round_order=order)


def interpolate(state: AMRState, grid_x: int, grid_y: int) -> AMRState:
    """Fill the pixels of rounds above their tile's level by copying the
    level's source pixel."""
    h, w = state.final_t.shape
    dev = state.final_t.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    tilemap = state.tile_levels.reshape(grid_y, grid_x)
    lvl = tilemap[torch.clamp_max(yy // TILE, grid_y - 1), torch.clamp_max(xx // TILE, grid_x - 1)]
    ox, oy = xx % 2, yy % 2
    rnd = torch.where((ox == 0) & (oy == 0), 1, torch.where(
        (ox == 1) & (oy == 1), 2, torch.where((ox == 1) & (oy == 0), 3, 4)))
    src = (lvl >= 3).to(torch.int64)
    sx = (xx // 2) * 2 + src
    sy = (yy // 2) * 2 + src
    need = rnd > lvl
    color = torch.where(need[None], state.color[:, sy, sx], state.color)
    final_t = torch.where(need, state.final_t[sy, sx], state.final_t)
    return state._replace(color=color, final_t=final_t)


def render_amr_fused(means3d, scales, quats, opacities, sh, sh_degree, cam: CameraParams,
                     bg, *, max_instances: int = 1 << 20, active_mask=None, gaze_xy=None,
                     gaze_radii=None, interpolate_image: bool = True,
                     percentiles=(0.25, 0.5, 0.9), state: Optional[AMRState] = None,
                     decimation=(1, 1, 1, 1), predecimate: bool = False):
    """One-pass foveated frame, the same image as ``render_amr`` (up to the
    early exit, taken over all of a tile's rounds at once): one
    ``blend.blend_levels`` launch streams each tile's instances once for
    rounds 1..level. ``decimation[L-1]`` thins level-L tiles' streams with
    aggregate-opacity compensation; ``predecimate`` drops those instances
    at binning time instead (the compositor then only rescales). Pass
    ``state`` to reuse a step 0. Returns (color (3, H, W), state); the
    subgrid images are assembled by stacking and reshaping, no scatter."""
    grid_x, grid_y = _grid(cam)
    if state is None:
        state = fovea_step0(means3d, scales, quats, opacities, sh, sh_degree, cam,
                            max_instances=max_instances, active_mask=active_mask,
                            gaze_xy=gaze_xy, gaze_radii=gaze_radii, percentiles=percentiles,
                            predecimate=tuple(decimation) if predecimate else None)
    tiles_all = blend.blend_levels(
        state.feat_soa, state.offsets, state.offsets[1:] - state.offsets[:-1],
        state.tile_levels, grid_x, grid_y, decimation=decimation, scale_only=predecimate)
    with tracing.span("gs.assemble"):
        sub = (TILE // 2) ** 2
        lvlmap = _level_map(state.tile_levels, grid_x, grid_y)
        rounds_c, rounds_t = [], []
        for r in range(4):
            gate_px = lvlmap > r  # round r+1 rendered where level >= r+1
            c, t_ = _subgrid_image(tiles_all[:, r * sub:(r + 1) * sub], grid_x, grid_y)
            rounds_c.append(torch.where(gate_px[None], c, 0.0))
            rounds_t.append(torch.where(gate_px, t_, 1.0))
        if interpolate_image:
            src_c = torch.where((lvlmap >= 3)[None], rounds_c[1], rounds_c[0])
            src_t = torch.where(lvlmap >= 3, rounds_t[1], rounds_t[0])
            for r in range(4):
                need = (r + 1) > lvlmap
                rounds_c[r] = torch.where(need[None], src_c, rounds_c[r])
                rounds_t[r] = torch.where(need, src_t, rounds_t[r])
        # pixel (2yc+oy, 2xc+ox) comes from the round at offset (ox, oy):
        # [oy][ox] = [[r1, r3], [r4, r2]]
        hc, wc = lvlmap.shape
        color = torch.stack([torch.stack([rounds_c[0], rounds_c[2]], -1),
                             torch.stack([rounds_c[3], rounds_c[1]], -1)],
                            2).reshape(3, 2 * hc, 2 * wc)
        final_t = torch.stack([torch.stack([rounds_t[0], rounds_t[2]], -1),
                               torch.stack([rounds_t[3], rounds_t[1]], -1)],
                              1).reshape(2 * hc, 2 * wc)
        state = state._replace(color=color, final_t=final_t, tile_levels_last=state.tile_levels)
        out = color + final_t[None] * bg[:, None, None]
        return out[:, :cam.height, :cam.width], state


def render_amr(means3d, scales, quats, opacities, sh, sh_degree, cam: CameraParams, bg, *,
               max_instances: int = 1 << 20, active_mask=None, gaze_xy=None, gaze_radii=None,
               interpolate_image: bool = True, percentiles=(0.25, 0.5, 0.9),
               impl: str = "kernels", max_per_tile: int = 1024):
    """The 5-step foveated frame: step 0, rounds 1..4 (one
    ``blend.blend_round`` launch each, or the oracle with ``impl="jnp"``),
    interpolation, background. Returns (color (3, H, W), state)."""
    grid_x, grid_y = _grid(cam)
    state = fovea_step0(means3d, scales, quats, opacities, sh, sh_degree, cam,
                        max_instances=max_instances, active_mask=active_mask,
                        gaze_xy=gaze_xy, gaze_radii=gaze_radii, percentiles=percentiles)
    for rnd in range(1, 5):
        state = fovea_step_render(state, rnd, grid_x, grid_y, impl=impl,
                                  max_per_tile=max_per_tile)
    if interpolate_image:
        state = interpolate(state, grid_x, grid_y)
    color = state.color + state.final_t[None] * bg[:, None, None]
    return color[:, :cam.height, :cam.width], state
