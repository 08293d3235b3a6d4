"""Tile compositing as dense tensors: the ``impl="jnp"`` oracle.

Port of ``TileBlendOut``, ``dense_tile_instances``, ``blend_tile_block``
and ``render_tiles_jnp`` from
``gaussian_splatting_with_eye_tracking_tpu/ops/tile_blend.py``. Each tile's
depth-sorted instance list (``binning.bin_gaussians``), padded to
``max_per_tile``, is composited for all its pixels at once::

    alpha[p, i] = min(0.99, op_i exp(power)), 0 where power > 0 or < 1/255
    logT[p, i]  = exclusive cumsum over i of log(1 - alpha)
    w[p, i]     = alpha exp(logT)
    color[p]    = sum_i w[p, i] rgb_i + exp(sum_i log(1 - alpha)) bg

There is no early stop: the reference stops a pixel once T < 1e-4, the
kernels a tile once every pixel has, so the three differ by less than
1e-4 a channel. Plain PyTorch on any device, differentiable by autograd
(the gradient oracle); it holds (tiles, pixels, instances) tensors, so keep
it to small images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99


class TileBlendOut(NamedTuple):
    color: torch.Tensor  # (T, P, 3)
    final_t: torch.Tensor  # (T, P)
    # per pixel, the kept instances whose incoming transmittance is at least
    # 1e-4: JAX's meaning, not the reference's n_contrib (the index of the
    # last instance its pixel loop reached)
    n_contrib: torch.Tensor


def dense_tile_instances(gauss_id, offsets, max_per_tile: int, counts=None):
    """CSR instance list -> (T, max_per_tile) gaussian indices, their
    validity mask and T. Tiles denser than the cap are truncated (the
    caller reports it); ``counts`` overrides the tiles' lengths (the AMR
    round's level gate)."""
    num_tiles = offsets.shape[0] - 1
    k = gauss_id.shape[0]
    ends = offsets[1:] if counts is None else offsets[:-1] + counts
    idx = offsets[:-1, None].to(torch.int64) + torch.arange(
        max_per_tile, device=offsets.device)[None, :]
    valid = idx < ends[:, None]
    g = gauss_id.to(torch.int64)[torch.clamp(idx, 0, k - 1)]
    return g, valid, num_tiles


def blend_tile_block(px, py, xy, conic, rgb, op, valid, bg) -> TileBlendOut:
    """Composite a block of tiles: px, py (T, P) pixel coordinates; xy (T,
    M, 2), conic (T, M, 3), rgb (T, M, 3), op (T, M), valid (T, M) the
    tiles' instances front to back. Colour includes the background."""
    dx = xy[:, None, :, 0] - px[:, :, None]  # (T, P, M)
    dy = xy[:, None, :, 1] - py[:, :, None]
    a_ = conic[:, None, :, 0]
    b_ = conic[:, None, :, 1]
    c_ = conic[:, None, :, 2]
    power = -0.5 * (a_ * dx * dx + c_ * dy * dy) - b_ * dx * dy
    alpha = torch.clamp_max(op[:, None, :] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
    keep = valid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(keep, alpha, 0.0)

    log_om_a = torch.log1p(-alpha)
    log_t = torch.cumsum(log_om_a, dim=-1) - log_om_a  # exclusive
    t = torch.exp(log_t)
    color = torch.einsum("tpm,tmc->tpc", alpha * t, rgb)
    final_t = torch.exp(torch.sum(log_om_a, dim=-1))
    color = color + final_t[..., None] * bg[None, None, :]
    n_contrib = torch.sum((alpha > 0.0) & (t >= 1e-4), dim=-1).to(torch.int32)
    return TileBlendOut(color=color, final_t=final_t, n_contrib=n_contrib)


def _tiles_to_image(x, grid_x: int, grid_y: int, pw: int):
    """(T, pw*pw[, C]) -> ([C,] grid_y*pw, grid_x*pw)."""
    if x.dim() == 3:
        x = x.reshape(grid_y, grid_x, pw, pw, x.shape[-1])
        return x.permute(4, 0, 2, 1, 3).reshape(-1, grid_y * pw, grid_x * pw)
    return x.reshape(grid_y, grid_x, pw, pw).permute(0, 2, 1, 3).reshape(
        grid_y * pw, grid_x * pw)


def render_tiles_jnp(xy, conic, rgb, op, gauss_id, offsets, grid_x: int, grid_y: int,
                     tile: int, bg, max_per_tile: int = 1024, tiles_per_block: int = 8,
                     stride: int = 1, offx: int = 0, offy: int = 0, counts=None,
                     return_n_contrib: bool = False):
    """The whole image, ``tiles_per_block`` tiles at a time. Returns
    (color (3, H, W), final_t (H, W)[, n_contrib (H, W)]) with H =
    grid_y*tile/stride, W = grid_x*tile/stride (crop upstream); ``stride``
    / ``offx`` / ``offy`` pick an AMR round's pixel subgrid."""
    g, valid, num_tiles = dense_tile_instances(gauss_id, offsets, max_per_tile, counts)
    dev = xy.device
    pw = tile // stride
    p = torch.arange(pw * pw, device=dev, dtype=torch.float32)
    px_local = (p % pw) * stride + offx
    py_local = torch.div(p, pw, rounding_mode="floor") * stride + offy
    t_ids = torch.arange(num_tiles, device=dev, dtype=torch.float32)
    px = ((t_ids % grid_x) * tile)[:, None] + px_local[None, :]  # (T, P)
    py = (torch.div(t_ids, grid_x, rounding_mode="floor") * tile)[:, None] + py_local[None, :]

    pad_t = (-num_tiles) % tiles_per_block
    g, valid, px, py = (F.pad(x, (0, 0, 0, pad_t)) for x in (g, valid, px, py))
    outs = [blend_tile_block(px[s], py[s], xy[g[s]], conic[g[s]], rgb[g[s]], op[g[s]],
                             valid[s], bg)
            for s in (slice(i, i + tiles_per_block)
                      for i in range(0, num_tiles + pad_t, tiles_per_block))]
    color = torch.cat([o.color for o in outs])[:num_tiles]
    final_t = torch.cat([o.final_t for o in outs])[:num_tiles]
    color = _tiles_to_image(color, grid_x, grid_y, pw)
    final_t = _tiles_to_image(final_t, grid_x, grid_y, pw)
    if return_n_contrib:
        nc = torch.cat([o.n_contrib for o in outs])[:num_tiles]
        return color, final_t, _tiles_to_image(nc, grid_x, grid_y, pw)
    return color, final_t
