"""Brute-force reference rasterizer: the executable spec and test oracle.

Port of ``NaiveRenderOut`` and ``render_naive`` from
``gaussian_splatting_with_eye_tracking_tpu/ops/reference.py``. Per pixel,
over all gaussians in stable depth order, the reference CUDA kernel's
front-to-back compositing (``forward.cu``):

- skip where the Mahalanobis power > 0, or alpha = min(0.99, opacity
  exp(power)) < 1/255;
- stop, without the stopping contribution, where the transmittance would
  fall below 1e-4;
- a gaussian reaches only the pixels of the tiles in its screen rect, and
  only if its radius is positive;
- colour = accumulated + T * background.

Exclusive cumulative products instead of a loop, O(pixels x N), a chunk of
pixels at a time: for tests and small scenes only. Differentiable by
autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4


class NaiveRenderOut(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    final_t: torch.Tensor  # (H, W) remaining transmittance
    n_contrib: torch.Tensor  # (H, W) int32 contributions applied


def render_naive(prep, width: int, height: int, bg: torch.Tensor, tile: int = 32,
                 pixel_chunk: int = 1024, exact_stop: bool = True) -> NaiveRenderOut:
    """Render a ``projection.Preprocessed`` by brute force.
    ``exact_stop=False`` drops the T < 1e-4 stop (the oracle's and the
    kernels' relaxation: within 1e-4 a channel of the exact result)."""
    dev = prep.means2d.device
    order = torch.argsort(prep.depths, stable=True)
    xy = prep.means2d[order]
    conic = prep.conics[order]
    rgb = prep.rgb[order]
    op = prep.opacities[order]
    visible = prep.radii[order] > 0
    rmin = prep.rect_min[order]
    rmax = prep.rect_max[order]

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)  # (P, 2)
    tiles = (pix / tile).to(torch.int32)  # (P, 2) tile coordinates
    n_pix = width * height
    pad = (-n_pix) % pixel_chunk
    pix = F.pad(pix, (0, 0, 0, pad))
    tiles = F.pad(tiles, (0, 0, 0, pad))

    colors, final_ts, n_contribs = [], [], []
    for s in range(0, n_pix + pad, pixel_chunk):
        pc, tc = pix[s:s + pixel_chunk], tiles[s:s + pixel_chunk]
        d = xy[None, :, :] - pc[:, None, :]  # (C, N, 2)
        dx, dy = d[..., 0], d[..., 1]
        power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
                 - conic[None, :, 1] * dx * dy)
        alpha = torch.clamp_max(op[None, :] * torch.exp(torch.clamp_max(power, 0.0)),
                                ALPHA_MAX)
        in_rect = ((tc[:, None, 0] >= rmin[None, :, 0]) & (tc[:, None, 0] < rmax[None, :, 0])
                   & (tc[:, None, 1] >= rmin[None, :, 1]) & (tc[:, None, 1] < rmax[None, :, 1]))
        eligible = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_rect & visible[None, :]
        a = torch.where(eligible, alpha, 0.0)
        one_minus = 1.0 - a
        t_before = torch.cat([torch.ones_like(a[:, :1]),
                              torch.cumprod(one_minus, dim=-1)[:, :-1]], dim=-1)
        if exact_stop:
            stop = eligible & (t_before * (1.0 - alpha) < T_MIN)
            done_before = torch.cat([torch.zeros_like(stop[:, :1]),
                                     torch.cumsum(stop.to(torch.int32), dim=-1)[:, :-1] > 0],
                                    dim=-1)
            applied = eligible & ~stop & ~done_before
        else:
            applied = eligible
        w = torch.where(applied, a * t_before, 0.0)
        final_t = torch.prod(torch.where(applied, one_minus, 1.0), dim=-1)
        colors.append(w @ rgb + final_t[:, None] * bg[None, :])
        final_ts.append(final_t)
        n_contribs.append(applied.sum(dim=-1).to(torch.int32))

    color = torch.cat(colors)[:n_pix].reshape(height, width, 3)
    return NaiveRenderOut(color=color.permute(2, 0, 1),
                          final_t=torch.cat(final_ts)[:n_pix].reshape(height, width),
                          n_contrib=torch.cat(n_contribs)[:n_pix].reshape(height, width))
