"""High-level render API.

Port of ``sh_band_mask`` and ``render`` from
``gaussian_splatting_with_eye_tracking_tpu/renderer/__init__.py``: apply the
model activations and mask the SH bands above the state's active degree
(``activated``), and call the rasterizer (differentiable; ``means2d_offset`` is the handle for
the screen-space gradient) through the ``impl`` it names (``ops/rasterize.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


def sh_band_mask(sh_degree: int, max_sh_degree: int, device=None) -> torch.Tensor:
    """(K,) bool mask of the SH coefficients active at ``sh_degree``."""
    k = (max_sh_degree + 1) ** 2
    idx = torch.arange(k, device=device)
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return band <= sh_degree


@tracing.spanned("gs.activate")
def activated(state: gm.GaussianModelState, max_sh_degree: int) -> tuple:
    """(means, scales, rotations, opacities, SH with the bands above the
    state's active degree zeroed): the rasterizer's inputs."""
    p = state.params
    mask = sh_band_mask(state.sh_degree, max_sh_degree, p.xyz.device)
    sh = gm.get_sh(p) * mask[None, None, :]
    return p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p), sh


@tracing.spanned("gs.render")
def render(
    cam: CameraParams,
    state: gm.GaussianModelState,
    bg: torch.Tensor,
    *,
    max_sh_degree: int = 3,
    scale_modifier: float = 1.0,
    means2d_offset: Optional[torch.Tensor] = None,
    max_instances: int = 1 << 20,
    max_live: Optional[int] = None,
    impl: str = "kernels",
    max_per_tile: int = 2048,
    debug: bool = False,
) -> rast.RenderOut:
    return rast.rasterize(
        *activated(state, max_sh_degree),
        cam,
        bg,
        sh_degree=max_sh_degree,
        max_instances=max_instances,
        max_live=max_live,
        active_mask=state.active,
        means2d_offset=means2d_offset,
        scale_modifier=scale_modifier,
        impl=impl,
        max_per_tile=max_per_tile,
        debug=debug,
    )
