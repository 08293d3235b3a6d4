"""High-level render API.

Port of ``sh_band_mask`` and ``render`` from
``gaussian_splatting_with_eye_tracking_tpu/renderer/__init__.py``: apply the
model activations and mask the SH bands above the state's active degree
(``activated``), and call the rasterizer (differentiable; ``means2d_offset`` is the handle for
the screen-space gradient) through the ``impl`` it names (``ops/rasterize.py``).

``model_inputs`` picks the rasterizer's model inputs by the rule
``ops/projection.preprocess`` routes by: where preprocess will launch the
preprocess kernel (K7), the raw parameters as one ``gm.RawGaussians``
(K7 activates each row it reads, so no activated copy of the model is
written); elsewhere (a call that may need a gradient, the CPU)
``activated``'s tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models.gaussian_model import (  # noqa: F401
    sh_band_mask,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


@tracing.spanned("gs.activate")
def activated(state: gm.GaussianModelState, max_sh_degree: int) -> tuple:
    """(means, scales, rotations, opacities, SH with the bands above the
    state's active degree zeroed): the rasterizer's inputs."""
    return gm.activate(state.params, state.sh_degree, max_sh_degree)


def model_inputs(state: gm.GaussianModelState, max_sh_degree: int) -> tuple:
    """The rasterizer's five model arguments for ``state``: where
    ``projection.preprocess`` will launch K7 on the raw parameters
    (``projection.takes_kernel``: no gradient to take, CUDA tensors), a
    ``gm.RawGaussians`` in the means' place and None in the other four,
    packed inside ``gs.activate`` and launching nothing; elsewhere
    ``activated``'s five tensors."""
    if projection.takes_kernel(*state.params):
        with tracing.span("gs.activate"):
            return gm.RawGaussians(*state.params, state.sh_degree), None, None, None, None
    return activated(state, max_sh_degree)


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
        *model_inputs(state, max_sh_degree),
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
