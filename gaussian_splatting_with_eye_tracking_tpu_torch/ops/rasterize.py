"""Public differentiable rasterization API.

Port of ``RenderOut``, ``rasterize`` and ``mark_visible`` from
``gaussian_splatting_with_eye_tracking_tpu/ops/rasterize.py``: preprocess
(ops/projection.py), then one of two implementations, as ``impl`` says:

- ``"kernels"`` (also ``"auto"``; the JAX package's ``"pallas"``): the
  differentiable splat (ops/blend.Splat: binning, the pipeline K8,
  the tile compositor forward, and in the backward the backward
  compositor and the segment sum) -> image assembly: the CUDA kernels on
  CUDA tensors, their plain PyTorch versions on CPU tensors;
- ``"jnp"`` (JAX's name, kept so one test can pass the same string to
  both packages): the oracle, ``binning.bin_gaussians`` ->
  ``tile_blend.render_tiles_jnp``, dense tensors with no early stop,
  differentiated by autograd; small images only.

JAX's default off its TPU is ``"jnp"``; the port's is the kernels.

The reference's ``screenspace_points`` handle for the screen-space
gradient (the densification statistic) is an explicit ``means2d_offset``
input, as in JAX: pass zeros of shape (N, 2) with ``requires_grad`` and
read their gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch.models.gaussian_model import RawGaussians
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, tile_blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import (
    NEAR,
    CameraParams,
    preprocess,
)


IMPLS = ("kernels", "auto", "jnp")


class RenderOut(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    final_t: torch.Tensor  # (H, W) remaining transmittance
    radii: torch.Tensor  # (N,) int32, 0 = culled
    means2d: torch.Tensor  # (N, 2) screen-space centers
    num_instances: torch.Tensor  # () int32 live instances
    num_enumerated: torch.Tensor  # () int32 rect pairs before the ellipse cull
    overflow: torch.Tensor  # () bool, instance capacity exceeded


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """(N,) bool, True where the point's view-space depth exceeds the near
    plane."""
    p_view_z = means3d @ viewmatrix[2, :3] + viewmatrix[2, 3]
    return p_view_z > NEAR


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor,
    cam: CameraParams,
    bg: torch.Tensor,
    *,
    sh_degree: int = 3,
    max_instances: int = 1 << 19,
    max_live: int | None = None,
    active_mask: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    debug: bool = False,
    impl: str = "kernels",
    max_per_tile: int = 1024,
) -> RenderOut:
    """Differentiable 3DGS rasterization, activated parameters in, image
    out.

    means3d (N,3); scales (N,3) post-exp; quats (N,4) unnormalized ok;
    opacities (N,) post-sigmoid; sh (N, 3, (sh_degree+1)^2); or, in
    place of those five, a ``RawGaussians`` as ``means3d`` and None for
    the other four (``renderer.model_inputs``; ``projection.preprocess``
    takes either form); bg (3,);
    ``means2d_offset`` (N, 2) is added to the screen-space centers before
    the splat. All tensors on one device, which decides where the work
    runs. Tiles are ``blend.TILE`` pixels square on every device.
    ``max_per_tile`` caps each tile's instances on the ``"jnp"`` path
    (denser tiles are truncated there, as in JAX).

    ``debug=True`` saves every input to ``snapshot_fw.pt`` (``torch.save``)
    on an exception before re-raising, as the JAX function does with
    ``snapshot_fw.npz``."""
    if impl not in IMPLS:
        raise ValueError(f"rasterize: impl {impl!r} is not one of {IMPLS}")
    if isinstance(means3d, RawGaussians):
        model = dict(zip(RawGaussians._fields[:6], means3d[:6]))
    else:
        model = dict(means3d=means3d, scales=scales, quats=quats, opacities=opacities, sh=sh)
    args = dict(**model, means2d_offset=means2d_offset, bg=bg, active_mask=active_mask,
                viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                campos=cam.campos)
    devices = {t.device for t in args.values() if t is not None}
    if len(devices) != 1:
        raise ValueError(f"rasterize: inputs on several devices {devices}")
    try:
        return _rasterize(
            means3d, scales, quats, opacities, sh, cam, bg, sh_degree=sh_degree,
            max_instances=max_instances,
            max_live=max_instances if max_live is None else max_live,
            active_mask=active_mask, means2d_offset=means2d_offset,
            scale_modifier=scale_modifier, impl=impl, max_per_tile=max_per_tile)
    except Exception:
        if not debug:
            raise
        snapshot = {k: v.detach().cpu() for k, v in args.items() if v is not None}
        snapshot.update(tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
                        width=cam.width, height=cam.height,
                        scale_modifier=scale_modifier)
        if isinstance(means3d, RawGaussians):
            snapshot.update(model_sh_degree=means3d.sh_degree)
        torch.save(snapshot, "snapshot_fw.pt")
        print("\nAn error occurred in rasterization: inputs dumped to "
              "snapshot_fw.pt for forensics. Re-raising.")
        raise


def _rasterize(means3d, scales, quats, opacities, sh, cam, bg, *, sh_degree,
               max_instances, max_live, active_mask, means2d_offset,
               scale_modifier, impl, max_per_tile) -> RenderOut:
    prep = preprocess(
        means3d, scales, quats, opacities, sh, sh_degree, cam,
        tile=blend.TILE, active_mask=active_mask, scale_modifier=scale_modifier,
    )
    means2d = prep.means2d if means2d_offset is None else prep.means2d + means2d_offset
    grid_x = -(-cam.width // blend.TILE)
    grid_y = -(-cam.height // blend.TILE)
    if impl == "jnp":
        b = binning.bin_gaussians(prep, grid_x, grid_y, max_instances, tile_px=blend.TILE,
                                  max_live=max_live)
        color, final_t = tile_blend.render_tiles_jnp(
            means2d, prep.conics, prep.rgb, prep.opacities, b.gauss_id, b.offsets,
            grid_x, grid_y, blend.TILE, bg, max_per_tile=max_per_tile)
        num_instances, num_enumerated, overflow = b.num_instances, b.num_enumerated, b.overflow
    else:
        color, final_t, aux = blend.render_tiles(
            prep, means2d, grid_x, grid_y, bg, max_instances, max_live)
        num_instances, num_enumerated, overflow = aux
    return RenderOut(
        color=color[:, :cam.height, :cam.width],
        final_t=final_t[:cam.height, :cam.width],
        radii=prep.radii, means2d=prep.means2d,
        num_instances=num_instances, num_enumerated=num_enumerated,
        overflow=overflow,
    )
