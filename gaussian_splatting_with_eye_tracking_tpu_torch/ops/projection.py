"""Per-gaussian preprocessing: project, EWA 2D covariance, conic, radii,
tile rects.

Port of ``gaussian_splatting_with_eye_tracking_tpu/ops/projection.py``:
``CameraParams``, ``Preprocessed`` and the forward of
``_preprocess_autodiff`` (which is also the forward of the JAX
``preprocess``'s hand-VJP path). Vectorized over all N gaussians; no
kernel (elementwise column math). Its gradient is torch autograd through
this forward, which the JAX package cross-checks its hand VJP against
(``projection.py:219-231`` there). The binning-only quantities carry no
gradient, as in JAX: ``cull_thr`` and the opacity-aware extents are
detached (JAX ``stop_gradient``), so the radius chain, whose
``sqrt(clamp(..., 0))`` would turn a zero cotangent into 0 * inf, is never
differentiated.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import sh as sh_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as tf

NEAR = 0.2  # view-space depth below which a gaussian is culled

# |value| cap before a float->int32 cast: a float beyond int32 range has no
# defined conversion in C; clamping first gives XLA's saturating convert
_INT_CAST_LIMIT = float(1 << 30)


class CameraParams(NamedTuple):
    """Per-frame camera data consumed by the rasterizer."""

    viewmatrix: torch.Tensor  # (4,4) world->view, column-vector convention
    projmatrix: torch.Tensor  # (4,4) full = proj @ view
    campos: torch.Tensor  # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Preprocessed(NamedTuple):
    """Per-gaussian screen-space quantities."""

    means2d: torch.Tensor  # (N,2) pixel coords
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N,3) inverse 2D covariance [a,b,c]
    rgb: torch.Tensor  # (N,3) view-dependent color
    opacities: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) int32 screen-space radius, 0 = culled
    tiles_touched: torch.Tensor  # (N,) int32
    rect_min: torch.Tensor  # (N,2) int32 tile-rect [x,y]
    rect_max: torch.Tensor  # (N,2) int32 (exclusive)
    # ln(255*op): a pixel at Mahalanobis quadratic q passes the blend's
    # alpha >= 1/255 gate iff q <= cull_thr (binning's exact tile cull)
    cull_thr: Optional[torch.Tensor] = None


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncating toward zero, saturating out of range."""
    return x.clamp(-_INT_CAST_LIMIT, _INT_CAST_LIMIT).to(torch.int32)


@tracing.spanned("gs.preprocess")
def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor,
    sh_degree: int,
    cam: CameraParams,
    tile: int = 32,
    active_mask: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
) -> Preprocessed:
    """means3d (N,3), scales (N,3) activated, quats (N,4), opacities (N,)
    activated, sh (N, 3, K). ``active_mask`` (N,) bool kills padded slots.
    The camera's tan(fov) values enter as float32 scalars, as in the JAX
    package's ``preprocess``. Counts ``gs.preprocess.rows`` and
    ``gs.preprocess.active`` while tracing is on."""
    if tracing.is_on():
        n = means3d.shape[0]
        tracing.count("gs.preprocess.rows", n)
        tracing.count("gs.preprocess.active", n if active_mask is None else active_mask.sum())
    dev = means3d.device
    grid_x = (cam.width + tile - 1) // tile
    grid_y = (cam.height + tile - 1) // tile
    tan_fovx = torch.tensor(cam.tan_fovx, dtype=torch.float32, device=dev)
    tan_fovy = torch.tensor(cam.tan_fovy, dtype=torch.float32, device=dev)

    p_view = means3d @ cam.viewmatrix[:3, :3].T + cam.viewmatrix[:3, 3]
    depths = p_view[:, 2]
    visible = depths > NEAR
    if active_mask is not None:
        visible = visible & active_mask

    # projection to NDC, then pixels
    p_hom = means3d @ cam.projmatrix[:3, :3].T + cam.projmatrix[:3, 3]
    p_w = means3d @ cam.projmatrix[3, :3] + cam.projmatrix[3, 3]
    p_w = torch.where(visible, p_w + 1e-7, torch.ones_like(p_w))
    p_proj = p_hom / p_w[:, None]
    mean_x = tf.ndc_to_pix(p_proj[:, 0], cam.width)
    mean_y = tf.ndc_to_pix(p_proj[:, 1], cam.height)
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    cov3d = tf.build_cov3d(scales, quats, scale_modifier)
    focal_x = cam.width / (2.0 * tan_fovx)
    focal_y = cam.height / (2.0 * tan_fovy)
    cov2d = tf.ewa_project(
        means3d, cov3d, cam.viewmatrix, focal_x, focal_y, tan_fovx, tan_fovy)
    a, b, c = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = a * c - b * b
    visible = visible & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_det = 1.0 / det_safe
    conics = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    # screen-space radius = ceil(3 sqrt(max eigenvalue))
    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda_max = mid + disc
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda_max, 0.0)))

    # opacity-aware extents: the pixels that can pass alpha >= 1/255 form
    # the ellipse d^T conic d <= 2 ln(255 op); its per-axis half-widths,
    # capped at the 3-sigma radius, give the tile rect
    ln_op = torch.log(torch.clamp_min(255.0 * opacities, 1.0))
    cull_thr = ln_op.detach()
    ext_x = torch.ceil(torch.sqrt(torch.clamp_min(2.0 * a * ln_op, 1e-12)))
    ext_y = torch.ceil(torch.sqrt(torch.clamp_min(2.0 * c * ln_op, 1e-12)))
    ext_x = torch.minimum(ext_x, radius).detach()
    ext_y = torch.minimum(ext_y, radius).detach()

    # tile rect; the int casts truncate toward zero, as in the JAX package
    rect_min_x = _to_int32((mean_x - ext_x) / tile).clamp(0, grid_x)
    rect_min_y = _to_int32((mean_y - ext_y) / tile).clamp(0, grid_y)
    rect_max_x = _to_int32((mean_x + ext_x + tile - 1) / tile).clamp(0, grid_x)
    rect_max_y = _to_int32((mean_y + ext_y + tile - 1) / tile).clamp(0, grid_y)
    tiles_touched = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
    visible = visible & (tiles_touched > 0)

    radii = _to_int32(torch.where(visible, radius, torch.zeros_like(radius)))
    tiles_touched = torch.where(
        visible, tiles_touched, torch.zeros_like(tiles_touched)).to(torch.int32)

    rgb, _ = sh_ops.sh_to_rgb(sh_degree, sh, means3d, cam.campos)

    return Preprocessed(
        means2d=means2d,
        depths=depths,
        conics=conics,
        rgb=rgb,
        opacities=torch.where(visible, opacities, torch.zeros_like(opacities)),
        radii=radii,
        tiles_touched=tiles_touched,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        cull_thr=cull_thr,
    )
