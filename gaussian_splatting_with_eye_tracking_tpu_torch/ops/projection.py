"""Per-gaussian preprocessing: project, EWA 2D covariance, conic, radii,
tile rects.

Port of ``gaussian_splatting_with_eye_tracking_tpu/ops/projection.py``:
``CameraParams``, ``Preprocessed`` and the forward of
``_preprocess_autodiff`` (which is also the forward of the JAX
``preprocess``'s hand-VJP path). ``preprocess`` takes one of two paths, as
its inputs show:

- a call that may need a gradient (grad mode on and an input that
  ``requires_grad``: the train steps) runs ``preprocess_plain``, column
  math over all N gaussians whose gradient is torch autograd through this
  forward, which the JAX package cross-checks its hand VJP against
  (``projection.py:219-231`` there). The binning-only quantities carry no
  gradient, as in JAX: ``cull_thr`` and the opacity-aware extents are
  detached (JAX ``stop_gradient``), so the radius chain, whose
  ``sqrt(clamp(..., 0))`` would turn a zero cotangent into 0 * inf, is
  never differentiated;
- any other call launches the hand-written kernel K7
  (``csrc/preprocess.cu``, ``preprocess_kernel``) on CUDA tensors, one
  thread per slot, and runs ``preprocess_plain`` on CPU tensors
  (``takes_kernel`` is the rule).

The model comes in either of two forms: the five activated tensors
(``renderer.activated``), or a ``gaussian_model.RawGaussians`` in the
means' place with the other four None (``renderer.model_inputs`` hands it
down where K7 runs). K7 activates the raw form's rows as it loads them;
``preprocess_plain`` applies the model's activation ops to it first. Both
forms give the same record on every route.

K7 writes the plain record as the plain version computes it on the card,
each float rounded alike (so the integer fields, radii, tiles_touched and
the rects, are equal); one field differs by design: a culled slot's
``rgb`` is 0 (its SH row is never read). Nothing reads a culled slot's colour:
its ``tiles_touched`` is 0, so binning enumerates no instance of it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.models.gaussian_model import RawGaussians
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


PREPROCESS = backend.CudaKernel(
    "preprocess", "preprocess", "preprocess_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 3
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    + [ctypes.c_void_p] * 11,
)
# the raw form's activation alone (x, exp(x), sigmoid(x), n): for checks
ACTIVATION = backend.CudaKernel(
    "preprocess_activation", "preprocess", "preprocess_activation_launch",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
)
SH_COEFFS = (1, 4, 9, 16)  # SH coefficients per channel K7 takes
_CAMERA = ("viewmatrix", "projmatrix", "campos")
_INPUTS = ("means3d", "scales", "quats", "opacities", "sh") + _CAMERA
_RAW_INPUTS = RawGaussians._fields[:6] + _CAMERA


def takes_kernel(*tensors: torch.Tensor) -> bool:
    """Whether ``preprocess`` launches K7 on these inputs (the model's and
    the camera's tensors): no gradient to take (grad mode off, or no input
    that ``requires_grad``) and CUDA tensors."""
    grads = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return not grads and tensors[0].is_cuda


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
    activated, sh (N, 3, K); or ``means3d`` a ``RawGaussians`` and the
    next four None (its bands up to its own degree are shaded, at most
    ``sh_degree``). ``active_mask`` (N,) bool kills padded slots. The
    camera's tan(fov) values enter as float32 scalars, as in the JAX
    package's ``preprocess``.

    ``preprocess_plain`` where a gradient may be taken or the tensors are
    on the CPU; otherwise K7 (``preprocess_kernel``), which raises on
    inputs it does not take (``takes_kernel``). Counts
    ``gs.preprocess.rows`` and ``gs.preprocess.active`` while tracing is
    on, ``gs.preprocess.kernel`` (the rows given to K7) and
    ``gs.preprocess.raw`` (those of them K7 activated from the raw
    form)."""
    raw = isinstance(means3d, RawGaussians)
    model = means3d[:6] if raw else (means3d, scales, quats, opacities, sh)
    n = model[0].shape[0]
    if tracing.is_on():
        tracing.count("gs.preprocess.rows", n)
        tracing.count("gs.preprocess.active", n if active_mask is None else active_mask.sum())
    args = (means3d, scales, quats, opacities, sh, sh_degree, cam, tile, active_mask,
            scale_modifier)
    if not takes_kernel(*model, *cam[:3]):
        return preprocess_plain(*args)
    tracing.count("gs.preprocess.kernel", n)
    if raw:
        tracing.count("gs.preprocess.raw", n)
    return preprocess_kernel(*args)


def preprocess_kernel(
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
    """``preprocess_plain``'s record from one launch of K7 on CUDA float32
    tensors, with no gradient, from either form of the model (see
    ``preprocess``; the raw form is activated row by row as K7 loads it).
    Takes K in ``SH_COEFFS`` and ``sh_degree`` <= 3 with (sh_degree + 1)^2
    <= K; the camera's matrices stay on the card. A culled slot (radius 0)
    gets ``rgb`` 0 and opacity 0; every other field as the plain version
    computes it."""
    raw = isinstance(means3d, RawGaussians)
    if raw:
        n, k = means3d.xyz.shape[0], 1 + means3d.f_rest.shape[-1]
        model = means3d[:6]
        shapes = ((n, 3), (n, 3, 1), (n, 3, k - 1), (n, 3), (n, 4), (n, 1))
        names, degree = _RAW_INPUTS, min(sh_degree, means3d.sh_degree)
    else:
        n, k = means3d.shape[0], sh.shape[-1]
        model = (means3d, scales, quats, opacities, sh)
        shapes = ((n, 3), (n, 3), (n, 4), (n,), (n, 3, k))
        names, degree = _INPUTS, sh_degree
    if not (0 <= degree <= 3 and k in SH_COEFFS and (sh_degree + 1) ** 2 <= k):
        raise ValueError(f"preprocess: sh_degree {sh_degree} with {k} SH coefficients")
    ins = [t.contiguous() for t in (*model, *cam[:3])]
    for name, t, shape in zip(names, ins, shapes + ((4, 4), (4, 4), (3,))):
        if t.shape != shape or t.dtype != torch.float32 or not t.is_cuda:
            raise ValueError(f"preprocess: {name} must be a CUDA float32 tensor of shape "
                             f"{shape}, not {t.dtype} {tuple(t.shape)} on {t.device}")
    if raw:  # xyz, log-scales, rotation, logits; f_dc, f_rest (None where K = 1)
        geometry, sh_ins = [ins[0], ins[3], ins[4], ins[5]], [ins[1], ins[2] if k > 1 else None]
        staged = ("f_rest", sh_ins[1])
    else:
        geometry, sh_ins = ins[:4], [ins[4], None]
        staged = ("sh", ins[4])
    if staged[1] is not None:  # K7 stages it in 16-byte loads
        backend.check_aligned(*staged)
    if active_mask is not None:
        active_mask = active_mask.contiguous()
        if active_mask.shape != (n,) or active_mask.dtype != torch.bool or not active_mask.is_cuda:
            raise ValueError("preprocess: active_mask must be a CUDA bool tensor of shape "
                             f"{(n,)}, not {active_mask.dtype} {tuple(active_mask.shape)}")
    dev, f32, i32 = means3d.device, torch.float32, torch.int32
    prep = Preprocessed(
        means2d=torch.empty((n, 2), dtype=f32, device=dev),
        depths=torch.empty(n, dtype=f32, device=dev),
        conics=torch.empty((n, 3), dtype=f32, device=dev),
        rgb=torch.empty((n, 3), dtype=f32, device=dev),
        opacities=torch.empty(n, dtype=f32, device=dev),
        radii=torch.empty(n, dtype=i32, device=dev),
        tiles_touched=torch.empty(n, dtype=i32, device=dev),
        rect_min=torch.empty((n, 2), dtype=i32, device=dev),
        rect_max=torch.empty((n, 2), dtype=i32, device=dev),
        cull_thr=torch.empty(n, dtype=f32, device=dev))
    if n:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        PREPROCESS(*map(ptr, geometry + sh_ins), ptr(active_mask), n, k, degree, int(raw),
                   *map(ptr, ins[-3:]), float(cam.tan_fovx), float(cam.tan_fovy),
                   cam.width, cam.height, tile, float(scale_modifier),
                   *map(ptr, prep), backend.stream_ptr(ins[0]))
    return prep


def preprocess_plain(
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
    """``preprocess``'s plain PyTorch version, on any device and
    differentiable (see the module's docstring); a ``RawGaussians`` is
    activated first by ``gaussian_model``'s ops (``RawGaussians.activated``)."""
    if isinstance(means3d, RawGaussians):
        means3d, scales, quats, opacities, sh = means3d.activated()
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

    # projection to NDC, then pixels. Clip x, y and w come out of one
    # product, whose sums the card's BLAS takes as a chain of FMAs in k
    # order (K7 takes them so); a product by the w row alone went to a
    # matrix-vector kernel whose order changes with N
    p_hom = means3d @ cam.projmatrix[:, :3].T + cam.projmatrix[:, 3]
    p_w = torch.where(visible, p_hom[:, 3] + 1e-7, torch.ones_like(p_hom[:, 3]))
    p_proj = p_hom[:, :2] / p_w[:, None]
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
