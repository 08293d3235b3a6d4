"""Training step, density-control step and the view-request handler.

Port of ``StepAux``, ``make_train_step``, ``densify_step``,
``make_eval_render`` and ``camera_arrays`` from
``gaussian_splatting_with_eye_tracking_tpu/train_lib.py``, with
``render_grown`` (a render that grows its capacity past an overflow) and
``render_view`` for the CLIs' evaluations and renders. The train step
runs render -> (1-λ)·L1 + λ·(1-SSIM) -> backward (through the backward
compositor and the segment sum) -> per-group Adam -> densification
statistics; density control runs between steps. Entry points run on CUDA
unless ``device="cpu"`` is passed, and raise without a card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    num_instances: torch.Tensor
    num_enumerated: torch.Tensor
    overflow: torch.Tensor
    image: torch.Tensor


def _check_device(state, dev: torch.device, built: str):
    if state.params.xyz.device.type != dev.type:
        raise ValueError(f"model on {state.params.xyz.device}, {built} built for {dev}")


def make_train_step(tx: gm.Adam, opt: OptimizationConfig, max_sh_degree: int,
                    width: int, height: int, max_instances: int = 1 << 20,
                    max_live: Optional[int] = None, device=None):
    """Build the train step for one image size. Returns
    ``train_step(state, viewmatrix, projmatrix, campos, tan_fovx, tan_fovy,
    gt, bg, accumulate_stats, events=None) -> (state, StepAux)``.

    ``events``, if a list, receives ("forward" | "loss" | "backward" |
    "optimizer", torch.cuda.Event) pairs recorded as each phase ends, for
    timing on the card."""
    dev = backend.resolve_device(device)

    def mark(events, name):
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

    def train_step(state: gm.GaussianModelState, viewmatrix, projmatrix, campos,
                   tan_fovx, tan_fovy, gt, bg, accumulate_stats: bool, events=None):
        _check_device(state, dev, "step")
        cam = CameraParams(
            viewmatrix=viewmatrix, projmatrix=projmatrix, campos=campos,
            tan_fovx=tan_fovx, tan_fovy=tan_fovy, width=width, height=height,
        )
        params = gm.GaussianParams(*(v.detach().requires_grad_(True) for v in state.params))
        offset = torch.zeros((params.xyz.shape[0], 2), device=params.xyz.device,
                             requires_grad=True)
        out = renderer.render(
            cam, state._replace(params=params), bg, max_sh_degree=max_sh_degree,
            means2d_offset=offset, max_instances=max_instances, max_live=max_live)
        mark(events, "forward")
        l1 = ssim_ops.l1_loss(out.color, gt)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (
            1.0 - ssim_ops.ssim(out.color, gt))
        mark(events, "loss")
        *g_params, g_offset = torch.autograd.grad(loss, [*params, offset])
        mark(events, "backward")
        with torch.no_grad():
            new_params, opt_state = tx.update(gm.GaussianParams(*g_params),
                                              state.opt_state, state.params)
            state = state._replace(params=new_params, opt_state=opt_state)
            if accumulate_stats:
                state = gm.add_densification_stats(state, g_offset, out.radii,
                                                   width=width, height=height)
            image = out.color.detach()
            mse = torch.mean((image - gt) ** 2)
            aux = StepAux(
                loss=loss.detach(), l1=l1.detach(),
                psnr=-10.0 * torch.log10(torch.clamp_min(mse, 1e-10)),
                num_instances=out.num_instances, num_enumerated=out.num_enumerated,
                overflow=out.overflow, image=image,
            )
        mark(events, "optimizer")
        return state, aux

    return train_step


def densify_step(state: gm.GaussianModelState, generator: torch.Generator,
                 opt: OptimizationConfig, extent: float, max_screen_size: float):
    """One densify_and_prune, its split normals drawn from ``generator``
    (on the state's device). Returns (state, info)."""
    normals = torch.randn((2,) + tuple(state.params.xyz.shape), generator=generator,
                          device=state.params.xyz.device)
    return gm.densify_and_prune(
        state, normals, grad_threshold=opt.densify_grad_threshold, min_opacity=0.005,
        extent=extent, max_screen_size=max_screen_size, percent_dense=opt.percent_dense)


def grow_for_densify(state: gm.GaussianModelState,
                     opt: OptimizationConfig) -> gm.GaussianModelState:
    """Grow the capacity, before a densify step, until the free slots
    cover every clone or split candidate (the JAX training loop doubles it
    once per densify interval, which can fall short)."""
    grads = state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0)
    demand = int((state.active & (grads >= opt.densify_grad_threshold)).sum()
                 + state.active.sum())
    return gm.grow_capacity(state, gm.next_pow2(demand))


def make_eval_render(max_sh_degree, width, height, max_instances=1 << 20,
                     max_live=None, device=None):
    """Build the renderer for one image size. Returns
    ``eval_render(state, viewmatrix, projmatrix, campos, tan_fovx,
    tan_fovy, bg, scale_modifier=1.0) -> color (3, height, width)``, which
    runs without autograd on ``device`` (CUDA unless told otherwise) and
    raises if the model or camera lies elsewhere."""
    dev = backend.resolve_device(device)

    def eval_render(state, viewmatrix, projmatrix, campos, tan_fovx, tan_fovy,
                    bg, scale_modifier=1.0):
        _check_device(state, dev, "renderer")
        cam = CameraParams(
            viewmatrix=viewmatrix, projmatrix=projmatrix, campos=campos,
            tan_fovx=tan_fovx, tan_fovy=tan_fovy, width=width, height=height,
        )
        with torch.no_grad():
            out = renderer.render(
                cam, state, bg, max_sh_degree=max_sh_degree,
                max_instances=max_instances, max_live=max_live,
                scale_modifier=scale_modifier,
            )
        return out.color

    return eval_render


def render_grown(render, max_instances: int):
    """``render(capacity) -> (image, counters)``, with ``counters`` a
    ``RenderOut`` or an AMR state, at ``max_instances`` or, if the view's
    instances overflow it, again at the next power of two that holds them.
    Returns (image, counters, capacity); raises if that overflows too."""
    image, counters = render(max_instances)
    if bool(counters.overflow):
        max_instances = gm.next_pow2(int(counters.num_enumerated) + 1)
        image, counters = render(max_instances)
        if bool(counters.overflow):
            raise RuntimeError(f"{int(counters.num_enumerated)} instances overflow the grown "
                               f"capacity {max_instances}")
    return image, counters, max_instances


def render_view(state, cam_params, bg, max_sh_degree: int, max_instances: int):
    """(color (3, H, W), capacity) of one view rendered without autograd at
    ``max_instances`` or, if the view's instances overflow it, again at
    the next power of two that holds them (the capacity returned)."""
    def render(cap):
        out = renderer.render(cam_params, state, bg, max_sh_degree=max_sh_degree,
                              max_instances=cap)
        return out.color, out

    with torch.no_grad():
        color, _, max_instances = render_grown(render, max_instances)
    return color, max_instances


def camera_arrays(cam: CameraParams):
    return (cam.viewmatrix, cam.projmatrix, cam.campos, cam.tan_fovx, cam.tan_fovy)
