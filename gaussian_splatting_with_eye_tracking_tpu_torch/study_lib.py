"""What the study modules share (``AMR_test``, ``KDtree_test``,
``opacity_quant_test``, ``amr_quality_sweep``, ports of the root scripts of
those names): the root scripts' flags and camera, a rasterized frame, the
frames rendered and timed at a capacity that holds them, and the root
scripts' PSNR.

Each study's ``main(argv=None, device=None)`` returns its numbers as a
dict and runs on the card unless ``device="cpu"`` (or ``--data_device
cpu``) asks for the CPU, where the kernels' plain versions run. Where a
root script renders at a fixed capacity of 2^20 instances (and truncates
a frame past it), a study's capacity grows to the next power of two that
holds the frame, and the capacity is recorded; a frame that still
overflows raises.
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test, renderer, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast

CAPACITY = 1 << 20  # the root scripts' instance capacity, where a study starts


def study_parser(description: str, out_dir: str) -> ArgumentParser:
    """The root study scripts' flags: the model (``fps_test.model_args``,
    50,000 synthetic gaussians by default), the image size and the output
    directory."""
    parser = ArgumentParser(description=description)
    fps_test.model_args(parser)
    parser.set_defaults(num_gaussians=50_000)
    parser.add_argument("--width", default=640, type=int)
    parser.add_argument("--height", default=480, type=int)
    parser.add_argument("--out_dir", default=out_dir, type=str)
    return parser


def study_view(args, device=None):
    """(activated model, max SH degree, active mask, camera, background)
    of the model the flags name (``device`` overrides ``--data_device``),
    seen by the root scripts' camera, ``make_camera(width, height,
    cam_z=-5)``, over a black background."""
    if device is not None:
        args.data_device = str(device)
    state, deg, active = fps_test.load_or_synthetic(args)
    dev = state.params.xyz.device
    cam = make_camera(args.width, args.height, cam_z=-5.0, device=dev)
    return renderer.activated(state, deg), deg, active, cam, torch.zeros(3, device=dev)


def rasterizer(model, deg, cam, bg, active):
    """``render(capacity) -> (color, RenderOut)`` of ``model`` (activated
    means, scales, rotations, opacities, SH) through ``rasterize``."""
    def render(cap):
        out = rast.rasterize(*model, cam, bg, sh_degree=deg, active_mask=active,
                             max_instances=cap)
        return out.color, out
    return render


def timed_frames(renders: dict, device: torch.device, max_instances: int = CAPACITY) -> dict:
    """Each of ``renders`` ({name: render(capacity) -> (image, counters)},
    ``counters`` a ``RenderOut`` or an AMR state) once, without autograd,
    timed alone (``fps_test.timed``). The capacity is the one an untimed
    first render of the first frame settles on (``train_lib.render_grown``
    from ``max_instances``); a later frame that overflows it renders again
    at the next power of two that holds it, and one that still overflows
    raises. Returns {name: {"image", "ms", "capacity", "instances",
    "enumerated"}}."""
    frames = {}
    with torch.no_grad():
        cap = train_lib.render_grown(next(iter(renders.values())), max_instances)[2]
        for name, render in renders.items():
            (image, counters, cap), ms = fps_test.timed(
                lambda: train_lib.render_grown(render, cap), device)
            frames[name] = {"image": image, "ms": ms, "capacity": cap,
                            "instances": int(counters.num_instances),
                            "enumerated": int(counters.num_enumerated)}
    return frames


def frame_numbers(frames: dict) -> dict:
    """``timed_frames``' records without their images."""
    return {name: {k: v for k, v in f.items() if k != "image"} for name, f in frames.items()}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    """The root scripts' PSNR of two images: -10 log10(max(mse, 1e-12))."""
    mse = float(torch.mean((a - b) ** 2))
    return float(-10 * np.log10(max(mse, 1e-12)))


def device_record(device: torch.device) -> dict:
    """Where a study ran and how it was timed: the device, the timer and
    the card's name and power limit (``fps_test.card``)."""
    return {"device": str(device), "timer": fps_test.timer_name(device),
            "card": fps_test.card(device)}
