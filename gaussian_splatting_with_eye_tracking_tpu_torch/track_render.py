"""Eye-tracked foveated rendering: eye image -> RITnet segmentation ->
pupil-centroid gaze -> gaze-driven AMR frame.

Port of the repository's ``track_render.py``: ``estimate_gaze`` (on a
decoded uint8 image), ``foveated_view`` and the command line::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.track_render -m <model> \
        --eye_image eye.png [--num_views 4] [--out_dir D] [--data_device cpu]

reads the eye image through PIL, estimates the gaze, writes the
segmentation as ``<model>/eye_seg_pred.png``, loads the model (its
``cfg_args`` overlaid by the command line) and writes the 5-step foveated
frame of each of the first ``--num_views`` training cameras as
``foveated_NNN.png`` (default ``<model>/foveated``). The gaze in
eye-image coordinates maps linearly onto each rendered image; the rings
are (W/8, W/4, W/2), increasing as ``amr.gaze_levels`` reads them (the
root script passes them decreasing, which leaves rings 3 and 2 empty). A
view whose instances overflow 2^20 is rendered again at the next power
of two that holds them. Runs on the card unless ``--data_device cpu``.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer, tracing, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import (
    ModelConfig,
    add_config_args,
    extract_config,
    get_combined_args,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.general_utils import safe_state
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import (
    pil_image,
    save_image,
)


@tracing.spanned("gs.gaze")
def estimate_gaze(eye_u8: np.ndarray, weights=None, device=None):
    """uint8 grayscale eye image (H, W) -> (gaze_uv in [0, 1]^2 as a numpy
    (x, y), class map (H', W') on the device). The image is cropped to
    multiples of 16. ``weights``: None (the vendored RITnet weights), an
    ``.npz`` path, or a loaded ``ritnet.DenseNet2D`` on the device. Runs on
    CUDA unless ``device`` says otherwise."""
    dev = backend.resolve_device(device)
    eye = np.asarray(eye_u8)
    if eye.ndim != 2 or eye.dtype != np.uint8:
        raise ValueError(f"expected a uint8 (H, W) image, got {eye.dtype} {eye.shape}")
    h = eye.shape[0] - eye.shape[0] % 16
    w = eye.shape[1] - eye.shape[1] % 16
    eye = eye[:h, :w]
    model = weights if isinstance(weights, ritnet.DenseNet2D) else ritnet.load_pretrained(
        weights, device=dev)
    x = ritnet.preprocess_eye_image(eye, device=dev)
    with tracing.span("gs.gaze.net"), torch.no_grad():
        pred = ritnet.get_predictions(model(x))[0]
    gaze_px = ritnet.pupil_centroid(pred)
    return gaze_px / np.array([w, h]), pred


@tracing.spanned("gs.fovea")
def foveated_view(state: gm.GaussianModelState, cam: CameraParams, bg: torch.Tensor,
                  gaze_uv, max_sh_degree: int, *, radii, decimation=(1, 1, 1, 1),
                  predecimate: bool = False, fused: bool = True,
                  max_instances: int = 1 << 20):
    """One foveated view of ``state`` for a gaze in [0, 1]^2: the model's
    activations and SH band mask (as the served view applies them), the
    gaze mapped to pixels, ``radii`` (3,) the eccentricity rings in
    pixels. ``fused`` renders with ``amr.render_amr_fused`` (with
    ``decimation`` / ``predecimate``), else with the 5-step
    ``amr.render_amr``. Runs where the model lies. Returns (color (3, H,
    W), AMR state)."""
    dev = state.params.xyz.device
    gaze_xy = torch.tensor([gaze_uv[0] * cam.width, gaze_uv[1] * cam.height],
                           dtype=torch.float32, device=dev)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    args = (*renderer.activated(state, max_sh_degree), max_sh_degree, cam, bg)
    kw = dict(max_instances=max_instances, active_mask=state.active, gaze_xy=gaze_xy,
              gaze_radii=radii)
    with torch.no_grad():
        if fused:
            return amr.render_amr_fused(*args, decimation=decimation, predecimate=predecimate,
                                        **kw)
        return amr.render_amr(*args, **kw)


def read_eye_image(path: str) -> np.ndarray:
    """An image file as uint8 grayscale (H, W), through PIL."""
    with pil_image(path).open(path) as im:
        return np.asarray(im.convert("L"))


def ring_radii(width: int) -> tuple:
    """The CLI's eccentricity rings for a view ``width`` pixels wide."""
    return (width / 8, width / 4, width / 2)


def main(argv=None):
    """Returns {"gaze_uv", "renders": [paths], "view_ms": [ms per view],
    "capacities": [instance capacity per view]}."""
    parser = ArgumentParser(description="Eye-tracked foveated rendering")
    add_config_args(parser, ModelConfig(), "Model Parameters", sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--eye_image", default="eye.png", type=str)
    parser.add_argument("--ritnet_weights", default=os.environ.get("RITNET_WEIGHTS", None),
                        type=str, help="RITnet weights (.npz); default: the vendored weights")
    parser.add_argument("--out_dir", default="", type=str)
    parser.add_argument("--num_views", default=4, type=int)
    parser.add_argument("--quiet", action="store_true")
    args = get_combined_args(parser, argv)
    safe_state(args.quiet)
    cfg = extract_config(args, ModelConfig)
    dev = backend.resolve_data_device(cfg.data_device)

    gaze_uv, pred = estimate_gaze(read_eye_image(args.eye_image),
                                  getattr(args, "ritnet_weights", None),
                                  device=dev)
    if cfg.model_path:
        viz = pred.to(torch.float32).cpu().numpy() / 3.0
        save_image(np.stack([viz] * 3), os.path.join(cfg.model_path, "eye_seg_pred.png"))
    print(f"Gaze estimate (normalized): {gaze_uv}")

    scene = Scene(cfg, load_iteration=args.iteration, shuffle=False)
    state = scene.gaussians
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    out_dir = args.out_dir or os.path.join(cfg.model_path, "foveated")
    os.makedirs(out_dir, exist_ok=True)
    out = {"gaze_uv": gaze_uv.tolist(), "renders": [], "view_ms": [], "capacities": []}
    for i, cam in enumerate(scene.get_train_cameras()[:args.num_views]):
        c = cam.params(dev)
        t0 = time.perf_counter()
        color, _, cap = train_lib.render_grown(
            lambda cap: foveated_view(state, c, bg, gaze_uv, scene.max_sh_degree,
                                      radii=ring_radii(c.width), fused=False, max_instances=cap),
            1 << 20)
        image = torch.clamp(color, 0, 1).cpu().numpy()
        out["view_ms"].append((time.perf_counter() - t0) * 1e3)
        path = os.path.join(out_dir, f"foveated_{i:03d}.png")
        save_image(image, path)
        out["renders"].append(path)
        out["capacities"].append(cap)
    print(f"Wrote foveated renders to {out_dir} "
          f"(ms per view: {', '.join(f'{t:.2f}' for t in out['view_ms'])})")
    return out


if __name__ == "__main__":
    main()
