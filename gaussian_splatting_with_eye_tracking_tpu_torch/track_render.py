"""Eye-tracked foveated rendering: eye image -> RITnet segmentation ->
pupil-centroid gaze -> gaze-driven AMR frame.

Port of the repository's ``track_render.py``: ``estimate_gaze`` (on a
decoded uint8 image), ``foveated_view`` and the command line::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.track_render -m <model> \
        --eye_image eye.png [--eye_image_right eye_r.png] [--num_views 4] [--out_dir D] \
        [--data_device cpu]

which reads the eye image through PIL, estimates the gaze, writes the
segmentation as ``<model>/eye_seg_pred.png``, loads the model (its
``cfg_args`` overlaid by the command line) and writes the 5-step foveated
frame of each of the first ``--num_views`` training cameras as
``foveated_NNN.png`` (default ``<model>/foveated``). The gaze in
eye-image coordinates maps linearly onto each rendered image; the rings
are (W/8, W/4, W/2), increasing as ``amr.gaze_levels`` reads them (the
root script passes them decreasing, which leaves rings 3 and 2 empty). A
view whose instances overflow 2^20 is rendered again at the next power
of two that holds them. With ``--eye_image_right`` both eye images go
through one RITnet forward (the right eye's segmentation as
``eye_seg_pred_right.png``) and each camera gives a binocular frame: the
fused foveated views of two eye cameras ``IPD`` apart along the camera's
x axis, ``foveated_NNN_left.png`` and ``foveated_NNN_right.png``, each
from its own eye's gaze. Runs on the card unless ``--data_device cpu``.

A head-mounted display's binocular frame: ``estimate_gaze`` on a pair of
eye images runs one RITnet forward at batch 2; ``binocular_frame``
takes the model's inputs once (``renderer.model_inputs``: on the card the
raw parameters, which each eye's preprocess kernel activates as it reads
them) and renders each eye's fused foveated view with its own camera and
gaze; ``headset_frame`` is both, eye images in and two views out;
``eye_camera`` moves a camera along its own x axis to an eye's position.
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


# the interpupillary distance in scene units of one metre: 63 mm, the
# adult mean
IPD = 0.063


@tracing.spanned("gs.gaze")
def estimate_gaze(eye_u8, weights=None, device=None):
    """uint8 grayscale eye image (H, W) -> (gaze_uv in [0, 1]^2 as a numpy
    (x, y), class map (H', W') on the device). A (B, H, W) stack or a list
    of B (H, W) images (a headset's two eyes) -> ((B, 2) gazes, (B, H',
    W') class maps) from one ``DenseNet2D`` forward at batch B. Images are
    cropped to multiples of 16. ``weights``: None (the vendored RITnet
    weights), an ``.npz`` path, or a loaded ``ritnet.DenseNet2D`` on the
    device. Runs on CUDA unless ``device`` says otherwise."""
    dev = backend.resolve_device(device)
    eye = np.stack(eye_u8) if isinstance(eye_u8, (list, tuple)) else np.asarray(eye_u8)
    if eye.ndim not in (2, 3) or eye.dtype != np.uint8:
        raise ValueError(f"expected a uint8 (H, W) image or (B, H, W) stack, got {eye.dtype} "
                         f"{eye.shape}")
    h = eye.shape[-2] - eye.shape[-2] % 16
    w = eye.shape[-1] - eye.shape[-1] % 16
    model = weights if isinstance(weights, ritnet.DenseNet2D) else ritnet.load_pretrained(
        weights, device=dev)
    x = ritnet.preprocess_eye_images(eye.reshape(-1, *eye.shape[-2:])[:, :h, :w], device=dev)
    tracing.count("gs.gaze.eyes", x.shape[0])
    with tracing.span("gs.gaze.net"), torch.no_grad():
        pred = ritnet.get_predictions(model(x))
    uv = ritnet.pupil_centroids(pred) / np.array([w, h])
    return (uv[0], pred[0]) if eye.ndim == 2 else (uv, pred)


@tracing.spanned("gs.fovea")
def foveated_view(state: gm.GaussianModelState, cam: CameraParams, bg: torch.Tensor,
                  gaze_uv, max_sh_degree: int, *, radii, decimation=(1, 1, 1, 1),
                  predecimate: bool = False, fused: bool = True,
                  max_instances: int = 1 << 20, model_inputs=None):
    """One foveated view of ``state`` for a gaze in [0, 1]^2: the model as
    the served view takes it (``renderer.model_inputs``, made without
    autograd; pass its tuple as ``model_inputs`` to reuse it), the gaze
    mapped to pixels, ``radii`` (3,) the eccentricity rings in pixels.
    ``fused`` renders with ``amr.render_amr_fused`` (with ``decimation`` /
    ``predecimate``), else with the 5-step ``amr.render_amr``. Runs where
    the model lies. Returns (color (3, H, W), AMR state)."""
    dev = state.params.xyz.device
    gaze_xy = torch.tensor([gaze_uv[0] * cam.width, gaze_uv[1] * cam.height],
                           dtype=torch.float32, device=dev)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    kw = dict(max_instances=max_instances, active_mask=state.active, gaze_xy=gaze_xy,
              gaze_radii=radii)
    with torch.no_grad():
        if model_inputs is None:
            model_inputs = renderer.model_inputs(state, max_sh_degree)
        args = (*model_inputs, max_sh_degree, cam, bg)
        if fused:
            color, st = amr.render_amr_fused(*args, decimation=decimation,
                                             predecimate=predecimate, **kw)
        else:
            color, st = amr.render_amr(*args, **kw)
    tracing.count("gs.fovea.instances", st.num_instances)
    return color, st


def binocular_frame(state: gm.GaussianModelState, cams, bg: torch.Tensor, gaze_uvs,
                    max_sh_degree: int, *, radii, decimation=(1, 1, 1, 1),
                    max_instances: int = 1 << 20):
    """A headset's two eye views of ``state``: ``cams`` one camera per eye,
    ``gaze_uvs`` each eye's gaze in [0, 1]^2 (as ``estimate_gaze`` gives
    them for the pair). The model's inputs (``renderer.model_inputs``)
    are taken once and shared: on the card the raw parameters, which each
    eye's preprocess kernel activates as it reads them; elsewhere one
    activation. Each eye renders ``foveated_view(fused=True)`` with its
    own camera and gaze. Returns ([color (3, H, W) per eye], [AMR state
    per eye])."""
    with torch.no_grad():
        inputs = renderer.model_inputs(state, max_sh_degree)
    views = [foveated_view(state, cam, bg, uv, max_sh_degree, radii=radii,
                           decimation=decimation, fused=True, max_instances=max_instances,
                           model_inputs=inputs)
             for cam, uv in zip(cams, gaze_uvs)]
    return [c for c, _ in views], [st for _, st in views]


@tracing.spanned("gs.binocular")
def headset_frame(state: gm.GaussianModelState, cams, bg: torch.Tensor, eyes_u8, weights,
                  max_sh_degree: int, *, radii, decimation=(1, 1, 1, 1),
                  max_instances: int = 1 << 20, device=None):
    """One head-mounted display frame: the eye images (one per camera)
    through ``estimate_gaze`` in one RITnet forward, then
    ``binocular_frame`` on their gazes. Returns (gazes (B, 2), class maps
    (B, H', W'), [color per eye], [AMR state per eye])."""
    uvs, cls = estimate_gaze(eyes_u8, weights, device=device)
    colors, states = binocular_frame(state, cams, bg, uvs, max_sh_degree, radii=radii,
                                     decimation=decimation, max_instances=max_instances)
    return uvs, cls, colors, states


def eye_camera(cam: CameraParams, offset: float) -> CameraParams:
    """``cam`` moved ``offset`` scene units along its own x axis (an eye at
    -IPD / 2 or +IPD / 2 from the head's camera), with the same
    projection: a symmetric frustum, no canting."""
    view = cam.viewmatrix.to(torch.float64)
    proj = cam.projmatrix.to(torch.float64) @ torch.linalg.inv(view)
    shift = torch.eye(4, dtype=torch.float64, device=view.device)
    shift[0, 3] = -offset
    moved = shift @ view
    return cam._replace(viewmatrix=moved.to(torch.float32),
                        projmatrix=(proj @ moved).to(torch.float32),
                        campos=torch.linalg.inv(moved)[:3, 3].to(torch.float32))


def read_eye_image(path: str) -> np.ndarray:
    """An image file as uint8 grayscale (H, W), through PIL."""
    with pil_image(path).open(path) as im:
        return np.asarray(im.convert("L"))


def ring_radii(width: int) -> tuple:
    """The CLI's eccentricity rings for a view ``width`` pixels wide."""
    return (width / 8, width / 4, width / 2)


def main(argv=None):
    """Returns {"gaze_uv", "renders": [paths], "view_ms": [ms per view],
    "capacities": [instance capacity per view]}; with
    ``--eye_image_right`` a view is a camera's binocular frame, "gaze_uv"
    holds both eyes' gazes and "renders" both eyes' paths per camera."""
    parser = ArgumentParser(description="Eye-tracked foveated rendering")
    add_config_args(parser, ModelConfig(), "Model Parameters", sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--eye_image", default="eye.png", type=str)
    parser.add_argument("--eye_image_right", default="", type=str,
                        help="the right eye's image: render each camera as a binocular frame")
    parser.add_argument("--ritnet_weights", default=os.environ.get("RITNET_WEIGHTS", None),
                        type=str, help="RITnet weights (.npz); default: the vendored weights")
    parser.add_argument("--out_dir", default="", type=str)
    parser.add_argument("--num_views", default=4, type=int)
    parser.add_argument("--quiet", action="store_true")
    args = get_combined_args(parser, argv)
    safe_state(args.quiet)
    cfg = extract_config(args, ModelConfig)
    dev = backend.resolve_data_device(cfg.data_device)

    both = bool(getattr(args, "eye_image_right", ""))
    eyes = read_eye_image(args.eye_image)
    if both:
        eyes = [eyes, read_eye_image(args.eye_image_right)]
    gaze_uv, pred = estimate_gaze(eyes, getattr(args, "ritnet_weights", None), device=dev)
    if cfg.model_path:
        maps = pred if both else pred[None]
        for m, name in zip(maps, ("eye_seg_pred.png", "eye_seg_pred_right.png")):
            viz = m.to(torch.float32).cpu().numpy() / 3.0
            save_image(np.stack([viz] * 3), os.path.join(cfg.model_path, name))
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
        if both:
            cams = (eye_camera(c, -IPD / 2), eye_camera(c, IPD / 2))

            def frame(cap):
                colors, states = binocular_frame(state, cams, bg, gaze_uv, scene.max_sh_degree,
                                                 radii=ring_radii(c.width), max_instances=cap)
                # the eye with more instances overflows if either does
                return colors, max(states, key=lambda st: int(st.num_enumerated))

            colors, _, cap = train_lib.render_grown(frame, 1 << 20)
            names = [f"foveated_{i:03d}_left.png", f"foveated_{i:03d}_right.png"]
        else:
            color, _, cap = train_lib.render_grown(
                lambda cap: foveated_view(state, c, bg, gaze_uv, scene.max_sh_degree,
                                          radii=ring_radii(c.width), fused=False,
                                          max_instances=cap),
                1 << 20)
            colors, names = [color], [f"foveated_{i:03d}.png"]
        images = [torch.clamp(color, 0, 1).cpu().numpy() for color in colors]
        out["view_ms"].append((time.perf_counter() - t0) * 1e3)
        for image, name in zip(images, names):
            path = os.path.join(out_dir, name)
            save_image(image, path)
            out["renders"].append(path)
        out["capacities"].append(cap)
    print(f"Wrote foveated renders to {out_dir} "
          f"(ms per view: {', '.join(f'{t:.2f}' for t in out['view_ms'])})")
    return out


if __name__ == "__main__":
    main()
