"""Eye-tracked foveated rendering: eye image -> RITnet segmentation ->
pupil-centroid gaze -> gaze-driven AMR frame.

Port of ``estimate_gaze`` and of the per-view body of ``main`` from the
repository's ``track_render.py``. ``estimate_gaze`` takes a decoded uint8
image; reading image files and the command line come with the port's
scene IO. The gaze in eye-image coordinates maps linearly onto the
rendered image and drives the per-tile AMR levels.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


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
    with torch.no_grad():
        logits = model(ritnet.preprocess_eye_image(eye, device=dev))
    pred = ritnet.get_predictions(logits)[0]
    gaze_px = ritnet.pupil_centroid(pred)
    return gaze_px / np.array([w, h]), pred


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
    p = state.params
    dev = p.xyz.device
    sh = gm.get_sh(p) * renderer.sh_band_mask(state.sh_degree, max_sh_degree, dev)[None, None, :]
    gaze_xy = torch.tensor([gaze_uv[0] * cam.width, gaze_uv[1] * cam.height],
                           dtype=torch.float32, device=dev)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    args = (p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p), sh, max_sh_degree, cam, bg)
    kw = dict(max_instances=max_instances, active_mask=state.active, gaze_xy=gaze_xy,
              gaze_radii=radii)
    with torch.no_grad():
        if fused:
            return amr.render_amr_fused(*args, decimation=decimation, predecimate=predecimate,
                                        **kw)
        return amr.render_amr(*args, **kw)
