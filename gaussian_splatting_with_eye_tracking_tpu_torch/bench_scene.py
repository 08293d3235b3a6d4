"""bench.py's scene and view requests, for the port's smoke run, timing
and profiling scripts: 300,000 gaussians of SH degree 3 drawn in numpy
from a seed, seen at 1920x1088 by a camera at z = -5 looking down +z (and
small yaw/pitch turns of it), with bench.py's instance capacities. Also
the package's copies of the JAX package's test fixtures that its probes
use (``tests/helpers.make_camera`` and ``make_random_gaussians``)."""

from __future__ import annotations

import math

import numpy as np

from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as tf
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import MiniCam

W, H, N = 1920, 1088, 300_000
MAX_INSTANCES = (1 << 20) + (1 << 19) + (1 << 16)  # bench.py's capacities
MAX_LIVE = (1 << 20) + (1 << 18) + (1 << 17)
FOV = math.radians(60.0)
REPS = 10  # timed runs after the warm-up; the median is reported


def make_scene(n, seed=0, sh_degree=3, spread=2.5, depth_range=(3.0, 7.0),
               scale_range=(-4.6, -3.0)):
    """bench.py's scene (activated means, scales, quaternions, opacities,
    SH): ``make_random_gaussians`` with bench.py's spread and scales."""
    return make_random_gaussians(n, seed, sh_degree, spread, depth_range, scale_range)


def make_random_gaussians(n=500, seed=0, sh_degree=0, spread=1.5, depth_range=(3.0, 7.0),
                          scale_range=(-3.5, -2.0)):
    """Random gaussians in front of ``make_camera``'s viewpoint, as numpy
    arrays (means, scales, quaternions, opacities, SH): the draws of the
    JAX package's ``tests/helpers.make_random_gaussians``, in its order."""
    rng = np.random.default_rng(seed)
    means = np.stack([
        rng.uniform(-spread, spread, n),
        rng.uniform(-spread, spread, n),
        rng.uniform(depth_range[0] - 5.0, depth_range[1] - 5.0, n),
    ], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(scale_range[0], scale_range[1], (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.2, 0.95, n).astype(np.float32)
    sh = rng.normal(scale=0.3, size=(n, 3, (sh_degree + 1) ** 2)).astype(np.float32)
    sh[:, :, 0] += 0.8
    return means, scales, quats, opacities, sh


def raw_params(means, scales, quats, opacities, sh):
    """Activated scene -> the snapshot's raw (pre-activation) fields."""
    return dict(xyz=means, f_dc=sh[:, :, :1], f_rest=sh[:, :, 1:],
                scaling=np.log(scales), rotation=quats,
                opacity=np.log(opacities / (1.0 - opacities))[:, None])


def view_request(yaw_deg, pitch_deg, width=W, height=H) -> MiniCam:
    """bench.py's camera (at z = -5 looking down +z) turned by yaw/pitch."""
    y, p = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0], [-math.sin(y), 0, math.cos(y)]])
    rx = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]])
    R = ry @ rx  # camera-to-world rotation
    center = np.array([0.0, 0.0, -5.0])
    view = tf.world_to_view(R, -R.T @ center)
    full = (tf.projection_matrix(0.01, 100.0, FOV, FOV) @ view).astype(np.float32)
    return MiniCam(width, height, FOV, FOV, 0.01, 100.0, view, full)


def make_camera(width=64, height=64, fovx=math.radians(60), fovy=None, cam_z=-5.0,
                device=None):
    """The camera of the JAX package's ``tests/helpers.make_camera``: at (0,
    0, cam_z) looking down +z toward the origin. Returns ``CameraParams``
    on ``device`` (CUDA unless told otherwise)."""
    fovy = fovx if fovy is None else fovy
    view = tf.world_to_view(np.eye(3), np.array([0.0, 0.0, -cam_z]))
    full = (tf.projection_matrix(0.01, 100.0, fovx, fovy) @ view).astype(np.float32)
    return MiniCam(width, height, fovy, fovx, 0.01, 100.0, view, full).params(device)
