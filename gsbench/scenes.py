"""The configurations' scenes, drawn from the run's seed on the device.

A configuration file's ``scene`` names a ``kind`` and its sizes:

- ``random_gaussians``: bench.py's scene (the distributions of
  gaussian_splatting_with_eye_tracking_tpu_torch/bench_scene.py:25-47,
  ``make_random_gaussians`` with bench.py's spread and scales), drawn with
  a ``torch.Generator`` on the card in a few large calls rather than
  numpy's stream: means uniform in [-spread, spread]^2 x (depth_range -
  5), log-scales uniform in scale_range, quaternions normal then
  normalised, opacities uniform in opacity_range, SH normal(0, 0.3) with
  0.8 added to the DC term;
- ``point_cloud``: fps_test.py's synthetic scene
  (gaussian_splatting_with_eye_tracking_tpu_torch/fps_test.py:183-195 and
  models/gaussian_model.py:269-296, ``create_from_points``): points
  uniform in [-extent, extent]^3 with uniform colours, isotropic
  log-scales from the mean squared distance to the 3 nearest other points
  (floored at 1e-7), identity rotations, opacity 0.1, SH DC from the
  colour and the rest zero.

Both return raw (pre-activation) float32 parameters as the renderer's
inputs and the reference's: xyz (N, 3), f_dc (N, 3, 1), f_rest (N, 3,
15), scaling (N, 3), rotation (N, 4), opacity (N, 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def _logit(p):
    return torch.log(p / (1.0 - p))


def random_gaussians(gen: torch.Generator, spec: dict, device) -> dict:
    n = int(spec["n"])
    k = (int(spec["sh_degree"]) + 1) ** 2
    spread = float(spec["spread"])
    d0, d1 = (float(v) - 5.0 for v in spec["depth_range"])
    s0, s1 = (float(v) for v in spec["scale_range"])
    o0, o1 = (float(v) for v in spec["opacity_range"])
    u = torch.rand((7, n), generator=gen, device=device)
    g = torch.randn((4 + 3 * k, n), generator=gen, device=device)
    xyz = torch.stack([(2 * u[0] - 1) * spread, (2 * u[1] - 1) * spread,
                       d0 + (d1 - d0) * u[2]], -1)
    scaling = (s0 + (s1 - s0) * u[3:6]).T.contiguous()
    quats = g[:4].T
    quats = quats / torch.linalg.vector_norm(quats, dim=-1, keepdim=True)
    opacity = _logit(o0 + (o1 - o0) * u[6])[:, None]
    sh = (0.3 * g[4:]).T.reshape(n, 3, k)
    sh[:, :, 0] += 0.8
    return dict(xyz=xyz, f_dc=sh[:, :, :1].contiguous(), f_rest=sh[:, :, 1:].contiguous(),
                scaling=scaling, rotation=quats.contiguous(), opacity=opacity)


# frozen copy of gaussian_splatting_with_eye_tracking_tpu_torch/ops/knn.py:17-22
def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """(N, 3) points -> (N,) float32 mean of the squared distances to each
    point's 3 nearest other points (host, scipy's cKDTree)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    d, _ = cKDTree(pts).query(pts, k=4, workers=-1)  # includes self at d = 0
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)


def point_cloud(gen: torch.Generator, spec: dict, device) -> dict:
    n = int(spec["n"])
    k = (int(spec["sh_degree"]) + 1) ** 2
    ext = float(spec["extent"])
    u = torch.rand((n, 6), generator=gen, device=device)
    xyz = ((2 * u[:, :3] - 1) * ext).contiguous()
    dist2 = np.maximum(mean_sq_dist_3nn(xyz.cpu().numpy()), 1e-7)
    log_scale = torch.from_numpy(np.log(np.sqrt(dist2))).to(device)[:, None].repeat(1, 3)
    rot = torch.zeros((n, 4), device=device)
    rot[:, 0] = 1.0
    return dict(xyz=xyz, f_dc=((u[:, 3:] - 0.5) / SH_C0)[:, :, None].contiguous(),
                f_rest=torch.zeros((n, 3, k - 1), device=device), scaling=log_scale,
                rotation=rot,
                opacity=torch.full((n, 1), float(math.log(0.1 / 0.9)), device=device))


KINDS = {"random_gaussians": random_gaussians, "point_cloud": point_cloud}


def make_scene(spec: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    return KINDS[spec["kind"]](gen, spec, device)
