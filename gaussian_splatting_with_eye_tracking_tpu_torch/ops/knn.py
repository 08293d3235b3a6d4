"""Mean squared distance to the 3 nearest neighbours, for scale init.

Port of ``mean_sq_dist_3nn`` and ``mean_sq_dist_3nn_jax`` in
``gaussian_splatting_with_eye_tracking_tpu/ops/knn.py`` (the reference's
``distCUDA2``). ``mean_sq_dist_3nn`` is the scene-init path: host-side, run
once, with scipy's ``cKDTree`` as the JAX package's fallback does.
``mean_sq_dist_3nn_blocked`` is the brute-force oracle, on any device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """(N, 3) points -> (N,) float32 mean of the squared distances to each
    point's 3 nearest other points."""
    pts = np.asarray(points, np.float64)
    d, _ = cKDTree(pts).query(pts, k=4, workers=-1)  # includes self at d = 0
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)


def mean_sq_dist_3nn_blocked(points: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Brute-force 3-NN, ``block`` query points at a time (O(N^2)): the
    port of JAX's ``mean_sq_dist_3nn_jax``. Like it, every point at squared
    distance <= 1e-12 counts as the point itself, so an exact duplicate is
    not a neighbour; ``cKDTree`` (``mean_sq_dist_3nn``) counts it, at
    distance 0. Returns (N,) on the points' device."""
    n = points.shape[0]
    pts = F.pad(points, (0, 0, 0, (-n) % block), value=float("inf"))
    out = []
    for q in pts.split(block):
        d2 = torch.sum((q[:, None, :] - points[None, :, :]) ** 2, dim=-1)
        d2 = torch.where(d2 <= 1e-12, float("inf"), d2)
        out.append(torch.topk(d2, 3, dim=-1, largest=False).values.mean(dim=-1))
    return torch.cat(out)[:n]
