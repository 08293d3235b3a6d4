"""Mean squared distance to the 3 nearest neighbours, for scale init.

Port of ``mean_sq_dist_3nn`` in
``gaussian_splatting_with_eye_tracking_tpu/ops/knn.py`` (the reference's
``distCUDA2``): host-side and run once at scene init, with scipy's
``cKDTree`` as the JAX package's fallback does.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def mean_sq_dist_3nn(points: np.ndarray) -> np.ndarray:
    """(N, 3) points -> (N,) float32 mean of the squared distances to each
    point's 3 nearest other points."""
    pts = np.asarray(points, np.float64)
    d, _ = cKDTree(pts).query(pts, k=4, workers=-1)  # includes self at d = 0
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
