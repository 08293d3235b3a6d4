"""The benchmark's traffic: head paths (cameras), gaze paths and the
requests' timing, all drawn from the run's seed.

A mix (``gsbench/mixes/<mix>.json``) is data read by the functions here:
its ``entry`` names the path it drives (``gsbench/entries/<entry>.py``),
``arrival`` is ``"fixed"`` (an open loop at ``rate_hz``: request i is due
at i / rate_hz whether or not the one before has finished) or ``"closed"``
(the next request starts when the last has finished), and its ``head``
and ``gaze`` keys parametrise the paths below.
"""

from __future__ import annotations

import math

import numpy as np

FOV = math.radians(60.0)
ZNEAR, ZFAR = 0.01, 100.0


# frozen copy of gaussian_splatting_with_eye_tracking_tpu_torch/ops/transforms.py:28-71
# (world_to_view without translate/scale, projection_matrix)
def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    tan_half_fovx, tan_half_fovy = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    top, right = tan_half_fovy * znear, tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (2 * right)
    P[1, 1] = 2.0 * znear / (2 * top)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


# frozen copy of gaussian_splatting_with_eye_tracking_tpu_torch/bench_scene.py:53-62
# (view_request) and scene/cameras.py:91 (the camera centre)
def camera(yaw_deg: float, pitch_deg: float):
    """bench.py's camera at (0, 0, -5) looking down +z, turned by yaw and
    pitch. Returns (view (4, 4), full projection (4, 4), centre (3,)) as
    float32 numpy arrays."""
    y, p = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0], [-math.sin(y), 0, math.cos(y)]])
    rx = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]])
    R = ry @ rx
    center = np.array([0.0, 0.0, -5.0])
    view = world_to_view(R, -R.T @ center)
    full = (projection_matrix(ZNEAR, ZFAR, FOV, FOV) @ view).astype(np.float32)
    return view, full, np.linalg.inv(view)[:3, 3].astype(np.float32)


def head_path(rng: np.random.Generator, n: int, limit_deg: float, step_deg: float) -> np.ndarray:
    """(n, 2) yaw and pitch in degrees: a random walk from (0, 0) with
    N(0, step_deg) steps, reflected at +-limit_deg."""
    steps = rng.normal(0.0, step_deg, (n, 2))
    steps[0] = 0.0
    pose = np.cumsum(steps, axis=0)
    period = 4.0 * limit_deg  # fold onto [-limit, limit] by reflection
    pose = np.mod(pose + limit_deg, period)
    return np.where(pose > 2 * limit_deg, period - pose, pose) - limit_deg


def gaze_path(rng: np.random.Generator, n: int, fix_min: int, fix_max: int,
              lo: float, hi: float) -> np.ndarray:
    """(n, 2) pupil positions in [0, 1]^2: fixations of fix_min..fix_max
    frames, each followed by a saccade to a uniform point in [lo, hi]^2."""
    out = np.empty((n, 2))
    i = 0
    while i < n:
        length = int(rng.integers(fix_min, fix_max + 1))
        out[i:i + length] = rng.uniform(lo, hi, 2)
        i += length
    return out


def request_count(mix: dict, seconds: float) -> int:
    """Requests due in an open-loop window (0 for a closed loop, which runs
    until the window ends)."""
    if mix["arrival"] == "fixed":
        return int(math.floor(mix["rate_hz"] * seconds))
    return 0


def sample(rng: np.random.Generator, lo: int, hi: int, k: int) -> list[int]:
    """k distinct request indices in [lo, hi), sorted, always with the
    last one."""
    k = min(k, hi - lo)
    picks = set(rng.choice(np.arange(lo, hi - 1), size=k - 1, replace=False).tolist()) \
        if k > 1 else set()
    return sorted(picks | {hi - 1})
