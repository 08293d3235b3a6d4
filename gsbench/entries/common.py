"""What the entries share: the program's state from the scene's raw
parameters, the requests' cameras, and the reference's view of both."""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import traffic
from gsbench.reference import render as ref


def program_state(raw: dict, config: dict, with_optimizer=None):
    """The program's model of the scene: every row active in exactly N
    slots (``slots`` null), or padded to ``slots`` as its trainer and
    point-cloud init pad it. ``with_optimizer`` (an ``OptimizationConfig``
    and the xyz learning-rate scale) keeps Adam's state; otherwise only
    what rendering reads is kept. Returns (state, optimizer or None)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    params = gm.GaussianParams(**{k: v.clone() for k, v in raw.items()})
    sh_degree = int(config["scene"]["sh_degree"])
    slots = config.get("slots")
    if slots is None and with_optimizer is None:
        return gm.state_from_params(params, sh_degree), None
    opt, lr_scale = with_optimizer or (OptimizationConfig(), 1.0)
    tx = gm.make_optimizer(opt, lr_scale)
    state = gm.init_training(params, sh_degree, tx, capacity=int(slots or 0))
    if with_optimizer is None:
        state = state._replace(opt_state=None, max_radii2d=None, xyz_grad_accum=None,
                               denom=None)
        tx = None
    return state, tx


class Views:
    """The requests' cameras, on the device: numpy matrices from the head
    path, made once at set-up."""

    def __init__(self, poses: np.ndarray, width: int, height: int, device):
        self.width, self.height = width, height
        self.tan = math.tan(traffic.FOV * 0.5)
        cams = [traffic.camera(float(yaw), float(pitch)) for yaw, pitch in poses]
        views, fulls, centres = (torch.as_tensor(np.stack(m), device=device) for m in zip(*cams))
        self.mats = list(zip(views, fulls, centres))

    def __len__(self):
        return len(self.mats)

    def arrays(self, i):
        """(viewmatrix, projmatrix, campos, tan_fovx, tan_fovy): the
        program's camera arguments."""
        return (*self.mats[i], self.tan, self.tan)

    def params(self, i):
        from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams

        v, f, c = self.mats[i]
        return CameraParams(viewmatrix=v, projmatrix=f, campos=c, tan_fovx=self.tan,
                            tan_fovy=self.tan, width=self.width, height=self.height)

    def reference(self, i) -> ref.Camera:
        v, f, c = self.mats[i]
        return ref.Camera(view=v, full=f, campos=c, tan_fovx=self.tan, tan_fovy=self.tan,
                          width=self.width, height=self.height)


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """Widest gap between two images; NaN anywhere reads as NaN."""
    d = (a.float() - b.float()).abs()
    return float("nan") if not bool(torch.isfinite(d).all()) else float(d.max())
