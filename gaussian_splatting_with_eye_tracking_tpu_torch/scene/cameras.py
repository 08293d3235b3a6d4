"""Cameras: a training view and a pose-only view request.

Port of ``Camera`` and ``MiniCam`` from
``gaussian_splatting_with_eye_tracking_tpu/scene/cameras.py``. ``Camera``
holds a dataset view (pose, fov, the ground-truth image on the host and
an optional alpha mask); ``MiniCam`` is what the live viewer sends (width,
height, fov, clip planes, view and view-projection matrices). Their
``params()`` give the rasterizer's ``CameraParams``, and ``Camera.gt()``
the image, on the requested device: CUDA unless told otherwise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as tf
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


def _camera_params(cam, device) -> CameraParams:
    dev = backend.resolve_device(device)
    return CameraParams(
        viewmatrix=torch.as_tensor(cam.view, device=dev),
        projmatrix=torch.as_tensor(cam.full_proj, device=dev),
        campos=torch.as_tensor(cam.camera_center, device=dev),
        tan_fovx=math.tan(cam.fovx * 0.5),
        tan_fovy=math.tan(cam.fovy * 0.5),
        width=cam.width,
        height=cam.height,
    )


@dataclass
class Camera:
    colmap_id: int
    R: np.ndarray  # (3, 3) camera-to-world rotation (COLMAP convention transposed)
    T: np.ndarray  # (3,) world-to-camera translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]  # (3, H, W) float32 in [0, 1], may be None
    image_name: str
    uid: int
    width: int = 0
    height: int = 0
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    gt_alpha_mask: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.image is not None:
            self.height, self.width = self.image.shape[-2:]
            self.image = np.clip(self.image, 0.0, 1.0).astype(np.float32)
            if self.gt_alpha_mask is not None:
                # the reference multiplies the ground truth by the alpha mask
                self.image = self.image * self.gt_alpha_mask
        self.view = tf.world_to_view(self.R, self.T, self.trans, self.scale)
        self.proj = tf.projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
        self.full_proj = (self.proj @ self.view).astype(np.float32)
        self.camera_center = np.linalg.inv(self.view)[:3, 3].astype(np.float32)

    def params(self, device=None) -> CameraParams:
        """Runs on CUDA unless ``device`` says otherwise."""
        return _camera_params(self, device)

    def gt(self, device=None) -> torch.Tensor:
        """The (3, H, W) ground truth; CUDA unless ``device`` says
        otherwise."""
        if self.image is None:
            raise ValueError(f"camera {self.image_name}: loaded without its image")
        return torch.as_tensor(self.image, device=backend.resolve_device(device))


class MiniCam:
    def __init__(self, width, height, fovy, fovx, znear, zfar, view, full_proj):
        self.width = width
        self.height = height
        self.fovy = fovy
        self.fovx = fovx
        self.znear = znear
        self.zfar = zfar
        self.view = np.array(view, np.float32)
        self.full_proj = np.array(full_proj, np.float32)
        self.camera_center = np.linalg.inv(self.view)[:3, 3].astype(np.float32)

    def params(self, device=None) -> CameraParams:
        """Runs on CUDA unless ``device`` says otherwise."""
        return _camera_params(self, device)
