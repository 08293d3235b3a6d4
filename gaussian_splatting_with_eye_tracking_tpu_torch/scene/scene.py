"""Scene: a dataset and the gaussian model trained on it.

Port of ``Scene``, ``search_for_max_iteration`` and
``load_state_from_params`` from
``gaussian_splatting_with_eye_tracking_tpu/scene/scene.py`` (the
reference's ``scene/__init__.py``): read a COLMAP or Blender scene, write
``cameras.json`` and ``input.ply`` into a new model directory, shuffle the
cameras with ``random.Random(seed)``, take ``cameras_extent`` from the
scene normalization, build a camera list per resolution scale, and start
the model from the point cloud or restore it from
``point_cloud/iteration_N``. The model lives on ``cfg.data_device``.
``write=False`` leaves the model directory alone (the ranks of a
multi-process run other than the first).
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig, OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io as model_ply
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import dataset_readers as dsr
from gaussian_splatting_with_eye_tracking_tpu_torch.utils import camera_utils as cu


def search_for_max_iteration(folder: str) -> int:
    """The largest N of the ``iteration_N`` entries in ``folder``."""
    return max(int(f.split("_")[-1]) for f in os.listdir(folder))


class Scene:
    def __init__(
        self,
        cfg: ModelConfig,
        opt: Optional[OptimizationConfig] = None,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales: List[float] = (1.0,),
        load_images: bool = True,
        seed: int = 0,
        write: bool = True,
    ):
        self.device = backend.resolve_data_device(cfg.data_device)
        self.model_path = cfg.model_path
        self.loaded_iter = None

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        info = dsr.detect_and_read_scene(cfg.source_path, cfg.images, cfg.white_background,
                                         cfg.eval)
        self.info = info

        if not self.loaded_iter and self.model_path and write:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cam_json = [cu.camera_to_json(i, c)
                        for i, c in enumerate(info.train_cameras + info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        self.train_cameras: Dict[float, list] = {}
        self.test_cameras: Dict[float, list] = {}
        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(train_infos)
            rng.shuffle(test_infos)
        for scale in resolution_scales:
            self.train_cameras[scale] = cu.camera_list_from_infos(
                train_infos, cfg.resolution, scale, load_images)
            self.test_cameras[scale] = cu.camera_list_from_infos(
                test_infos, cfg.resolution, scale, load_images)

        self.cameras_extent = info.nerf_norm_radius

        opt = opt or OptimizationConfig()
        if self.loaded_iter:
            params, sh_degree = model_ply.load_gaussians_ply(
                os.path.join(self.model_path, "point_cloud", f"iteration_{self.loaded_iter}",
                             "point_cloud.ply"), device=self.device)
            self.max_sh_degree = sh_degree
            self.gaussians, self.tx = load_state_from_params(
                params, sh_degree, opt, self.cameras_extent, cfg.capacity)
        else:
            self.max_sh_degree = cfg.sh_degree
            self.gaussians, self.tx = gm.create_from_points(
                info.points, info.colors, cfg.sh_degree, opt,
                spatial_lr_scale=self.cameras_extent, capacity=cfg.capacity,
                device=self.device)

    def save(self, iteration: int) -> None:
        out = os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")
        os.makedirs(out, exist_ok=True)
        model_ply.save_gaussians_ply(os.path.join(out, "point_cloud.ply"),
                                     self.gaussians.params, self.gaussians.active)

    def get_train_cameras(self, scale: float = 1.0):
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0):
        return self.test_cameras[scale]


def load_state_from_params(params: gm.GaussianParams, sh_degree: int,
                           opt: OptimizationConfig, spatial_lr_scale: float,
                           capacity: int = 0):
    """A training state for restored parameters (every row active, active
    SH degree ``sh_degree``) at ``capacity`` slots, by default
    next_pow2(max(2n, 1024)), and its optimizer. Returns (state, tx)."""
    n = params.xyz.shape[0]
    tx = gm.make_optimizer(opt, spatial_lr_scale)
    cap = capacity or gm.next_pow2(max(n * 2, 1024))
    return gm.init_training(params, sh_degree, tx, cap), tx
