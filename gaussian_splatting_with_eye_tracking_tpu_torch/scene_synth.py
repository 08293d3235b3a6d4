"""A synthetic COLMAP scene whose images are renders of a known gaussian
mixture.

Port of ``synthesize_dataset`` from the repository's
``train_regression_r04.py``: 24 cameras (by default) on an orbit of
radius 5 around the origin with a wavy elevation, 256x256 PINHOLE with a
300 px focal length, written with the COLMAP writers; 800 noisy SfM
points drawn near the centres of a 3000-gaussian SH-3 mixture
(``bench_scene.make_scene`` with seed 3, spread 1.2, depths (4, 6),
log-scales (-3.6, -2.6), the numbers the JAX package's test helper
draws); and ground-truth PNGs rendered from that mixture through the
``Scene`` loader's own cameras and ``rasterize``, so the conventions the
trainer reads are the ones the images were made with. Runs on the card
unless ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_scene
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import colmap as cm
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_uint8


def _orbit_images(n_cams: int):
    """The orbit's ``ColmapImage``s (camera 1), named img_000.png..."""
    from scipy.spatial.transform import Rotation

    imgs = {}
    for i in range(n_cams):
        theta = 2 * np.pi * i / n_cams
        elev = 0.25 + 0.1 * np.sin(3 * theta)
        pos = np.array([5 * np.cos(theta) * np.cos(elev), 5 * np.sin(elev),
                        5 * np.sin(theta) * np.cos(elev)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
        right /= np.linalg.norm(right)
        R_w2c = np.stack([right, np.cross(fwd, right), fwd], axis=0)
        qx, qy, qz, qw = Rotation.from_matrix(R_w2c).as_quat()
        imgs[i + 1] = cm.ColmapImage(i + 1, np.array([qw, qx, qy, qz]), -R_w2c @ pos, 1,
                                     f"img_{i:03d}.png")
    return imgs


def synthesize_dataset(root: str, n_cams: int = 24, width: int = 256, height: int = 256,
                       seed: int = 3, device=None) -> str:
    """Write the scene under ``root`` (``sparse/0`` and ``images``);
    returns ``root``."""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    images_dir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)

    focal = 300.0
    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {1: cm.ColmapCamera(
        1, "PINHOLE", width, height, np.array([focal, focal, width / 2, height / 2]))})
    cm.write_images_binary(os.path.join(sparse, "images.bin"), _orbit_images(n_cams))

    # the SfM points: noisy samples of the mixture's centres
    gaussians = make_scene(3000, seed=seed, spread=1.2, depth_range=(4.0, 6.0),
                           scale_range=(-3.6, -2.6))
    sel = rng.choice(3000, 800, replace=False)
    xyz = gaussians[0][sel] + rng.normal(scale=0.03, size=(800, 3))
    rgb = rng.integers(40, 215, (800, 3))
    cm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)

    # the ground truth, through the cameras the trainer will read
    scene = Scene(ModelConfig(source_path=root, model_path="", data_device=str(dev)),
                  shuffle=False, load_images=False)
    g = [torch.from_numpy(a).to(dev) for a in gaussians]
    bg = torch.zeros(3, device=dev)
    for cam in scene.get_train_cameras() + scene.get_test_cameras():
        with torch.no_grad():
            out = rast.rasterize(*g, cam.params(dev), bg, sh_degree=3,
                                 max_instances=1 << 18, max_live=1 << 18)
        if bool(out.overflow):
            raise RuntimeError(f"{cam.image_name}: ground-truth render overflowed 2^18 instances")
        img = torch.clamp(out.color, 0, 1).permute(1, 2, 0).cpu().numpy()
        save_uint8((img * 255).astype(np.uint8), os.path.join(images_dir, cam.image_name + ".png"))
    return root
