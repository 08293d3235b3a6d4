"""Scene readers: COLMAP and Blender (NeRF-synthetic) datasets.

Port of ``gaussian_splatting_with_eye_tracking_tpu/scene/dataset_readers.py``
(the reference's ``readColmapSceneInfo``, ``readNerfSyntheticInfo`` and
``getNerfppNorm``):

- COLMAP: ``sparse/0`` (or ``sparse``) binary files, else text files;
  PINHOLE / SIMPLE_PINHOLE intrinsics; cameras sorted by image name;
  under ``eval`` every ``llffhold``-th camera is a test camera;
  ``points3D`` converted once to a ``points3D.ply`` cache beside it.
- Blender: ``transforms_train.json`` / ``transforms_test.json``, OpenGL
  camera axes flipped to COLMAP's, RGBA composited over the background
  when the images load; 100,000 random points (seed 0) when the scene
  has no ``points3d.ply``.
- The scene normalization: the bounding sphere of the training cameras'
  centres, radius times 1.1.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional

import numpy as np

from gaussian_splatting_with_eye_tracking_tpu_torch.ops.transforms import focal2fov, fov2focal
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import colmap as cm
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import ply as ply_io
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import image_size


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray  # (3, 3) camera-to-world rotation (COLMAP's, transposed)
    T: np.ndarray  # (3,) world-to-camera translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    bg01: Optional[float] = None  # Blender alpha-composite background (0 or 1)


class SceneInfo(NamedTuple):
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_norm_radius: float
    nerf_norm_translate: np.ndarray
    ply_path: str


def get_nerfpp_norm(cam_centers: np.ndarray):
    """(radius, translate): 1.1 times the largest distance of a camera
    centre from their mean, and minus that mean."""
    center = cam_centers.mean(axis=0, keepdims=True)
    dist = np.linalg.norm(cam_centers - center, axis=-1)
    radius = dist.max() * 1.1
    return float(radius), -center[0]


def _camera_center(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """C = -R_w2c^T t, with R stored transposed (camera-to-world)."""
    return (-R @ T.reshape(3, 1)).ravel()


def read_colmap_scene(path: str, images_dir: str = "images", eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = cm.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = cm.read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    for idx, key in enumerate(sorted(imgs.keys())):
        im = imgs[key]
        intr = cams[im.camera_id]
        R = cm.qvec_to_rotmat(im.qvec).T
        T = im.tvec.copy()
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                f"Unsupported COLMAP camera model {intr.model}: undistort the images "
                "first (PINHOLE/SIMPLE_PINHOLE only, as the reference reader).")
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=focal2fov(focal_x, intr.width),
            fovy=focal2fov(focal_y, intr.height),
            image_path=os.path.join(path, images_dir, im.name),
            image_name=os.path.splitext(im.name)[0],
            width=intr.width, height=intr.height,
        ))
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    radius, translate = get_nerfpp_norm(np.stack([_camera_center(c.R, c.T) for c in train]))

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = cm.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = cm.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        ply_io.store_point_cloud(ply_path, xyz, rgb)
    points, colors, _ = ply_io.fetch_point_cloud(ply_path)

    return SceneInfo(
        points=points, colors=colors, train_cameras=train, test_cameras=test,
        nerf_norm_radius=radius, nerf_norm_translate=translate, ply_path=ply_path,
    )


def _read_blender_cameras(path: str, transforms_file: str, white_background: bool):
    with open(os.path.join(path, transforms_file)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(meta["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path += ".png"
        image_path = os.path.join(path, file_path)
        # camera-to-world with OpenGL axes: flip y and z to COLMAP's
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        width, height = image_size(image_path)
        infos.append(CameraInfo(
            uid=idx, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=fovx,
            fovy=focal2fov(fov2focal(fovx, width), height),
            image_path=image_path,
            image_name=os.path.splitext(os.path.basename(file_path))[0],
            width=width, height=height,
            bg01=1.0 if white_background else 0.0,
        ))
    return infos


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True) -> SceneInfo:
    train = _read_blender_cameras(path, "transforms_train.json", white_background)
    if eval_split and os.path.exists(os.path.join(path, "transforms_test.json")):
        test = _read_blender_cameras(path, "transforms_test.json", white_background)
    else:
        test = []

    radius, translate = get_nerfpp_norm(np.stack([_camera_center(c.R, c.T) for c in train]))

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        rng = np.random.default_rng(0)
        xyz = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
        rgb = rng.random((n, 3)).astype(np.float32)
        ply_io.store_point_cloud(ply_path, xyz, (rgb * 255).astype(np.uint8))
    points, colors, _ = ply_io.fetch_point_cloud(ply_path)

    return SceneInfo(
        points=points, colors=colors, train_cameras=train, test_cameras=test,
        nerf_norm_radius=radius, nerf_norm_translate=translate, ply_path=ply_path,
    )


def detect_and_read_scene(path: str, images_dir: str = "images",
                          white_background: bool = False,
                          eval_split: bool = False) -> SceneInfo:
    """A COLMAP scene if ``path`` has ``sparse/``, a Blender scene if it
    has ``transforms_train.json`` (whose test split is always read)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(path, images_dir, eval_split)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return read_blender_scene(path, white_background, eval_split=True)
    raise ValueError(f"Could not recognize scene type for {path}")
