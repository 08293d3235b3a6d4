"""COLMAP sparse-reconstruction files: binary and text readers, binary
writers, and the quaternion -> rotation conversion.

Port (an own copy) of ``gaussian_splatting_with_eye_tracking_tpu/scene/
colmap.py`` (the reference's ``scene/colmap_loader.py``), pure ``struct``
and numpy: files written by either package are byte-identical and read
the same in both.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

# model_id -> (name, num_params); params order per COLMAP docs
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_NPARAMS = {name: n for name, n in CAMERA_MODELS.values()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """wxyz quaternion -> 3x3 rotation (world->cam for COLMAP images)."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<" + "d" * nparams))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<dddd"))
            tvec = np.array(_read(f, "<ddd"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n2d,) = _read(f, "<Q")
            f.seek(n2d * 24, os.SEEK_CUR)  # (x, y double, point3D_id int64)
            out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3), np.float64)
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty((num,), np.float64)
        for i in range(num):
            data = _read(f, "<QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(track_len * 8, os.SEEK_CUR)
    return xyz, rgb, err


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is the 2D point list
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name)
    return out


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([int(x) for x in parts[4:7]])
            errs.append(float(parts[7]))
    return (
        np.array(xyzs, np.float64),
        np.array(rgbs, np.uint8),
        np.array(errs, np.float64),
    )


def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    name_to_id = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, name_to_id[c.model], c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def write_images_binary(path: str, imgs: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
