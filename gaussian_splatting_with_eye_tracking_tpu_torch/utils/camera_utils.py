"""Camera lists from camera infos: image loading, the resolution policy
and the ``cameras.json`` export.

Port of ``load_image``, ``resize_image``, ``load_cam``,
``camera_list_from_infos`` and ``camera_to_json`` from
``gaussian_splatting_with_eye_tracking_tpu/utils/camera_utils.py`` (the
reference's ``loadCam`` and ``camera_to_JSON``). Images load on the host
as numpy through PIL, as in the JAX package; ``Camera.gt`` moves them to
the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gaussian_splatting_with_eye_tracking_tpu_torch.ops.transforms import fov2focal
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import Camera
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import pil_image

_WARNED = [False]  # the reference prints its downscale notice once per process


def load_image(path: str, bg01: Optional[float] = None) -> np.ndarray:
    """An image file as float32 (3, H, W) in [0, 1]; gray is repeated over
    the channels, and RGBA is composited over ``bg01`` (white when None),
    as the reference's Blender reader does."""
    with pil_image(path).open(path) as im:
        arr = np.asarray(im).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    if arr.shape[2] == 4:
        rgb, a = arr[:, :, :3], arr[:, :, 3:4]
        bg = 1.0 if bg01 is None else bg01
        arr = rgb * a + bg * (1 - a)
    return np.transpose(arr[:, :, :3], (2, 0, 1))


def resize_image(img: np.ndarray, size: tuple) -> np.ndarray:
    """(C, H, W) in [0, 1] -> (C, h, w) for ``size`` = (w, h): each channel
    truncated to uint8 and resized by PIL's BILINEAR filter."""
    image = pil_image("resize_image")
    w, h = size
    chans = [np.asarray(image.fromarray((np.clip(c, 0, 1) * 255).astype(np.uint8))
                        .resize((w, h), image.BILINEAR)).astype(np.float32) / 255.0
             for c in img]
    return np.stack(chans, axis=0)


def load_cam(info, resolution_arg: int, resolution_scale: float = 1.0,
             load_image_data: bool = True) -> Camera:
    """The reference's resolution policy: 1, 2, 4 or 8 divide the size;
    anything else (-1) keeps it, or scales it to 1600 px wide (with a
    one-time notice) when it is wider."""
    img = load_image(info.image_path, info.bg01) if load_image_data else None
    orig_w, orig_h = info.width, info.height
    if resolution_arg in (1, 2, 4, 8):
        scale = resolution_scale * resolution_arg
        target = (round(orig_w / scale), round(orig_h / scale))
    else:
        if orig_w > 1600:
            if not _WARNED[0]:
                print(
                    "[ INFO ] Encountered quite large input images (>1.6K "
                    "pixels width), rescaling to 1.6K.\n If this is not "
                    "desired, please explicitly specify '--resolution/-r' as 1"
                )
                _WARNED[0] = True
            global_down = orig_w / 1600
        else:
            global_down = 1
        scale = global_down * resolution_scale
        target = (int(orig_w / scale), int(orig_h / scale))
    if img is not None and (img.shape[2], img.shape[1]) != target:
        img = resize_image(img, target)
    return Camera(
        colmap_id=info.uid, R=info.R, T=info.T, fovx=info.fovx, fovy=info.fovy,
        image=img, image_name=info.image_name, uid=info.uid,
        width=target[0], height=target[1],
    )


def camera_list_from_infos(infos: List, resolution_arg: int, resolution_scale: float = 1.0,
                           load_images: bool = True) -> List[Camera]:
    return [load_cam(i, resolution_arg, resolution_scale, load_images) for i in infos]


def camera_to_json(idx: int, cam) -> dict:
    """One entry of ``cameras.json``: camera centre and camera-to-world
    rotation, size and focal lengths."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(cam.fovy, cam.height),
        "fx": fov2focal(cam.fovx, cam.width),
    }
