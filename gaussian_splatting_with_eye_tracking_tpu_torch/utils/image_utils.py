"""Image metrics and image files.

Port of ``mse_np``, ``psnr_np``, ``save_image`` and ``load_image_chw``
from ``gaussian_splatting_with_eye_tracking_tpu/utils/image_utils.py``.
Image files are read and written through PIL (Pillow), as the JAX package
does; it is imported when a file is touched, never at import, and its
absence raises an error that names the file.
"""

from __future__ import annotations

import numpy as np


def mse_np(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a - b) ** 2))


def psnr_np(a: np.ndarray, b: np.ndarray) -> float:
    m = mse_np(a, b)
    return float(20.0 * np.log10(1.0 / np.sqrt(max(m, 1e-10))))


def pil_image(what: str):
    """PIL's ``Image`` module; without Pillow, a ``RuntimeError`` naming
    ``what`` (the file or the operation that needed it)."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{what}: image files are read and written through PIL (Pillow), "
                           "which is not installed") from None
    return Image


def image_size(path: str) -> tuple:
    """(width, height) of an image file, from its header."""
    with pil_image(path).open(path) as im:
        return im.size


def save_uint8(arr_hwc: np.ndarray, path: str) -> None:
    """uint8 (H, W, 3) -> an image file, its format from the extension."""
    pil_image(path).fromarray(arr_hwc).save(path)


def save_image(img_chw: np.ndarray, path: str) -> None:
    """(3, H, W) float in [0, 1] -> PNG."""
    save_uint8((np.clip(np.transpose(img_chw, (1, 2, 0)), 0, 1) * 255 + 0.5).astype(np.uint8),
               path)


def load_image_chw(path: str) -> np.ndarray:
    """An image file as float32 (3, H, W) in [0, 1], through PIL's
    ``convert("RGB")``."""
    with pil_image(path).open(path) as im:
        arr = np.asarray(im.convert("RGB")).astype(np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))
