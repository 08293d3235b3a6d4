"""RITnet dataset pipeline, on the host in numpy, scipy and CPU tensors.

Port of ``gaussian_splatting_with_eye_tracking_tpu/models/ritnet_data.py``
(the reference's RITnet/dataset.py:35-212, IrisDataset). OpenEDS-style
folders:

    <root>/<split>/images/*.png   grayscale eye images
    <root>/<split>/labels/*.npy   (H, W) int class maps (0..3)

Preprocessing: gamma-0.8 table, CLAHE(1.5, 8x8), [-1, 1] normalisation
(``ritnet.normalise_eye_images`` on each batch, as inference). Training
augmentations: horizontal flip, gaussian blur, bright lines, a bright
blob, a small translation. Every random draw comes from one
``np.random.Generator`` in JAX's order (the permutation, then per image the
flip, the blur and its sigma, the line counts and ends, the blob centre,
the shift), so one seed gives JAX's batches bit for bit. No torch RNG is
used; the batches are numpy arrays, and the caller moves each to the
device once.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train


def list_split(root: str, split: str) -> List[str]:
    img_dir = os.path.join(root, split, "images")
    return sorted(
        os.path.splitext(f)[0] for f in os.listdir(img_dir)
        if f.endswith((".png", ".jpg", ".bmp"))
    )


def load_example(root: str, split: str, name: str):
    """(uint8 grayscale image (H, W), int32 label (H, W)) of ``name``."""
    from PIL import Image

    img_path = None
    for ext in (".png", ".jpg", ".bmp"):
        p = os.path.join(root, split, "images", name + ext)
        if os.path.exists(p):
            img_path = p
            break
    with Image.open(img_path) as im:
        img = np.asarray(im.convert("L"))
    label = np.load(os.path.join(root, split, "labels", name + ".npy"))
    return img, label.astype(np.int32)


def augment(img: np.ndarray, label: np.ndarray, rng: np.random.Generator):
    """Flip (p 0.5), gaussian blur, 1-3 bright lines, a bright blob, a
    shift of up to 8 px (each p 0.2), drawn from ``rng`` in JAX's order."""
    h, w = img.shape
    if rng.random() < 0.5:
        img = img[:, ::-1].copy()
        label = label[:, ::-1].copy()
    if rng.random() < 0.2:  # gaussian blur
        from scipy import ndimage

        img = ndimage.gaussian_filter(img.astype(np.float32), sigma=rng.uniform(1, 2))
        img = np.clip(img, 0, 255).astype(np.uint8)
    if rng.random() < 0.2:  # random bright lines (reflection artifacts)
        img = img.copy()
        for _ in range(rng.integers(1, 4)):
            x0, x1 = rng.integers(0, w, 2)
            y0, y1 = rng.integers(0, h, 2)
            n = max(abs(int(x1) - int(x0)), abs(int(y1) - int(y0)), 1)
            xs = np.linspace(x0, x1, n).astype(int)
            ys = np.linspace(y0, y1, n).astype(int)
            img[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = 255
    if rng.random() < 0.2:  # starburst-style bright blob
        img = img.astype(np.float32)
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = 120 * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 15.0**2)))
        img = np.clip(img + blob, 0, 255).astype(np.uint8)
    if rng.random() < 0.2:  # small translation
        dy, dx = rng.integers(-8, 9, 2)
        img = np.roll(np.roll(img, dy, 0), dx, 1)
        label = np.roll(np.roll(label, dy, 0), dx, 1)
    return img, label


def batches(
    root: str, split: str, batch_size: int, rng: np.random.Generator,
    train: bool = True, crop16: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yields (images (B, 1, H, W) float32, labels (B, H, W) int32, weight
    maps (B, H, W), distance maps (B, C, H, W)); a training split is
    shuffled and augmented, and a last partial batch is dropped."""
    names = list_split(root, split)
    order = rng.permutation(len(names)) if train else np.arange(len(names))
    for s in range(0, len(order) - batch_size + 1, batch_size):
        imgs, labels, wmaps, dmaps = [], [], [], []
        for i in order[s:s + batch_size]:
            img, label = load_example(root, split, names[i])
            if train:
                img, label = augment(img, label, rng)
            if crop16:
                hh = img.shape[0] - img.shape[0] % 16
                ww = img.shape[1] - img.shape[1] % 16
                img, label = img[:hh, :ww], label[:hh, :ww]
            imgs.append(img)
            labels.append(label)
            wmaps.append(ritnet_train.boundary_weight_map(label))
            dmaps.append(ritnet_train.distance_maps(label))
        yield (
            ritnet.normalise_eye_images(torch.from_numpy(np.stack(imgs)))[:, None].numpy(),
            np.stack(labels).astype(np.int32),
            np.stack(wmaps), np.stack(dmaps),
        )
