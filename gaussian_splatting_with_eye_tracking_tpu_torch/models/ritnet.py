"""RITnet eye segmentation (DenseNet2D), inference only.

Port of ``gaussian_splatting_with_eye_tracking_tpu/models/ritnet.py``: the
DenseUNet of 5 down blocks (2x2 average pooling, dense 3x3/1x1
convolutions, LeakyReLU 0.01, BatchNorm) and 4 up blocks (nearest x2
upsampling and skip concatenation), 32 channels, 4 classes (background,
sclera, iris, pupil), 249,220 parameters; the preprocessing (gamma 0.8
table, CLAHE 1.5 on an 8x8 grid, normalisation to [-1, 1]) and the pupil
centroid that serves as the gaze estimate.

Submodule names are the checkpoint's keys (``down_block1.conv1``, ...,
``out_conv1``), so the vendored weights load as a state dict. The weights
file ``weights/ritnet_best.npz`` is this package's own copy of the JAX
package's vendored conversion of the reference checkpoint. BatchNorm runs
in eval mode (running statistics, eps 1e-5). The convolutions run in true
float32: ``backend`` turns cuDNN's TF32 off for the process.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussian_splatting_with_eye_tracking_tpu_torch import backend

LEAK = 0.01  # torch LeakyReLU default
CHANNELS = 32
NUM_CLASSES = 4
PUPIL = 3

VENDORED_WEIGHTS = Path(__file__).resolve().parent / "weights" / "ritnet_best.npz"


def _conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class DownBlock(nn.Module):
    def __init__(self, cin: int, c: int, pool: bool):
        super().__init__()
        self.pool = pool
        self.conv1 = _conv(cin, c, 3)
        self.conv21 = _conv(cin + c, c, 1)
        self.conv22 = _conv(c, c, 3)
        self.conv31 = _conv(cin + 2 * c, c, 1)
        self.conv32 = _conv(c, c, 3)
        self.bn = nn.BatchNorm2d(c, eps=1e-5)

    def forward(self, x):
        if self.pool:
            x = F.avg_pool2d(x, 2)
        x1 = F.leaky_relu(self.conv1(x), LEAK)
        x21 = torch.cat([x, x1], 1)
        x22 = F.leaky_relu(self.conv22(self.conv21(x21)), LEAK)
        x31 = torch.cat([x21, x22], 1)
        return self.bn(F.leaky_relu(self.conv32(self.conv31(x31)), LEAK))


class UpBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv11 = _conv(2 * c, c, 1)
        self.conv12 = _conv(c, c, 3)
        self.conv21 = _conv(3 * c, c, 1)
        self.conv22 = _conv(c, c, 3)

    def forward(self, skip, x):
        x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skip], 1)
        x1 = F.leaky_relu(self.conv12(self.conv11(x)), LEAK)
        x21 = torch.cat([x, x1], 1)
        return F.leaky_relu(self.conv22(self.conv21(x21)), LEAK)


class DenseNet2D(nn.Module):
    """(N, 1, H, W) normalised grayscale, H and W divisible by 16 ->
    (N, 4, H, W) class logits. Port of ``densenet2d_apply``."""

    def __init__(self, channels: int = CHANNELS, in_channels: int = 1,
                 out_channels: int = NUM_CLASSES):
        super().__init__()
        c = channels
        self.down_block1 = DownBlock(in_channels, c, pool=False)
        for i in range(2, 6):
            setattr(self, f"down_block{i}", DownBlock(c, c, pool=True))
        for i in range(1, 5):
            setattr(self, f"up_block{i}", UpBlock(c))
        self.out_conv1 = _conv(c, out_channels, 1)
        self.eval()

    def forward(self, x):
        x1 = self.down_block1(x)
        x2 = self.down_block2(x1)
        x3 = self.down_block3(x2)
        x4 = self.down_block4(x3)
        x5 = self.down_block5(x4)
        x6 = self.up_block1(x4, x5)
        x7 = self.up_block2(x3, x6)
        x8 = self.up_block3(x2, x7)
        x9 = self.up_block4(x1, x8)
        return self.out_conv1(x9)


def get_predictions(logits: torch.Tensor) -> torch.Tensor:
    """Class map: argmax over the class axis."""
    return torch.argmax(logits, dim=1)


def params_from_jax(params: Mapping[str, np.ndarray]) -> dict:
    """The JAX package's parameter dict (checkpoint names, numpy-like
    values) -> a ``DenseNet2D`` state dict on the CPU, BatchNorm's batch
    counters included."""
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k.removesuffix("running_var") + "num_batches_tracked"] = torch.tensor(0)
    return sd


def load_pretrained(path=None, device=None) -> DenseNet2D:
    """``DenseNet2D`` with weights from an ``.npz`` of checkpoint-named
    arrays (the vendored ``weights/ritnet_best.npz`` by default), in eval
    mode on ``device``: CUDA unless the caller asks for another."""
    dev = backend.resolve_device(device)
    with np.load(VENDORED_WEIGHTS if path is None else path) as z:
        sd = params_from_jax({k: z[k] for k in z.files})
    model = DenseNet2D()
    model.load_state_dict(sd)
    return model.to(dev).eval()


# ---------------------------------------------------------------------------
# Preprocessing (numpy, as the JAX package's): gamma table, CLAHE, normalise
# ---------------------------------------------------------------------------


def gamma_lut(img_u8: np.ndarray, gamma: float = 0.8) -> np.ndarray:
    table = (255.0 * ((np.arange(256) / 255.0) ** gamma)).astype(np.uint8)
    return table[img_u8]


def clahe(img_u8: np.ndarray, clip_limit: float = 1.5, grid=(8, 8)) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation: per-tile clipped
    histogram equalisation, mappings interpolated bilinearly between tile
    centres."""
    h, w = img_u8.shape
    gy, gx = grid
    th, tw = -(-h // gy), -(-w // gx)
    pad_h, pad_w = th * gy - h, tw * gx - w
    img = np.pad(img_u8, ((0, pad_h), (0, pad_w)), mode="reflect")
    maps = np.zeros((gy, gx, 256), np.float32)
    clip = max(1, int(clip_limit * th * tw / 256.0))
    for i in range(gy):
        for j in range(gx):
            tile_px = img[i * th:(i + 1) * th, j * tw:(j + 1) * tw]
            hist = np.bincount(tile_px.ravel(), minlength=256).astype(np.float64)
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = hist.cumsum()
            cdf = (cdf - cdf.min()) / max(cdf[-1] - cdf.min(), 1e-9) * 255.0
            maps[i, j] = cdf.astype(np.float32)
    yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    fy = (yy + 0.5) / th - 0.5
    fx = (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gy - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gx - 1)
    y1 = np.clip(y0 + 1, 0, gy - 1)
    x1 = np.clip(x0 + 1, 0, gx - 1)
    wy = np.clip(fy - y0, 0, 1)
    wx = np.clip(fx - x0, 0, 1)
    v = img
    out = (
        maps[y0, x0, v] * (1 - wy) * (1 - wx)
        + maps[y1, x0, v] * wy * (1 - wx)
        + maps[y0, x1, v] * (1 - wy) * wx
        + maps[y1, x1, v] * wy * wx
    )
    return out[:h, :w].astype(np.uint8)


def preprocess_eye_image(img_u8_gray: np.ndarray, device=None) -> torch.Tensor:
    """uint8 grayscale (H, W) -> the normalised (1, 1, H, W) float32 model
    input on ``device``: CUDA unless the caller asks for another."""
    dev = backend.resolve_device(device)
    x = gamma_lut(img_u8_gray, 0.8)
    x = clahe(x, 1.5, (8, 8))
    x = x.astype(np.float32) / 255.0
    x = (x - 0.5) / 0.5
    return torch.from_numpy(x)[None, None].to(dev)


def pupil_centroid(pred) -> np.ndarray:
    """Gaze estimate: the pupil class's centroid (x, y) in image
    coordinates of an (H, W) class map (tensor or array), or the image
    centre where no pixel is pupil."""
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    ys, xs = np.nonzero(pred == PUPIL)
    if len(xs) == 0:
        h, w = pred.shape
        return np.array([w / 2.0, h / 2.0])
    return np.array([xs.mean(), ys.mean()])
