"""Plain NumPy / PyTorch reference of the eye tracker: eye image -> class
map -> gaze, importing nothing of the system.

- preprocessing (NumPy, float64): the gamma table 255 (v / 255)^0.8
  truncated to uint8; CLAHE with clip 1.5 on an 8x8 grid: the image padded
  by reflection to whole tiles, each tile's 256-bin histogram clipped at
  max(1, int(1.5 th tw / 256)) with the excess spread evenly, its
  cumulative sum stretched to [0, 255], the four nearest tiles' mappings
  blended bilinearly between tile centres and truncated to uint8; then
  v / 255 mapped to [-1, 1];
- RITnet's DenseNet2D (Chaudhary et al., "RITnet: Real-time Semantic
  Segmentation of the Eye for Gaze Tracking", 2019): 5 down blocks (2x2
  average pooling before all but the first; conv 3x3, then 1x1 + 3x3 and
  1x1 + 3x3 on the dense concatenations, LeakyReLU 0.01 after each pair,
  BatchNorm with running statistics at the end) and 4 up blocks (nearest
  x2, concatenation with the skip, 1x1 + 3x3 twice, densely), then a 1x1
  to 4 classes; the weights are read from the raw ``.npz`` file of
  checkpoint-named arrays;
- the class map is the argmax over classes; the gaze is the mean (x, y)
  of the pupil class (3), or the image centre where there is none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PUPIL = 3


def gamma_table(gamma: float = 0.8) -> np.ndarray:
    return (255.0 * ((np.arange(256) / 255.0) ** gamma)).astype(np.uint8)


def clahe(img: np.ndarray, clip_limit: float = 1.5, grid=(8, 8)) -> np.ndarray:
    h, w = img.shape
    gy, gx = grid
    th, tw = -(-h // gy), -(-w // gx)
    padded = np.pad(img, ((0, th * gy - h), (0, tw * gx - w)), mode="reflect")
    tiles = padded.reshape(gy, th, gx, tw).transpose(0, 2, 1, 3).reshape(gy * gx, th * tw)
    idx = tiles.astype(np.int64) + 256 * np.arange(gy * gx)[:, None]
    hist = np.bincount(idx.ravel(), minlength=256 * gy * gx).reshape(gy * gx, 256)
    hist = hist.astype(np.float64)
    clip = max(1, int(clip_limit * th * tw / 256.0))
    excess = np.maximum(hist - clip, 0).sum(axis=1, keepdims=True)
    cdf = np.cumsum(np.minimum(hist, clip) + excess / 256.0, axis=1)
    lo = cdf.min(axis=1, keepdims=True)
    maps = ((cdf - lo) / np.maximum(cdf[:, -1:] - lo, 1e-9) * 255.0).astype(np.float32)
    maps = maps.reshape(gy, gx, 256)
    yy, xx = np.mgrid[0:padded.shape[0], 0:padded.shape[1]]
    fy, fx = (yy + 0.5) / th - 0.5, (xx + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(fy).astype(int), 0, gy - 1)
    x0 = np.clip(np.floor(fx).astype(int), 0, gx - 1)
    y1, x1 = np.clip(y0 + 1, 0, gy - 1), np.clip(x0 + 1, 0, gx - 1)
    wy, wx = np.clip(fy - y0, 0, 1), np.clip(fx - x0, 0, 1)
    v = padded
    out = (maps[y0, x0, v] * (1 - wy) * (1 - wx) + maps[y1, x0, v] * wy * (1 - wx)
           + maps[y0, x1, v] * (1 - wy) * wx + maps[y1, x1, v] * wy * wx)
    return out[:h, :w].astype(np.uint8)


def network_input(eye_u8: np.ndarray) -> np.ndarray:
    """uint8 (H, W) eye -> float32 (H, W) in [-1, 1]."""
    x = clahe(gamma_table()[eye_u8]).astype(np.float32) / 255.0
    return (x - 0.5) / 0.5


def load_weights(path, device, dtype=torch.float32) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device, dtype)
                for k in z.files}


def _conv(x, p, name):
    w = p[name + ".weight"]
    return F.conv2d(x, w, p[name + ".bias"], padding=w.shape[-1] // 2)


def _bn(x, p, name):
    scale = p[name + ".weight"] / torch.sqrt(p[name + ".running_var"] + 1e-5)
    return ((x - p[name + ".running_mean"][None, :, None, None]) * scale[None, :, None, None]
            + p[name + ".bias"][None, :, None, None])


def _act(x):
    return F.leaky_relu(x, 0.01)


def _down(x, p, name, pool):
    if pool:
        x = F.avg_pool2d(x, 2)
    x1 = _act(_conv(x, p, name + ".conv1"))
    x21 = torch.cat([x, x1], 1)
    x22 = _act(_conv(_conv(x21, p, name + ".conv21"), p, name + ".conv22"))
    x31 = torch.cat([x21, x22], 1)
    return _bn(_act(_conv(_conv(x31, p, name + ".conv31"), p, name + ".conv32")), p, name + ".bn")


def _up(skip, x, p, name):
    x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skip], 1)
    x1 = _act(_conv(_conv(x, p, name + ".conv11"), p, name + ".conv12"))
    return _act(_conv(_conv(torch.cat([x, x1], 1), p, name + ".conv21"), p, name + ".conv22"))


def logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 1, H, W) network input -> (N, 4, H, W) class logits."""
    d1 = _down(x, p, "down_block1", False)
    d2 = _down(d1, p, "down_block2", True)
    d3 = _down(d2, p, "down_block3", True)
    d4 = _down(d3, p, "down_block4", True)
    d5 = _down(d4, p, "down_block5", True)
    u = _up(d4, d5, p, "up_block1")
    u = _up(d3, u, p, "up_block2")
    u = _up(d2, u, p, "up_block3")
    u = _up(d1, u, p, "up_block4")
    return _conv(u, p, "out_conv1")


def gaze(eye_u8: np.ndarray, p: dict, device, dtype=torch.float32):
    """(gaze uv in [0, 1]^2 as numpy (x, y), class map (H', W') on the
    device) of a uint8 eye, cropped to multiples of 16."""
    h, w = eye_u8.shape[0] // 16 * 16, eye_u8.shape[1] // 16 * 16
    eye = np.ascontiguousarray(eye_u8[:h, :w])
    x = torch.from_numpy(network_input(eye))[None, None].to(device, dtype)
    with torch.no_grad():
        cls = torch.argmax(logits(p, x).float(), dim=1)[0]
    ys, xs = np.nonzero(cls.cpu().numpy() == PUPIL)
    px = np.array([w / 2.0, h / 2.0]) if len(xs) == 0 else np.array([xs.mean(), ys.mean()])
    return px / np.array([w, h]), cls
