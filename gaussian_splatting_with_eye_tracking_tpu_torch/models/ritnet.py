"""RITnet eye segmentation (DenseNet2D): inference and the training form.

Port of ``gaussian_splatting_with_eye_tracking_tpu/models/ritnet.py``: the
DenseUNet of 5 down blocks (2x2 average pooling, dense 3x3/1x1
convolutions, LeakyReLU 0.01, BatchNorm) and 4 up blocks (nearest x2
upsampling and skip concatenation), 32 channels, 4 classes (background,
sclera, iris, pupil), 249,220 parameters; the preprocessing (gamma 0.8
table, CLAHE 1.5 on an 8x8 grid, normalisation to [-1, 1]) and the pupil
centroid that serves as the gaze estimate, for one eye image or a stack
of them (a headset's two eyes through one forward).

One forward, ``densenet2d_apply``, runs over a dict of checkpoint-named
tensors (``down_block1.conv1.weight``, ..., ``out_conv1.bias``) with one of
two BatchNorms:

- ``batch_norm_affine``, JAX's ``_bn``: the running statistics folded into
  an affine map, x * g / sqrt(var + 1e-5) + (b - mean * g / sqrt(var +
  1e-5)). It never uses batch statistics, and all four tensors are
  differentiable: the training form (``models/ritnet_train.py``), as in
  JAX, trains ``running_mean`` and ``running_var`` with Adam.
- ``batch_norm_eval``, ``nn.BatchNorm2d``'s eval-mode arithmetic: the
  ``DenseNet2D`` module, the inference path (``load_pretrained``,
  ``track_render.estimate_gaze``).

Submodule names are the checkpoint's keys, so the vendored weights load as
a state dict. The weights file ``weights/ritnet_best.npz`` is this
package's own copy of the JAX package's vendored conversion of the
reference checkpoint. The convolutions run in true float32: ``backend``
turns cuDNN's TF32 off for the process.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, tracing

LEAK = 0.01  # torch LeakyReLU default
CHANNELS = 32
NUM_CLASSES = 4
PUPIL = 3
BN_EPS = 1e-5

VENDORED_WEIGHTS = Path(__file__).resolve().parent / "weights" / "ritnet_best.npz"


def _conv(x, p, name):
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p[f"{name}.bias"], padding=w.shape[-1] // 2)


def _lrelu(x):
    return F.leaky_relu(x, LEAK)


def batch_norm_affine(x, p, prefix):
    """JAX's ``_bn``: the running statistics as an affine map,
    differentiable in all four tensors."""
    inv = p[f"{prefix}.weight"] / torch.sqrt(p[f"{prefix}.running_var"] + BN_EPS)
    shift = p[f"{prefix}.bias"] - p[f"{prefix}.running_mean"] * inv
    return x * inv[None, :, None, None] + shift[None, :, None, None]


def batch_norm_eval(x, p, prefix):
    """``nn.BatchNorm2d`` in eval mode (running statistics, eps 1e-5)."""
    return F.batch_norm(x, p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"],
                        p[f"{prefix}.weight"], p[f"{prefix}.bias"], False, 0.0, BN_EPS)


def _down_block(x, p, name, pool, bn):
    if pool:
        x = F.avg_pool2d(x, 2)
    x1 = _lrelu(_conv(x, p, f"{name}.conv1"))
    x21 = torch.cat([x, x1], 1)
    x22 = _lrelu(_conv(_conv(x21, p, f"{name}.conv21"), p, f"{name}.conv22"))
    x31 = torch.cat([x21, x22], 1)
    out = _lrelu(_conv(_conv(x31, p, f"{name}.conv31"), p, f"{name}.conv32"))
    return bn(out, p, f"{name}.bn")


def _up_block(skip, x, p, name):
    x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), skip], 1)
    x1 = _lrelu(_conv(_conv(x, p, f"{name}.conv11"), p, f"{name}.conv12"))
    x21 = torch.cat([x, x1], 1)
    return _lrelu(_conv(_conv(x21, p, f"{name}.conv21"), p, f"{name}.conv22"))


def densenet2d_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                     bn=batch_norm_affine) -> torch.Tensor:
    """(N, 1, H, W) normalised grayscale, H and W divisible by 16 -> (N, 4,
    H, W) class logits, over checkpoint-named tensors. Port of
    ``densenet2d_apply``; ``bn`` is JAX's affine BatchNorm by default."""
    x1 = _down_block(x, params, "down_block1", False, bn)
    x2 = _down_block(x1, params, "down_block2", True, bn)
    x3 = _down_block(x2, params, "down_block3", True, bn)
    x4 = _down_block(x3, params, "down_block4", True, bn)
    x5 = _down_block(x4, params, "down_block5", True, bn)
    x6 = _up_block(x4, x5, params, "up_block1")
    x7 = _up_block(x3, x6, params, "up_block2")
    x8 = _up_block(x2, x7, params, "up_block3")
    x9 = _up_block(x1, x8, params, "up_block4")
    return _conv(x9, params, "out_conv1")


def _conv_module(cin: int, cout: int, k: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class DownBlock(nn.Module):
    """A down block's checkpoint-named parameters (its forward is
    ``_down_block``)."""

    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv1 = _conv_module(cin, c, 3)
        self.conv21 = _conv_module(cin + c, c, 1)
        self.conv22 = _conv_module(c, c, 3)
        self.conv31 = _conv_module(cin + 2 * c, c, 1)
        self.conv32 = _conv_module(c, c, 3)
        self.bn = nn.BatchNorm2d(c, eps=BN_EPS)


class UpBlock(nn.Module):
    """An up block's checkpoint-named parameters (its forward is
    ``_up_block``)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv11 = _conv_module(2 * c, c, 1)
        self.conv12 = _conv_module(c, c, 3)
        self.conv21 = _conv_module(3 * c, c, 1)
        self.conv22 = _conv_module(c, c, 3)


class DenseNet2D(nn.Module):
    """(N, 1, H, W) normalised grayscale, H and W divisible by 16 ->
    (N, 4, H, W) class logits: ``densenet2d_apply`` over the module's
    tensors with ``nn.BatchNorm2d``'s eval-mode arithmetic. The inference
    path; it never uses batch statistics, whatever its mode."""

    def __init__(self, channels: int = CHANNELS, in_channels: int = 1,
                 out_channels: int = NUM_CLASSES):
        super().__init__()
        c = channels
        self.down_block1 = DownBlock(in_channels, c)
        for i in range(2, 6):
            setattr(self, f"down_block{i}", DownBlock(c, c))
        for i in range(1, 5):
            setattr(self, f"up_block{i}", UpBlock(c))
        self.out_conv1 = _conv_module(c, out_channels, 1)
        self.eval()

    def forward(self, x):
        tensors = {**dict(self.named_parameters()), **dict(self.named_buffers())}
        return densenet2d_apply(tensors, x, bn=batch_norm_eval)


def get_predictions(logits: torch.Tensor) -> torch.Tensor:
    """Class map: argmax over the class axis."""
    return torch.argmax(logits, dim=1)


def init_params(generator: torch.Generator, channels: int = CHANNELS, in_channels: int = 1,
                out_channels: int = NUM_CLASSES) -> dict:
    """Random parameters in JAX's ``init_params`` names, shapes, order and
    scheme (the reference's): He-normal convolutions in fan-out mode, std
    sqrt(2 / (k * k * cout)), zero biases, BatchNorm (mean 0, var 1, weight
    1, bias 0). float32 CPU tensors drawn from ``generator``."""
    params = {}
    c = channels

    def conv(name, cin, cout, k):
        w = torch.randn((cout, cin, k, k), generator=generator, dtype=torch.float32)
        params[f"{name}.weight"] = w * math.sqrt(2.0 / (k * k * cout))
        params[f"{name}.bias"] = torch.zeros(cout)

    def bn(name, cout):
        params[f"{name}.running_mean"] = torch.zeros(cout)
        params[f"{name}.running_var"] = torch.ones(cout)
        params[f"{name}.weight"] = torch.ones(cout)
        params[f"{name}.bias"] = torch.zeros(cout)

    def down(name, cin):
        conv(f"{name}.conv1", cin, c, 3)
        conv(f"{name}.conv21", cin + c, c, 1)
        conv(f"{name}.conv22", c, c, 3)
        conv(f"{name}.conv31", cin + 2 * c, c, 1)
        conv(f"{name}.conv32", c, c, 3)
        bn(f"{name}.bn", c)

    def up(name):
        conv(f"{name}.conv11", 2 * c, c, 1)
        conv(f"{name}.conv12", c, c, 3)
        conv(f"{name}.conv21", 3 * c, c, 1)
        conv(f"{name}.conv22", c, c, 3)

    down("down_block1", in_channels)
    for i in range(2, 6):
        down(f"down_block{i}", c)
    for i in range(1, 5):
        up(f"up_block{i}")
    conv("out_conv1", c, out_channels, 1)
    return params


def params_from_jax(params: Mapping[str, np.ndarray]) -> dict:
    """The JAX package's parameter dict (checkpoint names, numpy-like
    values) -> a ``DenseNet2D`` state dict on the CPU, BatchNorm's batch
    counters included."""
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in params.items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k.removesuffix("running_var") + "num_batches_tracked"] = torch.tensor(0)
    return sd


def import_torch_state_dict(path) -> dict:
    """A torch checkpoint of a state dict (the reference's
    ``best_model.pkl``, possibly saved from ``nn.DataParallel``) -> float32
    numpy arrays by checkpoint name: ``module.`` stripped, the batch
    counters dropped. Read with ``weights_only=True``: tensors and plain
    containers only, no pickled module."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k.removeprefix("module."): np.asarray(v.detach().cpu().numpy(), np.float32)
            for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def load_pretrained(path=None, device=None) -> DenseNet2D:
    """``DenseNet2D`` in eval mode on ``device`` (CUDA unless the caller
    asks for another) with the weights of an ``.npz`` of checkpoint-named
    arrays (the vendored ``weights/ritnet_best.npz`` when ``path`` is None)
    or, for any other file, of a torch state dict
    (``import_torch_state_dict``)."""
    dev = backend.resolve_device(device)
    path = VENDORED_WEIGHTS if path is None else Path(path)
    if path.suffix == ".npz":
        with np.load(path) as z:
            params = {k: z[k] for k in z.files}
    else:
        params = import_torch_state_dict(path)
    model = DenseNet2D()
    model.load_state_dict(params_from_jax(params))
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


def normalise_eye_image(img_u8_gray: np.ndarray) -> np.ndarray:
    """uint8 grayscale (H, W) -> the float32 (H, W) model input in [-1, 1],
    on the host: gamma 0.8 table, CLAHE, normalisation."""
    x = gamma_lut(img_u8_gray, 0.8)
    x = clahe(x, 1.5, (8, 8))
    x = x.astype(np.float32) / 255.0
    return (x - 0.5) / 0.5


@tracing.spanned("gs.gaze.prep")
def preprocess_eye_image(img_u8_gray: np.ndarray, device=None) -> torch.Tensor:
    """uint8 grayscale (H, W) -> the normalised (1, 1, H, W) float32 model
    input on ``device``: CUDA unless the caller asks for another."""
    dev = backend.resolve_device(device)
    return torch.from_numpy(normalise_eye_image(img_u8_gray))[None, None].to(dev)


_CLAHE_PLANS: dict = {}


def _clahe_plan(h: int, w: int, device, clip_limit: float = 1.5, grid=(8, 8)) -> dict:
    """``normalise_eye_image``'s per-shape constants on ``device``, made
    once: the gamma and normalisation tables, each padded pixel's source
    pixel (reflect padding) and tile offset, and each output pixel's four
    neighbouring tiles' offsets and the float64 weights ``clahe`` gives
    them."""
    key = (h, w, str(device), clip_limit, tuple(grid))
    if key not in _CLAHE_PLANS:
        gy, gx = grid
        th, tw = -(-h // gy), -(-w // gx)
        rows = np.pad(np.arange(h), (0, th * gy - h), mode="reflect")
        cols = np.pad(np.arange(w), (0, tw * gx - w), mode="reflect")
        fy = (np.arange(h) + 0.5) / th - 0.5
        fx = (np.arange(w) + 0.5) / tw - 0.5
        y0 = np.clip(np.floor(fy).astype(int), 0, gy - 1)
        x0 = np.clip(np.floor(fx).astype(int), 0, gx - 1)
        y1, x1 = np.clip(y0 + 1, 0, gy - 1), np.clip(x0 + 1, 0, gx - 1)
        wy, wx = np.clip(fy - y0, 0, 1)[:, None], np.clip(fx - x0, 0, 1)[None, :]
        levels = np.arange(256, dtype=np.uint8)

        def on(a):
            return torch.as_tensor(a, device=device)

        _CLAHE_PLANS[key] = dict(
            tiles=gy * gx, clip=max(1, int(clip_limit * th * tw / 256.0)),
            gamma=on(gamma_lut(levels).astype(np.int64)),
            unit=on((levels.astype(np.float32) / 255.0 - 0.5) / 0.5),
            src=on((rows[:, None] * w + cols[None, :]).ravel()),
            tile=on(((np.arange(th * gy) // th)[:, None] * gx
                     + (np.arange(tw * gx) // tw)[None, :]).ravel() * 256),
            corners=[(on(((yi[:, None] * gx + xi[None, :]) * 256).ravel()), on(a), on(b))
                     for yi, xi, a, b in ((y0, x0, 1 - wy, 1 - wx), (y1, x0, wy, 1 - wx),
                                          (y0, x1, 1 - wy, wx), (y1, x1, wy, wx))])
    return _CLAHE_PLANS[key]


def normalise_eye_images(eyes_u8: torch.Tensor) -> torch.Tensor:
    """``normalise_eye_image`` for each of a (B, H, W) uint8 stack, where
    the stack lies, in tensor operations: the gamma 0.8 table, CLAHE 1.5
    on an 8x8 grid, normalisation to [-1, 1]. Equal bit for bit to the
    NumPy version: the histograms and cumulative sums are whole multiples
    of 1/256, and the maps and the interpolation take the same float64
    operations in the same order. -> (B, H, W) float32."""
    b, h, w = eyes_u8.shape
    plan = _clahe_plan(h, w, eyes_u8.device)
    tiles, clip = plan["tiles"], plan["clip"]
    v = plan["gamma"][eyes_u8.long()].reshape(b, h * w)
    keys = v[:, plan["src"]] + plan["tile"] + tiles * 256 * torch.arange(
        b, device=v.device)[:, None]
    hist = torch.bincount(keys.ravel(), minlength=b * tiles * 256).view(b, tiles, 256).double()
    excess = (hist - clip).clamp_min(0).sum(-1, keepdim=True)
    cdf = (hist.clamp_max(clip) + excess / 256.0).cumsum(-1)
    lo = cdf.amin(-1, keepdim=True)
    maps = ((cdf - lo) / (cdf[..., -1:] - lo).clamp_min(1e-9) * 255.0).float().view(b, -1)
    out = None
    for tile, wy, wx in plan["corners"]:
        term = maps.gather(1, tile + v).view(b, h, w) * wy * wx
        out = term if out is None else out + term
    return plan["unit"][out.to(torch.uint8).long()]


@tracing.spanned("gs.gaze.prep")
def preprocess_eye_images(imgs_u8_gray, device=None) -> torch.Tensor:
    """A list or (B, H, W) stack of uint8 grayscale eyes -> the normalised
    (B, 1, H, W) float32 model input on ``device`` (CUDA unless the caller
    asks for another): one upload of the uint8 stack, then
    ``normalise_eye_images`` there, equal to ``preprocess_eye_image`` on
    each eye."""
    dev = backend.resolve_device(device)
    eyes = torch.from_numpy(np.ascontiguousarray(np.stack(list(imgs_u8_gray)))).to(dev)
    return normalise_eye_images(eyes)[:, None]


@tracing.spanned("gs.gaze.centroid")
def pupil_centroid(pred) -> np.ndarray:
    """Gaze estimate: the pupil class's centroid (x, y) in image
    coordinates of an (H, W) class map (tensor or array), or the image
    centre where no pixel is pupil."""
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    return _centroid(pred)


def _centroid(pred: np.ndarray) -> np.ndarray:
    ys, xs = np.nonzero(pred == PUPIL)
    if len(xs) == 0:
        h, w = pred.shape
        return np.array([w / 2.0, h / 2.0])
    return np.array([xs.mean(), ys.mean()])


@tracing.spanned("gs.gaze.centroid")
def pupil_centroids(pred) -> np.ndarray:
    """(B, 2) pupil centroids (x, y) of a (B, H, W) class map (tensor or
    array), each as ``pupil_centroid`` reads its map, after one copy of
    the whole map to the host."""
    pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
    return np.stack([_centroid(p) for p in pred])
