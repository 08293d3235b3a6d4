"""Perceptual metric: LPIPS with a VGG-16 backbone.

Port of ``gaussian_splatting_with_eye_tracking_tpu/metrics_lib.py`` (the
reference's ``lpipsPyTorch``): inputs in [0, 1] mapped to [-1, 1] and
normalized by LPIPS's shift and scale; VGG-16's 13 convolutions (3x3,
padding 1, each followed by ReLU) in blocks of 2, 2, 3, 3, 3 with a 2x2
max-pool between blocks; the feature map after each block unit-normalized
over channels; the squared difference weighted per channel by the learned
1x1 "lin" layer, averaged over space and summed over the five taps.

The convolutions run in true float32 (``backend`` turns cuDNN's TF32 off).
The pretrained weights are not in the repository: ``load_weights`` takes
a torch state_dict (``features.N.weight`` / ``.bias``,
``lin.N.model.1.weight``) or an .npz export (``conv_i_w``, ``conv_i_b``,
``lin_i``), and the path comes from the argument or ``LPIPS_WEIGHTS``.
Without weights ``lpips_available()`` is False and callers skip the metric.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_with_eye_tracking_tpu_torch import backend  # noqa: F401  (TF32 off)

# torchvision's vgg16().features indices of the 13 convolutions
_VGG16_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_BLOCKS = (2, 2, 3, 3, 3)  # convolutions per block; a feature tap after each

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPSWeights:
    def __init__(self, convs: List[np.ndarray], conv_biases: List[np.ndarray],
                 lins: List[np.ndarray]):
        self.convs = convs  # 13 x (O, I, 3, 3)
        self.conv_biases = conv_biases  # 13 x (O,)
        self.lins = lins  # 5 x (C,)


_CACHED: Dict[str, LPIPSWeights] = {}  # loaded weights by path


def load_weights(weights_path: str) -> LPIPSWeights:
    if weights_path.endswith(".npz"):
        z = np.load(weights_path)
        return LPIPSWeights([z[f"conv_{i}_w"] for i in range(13)],
                            [z[f"conv_{i}_b"] for i in range(13)],
                            [z[f"lin_{i}"] for i in range(5)])
    sd = torch.load(weights_path, map_location="cpu", weights_only=True)
    return LPIPSWeights([sd[f"features.{i}.weight"].numpy() for i in _VGG16_CONVS],
                        [sd[f"features.{i}.bias"].numpy() for i in _VGG16_CONVS],
                        [sd[f"lin.{i}.model.1.weight"].numpy()[0, :, 0, 0] for i in range(5)])


def _get_weights(weights_path: Optional[str]) -> Optional[LPIPSWeights]:
    path = weights_path or os.environ.get("LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    if path not in _CACHED:
        _CACHED[path] = load_weights(path)
    return _CACHED[path]


def lpips_available(weights_path: Optional[str] = None) -> bool:
    return _get_weights(weights_path) is not None


def _vgg_features(x: torch.Tensor, w: LPIPSWeights) -> List[torch.Tensor]:
    """x (N, 3, H, W) normalized -> the five feature taps."""
    feats, conv_i, h = [], 0, x
    for b, n_convs in enumerate(_BLOCKS):
        if b > 0:
            h = F.max_pool2d(h, 2, 2)
        for _ in range(n_convs):
            k = torch.as_tensor(w.convs[conv_i], device=h.device)
            bias = torch.as_tensor(w.conv_biases[conv_i], device=h.device)
            h = torch.relu(F.conv2d(h, k, bias, padding=1))
            conv_i += 1
        feats.append(h)
    return feats


def lpips(x: torch.Tensor, y: torch.Tensor, weights_path: Optional[str] = None) -> torch.Tensor:
    """LPIPS(VGG) distance, (N,), between (3, H, W) or (N, 3, H, W) images
    in [0, 1] on one device."""
    w = _get_weights(weights_path)
    if w is None:
        raise RuntimeError(
            "LPIPS weights unavailable: set LPIPS_WEIGHTS to a VGG16+lin "
            "state_dict (.pth) or .npz export.")
    if x.dim() == 3:
        x, y = x[None], y[None]
    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]

    def norm_input(t):
        return (t * 2.0 - 1.0 - shift) / scale

    total = 0.0
    for i, (a, b) in enumerate(zip(_vgg_features(norm_input(x), w),
                                   _vgg_features(norm_input(y), w))):
        a = a / torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True) + 1e-10)
        b = b / torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True) + 1e-10)
        lin = torch.as_tensor(w.lins[i], device=x.device)[None, :, None, None]
        total = total + torch.mean(torch.sum((a - b) ** 2 * lin, dim=1), dim=(1, 2))
    return total
