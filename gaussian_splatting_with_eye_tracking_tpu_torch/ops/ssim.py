"""Image losses: L1, L2, SSIM, PSNR.

Port of ``gaussian_splatting_with_eye_tracking_tpu/ops/ssim.py`` (the
reference's ``utils/loss_utils.py`` and ``utils/image_utils.py``): an 11x11
Gaussian window (sigma 1.5) applied as a separable depthwise convolution
with SAME zero padding, C1 = 0.01^2, C2 = 0.03^2.

The blur runs in true float32: ``backend`` turns cuDNN's TF32 off, which
the variance cancellation blur(x*x) - mu^2 needs (at TF32's ~3 digits the
SSIM denominator can cross zero, the failure that NaN'd a JAX training run
when its convolutions ran in bf16).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_with_eye_tracking_tpu_torch import backend  # noqa: F401  (TF32 off)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR over [0, 1] images."""
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Depthwise separable blur of (N, C, H, W) with SAME zero padding."""
    n, c, h, w = x.shape
    k = window.shape[0]
    x = x.reshape(n * c, 1, h, w)
    x = F.conv2d(x, window.reshape(1, 1, k, 1), padding=(k // 2, 0))
    x = F.conv2d(x, window.reshape(1, 1, 1, k), padding=(0, k // 2))
    return x.reshape(n, c, h, w)


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of (N, C, H, W) inputs, in their dtype (float64
    inputs give the float64 map of the same float32 window)."""
    window = torch.from_numpy(_gaussian_window(window_size, 1.5)).to(img1.device, img1.dtype)
    mu1, mu2 = _blur(img1, window), _blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window) - mu2_sq
    sigma12 = _blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of (C, H, W) or (N, C, H, W) images in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean(ssim_map(img1, img2, window_size))


def dssim_l1_loss(img: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """The training loss: (1-λ)·L1 + λ·(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(img, gt) + lambda_dssim * (1.0 - ssim(img, gt))
