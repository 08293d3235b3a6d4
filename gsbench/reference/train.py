"""Plain PyTorch reference of the train step, importing nothing of the
system: the image (``render.render_differentiable``), the loss (1 -
lambda) L1 + lambda (1 - SSIM) with SSIM's 11x11 gaussian window (sigma
1.5, separable, zero padding, C1 = 0.01^2, C2 = 0.03^2; Wang et al. 2004
as the 3DGS reference's ``loss_utils.ssim`` computes it), its gradients
by autograd, and per-group Adam (b1, b2, eps from the configuration; the
position learning rate decays log-linearly from its initial to its
final value over ``position_lr_max_steps``, read at the step count
before the increment).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gsbench.reference import render as ref

LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")


def _window(dtype, device):
    x = torch.arange(11, dtype=torch.float64)
    g = torch.exp(-((x - 5) ** 2) / (2 * 1.5 ** 2))
    return (g / g.sum()).to(device, dtype)


def _blur(x, g):
    c = x.shape[1]
    x = F.conv2d(x, g.reshape(1, 1, 11, 1).expand(c, 1, 11, 1), padding=(5, 0), groups=c)
    return F.conv2d(x, g.reshape(1, 1, 1, 11).expand(c, 1, 1, 11), padding=(0, 5), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images."""
    a, b = a[None], b[None]
    g = _window(a.dtype, a.device)
    mu_a, mu_b = _blur(a, g), _blur(b, g)
    va = _blur(a * a, g) - mu_a * mu_a
    vb = _blur(b * b, g) - mu_b * mu_b
    cov = _blur(a * b, g) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
    return m.mean()


def loss(img, gt, lambda_dssim):
    return (1.0 - lambda_dssim) * (img - gt).abs().mean() + lambda_dssim * (1.0 - ssim(img, gt))


def lr(cfg: dict, name: str, count: int) -> float:
    if name == "xyz":
        t = min(max(count / cfg["position_lr_max_steps"], 0.0), 1.0)
        lo, hi = cfg["position_lr_final"] * cfg["extent"], cfg["position_lr_init"] * cfg["extent"]
        return math.exp(math.log(hi) * (1 - t) + math.log(lo) * t)
    return {"f_dc": cfg["feature_lr"], "f_rest": cfg["feature_lr"] / 20.0,
            "opacity": cfg["opacity_lr"], "scaling": cfg["scaling_lr"],
            "rotation": cfg["rotation_lr"]}[name]


def follow(raw: dict, cams: list, targets: list, bg, cfg: dict, dtype=torch.float32):
    """Train ``raw`` for len(cams) steps, one view each. Returns (losses,
    the first step's gradients, the parameters after the last step)."""
    params = {k: raw[k].detach().to(dtype).clone() for k in LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], cfg["adam_eps"]
    losses, first = [], None
    for count, (cam, gt) in enumerate(zip(cams, targets)):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        prep = ref.preprocess(*ref.activate(leaves, dtype), cam)
        img = ref.render_differentiable(prep, cam, bg)
        value = loss(img, gt.to(dtype), cfg["lambda_dssim"])
        grads = dict(zip(LEAVES, torch.autograd.grad(value, [leaves[k] for k in LEAVES])))
        losses.append(float(value.detach()))
        if first is None:
            first = {k: g.float() for k, g in grads.items()}
        with torch.no_grad():
            bc1, bc2 = 1.0 - b1 ** (count + 1), 1.0 - b2 ** (count + 1)
            for k in LEAVES:
                g = grads[k]
                mu[k] = (1.0 - b1) * g + b1 * mu[k]
                nu[k] = (1.0 - b2) * (g * g) + b2 * nu[k]
                step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
                params[k] = params[k].detach() - lr(cfg, k, count) * step
    return losses, first, {k: v.detach().float() for k, v in params.items()}
