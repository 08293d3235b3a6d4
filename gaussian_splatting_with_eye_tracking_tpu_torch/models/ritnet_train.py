"""RITnet training: losses, the train step, the metric.

Port of ``gaussian_splatting_with_eye_tracking_tpu/models/ritnet_train.py``
(the reference's RITnet/train.py:94-167 and RITnet/utils.py:35-111).

Loss = boundary-weighted cross entropy + alpha * generalized Dice + (1 -
alpha) * surface loss, alpha annealed 1 -> 0 over the first 125 epochs.
Optimizer: Adam 1e-3 (optax's: b1 0.9, b2 0.999, eps 1e-8 outside the
root, bias-corrected) over every tensor of the parameter dict, the
BatchNorm statistics included, as JAX differentiates them
(``ritnet.batch_norm_affine``). Metric: mean IoU.

Logits are (N, C, H, W) tensors, labels (N, H, W) integer tensors. The
boundary weight maps and the surface loss's distance maps are computed on
the host with scipy, as in the reference's dataset pipeline.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet

NUM_CLASSES = ritnet.NUM_CLASSES


def boundary_weight_map(label: np.ndarray, sigma: float = 5.0) -> np.ndarray:
    """1 + 10 exp(-d^2 / (2 sigma^2)), d the distance to the nearest class
    boundary pixel: pixels near a boundary get more cross-entropy weight."""
    from scipy import ndimage

    edges = np.zeros_like(label, bool)
    for c in range(NUM_CLASSES):
        m = label == c
        er = ndimage.binary_erosion(m)
        edges |= m & ~er
    dist = ndimage.distance_transform_edt(~edges)
    return (1.0 + 10.0 * np.exp(-(dist**2) / (2 * sigma**2))).astype(np.float32)


def distance_maps(label: np.ndarray) -> np.ndarray:
    """(C, H, W) signed distance map per class (the reference's
    one_hot2dist): the distance to the class outside it, one minus the
    distance to its complement inside, zeros for an absent class."""
    from scipy import ndimage

    out = np.zeros((NUM_CLASSES,) + label.shape, np.float32)
    for c in range(NUM_CLASSES):
        m = label == c
        if m.any():
            pos = ndimage.distance_transform_edt(m)
            neg = ndimage.distance_transform_edt(~m)
            out[c] = neg * (~m) - (pos - 1) * m
    return out


def cross_entropy_weighted(logits, label, weight_map):
    """mean(-log softmax(logits)[label] * weight_map)."""
    logp = F.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, label.long()[:, None])[:, 0]
    return torch.mean(nll * weight_map)


def generalized_dice_loss(logits, label):
    """1 - 2 sum_c w_c I_c / (sum_c w_c D_c + 1e-10), w_c = 1 / ((sum of
    class c's one-hot)^2 + 1e-10): a class absent from the batch weighs
    1e10. Each class is summed over (N, H, W) first, then the classes, as
    JAX sums them."""
    probs = F.softmax(logits, dim=1)
    onehot = F.one_hot(label.long(), NUM_CLASSES).permute(0, 3, 1, 2).to(probs.dtype)
    dims = (0, 2, 3)
    w = 1.0 / (torch.sum(onehot, dim=dims) ** 2 + 1e-10)
    inter = torch.sum(w * torch.sum(probs * onehot, dim=dims))
    denom = torch.sum(w * torch.sum(probs + onehot, dim=dims))
    return 1.0 - 2.0 * inter / (denom + 1e-10)


def surface_loss(logits, dist_map):
    """mean(softmax(logits) * distance map)."""
    return torch.mean(F.softmax(logits, dim=1) * dist_map)


def total_loss(logits, label, weight_map, dist_map, alpha):
    ce = cross_entropy_weighted(logits, label, weight_map)
    dice = generalized_dice_loss(logits, label)
    surf = surface_loss(logits, dist_map)
    return ce + alpha * dice + (1.0 - alpha) * surf


def alpha_schedule(epoch: int, period: int = 125) -> float:
    """1 -> 0 linear anneal over ``period`` epochs."""
    return max(0.0, 1.0 - epoch / period)


def miou(pred, label, num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """Mean IoU over the whole batch: per class intersection / union
    (float32), NaN where the union is empty, then their NaN-mean."""
    ious = []
    for c in range(num_classes):
        p, t = pred == c, label == c
        inter, union = torch.sum(p & t), torch.sum(p | t)
        iou = inter.to(torch.float32) / torch.clamp(union, min=1).to(torch.float32)
        ious.append(torch.where(union > 0, iou, torch.nan))
    return torch.nanmean(torch.stack(ious))


class AdamState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Adam:
    """optax's ``adam(lr)`` over a dict of tensors: b1 0.9, b2 0.999, eps
    1e-8 added outside the root, eps_root 0, the bias corrections computed
    in float32 as optax computes them."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                         {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """One step: (new params, new state)."""
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1.0 - self.b1) * g + self.b1 * state.mu[k]
            nu[k] = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[k]
            new_p[k] = p - self.lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps))
        return new_p, AdamState(count, mu, nu)


def loss_and_grads(params, batch, alpha):
    """(total loss, {name: gradient}) of ``ritnet.densenet2d_apply`` with
    JAX's BatchNorm on ``batch`` = (images (N, 1, H, W), labels (N, H, W),
    weight maps (N, H, W), distance maps (N, C, H, W))."""
    imgs, labels, wmaps, dmaps = batch
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = total_loss(ritnet.densenet2d_apply(leaves, imgs), labels, wmaps, dmaps, alpha)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(lr: float = 1e-3):
    """(optimizer, step): ``step(params, opt_state, batch, alpha)`` runs
    forward, the total loss, autograd and Adam where the tensors lie and
    returns (new params, new opt_state, loss), JAX's contract;
    ``optimizer.init(params)`` makes the first opt_state."""
    tx = Adam(lr)

    def step(params, opt_state, batch, alpha):
        loss, grads = loss_and_grads(params, batch, alpha)
        params, opt_state = tx.update(grads, opt_state, params)
        return params, opt_state, loss

    return tx, step
