"""The work counter against a brute-force count, and the yardstick's
arithmetic."""

import math

import numpy as np
import pytest
import torch

from gsbench import scenes, work
from gsbench.entries.common import Views
from gsbench.harness import ROOT
from gsbench.reference import render as ref

SPEC = {"kind": "random_gaussians", "n": 60, "sh_degree": 3, "spread": 1.0,
        "depth_range": [3.0, 7.0], "scale_range": [-2.5, -1.5], "opacity_range": [0.2, 0.95]}


def _brute(prep, lists, w, h):
    """Per pixel, over its tile's list in order: the pairs that pass the
    gate before the pixel's T < 1e-4, and the gaussians with one."""
    xy, con, op = prep.xy.numpy(), prep.conic.numpy(), prep.opacity.numpy()
    gid, off = lists.gid.numpy(), lists.offsets.numpy()
    gx = -(-w // ref.TILE)
    kept, used = 0, set()
    for py in range(h):
        for px in range(w):
            t = (py // ref.TILE) * gx + px // ref.TILE
            T = 1.0
            for g in gid[off[t]:off[t + 1]]:
                dx, dy = xy[g, 0] - px, xy[g, 1] - py
                power = -0.5 * (con[g, 0] * dx * dx + con[g, 2] * dy * dy) - con[g, 1] * dx * dy
                alpha = min(0.99, op[g] * math.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T >= 1e-4:
                    kept += 1
                    used.add(int(g))
                T *= 1 - alpha
    return kept, len(used)


@pytest.mark.parametrize("seed", [1, 2])
def test_kept_pairs_match_a_brute_force_count(seed):
    raw = scenes.make_scene(SPEC, seed, "cpu")
    views = Views(np.array([[1.0, -2.0]]), 64, 32, "cpu")
    cam = views.reference(0)
    prep = ref.preprocess(*ref.activate(raw), cam)
    frame = ref.render(prep, cam, torch.zeros(3), count_work=True)
    assert frame.kept > 0
    assert (frame.kept, frame.contributing) == _brute(prep, frame.lists, 64, 32)


def test_least_seconds_takes_the_slowest_bound():
    assert work.least_seconds(sfu=work.SFU_OPS_PER_S) == pytest.approx(1.0)
    assert work.least_seconds(flops=67e12, nbytes=3.35e12 * 2) == pytest.approx(2.0)
    w = work.forward_composite(kept=1000, contributing=10, pixels_out=100)
    assert w == {"sfu": 1000, "flops": 23000, "nbytes": 4 * (90 + 400)}


def test_densenet_flops_match_the_layer_shapes():
    from gsbench.reference import ritnet as ref_ritnet

    h, w = 32, 48
    p = ref_ritnet.load_weights(ROOT / "gaussian_splatting_with_eye_tracking_tpu_torch"
                                / "models" / "weights" / "ritnet_best.npz", "cpu")
    macs = []

    def hook(fn):
        def conv(x, weight, bias=None, padding=0, **kw):
            out = fn(x, weight, bias, padding=padding, **kw)
            macs.append(out.numel() * weight.shape[1] * weight.shape[2] * weight.shape[3])
            return out
        return conv

    orig = ref_ritnet.F.conv2d
    ref_ritnet.F.conv2d = hook(orig)
    try:
        ref_ritnet.logits(p, torch.zeros(1, 1, h, w))
    finally:
        ref_ritnet.F.conv2d = orig
    assert 2 * sum(macs) == work.densenet2d_flops(h, w)
