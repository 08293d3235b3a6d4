"""The yardstick: one H100's peaks and the least time the counted work of a
kernel, a request or a step can take on it.

Peaks (frozen copy of chip_smoke.py:248-254): HBM 3.35 TB/s and float32
67 TFLOP/s outside the tensor cores, from NVIDIA's H100 SXM data sheet;
special-function units 16 results per clock per SM (CUDA C++ Programming
Guide, arithmetic instruction throughput, compute capability 9.0) x 132
SMs x 1.98 GHz boost clock, a rate the data sheet does not state. All
assume the card's full 700 W; every reading carries the card's power
limit beside it.

The work is what the inputs need, counted by the reference
(``gsbench/reference/render.py``) whatever implements it: the (pixel,
gaussian) pairs that pass the alpha gate before their pixel's
transmittance falls below 1e-4 ("kept"), and the gaussians with at least
one such pair ("contributing"). Per kept pair, after chip_smoke.py's
rules (:609-616, :706-720, :2667-2692) with only what no implementation
can skip: the forward (K2, K5) one exp and 23 flops (offsets, the
quadratic form and its test, the clamp, the weight, three colour FMAs,
the transmittance step); the backward (K3) one exp and 46 flops (the
forward's 12 to recompute alpha, 34 for the cotangents and moments).
Bytes: 9 floats of each contributing gaussian read once, the outputs
written once, and the backward's cotangent and transmittance read and its
9 gradients per contributing gaussian written. A share against this
least time can only be lower than one against any count of what a
particular kernel runs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

PARAM_FLOATS = 3 + 3 + 45 + 3 + 4 + 1  # xyz, f_dc, f_rest, scaling, rotation, opacity


def least_seconds(sfu: float = 0.0, flops: float = 0.0, nbytes: float = 0.0) -> float:
    return max(sfu / SFU_OPS_PER_S, flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def forward_composite(kept: int, contributing: int, pixels_out: int) -> dict:
    """K2 / K5: pixels_out pixels written (rgb and transmittance)."""
    return dict(sfu=kept, flops=23 * kept, nbytes=4 * (9 * contributing + 4 * pixels_out))


def backward_composite(kept: int, contributing: int, pixels: int) -> dict:
    """K3: the image's cotangent (3 per pixel) and final transmittance read,
    9 gradients per contributing gaussian written."""
    return dict(sfu=kept, flops=46 * kept,
                nbytes=4 * (9 * contributing + 4 * pixels + 9 * contributing))


def densenet2d_flops(height: int, width: int, channels: int = 32, in_channels: int = 1,
                     classes: int = 4) -> int:
    """fp32 flops (2 per multiply-add) of RITnet's DenseNet2D forward at
    height x width: 5 down blocks (conv 3x3, 1x1 + 3x3, 1x1 + 3x3) at
    1/1 .. 1/16 resolution and 4 up blocks (1x1 + 3x3, 1x1 + 3x3) back up,
    then a 1x1 to the classes."""
    c = channels

    def conv(cin, cout, k, h, w):
        return 2 * cin * cout * k * k * h * w

    total = 0
    cin = in_channels
    for i in range(5):
        h, w = height >> i, width >> i
        total += (conv(cin, c, 3, h, w) + conv(cin + c, c, 1, h, w) + conv(c, c, 3, h, w)
                  + conv(cin + 2 * c, c, 1, h, w) + conv(c, c, 3, h, w))
        cin = c
    for i in (3, 2, 1, 0):
        h, w = height >> i, width >> i
        total += (conv(2 * c, c, 1, h, w) + conv(c, c, 3, h, w) + conv(3 * c, c, 1, h, w)
                  + conv(c, c, 3, h, w))
    return total + conv(c, classes, 1, height, width)
