"""Synthetic 640x400 OpenEDS-style eye images, the eyetrack mix's input.

Frozen copy of chip_smoke.py:279-299 (``eye_label``, ``make_eye``): skin,
a sclera ellipse, an iris and a pupil centred at the gaze, as gray levels
150 / 215 / 95 / 25 with N(0, 6) noise. The noise comes from a pool of
fields drawn once from the seed (one field per ``noise_pool`` requests in
turn), so that a window's images cost no host time when they are due.
"""

from __future__ import annotations

import numpy as np

GRAY = np.array([150.0, 215.0, 95.0, 25.0])


def eye_label(height: int, width: int, gaze_uv) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    label = np.zeros((height, width), np.int32)
    sclera = ((xx - width / 2) / (0.42 * width)) ** 2 + ((yy - height / 2) / (0.3 * height)) ** 2
    label[sclera <= 1.0] = 1
    r = np.hypot(xx - gaze_uv[0] * width, yy - gaze_uv[1] * height)
    label[r <= 0.19 * height] = 2
    label[r <= 0.08 * height] = 3
    return label


def eye_images(rng: np.random.Generator, gaze: np.ndarray, height: int, width: int,
               noise_pool: int) -> list[np.ndarray]:
    """One uint8 (height, width) eye per row of ``gaze`` (n, 2)."""
    noise = [rng.normal(0.0, 6.0, (height, width)) for _ in range(noise_pool)]
    labels = {}
    out = []
    for i, uv in enumerate(gaze):
        key = (float(uv[0]), float(uv[1]))
        if key not in labels:
            labels[key] = GRAY[eye_label(height, width, key)]
        out.append(np.clip(np.rint(labels[key] + noise[i % noise_pool]), 0, 255).astype(np.uint8))
    return out
