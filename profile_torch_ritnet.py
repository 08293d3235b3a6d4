#!/usr/bin/env python3
"""Where the time of RITnet's training goes, in the PyTorch port.

Run from the repository root on a machine with a CUDA card:

    python3 profile_torch_ritnet.py

Writes chip_smoke.py's synthetic OpenEDS-style dataset (16 training and 8
validation eyes at 640x400, seed 1) to a temporary directory and prints,
as JSON lines:

- ``step``: from torch.profiler over ``chip_smoke.REPS`` train steps at
  8x1x400x640 (JAX-scheme parameters, seed 0), the wall and device time
  per step, the device's idle share (1 - device time / wall time), the
  device time per kernel name (top 20) and by kind (cuDNN convolutions,
  concatenation copies, everything else);
- ``epoch``: from torch.profiler over one epoch of ``train_ritnet.main``
  (2 batches of 8, then the validation batch), its wall time, the device
  time and the idle share.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

import chip_smoke as cs

CONV_KEYS = ("conv", "gemm", "cudnn", "xmma", "wgrad", "dgrad", "winograd", "fft")


def profiled(fn, reps=1):
    """(wall us, {kernel name: device us}) of ``reps`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    from gaussian_splatting_with_eye_tracking_tpu_torch import tracing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(float)
    for e in tracing.device_ops(prof.events()):  # not the spans' device-side ranges
        by_kernel[e.key] += e.time_range.elapsed_us()
    return wall_us, by_kernel


def main():
    from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test, train_ritnet
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet, ritnet_data
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train

    dev = torch.device("cuda")
    card = fps_test.card(dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "eyes")
        cs.write_eye_dataset(root, *cs.RITNET_SPLITS, seed=1)
        batch = train_ritnet.to_device(
            next(ritnet_data.batches(root, "train", 8, np.random.default_rng(2))), dev)
        params = {k: v.to(dev) for k, v in
                  ritnet.init_params(torch.Generator().manual_seed(0)).items()}
        tx, step = ritnet_train.make_train_step(1e-3)
        state = tx.init(params)
        for _ in range(2):  # warm-up: cuDNN's first calls
            step(params, state, batch, 1.0)
        wall_us, by_kernel = profiled(lambda: step(params, state, batch, 1.0), cs.REPS)
        device_us = sum(by_kernel.values())
        kinds = defaultdict(float)
        for name, us in by_kernel.items():
            low = name.lower()
            kind = ("convolution" if any(k in low for k in CONV_KEYS) else
                    "concatenation" if "cat" in low else "other")
            kinds[kind] += us / cs.REPS / 1e3
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]
        print(json.dumps({"step": {
            "shape": list(batch[0].shape), "steps": cs.REPS,
            "wall_ms_per_step": wall_us / cs.REPS / 1e3,
            "device_ms_per_step": device_us / cs.REPS / 1e3,
            "idle_share": 1.0 - device_us / wall_us,
            "by_kind_ms_per_step": dict(kinds),
            "kernels_ms_per_step": {k[:90]: us / cs.REPS / 1e3 for k, us in top},
            "card": card}}), flush=True)

        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            wall_us, by_kernel = profiled(lambda: train_ritnet.main(
                ["--dataset", root, "--epochs", "1", "--bs", "8", "--expname", "profile"]))
        finally:
            os.chdir(cwd)
        device_us = sum(by_kernel.values())
        print(json.dumps({"epoch": {
            "wall_ms": wall_us / 1e3, "device_ms": device_us / 1e3,
            "idle_share": 1.0 - device_us / wall_us, "card": card}}), flush=True)


if __name__ == "__main__":
    main()
