"""Metrics CLI: SSIM, PSNR and LPIPS of the test renders.

Port of ``read_images``, ``evaluate`` and ``main`` from the repository's
root ``metrics.py`` (the reference's ``metrics.py``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.metrics -m <model> [<model> ...] \
        [--no_lpips] [--data_device cpu]

scores ``<model>/test/<method>/renders`` against ``gt`` and writes
``results.json`` and ``per_view.json`` into each model directory. LPIPS
needs weights (``metrics_lib.lpips_available``) and is skipped with a
notice without them. A model directory that cannot be scored (no test
renders, an unreadable image) raises, so the command exits non-zero.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, metrics_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import load_image_chw


def read_images(renders_dir: Path, gt_dir: Path):
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        renders.append(load_image_chw(str(renders_dir / fname)))
        gts.append(load_image_chw(str(gt_dir / fname)))
        names.append(fname)
    if not names:
        raise ValueError(f"{renders_dir}: no renders to score")
    return renders, gts, names


def evaluate(model_paths, use_lpips=True, data_device="cuda"):
    """{model: {method: {"SSIM", "PSNR"[, "LPIPS"]}}} on ``data_device``
    (the card unless "cpu")."""
    dev = backend.resolve_data_device(data_device)
    full_dict, per_view_dict = {}, {}
    lp_ok = use_lpips and metrics_lib.lpips_available()
    if use_lpips and not lp_ok:
        print("  (LPIPS skipped: no pretrained weights; set LPIPS_WEIGHTS)")
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = Path(scene_dir) / "test"
        methods = sorted(os.listdir(test_dir))
        if not methods:
            raise ValueError(f"{test_dir}: no rendered method to score")
        for method in methods:
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names = read_images(method_dir / "renders", method_dir / "gt")
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt, gt = torch.from_numpy(r).to(dev), torch.from_numpy(g).to(dev)
                ssims.append(float(ssim_ops.ssim(rt, gt)))
                mse = float(torch.mean((rt - gt) ** 2))
                psnrs.append(-10 * np.log10(max(mse, 1e-10)))
                if lp_ok:
                    lpipss.append(float(metrics_lib.lpips(rt, gt)[0]))
            print(f"  SSIM : {np.mean(ssims):.7f}")
            print(f"  PSNR : {np.mean(psnrs):.7f}")
            if lp_ok:
                print(f"  LPIPS: {np.mean(lpipss):.7f}")
            full_dict[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                **({"LPIPS": float(np.mean(lpipss))} if lp_ok else {}),
            }
            per_view_dict[scene_dir][method] = {
                "SSIM": dict(zip(names, map(float, ssims))),
                "PSNR": dict(zip(names, map(float, psnrs))),
                **({"LPIPS": dict(zip(names, map(float, lpipss)))} if lp_ok else {}),
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=True)
    return full_dict


def main(argv=None):
    parser = ArgumentParser(description="Metrics script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+", type=str)
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return evaluate(args.model_paths, use_lpips=not args.no_lpips,
                    data_device=args.data_device)


if __name__ == "__main__":
    main()
