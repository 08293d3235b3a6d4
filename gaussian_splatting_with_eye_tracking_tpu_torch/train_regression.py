"""End-to-end training regression through the CLIs, on the card.

Port of ``main`` from the repository's ``train_regression_r04.py`` (the
protocol behind ``TRAIN_r05.json``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.train_regression \
        [--iters 30000] [--root DIR] [--model DIR] [--out FILE.json]

1. ``scene_synth.synthesize_dataset``: 24 cameras at 256x256;
2. ``train.main`` with the default ``OptimizationConfig`` (densify 500 to
   15,000 every 100, opacity resets every 3000, SH annealed to 3) and
   ``--eval``, evaluating at 1000, 3500, 7000, 14500, 22000 and the last
   iteration (those under ``--iters``);
3. ``render.main`` and ``metrics.main`` on the model;
4. a JSON record: the test PSNR and point trajectories, wall times, the
   CLI metrics and the card's name and power limit.

The JAX script's 1080p benchmark of the trained model is not ported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from argparse import ArgumentParser

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import metrics, render, scene_synth, train


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def run_cli(fn, argv):
    """``fn(argv)`` with ``sys.stdout`` restored afterwards (the CLIs
    timestamp or silence it for the rest of the process)."""
    saved = sys.stdout
    try:
        return fn(argv)
    finally:
        sys.stdout = saved


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--root", default="logs/train_torch/scene")
    ap.add_argument("--model", default="logs/train_torch/model")
    ap.add_argument("--out", default="logs/train_torch/TRAIN.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the training regression runs on a CUDA card; none is available")

    t_all = time.time()
    print("== synthesizing dataset ==", flush=True)
    scene_synth.synthesize_dataset(args.root)

    print("== training (CLI) ==", flush=True)
    test_iters = [i for i in (1000, 3500, 7000, 14500, 22000) if i < args.iters] + [args.iters]
    t0 = time.time()
    _, _, log = run_cli(train.main, [
        "-s", args.root, "-m", args.model, "--iterations", str(args.iters),
        "--test_iterations", *map(str, test_iters), "--save_iterations", str(args.iters),
        "--checkpoint_iterations", str(args.iters), "--eval", "--disable_viewer"])
    wall_train = time.time() - t0

    print("== render ==", flush=True)
    run_cli(render.main, ["-m", args.model, "--quiet", "--iteration", str(args.iters)])
    print("== metrics ==", flush=True)
    results = run_cli(metrics.main, ["-m", args.model])[args.model]

    doc = {
        "config": "default OptimizationConfig: densify 500..15000/100, opacity resets "
                  "every 3000, SH annealed to 3",
        "protocol": "CLI end-to-end: train -> render -> metrics (the port's modules)",
        "card": card_name(),
        "resolution": [256, 256], "n_cams": 24, "eval_split": "llffhold-8",
        "iters": args.iters,
        "wall_time_train_s": wall_train,
        "ms_per_iteration": 1e3 * log["seconds"] / args.iters,
        "psnr_trajectory": [{"iter": it, "test_psnr": v["psnr"]}
                            for it, v in sorted(log["eval"]["test"].items())],
        "points_trajectory": [{"iter": it, "points": n}
                              for it, n in sorted(log["points"].items()) if it % 500 == 0],
        "final_capacity": log["capacity"],
        "metrics_results_json": results,
        "total_wall_s": time.time() - t_all,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({k: doc[k] for k in ("card", "wall_time_train_s", "ms_per_iteration",
                                          "psnr_trajectory", "metrics_results_json")}),
          flush=True)
    return doc


if __name__ == "__main__":
    main()
