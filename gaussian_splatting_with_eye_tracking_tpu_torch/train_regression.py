"""End-to-end training regression through the CLIs, on the card.

Port of ``main`` from the repository's ``train_regression_r04.py`` (the
protocol behind ``TRAIN_r05.json``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.train_regression \
        [--iters 30000] [--seed 0] [--root DIR] [--model DIR] [--out FILE.json]
    python -m gaussian_splatting_with_eye_tracking_tpu_torch.train_regression \
        --seeds 0 1 2 [--iters 30000] [--out FILE.json]

1. ``scene_synth.synthesize_dataset``: 24 cameras at 256x256;
2. ``train.main`` with the default ``OptimizationConfig`` (densify 500 to
   15,000 every 100, opacity resets every 3000, SH annealed to 3),
   ``--eval`` and ``--seed`` as the trainer's ``random_order_seed`` (camera
   order and split draws), evaluating at 1000, 3500, 7000, 14500, 22000
   and the last iteration (those under ``--iters``) and saving the model
   at 1000, 3500, 7000 and the last;
3. ``render.main`` (test views) of each saved model and ``metrics.main``;
4. a JSON record: the test PSNR and point trajectories, PSNR, SSIM and
   points at each saved iteration, wall times, the CLI metrics and the
   card's name and power limit.

``--seeds`` runs one such process per seed at once on the one card (each
in its own ``--root``/``--model`` with a ``_seed<k>`` suffix) and writes
their records, and the spread over the seeds, to ``--out``. The processes
share the card and the host's cores, so their per-iteration times are
not speed figures.

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


EVALS = (1000, 3500, 7000, 14500, 22000)  # test evaluations besides the last iteration
SAVED = (1000, 3500, 7000)  # of those, the ones also saved, rendered and scored


def run_one(args):
    """One seed's run (steps 1-4 above); returns its record."""
    t_all = time.time()
    print("== synthesizing dataset ==", flush=True)
    scene_synth.synthesize_dataset(args.root)

    print("== training (CLI) ==", flush=True)
    test_iters = [i for i in EVALS if i < args.iters] + [args.iters]
    saved = [i for i in SAVED if i < args.iters] + [args.iters]
    t0 = time.time()
    _, _, log = run_cli(lambda argv: train.main(argv, random_order_seed=args.seed), [
        "-s", args.root, "-m", args.model, "--iterations", str(args.iters),
        "--test_iterations", *map(str, test_iters), "--save_iterations", *map(str, saved),
        "--checkpoint_iterations", str(args.iters), "--eval", "--disable_viewer"])
    wall_train = time.time() - t0

    print("== render ==", flush=True)
    for it in saved:
        run_cli(render.main, ["-m", args.model, "--quiet", "--skip_train", "--iteration",
                              str(it)])
    print("== metrics ==", flush=True)
    results = run_cli(metrics.main, ["-m", args.model])[args.model]

    doc = {
        "config": "default OptimizationConfig: densify 500..15000/100, opacity resets "
                  "every 3000, SH annealed to 3",
        "protocol": "CLI end-to-end: train -> render -> metrics (the port's modules)",
        "card": card_name(),
        "seed": args.seed,
        "resolution": [256, 256], "n_cams": 24, "eval_split": "llffhold-8",
        "iters": args.iters,
        "wall_time_train_s": wall_train,
        "ms_per_iteration": 1e3 * log["seconds"] / args.iters,
        "psnr_trajectory": [{"iter": it, "test_psnr": v["psnr"]}
                            for it, v in sorted(log["eval"]["test"].items())],
        "points_trajectory": [{"iter": it, "points": n}
                              for it, n in sorted(log["points"].items()) if it % 500 == 0],
        "at": {str(it): {"test_psnr": log["eval"]["test"][it]["psnr"],
                         "metrics_psnr": results[f"ours_{it}"]["PSNR"],
                         "ssim": results[f"ours_{it}"]["SSIM"],
                         "points": log["points"][it]} for it in saved},
        "final_capacity": log["capacity"],
        "metrics_results_json": results,
        "total_wall_s": time.time() - t_all,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({k: doc[k] for k in ("card", "seed", "wall_time_train_s",
                                          "ms_per_iteration", "at")}), flush=True)
    return doc


def run_seeds(args):
    """One process per seed, all at once; their records and the spread
    over the seeds of each saved iteration's numbers go to ``args.out``."""
    stem = os.path.splitext(args.out)[0]
    jobs = {}
    for seed in args.seeds:
        out = f"{stem}_seed{seed}.json"
        cmd = [sys.executable, "-m", "gaussian_splatting_with_eye_tracking_tpu_torch.train_regression", "--iters", str(args.iters),
               "--seed", str(seed), "--root", f"{args.root}_seed{seed}",
               "--model", f"{args.model}_seed{seed}", "--out", out]
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        logf = open(f"{stem}_seed{seed}.log", "w")
        jobs[seed] = (subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT), logf, out)
    failed = []
    for seed, (proc, logf, _) in jobs.items():
        if proc.wait() != 0:
            failed.append(seed)
        logf.close()
    if failed:
        raise RuntimeError(f"train_regression: seeds {failed} failed; see {stem}_seed*.log")
    runs = {}
    for seed, (_, _, out) in jobs.items():
        with open(out) as f:
            runs[str(seed)] = json.load(f)
    spread = {}
    for it in runs[str(args.seeds[0])]["at"]:
        spread[it] = {key: {"min": min(r["at"][it][key] for r in runs.values()),
                            "max": max(r["at"][it][key] for r in runs.values()),
                            "mean": sum(r["at"][it][key] for r in runs.values()) / len(runs)}
                      for key in ("test_psnr", "ssim", "points")}
    doc = {"card": card_name(), "seeds": args.seeds, "iters": args.iters,
           "note": f"{len(runs)} processes shared one card and its host at once: their "
                   "per-iteration times are not speed figures",
           "spread": spread,
           "runs": {k: {key: r[key] for key in ("at", "psnr_trajectory", "points_trajectory",
                                                "ms_per_iteration", "metrics_results_json")}
                    for k, r in runs.items()}}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps({"card": doc["card"], "spread": spread}), flush=True)
    return doc


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=0,
                    help="the trainer's random_order_seed (camera order, split draws)")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="run these seeds at once, one process each, and record them together")
    ap.add_argument("--root", default="logs/train_torch/scene")
    ap.add_argument("--model", default="logs/train_torch/model")
    ap.add_argument("--out", default="logs/train_torch/TRAIN.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the training regression runs on a CUDA card; none is available")
    return run_seeds(args) if args.seeds else run_one(args)


if __name__ == "__main__":
    main()
