"""Multi-device scaling benchmark: rays/s of the tile-band train step
(``parallel.make_sharded_train_step``) at 1 device and at N devices.

Port of the repository's root ``scaling_bench.py``, with its flags,
defaults (200,000 random points at 1024x1024, SH degree 1,
``max_instances_per_band = max(2^20 / devices, 2^14)``) and JSON output (a
list of ``devices``, ``ms_per_step``, ``rays_per_s``,
``scaling_efficiency``; here also the card's name and power limit and the
overflow flag). One rank runs on each card::

    torchrun --nproc_per_node N -m gaussian_splatting_with_eye_tracking_tpu_torch.scaling_bench

or without torchrun on one card (1 device). The counts measured are the
ranks' meshes of ``--devices`` (default 1, 2 and all), each the first
ranks of the run. A count larger than the number of cards is refused:
ranks sharing a card give no scaling figure. ``--emulate_devices N``
checks the harness on the CPU instead: this process starts N ranks of
itself on gloo and reports theirs.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import (
    make_mesh,
    make_sharded_train_step,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost

RANK_TIMEOUT_S = 3600  # an emulated rank that takes longer is killed


def measure_step(step, state, cam_args, gt, bg, iters=3):
    """Seconds per step: one warm-up step, then ``iters`` steps chained on
    their own state, ended by reading the last loss. Returns (seconds,
    whether any step overflowed)."""
    s1, aux = step(state, *cam_args, gt, bg, True)
    overflow = bool(aux["overflow"])
    t0 = time.perf_counter()
    s = state
    for _ in range(iters):
        s, aux = step(s, *cam_args, gt, bg, True)
    _ = float(aux["loss"])
    return (time.perf_counter() - t0) / iters, overflow or bool(aux["overflow"])


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="rays/s of the tile-band train step at 1 and N devices")
    parser.add_argument("--devices", nargs="+", type=int, default=None)
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=1024)
    parser.add_argument("--num_gaussians", type=int, default=200_000)
    parser.add_argument("--out", type=str, default="scaling_data.json")
    parser.add_argument("--emulate_devices", type=int, default=0,
                        help="run N gloo ranks on the CPU (harness validation)")
    parser.add_argument("--data_device", type=str, default="cuda")
    return parser


def _emulate(args, argv) -> list:
    """Start ``args.emulate_devices`` CPU ranks of this module with
    torchrun's variables; returns rank 0's results (read from --out)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    n = args.emulate_devices
    child_argv = []
    skip = False
    for a in argv:  # the same flags, without --emulate_devices
        if skip:
            skip = False
            continue
        if a == "--emulate_devices":
            skip = True
            continue
        if not a.startswith("--emulate_devices="):
            child_argv.append(a)
    root = str(Path(__file__).resolve().parent.parent)
    procs = []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS=str(max(1, os.cpu_count() // n)),
                   PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", __spec__.name, *child_argv, "--data_device", "cpu"],
            env=env))
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=RANK_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    if any(codes):
        raise RuntimeError(f"emulated ranks exited with {codes}")
    with open(args.out) as f:
        return json.load(f)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.emulate_devices and not multihost.is_distributed():
        return _emulate(args, argv)

    joined = not torch.distributed.is_initialized() and multihost.maybe_initialize_distributed(
        device=args.data_device)
    dev = multihost.local_device(args.data_device)
    is_main = multihost.process_index() == 0
    n_avail = multihost.process_count()
    if dev.type == "cuda" and n_avail > torch.cuda.device_count():
        raise SystemExit(f"{n_avail} ranks on {torch.cuda.device_count()} card(s): ranks that "
                         "share a card give no scaling figure")
    dev_counts = args.devices or sorted({1, 2, n_avail} & set(range(1, n_avail + 1)))
    if dev.type == "cuda" and max(dev_counts) > torch.cuda.device_count():
        raise SystemExit(f"--devices {dev_counts}: only {torch.cuda.device_count()} card(s)")
    dev_counts = [d for d in dev_counts if d <= n_avail and args.height % (32 * d) == 0]
    card = fps_test.card(dev)
    if is_main:
        print(card)
        print(f"{n_avail} devices available; measuring {dev_counts}", flush=True)

    rng = np.random.default_rng(0)
    opt = OptimizationConfig()
    state, tx = gm.create_from_points(
        rng.uniform(-2.5, 2.5, (args.num_gaussians, 3)).astype(np.float32),
        rng.uniform(size=(args.num_gaussians, 3)).astype(np.float32),
        1, opt, 1.0, device=dev,
    )
    cam = make_camera(args.width, args.height, cam_z=-5.0, device=dev)
    gt = torch.zeros((3, args.height, args.width), device=dev)
    bg = torch.zeros(3, device=dev)
    cam_args = train_lib.camera_arrays(cam)

    results = []
    for nd in dev_counts:
        mesh = make_mesh(nd, device=dev)  # every rank takes part in making it
        if not mesh.member:
            continue
        step = make_sharded_train_step(
            mesh, tx, opt, max_sh_degree=1, width=args.width, height=args.height,
            max_instances_per_band=max((1 << 20) // nd, 1 << 14), max_per_tile=1024,
        )
        dt, overflow = measure_step(step, state, cam_args, gt, bg)
        rays = args.width * args.height / dt
        eff = None
        if results:
            base = results[0]
            eff = (rays / base["rays_per_s"]) / (nd / base["devices"])
        results.append({"devices": nd, "ms_per_step": dt * 1000, "rays_per_s": rays,
                        "scaling_efficiency": eff, "overflow": overflow, "card": card})
        if is_main:
            print(f"{nd} device(s): {dt * 1000:.1f} ms/step -> {rays / 1e6:.2f} Mray/s"
                  + (f" (eff {eff * 100:.0f}%)" if eff else "")
                  + (" (instance capacity overflowed)" if overflow else ""), flush=True)

    if is_main:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    if joined:
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
