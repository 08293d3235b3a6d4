"""Rasterizer frame-rate sweep: 1920x1080 times ratios 0.2 .. 2.0, forward
only.

Port of the repository's root ``fps_test.py`` (the reference's
``fps_test.py``). A trained model (``-m``) or, with ``--synthetic``, a
random 100k-gaussian scene is rendered by bench's front camera (z = -5,
60 degrees) at each resolution, through ``rasterize`` (the expand and
tile-compositor kernels) or, in AMR mode, the 5-step foveated frame
``amr.render_amr`` (the binning pipeline and the four AMR rounds). Each
resolution is timed with CUDA events around the call: a warm-up, then
the median of ``REPS`` runs. Writes ``fps_data_{vanilla,amr}.json``::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test --synthetic
    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test -m <model> [--iteration N]

Deltas from the root script: a view whose instances overflow the starting
capacity (2^20) is rendered again at the next power of two that holds
them, so no frame is truncated, and the JSON records each resolution's
instances and capacity beside the card's name and power limit; ``-m``
overlays the model directory's ``cfg_args``, so ``-m`` alone finds the
source path. Runs on the card unless ``--data_device cpu``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene as bs
from gaussian_splatting_with_eye_tracking_tpu_torch.config import (
    OptimizationConfig,
    model_config_of,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene

REPS = 10  # timed runs after the warm-up; the median is reported
CAPACITY = 1 << 20  # the root script's instance capacity, where each view starts
RATIOS = (0.2, 0.4, 0.6, 0.8, 1.0, 1.2, 1.4, 1.6, 1.8, 2.0)


def timed(fn, device: torch.device):
    """(``fn()``, its milliseconds) of one call: CUDA events around it on
    a card, the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps: int, device: torch.device, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warmup``
    (``timed``)."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed(fn, device)[1] for _ in range(reps))


def timer_name(device: torch.device) -> str:
    return "cuda events" if device.type == "cuda" else "host clock"


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its line for the
    device's index), beside which a time on it is written; "cpu" for the
    CPU. The entry points add it to what they print and write."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()
    return lines[device.index if device.index is not None else torch.cuda.current_device()]


def sweep_size(base, ratio) -> tuple:
    """The root script's resolution: base times ratio, each side floored to
    a multiple of 32 and at least 32."""
    w = int(base[0] * ratio) // 32 * 32
    h = int(base[1] * ratio) // 32 * 32
    return max(w, 32), max(h, 32)


def sweep_camera(width: int, height: int, device):
    """tests/helpers.make_camera's camera (at z = -5 looking down +z, 60
    degrees each way), which is bench's front view."""
    return bs.view_request(0.0, 0.0, width, height).params(device=device)


def _render(args, max_sh_degree, active, cam, bg, max_instances, amr_mode):
    """(color, counters) of one view of the ``renderer.activated`` model."""
    if amr_mode:
        return amr.render_amr(*args, max_sh_degree, cam, bg, max_instances=max_instances,
                              active_mask=active)
    out = rast.rasterize(*args, cam, bg, sh_degree=max_sh_degree, max_instances=max_instances,
                         active_mask=active)
    return out.color, out


def render_at_capacity(args, max_sh_degree, active, cam, bg, max_instances: int,
                       amr_mode: bool = False):
    """One view of the ``renderer.activated`` model without autograd at
    ``max_instances`` or, past an overflow, at the next power of two that
    holds it (``train_lib.render_grown``). Returns (color (3, H, W),
    capacity, instances, enumerated)."""
    with torch.no_grad():
        color, counters, cap = train_lib.render_grown(
            lambda cap: _render(args, max_sh_degree, active, cam, bg, cap, amr_mode),
            max_instances)
    return color, cap, int(counters.num_instances), int(counters.num_enumerated)


def run_sweep(state: gm.GaussianModelState, max_sh_degree: int, active, base=(1920, 1080),
              ratios=None, amr_mode: bool = False, out_json: str = "fps_data.json", *,
              max_instances: int = CAPACITY, device=None, card_line: str | None = None):
    """Time one forward view of ``state`` at each ``sweep_size(base,
    ratio)``, at the capacity ``render_at_capacity`` settles on (``REPS``
    timed runs), and write the JSON, with ``card_line`` (``card``'s line,
    given by the caller) under "card". Runs on CUDA unless ``device`` says
    otherwise, with the model there. Returns the per-resolution results."""
    dev = backend.resolve_device(device)
    if state.params.xyz.device.type != dev.type:
        raise ValueError(f"model on {state.params.xyz.device}, sweep asked on {dev}")
    args = renderer.activated(state, max_sh_degree)
    bg = torch.zeros(3, device=dev)
    results = []
    for ratio in ratios or RATIOS:
        w, h = sweep_size(base, ratio)
        cam = sweep_camera(w, h, dev)
        _, cap, n, enum = render_at_capacity(args, max_sh_degree, active, cam, bg,
                                             max_instances, amr_mode)
        with torch.no_grad():
            ms = time_ms(lambda: _render(args, max_sh_degree, active, cam, bg, cap, amr_mode),
                         REPS, dev)
        results.append({"width": w, "height": h, "ratio": ratio, "ms": ms, "fps": 1e3 / ms,
                        "instances": n, "enumerated": enum, "capacity": cap})
        print(f"{w}x{h} (ratio {ratio}): {ms:.2f} ms -> {1e3 / ms:.1f} fps "
              f"({n} instances of {enum} enumerated, capacity {cap})", flush=True)
    with open(out_json, "w") as f:
        json.dump({"impl": "cuda" if dev.type == "cuda" else "plain", "amr": amr_mode,
                   "results": results, "card": card_line, "timer": timer_name(dev),
                   "reps": REPS}, f, indent=2)
    return results


def plot_results(results, out_png, label):
    """Resolution-vs-fps plot with the reference's overlay curves
    (1.5e8/x^2 and 7e4/x); nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    xs = [r["width"] for r in results]
    ys = [r["fps"] for r in results]
    plt.figure()
    plt.plot(xs, ys, "o-", label=label)
    xr = np.linspace(min(xs), max(xs), 100)
    plt.plot(xr, 1.5e8 / xr**2, "--", label="1.5e8/x^2")
    plt.plot(xr, 7e4 / xr, ":", label="7e4/x")
    plt.xlabel("width (px)")
    plt.ylabel("fps")
    plt.yscale("log")
    plt.legend()
    plt.savefig(out_png, dpi=120)


def synthetic_scene(n: int, device=None):
    """The root script's random scene: ``n`` points uniform in [-2.5,
    2.5]^3 with uniform colours (``default_rng(0)``), initialized as a
    point cloud and shown at SH degree 3. Returns (state, 3, active). Runs
    on CUDA unless ``device`` says otherwise."""
    rng = np.random.default_rng(0)
    state, _ = gm.create_from_points(
        rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32),
        rng.uniform(size=(n, 3)).astype(np.float32),
        3, OptimizationConfig(), 1.0, device=backend.resolve_device(device))
    state = state._replace(sh_degree=3)
    return state, 3, state.active


def load_or_synthetic(args):
    """(state, max SH degree, active mask) of the model the command line
    names: with ``--synthetic`` or no ``-m``, ``synthetic_scene`` of
    ``args.num_gaussians``; else the model directory through ``Scene`` (no
    images), its ``cfg_args`` overlaid by ``-s`` and ``--data_device``
    where given."""
    data_device = getattr(args, "data_device", None)
    if args.synthetic or not args.model_path:
        return synthetic_scene(args.num_gaussians, data_device)
    argv = ["-m", args.model_path]
    if args.source_path:
        argv += ["-s", args.source_path]
    if data_device:
        argv += ["--data_device", data_device]
    scene = Scene(model_config_of(argv), load_iteration=args.iteration, shuffle=False,
                  load_images=False)
    return scene.gaussians, scene.max_sh_degree, scene.gaussians.active


def model_args(parser: ArgumentParser) -> None:
    """The model flags of the root sweep scripts, and the port's
    ``--data_device``."""
    parser.add_argument("--model_path", "-m", default="", type=str)
    parser.add_argument("--source_path", "-s", default="", type=str)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--num_gaussians", default=100_000, type=int)
    parser.add_argument("--data_device", default=None, type=str,
                        help="cuda (the default; a model's cfg_args may say) or cpu")


def main(argv=None, amr_mode=False, base=(1920, 1080), ratios=None):
    parser = ArgumentParser(description="Rasterizer frame-rate sweep")
    model_args(parser)
    parser.add_argument("--out", default="", type=str)
    parser.add_argument("--plot", action="store_true")
    args = parser.parse_args(argv)

    state, deg, active = load_or_synthetic(args)
    tag = "amr" if amr_mode else "vanilla"
    out_json = args.out or f"fps_data_{tag}.json"
    dev = state.params.xyz.device
    results = run_sweep(state, deg, active, base=base, ratios=ratios, amr_mode=amr_mode,
                        out_json=out_json, device=dev, card_line=card(dev))
    if args.plot:
        plot_results(results, out_json.replace(".json", ".png"),
                     f"model: 3DGS-CUDA{' AMR' if amr_mode else ''}")
    return results


if __name__ == "__main__":
    main()
