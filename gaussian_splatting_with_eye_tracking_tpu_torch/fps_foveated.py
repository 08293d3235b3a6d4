"""Foveated frame timing: the 5-step protocol step by step, the fused
frame with and without decimation, and the plain full-resolution view.

Port of ``run_foveated_breakdown`` from the repository's
``fps_test_amr_foveated.py``, timed with CUDA events (a warm-up, then the
median of ``reps`` runs) on a card; on the CPU (``device="cpu"``) with the
host clock, and the result says so. Run on bench.py's 300k-gaussian SH-3
scene at 1920x1088 (``bench_scene``), gazing at (u, v) in [0, 1]^2 of the
image (default the centre):

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_foveated [--gaze_uv U V]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene as bs
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


def time_ms(fn, reps: int, device: torch.device, warmup: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warmup``:
    CUDA events on a card, the host clock around the call on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_foveated_breakdown(state: gm.GaussianModelState, cam: CameraParams, bg, *,
                           max_sh_degree: int = 3, gaze_xy=None, radii=None,
                           decimation=(4, 2, 1, 1), max_instances: int = 1 << 20,
                           max_live=None, reps: int = 10, device=None) -> dict:
    """Times of one view of ``state``: step 0, rounds 1..4 and their sum
    with step 0, the 5-step frame, the fused frame, the fused frame with
    ``decimation`` and (with a gaze) with ``predecimate``, and the plain
    served view (``renderer.render`` at ``max_instances``/``max_live``);
    on a card also the peak memory of a fused frame and what was held
    before it. Percentile levels without ``gaze_xy`` (pixels, with
    ``radii`` the three ring radii). Raises if an instance capacity
    overflows. Runs on CUDA unless ``device`` says otherwise, with the
    model and camera there."""
    dev = backend.resolve_device(device)
    if state.params.xyz.device.type != dev.type:
        raise ValueError(f"model on {state.params.xyz.device}, timing asked on {dev}")
    p = state.params
    sh = gm.get_sh(p) * renderer.sh_band_mask(state.sh_degree, max_sh_degree, dev)[None, None, :]
    args = (p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p), sh, max_sh_degree, cam)
    kw = dict(max_instances=max_instances, active_mask=state.active, gaze_xy=gaze_xy,
              gaze_radii=radii)
    grid_x, grid_y = -(-cam.width // amr.TILE), -(-cam.height // amr.TILE)
    out = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "timer": "cuda events" if dev.type == "cuda" else "host clock", "reps": reps,
           "width": cam.width, "height": cam.height, "decimation": list(decimation),
           "levels": "gaze" if gaze_xy is not None else "percentile(25/50/90)"}

    def ms(fn):
        return time_ms(fn, reps, dev)

    with torch.no_grad():
        state0 = amr.fovea_step0(*args, **kw)
        if bool(state0.overflow):
            raise RuntimeError(f"instance capacity {max_instances} overflows")
        out["level_histogram"] = torch.bincount(state0.tile_levels, minlength=5)[1:].tolist()
        steps = [ms(lambda: amr.fovea_step0(*args, **kw))]
        for rnd in range(1, 5):
            steps.append(ms(lambda rnd=rnd: amr.fovea_step_render(state0, rnd, grid_x, grid_y)))
        out["steps_ms"] = steps
        out["steps_total_ms"] = sum(steps)
        out["five_step_frame_ms"] = ms(lambda: amr.render_amr(*args, bg, **kw))
        out["fused_ms"] = ms(lambda: amr.render_amr_fused(*args, bg, **kw))
        out["fused_decimated_ms"] = ms(lambda: amr.render_amr_fused(
            *args, bg, decimation=decimation, **kw))
        if gaze_xy is not None:
            _, pre = amr.render_amr_fused(*args, bg, decimation=decimation, predecimate=True,
                                          **kw)
            out["predecimated_instances"] = int(pre.num_instances)
            out["fused_predecimated_ms"] = ms(lambda: amr.render_amr_fused(
                *args, bg, decimation=decimation, predecimate=True, **kw))
        out["instances"] = int(state0.num_instances)
        plain = renderer.render(cam, state, bg, max_sh_degree=max_sh_degree,
                                max_instances=max_instances, max_live=max_live)
        if bool(plain.overflow):
            raise RuntimeError(f"instance capacities {max_instances}/{max_live} overflow")
        out["plain_ms"] = ms(lambda: renderer.render(
            cam, state, bg, max_sh_degree=max_sh_degree, max_instances=max_instances,
            max_live=max_live))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            out["fused_held_mib"] = torch.cuda.memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
            amr.render_amr_fused(*args, bg, **kw)
            torch.cuda.synchronize()
            out["fused_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    fused = [out[k] for k in ("fused_ms", "fused_decimated_ms", "fused_predecimated_ms")
             if k in out]
    out["best_fused_vs_plain"] = min(fused) / out["plain_ms"]
    out["fused_vs_plain"] = out["fused_ms"] / out["plain_ms"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num_gaussians", type=int, default=bs.N)
    parser.add_argument("--gaze_uv", nargs=2, type=float, default=[0.5, 0.5],
                        metavar=("U", "V"), help="gaze point in [0, 1]^2 of the image")
    parser.add_argument("--decimate", nargs=4, type=int, default=[4, 2, 1, 1])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    dev = backend.resolve_device(args.device)
    params = gm.params_from_jax(bs.raw_params(*bs.make_scene(args.num_gaussians)), device=dev)
    state = gm.state_from_params(params, 3)
    cam = bs.view_request(0.0, 0.0).params(device=dev)
    gaze = torch.tensor([args.gaze_uv[0] * bs.W, args.gaze_uv[1] * bs.H], device=dev)
    radii = torch.tensor([bs.H / 8, bs.H / 4, bs.H / 2], device=dev)
    doc = run_foveated_breakdown(state, cam, torch.zeros(3, device=dev), gaze_xy=gaze,
                                 radii=radii, decimation=tuple(args.decimate),
                                 max_instances=bs.MAX_INSTANCES, max_live=bs.MAX_LIVE,
                                 reps=bs.REPS, device=dev)
    print(json.dumps(doc))


if __name__ == "__main__":
    main()
