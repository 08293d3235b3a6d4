"""Foveated frame timing: the 5-step protocol step by step, the fused
frame with and without decimation, and the plain full-resolution view.

Port of ``run_foveated_breakdown`` and ``main`` from the repository's
``fps_test_amr_foveated.py``, timed with CUDA events (a warm-up, then the
median of ``reps`` runs) on a card; on the CPU (``--data_device cpu``)
with the host clock, and the result says so. The model is
``fps_test.load_or_synthetic``'s (a trained ``-m`` model or the random
100k-gaussian scene), seen by bench's front camera at ``--width`` x
``--height``; the levels come from the instance-count percentiles or,
with ``--gaze`` (the image centre) or ``--gaze_uv U V``, from the rings
(H/8, H/4, H/2) around the gaze::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_foveated --synthetic --gaze

writes the root script's document (``--out_json``) with the port's
extras: the card, the timer, the level histogram, the 5-step frame as a
whole, the instances and the capacity. Deltas from the root script: a
frame whose instances overflow ``--max_instances`` is rendered at the
next power of two that holds them (the capacity is recorded); ``--alpha``
takes only ``f32``.
"""

from __future__ import annotations

import argparse
import json

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test, renderer, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams

BF16_REFUSED = (
    "the port composites in f32 only: the TPU kernel's bf16 alpha modes compute "
    "z^T (L^T L) z, not the conic's quadratic form "
    "(gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:291-294)")


def run_foveated_breakdown(state: gm.GaussianModelState, cam: CameraParams, bg, *,
                           max_sh_degree: int = 3, gaze_xy=None, radii=None,
                           decimation=(4, 2, 1, 1), max_instances: int = 1 << 20,
                           max_live=None, reps: int = 10, device=None) -> dict:
    """Times of one view of ``state``: step 0, rounds 1..4 and their sum,
    the 5-step frame, the fused frame, and the plain served view
    (``renderer.render`` at the capacity and ``max_live``); unless
    ``decimation`` is (1, 1, 1, 1), the fused frame with it and (with a
    gaze) with ``predecimate``; on a card also the peak memory of a fused
    frame and what was held before it. Percentile levels without
    ``gaze_xy`` (pixels, with ``radii`` the three ring radii). Step 0 at
    ``max_instances`` or, past an overflow, at the next power of two that
    holds the frame (``train_lib.render_grown``); raises if an instance
    capacity still overflows. Runs on CUDA unless ``device`` says
    otherwise, with the model and camera there."""
    dev = backend.resolve_device(device)
    if state.params.xyz.device.type != dev.type:
        raise ValueError(f"model on {state.params.xyz.device}, timing asked on {dev}")
    args = (*renderer.activated(state, max_sh_degree), max_sh_degree, cam)
    kw = dict(active_mask=state.active, gaze_xy=gaze_xy, gaze_radii=radii)
    decimated = tuple(decimation) != (1, 1, 1, 1)
    grid_x, grid_y = -(-cam.width // amr.TILE), -(-cam.height // amr.TILE)
    out = {"impl": "cuda" if dev.type == "cuda" else "plain", "alpha_mode": "f32",
           "width": cam.width, "height": cam.height,
           "levels": "gaze+percentile" if gaze_xy is not None else "percentile(25/50/90)",
           "num_gaussians": int(state.params.xyz.shape[0]),
           "active_gaussians": int(state.active.sum()),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "timer": fps_test.timer_name(dev), "reps": reps}

    def ms(fn):
        return fps_test.time_ms(fn, reps, dev)

    with torch.no_grad():
        _, state0, kw["max_instances"] = train_lib.render_grown(
            lambda cap: (None, amr.fovea_step0(*args, **kw, max_instances=cap)), max_instances)
        out["capacity"] = kw["max_instances"]
        out["instances"] = int(state0.num_instances)
        out["level_histogram"] = torch.bincount(state0.tile_levels, minlength=5)[1:].tolist()
        steps = [ms(lambda: amr.fovea_step0(*args, **kw))]
        for rnd in range(1, 5):
            steps.append(ms(lambda rnd=rnd: amr.fovea_step_render(state0, rnd, grid_x, grid_y)))
        out["steps_protocol"] = [{"step": i, "ms": t} for i, t in enumerate(steps)]
        out["steps_protocol_total_ms"] = sum(steps)
        out["five_step_frame_ms"] = ms(lambda: amr.render_amr(*args, bg, **kw))
        fused = ms(lambda: amr.render_amr_fused(*args, bg, **kw))
        out["fused_ms"], out["fused_fps"] = fused, 1e3 / fused
        best = fused
        if decimated:
            t = ms(lambda: amr.render_amr_fused(*args, bg, decimation=decimation, **kw))
            out["decimation"] = list(decimation)
            out["fused_decimated_ms"], out["fused_decimated_fps"] = t, 1e3 / t
            best = min(best, t)
            if gaze_xy is not None:
                _, pre = amr.render_amr_fused(*args, bg, decimation=decimation,
                                              predecimate=True, **kw)
                out["predecimated_instances"] = int(pre.num_instances)
                t = ms(lambda: amr.render_amr_fused(*args, bg, decimation=decimation,
                                                    predecimate=True, **kw))
                out["fused_predecimated_ms"], out["fused_predecimated_fps"] = t, 1e3 / t
                best = min(best, t)
        cap = kw["max_instances"]
        plain = renderer.render(cam, state, bg, max_sh_degree=max_sh_degree,
                                max_instances=cap, max_live=max_live)
        if bool(plain.overflow):
            raise RuntimeError(f"instance capacities {cap}/{max_live} overflow")
        t = ms(lambda: renderer.render(cam, state, bg, max_sh_degree=max_sh_degree,
                                       max_instances=cap, max_live=max_live))
        out["plain_forward_ms"], out["plain_forward_fps"] = t, 1e3 / t
        if dev.type == "cuda":
            torch.cuda.synchronize()
            out["fused_held_mib"] = torch.cuda.memory_allocated() / 2**20
            torch.cuda.reset_peak_memory_stats()
            amr.render_amr_fused(*args, bg, **kw)
            torch.cuda.synchronize()
            out["fused_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    out["fused_vs_plain"] = best / out["plain_forward_ms"]
    out["fused_undecimated_vs_plain"] = fused / out["plain_forward_ms"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Foveated AMR timing")
    fps_test.model_args(parser)
    parser.add_argument("--width", default=1920, type=int)
    parser.add_argument("--height", default=1088, type=int)
    parser.add_argument("--max_instances", default=1 << 20, type=int)
    parser.add_argument("--out_json", default="fps_data_foveated.json")
    parser.add_argument("--gaze", action="store_true",
                        help="gaze at the image centre, rings (H/8, H/4, H/2)")
    parser.add_argument("--gaze_uv", nargs=2, type=float, default=None, metavar=("U", "V"),
                        help="gaze at (U, V) in [0, 1]^2 of the image (implies --gaze)")
    parser.add_argument("--decimate", nargs=4, type=int, default=[1, 1, 1, 1],
                        metavar=("D1", "D2", "D3", "D4"),
                        help="per-level instance-stream decimation (powers of two)")
    parser.add_argument("--alpha", default="f32", choices=("f32", "bf16", "bf16x"))
    args = parser.parse_args(argv)
    if args.alpha != "f32":
        parser.error(f"--alpha {args.alpha}: {BF16_REFUSED}")
    state, deg, _ = fps_test.load_or_synthetic(args)
    dev = state.params.xyz.device
    cam = fps_test.sweep_camera(args.width, args.height, dev)
    gaze_xy = radii = None
    if args.gaze or args.gaze_uv is not None:
        u, v = args.gaze_uv or (0.5, 0.5)
        gaze_xy = torch.tensor([u * args.width, v * args.height], device=dev)
        radii = torch.tensor([args.height / 8, args.height / 4, args.height / 2], device=dev)
    doc = run_foveated_breakdown(state, cam, torch.zeros(3, device=dev),
                                 max_sh_degree=deg, gaze_xy=gaze_xy, radii=radii,
                                 decimation=tuple(args.decimate),
                                 max_instances=args.max_instances, reps=fps_test.REPS,
                                 device=dev)
    doc["card"] = fps_test.card(dev)
    with open(args.out_json, "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
