"""Foveated-decimation quality: PSNR and SSIM of the gaze-driven fused
foveated frame under instance-stream decimation against the undecimated
fused frame, over scene densities and decimations, with a side-by-side
image.

Port of the repository's root ``amr_quality_sweep.py``. Every frame is
``amr.render_amr_fused`` (binning through its pipeline, then one launch
of the fused levels kernel) at bench's front camera, gaze at the image
centre and rings (H/8, H/4, H/2). Each decimation, (2,2,1,1), (4,2,1,1)
and (8,4,2,1), is rendered in the kernel and at binning time
(``predecimate``); the in-kernel frame is compared with the undecimated
one, the predecimated frame with the undecimated one of the same pure
gaze rings (``predecimate`` with no decimation), so both sides share the
path and the rings and only the decimation differs::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.amr_quality_sweep \\
        --out AMR_QUALITY.json [-m <model>] [--densities 100000 1000000]

writes the JSON document (``--out``) and the side-by-side PNG (``--png``:
undecimated | (4,2,1,1) predecimated | 10x their difference, from the
first synthetic workload) and returns the document. Each row also holds
the capacity, the instances and enumerated pairs, the overflow flag (false
by construction), each frame's milliseconds (CUDA events), the peak
device memory of its frames and the card. Deltas from the root script:
the capacity (``study_lib``; the root script renders every frame at 2^20
and truncates the 1080p frames of 100k gaussians and up); PSNR and SSIM
unrounded, SSIM on the device (``ops/ssim``); each workload loaded when
its turn comes; ``--alpha_modes`` takes ``f32`` alone and by default
nothing, since the port composites in f32 only (the root script's bf16
modes are a TPU kernel's knob, and wrong there); ``--data_device``.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser, Namespace

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test, renderer, study_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.fps_foveated import BF16_REFUSED
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_uint8

DECIMATIONS = ((2, 2, 1, 1), (4, 2, 1, 1), (8, 4, 2, 1))
UNDECIMATED = (1, 1, 1, 1)
PANEL = (4, 2, 1, 1)  # the side-by-side image's decimation


def psnr_ssim(a: torch.Tensor, b: torch.Tensor):
    """(PSNR 10 log10(1 / max(mse, 1e-12)), mean SSIM) of two images."""
    return study_lib.psnr(a, b), float(ssim_ops.ssim(a, b))


def gaze_view(width: int, height: int, device):
    """(camera, gaze at the image centre, ring radii (H/8, H/4, H/2))."""
    return (make_camera(width, height, cam_z=-5.0, device=device),
            torch.tensor([width / 2.0, height / 2.0], device=device),
            torch.tensor([height / 8.0, height / 4.0, height / 2.0], device=device))


def frame_name(decimation, predecimate: bool = False) -> str:
    return ",".join(map(str, decimation)) + (" predecimate" if predecimate else "")


def fused_renders(model, deg, active, cam, gaze, radii, bg) -> dict:
    """{``frame_name``: render(capacity) -> (image clipped to [0, 1], AMR
    state)}, in the root script's order: the two undecimated baselines,
    then each decimation in the kernel and at binning time."""
    def render(decimation, predecimate):
        def at(cap):
            img, st = amr.render_amr_fused(
                *model, deg, cam, bg, active_mask=active, max_instances=cap, gaze_xy=gaze,
                gaze_radii=radii, decimation=decimation, predecimate=predecimate)
            return img.clamp(0, 1), st
        return at

    keys = [(UNDECIMATED, False), (UNDECIMATED, True)]
    keys += [(d, pre) for d in DECIMATIONS for pre in (False, True)]
    return {frame_name(*key): render(*key) for key in keys}


def workloads(args):
    """(name, model flags) of each workload: the trained model first, if
    given, then each synthetic density."""
    common = dict(source_path="", data_device=args.data_device)
    out = []
    if args.model_path:
        out.append(("trained", Namespace(model_path=args.model_path, iteration=args.iteration,
                                         synthetic=False, num_gaussians=0, **common)))
    out += [(f"synthetic_{n}", Namespace(model_path="", iteration=-1, synthetic=True,
                                         num_gaussians=n, **common)) for n in args.densities]
    return out


def run_workload(name, flags, args, with_panel: bool):
    """(one workload's row, its side-by-side panels if ``with_panel``, its
    device)."""
    state, deg, active = fps_test.load_or_synthetic(flags)
    dev = state.params.xyz.device
    model = renderer.activated(state, deg)
    cam, gaze, radii = gaze_view(args.width, args.height, dev)
    bg = torch.zeros(3, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev) / 2**20
        torch.cuda.reset_peak_memory_stats(dev)
    renders = fused_renders(model, deg, active, cam, gaze, radii, bg)
    base_name = frame_name(UNDECIMATED)
    for mode in args.alpha_modes:  # f32 only: the baseline's frame again
        renders[f"alpha {mode}"] = renders[base_name]
    frames = study_lib.timed_frames(renders, dev, args.max_instances)
    base = frames[base_name]["image"]
    base_pre = frames[frame_name(UNDECIMATED, True)]["image"]
    row = {"workload": name, "num_gaussians": int(state.params.xyz.shape[0]),
           "active_gaussians": int(active.sum()), "gaze_rings_px": radii.tolist(),
           "decimation": [], "alpha_modes": [],
           "capacity": max(f["capacity"] for f in frames.values()),
           "instances": frames[base_name]["instances"],
           "enumerated": frames[base_name]["enumerated"], "overflow": False,
           "frames": study_lib.frame_numbers(frames), "card": fps_test.card(dev)}
    if dev.type == "cuda":
        row["held_mib"] = held
        row["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2**20
    panels = None
    for d in DECIMATIONS:
        img, imgp = frames[frame_name(d)]["image"], frames[frame_name(d, True)]["image"]
        ps, ss = psnr_ssim(img, base)
        psp, ssp = psnr_ssim(imgp, base_pre)
        row["decimation"].append({"decimation": list(d), "psnr_db": ps, "ssim": ss,
                                  "predecimate_psnr_db": psp, "predecimate_ssim": ssp})
        print(f"[{name}] decim {d}: kernel PSNR {ps:.2f} dB SSIM {ss:.4f} | binning-time "
              f"PSNR {psp:.2f} dB SSIM {ssp:.4f}", flush=True)
        if with_panel and d == PANEL:
            panels = (base_pre, imgp)
    for mode in args.alpha_modes:
        ps, ss = psnr_ssim(frames[f"alpha {mode}"]["image"], base)
        row["alpha_modes"].append({"mode": mode, "psnr_db": ps, "ssim": ss})
        print(f"[{name}] alpha {mode}: PSNR {ps:.2f} dB SSIM {ss:.4f}", flush=True)
    return row, panels, dev


def side_by_side(a: torch.Tensor, b: torch.Tensor, path: str):
    """a | b | 10x |a - b|, as the root script writes it (uint8 by
    truncation)."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    panel = np.concatenate([a, b, np.clip(np.abs(a - b) * 10.0, 0, 1)], axis=2)
    save_uint8((np.transpose(panel, (1, 2, 0)) * 255).astype(np.uint8), path)


def main(argv=None, device=None):
    ap = ArgumentParser(description="Foveated-decimation quality sweep")
    ap.add_argument("--model_path", "-m", default="", type=str)
    ap.add_argument("--iteration", default=-1, type=int)
    ap.add_argument("--densities", nargs="*", type=int, default=[100_000, 400_000, 1_000_000])
    ap.add_argument("--width", default=1920, type=int)
    ap.add_argument("--height", default=1088, type=int)
    ap.add_argument("--max_instances", default=study_lib.CAPACITY, type=int,
                    help="the starting instance capacity; a frame past it grows it")
    ap.add_argument("--out", default="AMR_QUALITY.json")
    ap.add_argument("--png", default="amr_quality_side_by_side.png")
    ap.add_argument("--alpha_modes", nargs="*", default=[],
                    help="f32 only: the port composites in f32")
    ap.add_argument("--data_device", default=None, type=str,
                    help="cuda (the default; a model's cfg_args may say) or cpu")
    args = ap.parse_args(argv)
    refused = [m for m in args.alpha_modes if m != "f32"]
    if refused:
        ap.error(f"--alpha_modes {' '.join(refused)}: {BF16_REFUSED}")
    if device is not None:
        args.data_device = str(device)

    results, panels, dev = [], None, None
    for name, flags in workloads(args):
        row, p, dev = run_workload(name, flags, args,
                                   panels is None and name.startswith("synthetic"))
        panels = panels or p
        results.append(row)
    if panels is not None:
        side_by_side(*panels, args.png)
        print(f"side-by-side (undecimated | {PANEL} | 10x diff) -> {args.png}", flush=True)
    doc = {"protocol": "fused gaze-driven AMR, decimated vs undecimated "
                       "(same path, same gaze rings); full-image metrics",
           "resolution": [args.width, args.height], "results": results}
    if dev is not None:
        doc.update(study_lib.device_record(dev))
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=2)
    if results:
        print(json.dumps(results[-1]["decimation"]), flush=True)
    return doc


if __name__ == "__main__":
    main()
