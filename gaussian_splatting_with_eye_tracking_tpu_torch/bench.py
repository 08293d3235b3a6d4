"""Headline benchmark: rasterizer forward + backward throughput at 1080p.

Port of the repository's root ``bench.py``: bench's 300,000-gaussian
SH-3 scene (``bench_scene``) seen by its front camera at 1920x1088, at
its instance capacities (1,638,400 enumerated, 1,441,792 live; a probe
raises on overflow before anything is timed). The loss mean(color^2) is
differentiated with respect to the means through the port's autograd
path: preprocess, binning (the pipeline K8), the tile compositor,
and in the backward the backward compositor and the per-gaussian segment
sum. Forward and backward together are timed with CUDA events: a
warm-up, then the median of ``REPS`` runs. Prints the card's name and
power limit (nvidia-smi), then the root script's one JSON line::

    {"metric": "1080p_fwd_bwd_rasterize_throughput", "value": <pixels/s>,
     "unit": "pixels/s", "vs_baseline": <value / (30 x 1920 x 1080)>}

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.bench [--data_device cpu]

vs_baseline normalizes against the reference's real-time claim of 30 fps
at 1080p, forward only. Runs on the card unless ``--data_device cpu``.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test
from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene as bs
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast

BASELINE_PX_PER_S = 30.0 * 1920 * 1080  # the reference: 30 fps at 1080p, forward only


def measure(num_gaussians: int = bs.N, width: int = bs.W, height: int = bs.H,
            max_instances: int = bs.MAX_INSTANCES, max_live: int = bs.MAX_LIVE,
            reps: int = bs.REPS, device=None) -> dict:
    """``time_fwd_bwd`` on bench's scene (``num_gaussians`` of it) and
    front camera, with the size and scene in the result. Runs on CUDA
    unless ``device`` says otherwise."""
    dev = backend.resolve_device(device)
    scene = [torch.from_numpy(a).to(dev) for a in bs.make_scene(num_gaussians)]
    cam = bs.view_request(0.0, 0.0, width, height).params(device=dev)
    result = time_fwd_bwd(scene, cam, torch.zeros(3, device=dev), 3, max_instances, max_live,
                          reps)
    result.update(width=width, height=height, num_gaussians=num_gaussians)
    return result


def time_fwd_bwd(scene, cam, bg, sh_degree: int, max_instances: int, max_live: int,
                 reps: int = bs.REPS) -> dict:
    """Forward + backward of mean(color^2) with respect to the means of
    ``scene`` (activated means, scales, quaternions, opacities, SH, on one
    device) seen by ``cam``: the loss and gradient of one step, the median
    ms of ``reps`` timed steps (after a warm-up), the probe's instance
    counts, and each kernel's launches over the timed steps (none on the
    CPU, where the plain versions run). Raises if the capacities
    overflow."""
    means, scales, quats, opacities, sh = scene
    dev = means.device
    kw = dict(sh_degree=sh_degree, max_instances=max_instances, max_live=max_live)
    with torch.no_grad():
        probe = rast.rasterize(means, scales, quats, opacities, sh, cam, bg, **kw)
    if bool(probe.overflow):
        raise RuntimeError(f"instance capacity overflow: {int(probe.num_enumerated)} enumerated "
                           f"of {max_instances}, {int(probe.num_instances)} live of {max_live}")

    def step():
        m = means.detach().requires_grad_(True)
        out = rast.rasterize(m, scales, quats, opacities, sh, cam, bg, **kw)
        loss = torch.mean(out.color ** 2)
        (grad,) = torch.autograd.grad(loss, [m])
        return loss.detach(), grad

    loss, grad = step()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for kern in backend.kernels():
        kern.launches = 0
    ms = fps_test.time_ms(step, reps, dev)
    launches = {kern.name: kern.launches for kern in backend.kernels()}
    return {"loss": loss, "grad": grad, "ms": ms, "instances": int(probe.num_instances),
            "enumerated": int(probe.num_enumerated), "launches": launches,
            "iterations": reps + 1, "timer": fps_test.timer_name(dev)}


def throughput_line(width: int, height: int, ms: float) -> dict:
    """The root script's JSON line for one forward + backward of ``ms``."""
    px_per_s = width * height / (ms * 1e-3)
    return {"metric": "1080p_fwd_bwd_rasterize_throughput", "value": round(px_per_s, 1),
            "unit": "pixels/s", "vs_baseline": round(px_per_s / BASELINE_PX_PER_S, 4)}


def main(argv=None):
    """Print the card line and the JSON line; return ``measure``'s result
    with the line under "line"."""
    parser = ArgumentParser(description="Rasterizer forward + backward throughput at 1080p")
    parser.add_argument("--data_device", default=None, type=str,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dev = backend.resolve_device(args.data_device)
    result = measure(device=dev)
    result["line"] = throughput_line(result["width"], result["height"], result["ms"])
    print(fps_test.card(dev), flush=True)
    print(json.dumps(result["line"]), flush=True)
    return result


if __name__ == "__main__":
    main()
