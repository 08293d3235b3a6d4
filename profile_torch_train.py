#!/usr/bin/env python3
"""Where the time of one 1920x1088 train step goes, in the PyTorch port.

Run from the repository root on a machine with a CUDA card:

    python3 profile_torch_train.py

Uses chip_smoke.py's scene (bench.py's 300k-gaussian SH-3 model) and front
camera, in a training state of 524,288 slots with f_dc perturbed by
N(0, 0.1) and the unperturbed model's render as the target, as
chip_smoke.py trains it. Prints, as JSON lines:

- ``phases``: the median CUDA-event time of the whole step and of its
  phases (forward, loss, backward, optimizer) over ``chip_smoke.REPS``
  steps, and of the backward's parts run on their own: the backward
  compositor kernel; the per-gaussian reduction as the step runs it
  (``segment_reduce_grads``), its id-order source and its gather-and-sum
  kernel; and the table route beside it (the permutation into a
  gaussian-id-order table, also as its zero fill and its scatter apart,
  and the segment sum kernel on that table);
- ``segments``: the front view's per-gaussian instance counts (segment
  lengths of the reduction): empty ones, mean, quantiles and the largest;
- ``profile``: from torch.profiler over ``chip_smoke.REPS`` steps, the
  wall and device time per step, the device's idle share (1 - device time
  / wall time), and the device time per kernel name (top 20).
"""

from __future__ import annotations

import json
import statistics
import time
from collections import defaultdict

import torch

import chip_smoke as cs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend, segsum

    backend.build_kernels()
    dev = torch.device("cuda")
    params = gm.params_from_jax(cs.raw_params(*cs.make_scene(cs.N)))
    bg = torch.zeros(3, device=dev)
    cam = cs.view_request(0.0, 0.0).params()
    render = train_lib.make_eval_render(3, cs.W, cs.H, max_instances=cs.MAX_INSTANCES,
                                        max_live=cs.MAX_LIVE)
    target = render(gm.state_from_params(params, 3), *train_lib.camera_arrays(cam), bg)
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, cs.EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(params.f_dc.shape, generator=gen, device="cuda")
    state = gm.init_training(params._replace(f_dc=params.f_dc + 0.1 * noise), 3, tx,
                             capacity=gm.next_pow2(cs.N))
    step = train_lib.make_train_step(tx, opt, 3, cs.W, cs.H, cs.MAX_INSTANCES, cs.MAX_LIVE)
    args = (*train_lib.camera_arrays(cam), target, bg, True)

    def timed_step():
        t0 = torch.cuda.Event(enable_timing=True)
        events = []
        t0.record()
        step(state, *args, events=events)
        events[-1][1].synchronize()
        out, prev = {"step": t0.elapsed_time(events[-1][1])}, t0
        for name, ev in events:
            out[name] = prev.elapsed_time(ev)
            prev = ev
        return out

    timed_step()
    runs = [timed_step() for _ in range(cs.REPS)]
    phases = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    # the backward's own parts on the front view's inputs (a random cotangent)
    si, feat, tiles = cs.splat_inputs(state, cam)
    b = si.binning
    offsets = b.offsets
    cot = torch.randn_like(tiles)
    gx, gy = -(-cs.W // 32), -(-cs.H // 32)
    dfeat = blend.blend_bwd(feat, offsets, tiles, cot, gx, gy)
    table, bounds = blend.id_order_table(dfeat, si.id_pos, b.gauss_start, b.gauss_count,
                                         cs.MAX_INSTANCES)
    phases["backward: blend_bwd kernel"] = cs.cuda_ms(
        lambda: blend.blend_bwd(feat, offsets, tiles, cot, gx, gy), warmup=2)
    phases["backward: id-order permutation"] = cs.cuda_ms(
        lambda: blend.id_order_table(dfeat, si.id_pos, b.gauss_start, b.gauss_count,
                                     cs.MAX_INSTANCES), warmup=2)
    phases["backward: blend_bwd output zero fill"] = cs.cuda_ms(
        lambda: torch.zeros_like(dfeat), warmup=2)
    phases["backward: id-order zero fill"] = cs.cuda_ms(
        lambda: dfeat.new_zeros((dfeat.shape[0], cs.MAX_INSTANCES + 1)), warmup=2)

    def scatter():
        table[:, si.id_pos] = dfeat[:, :si.id_pos.shape[0]]

    phases["backward: id-order scatter"] = cs.cuda_ms(scatter, warmup=2)
    phases["backward: segsum kernel"] = cs.cuda_ms(
        lambda: segsum.segment_sum_bounds(table, bounds), warmup=2)
    red = (dfeat, si.id_pos, b.gauss_start, b.gauss_count, cs.MAX_INSTANCES)
    src = blend.id_order_source(si.id_pos, cs.MAX_INSTANCES)
    phases["backward: segment_reduce_grads"] = cs.cuda_ms(
        lambda: blend.segment_reduce_grads(*red), warmup=2)
    phases["backward: id-order source"] = cs.cuda_ms(
        lambda: blend.id_order_source(si.id_pos, cs.MAX_INSTANCES), warmup=2)
    phases["backward: segsum gather kernel"] = cs.cuda_ms(
        lambda: segsum.segment_sum_gather(dfeat, src, bounds), warmup=2)
    print(json.dumps({"phases": phases}), flush=True)
    counts = b.gauss_count.to(torch.float64)
    live = counts[counts > 0]
    q = torch.quantile(live, torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64,
                                          device=live.device)).tolist()
    print(json.dumps({"segments": {
        "gaussians": counts.numel(), "empty": int((counts == 0).sum()),
        "instances": int(counts.sum()), "mean_nonempty": float(live.mean()),
        "p50_p90_p99_p999": q, "max": int(counts.max())}}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cs.REPS):
            step(state, *args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_kernel = defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.key] += e.time_range.elapsed_us()
    device_us = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:20]
    print(json.dumps({"profile": {
        "steps": cs.REPS,
        "wall_ms_per_step": wall_us / cs.REPS / 1e3,
        "device_ms_per_step": device_us / cs.REPS / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
        "kernels_ms_per_step": {k[:90]: us / cs.REPS / 1e3 for k, us in top},
    }}), flush=True)


if __name__ == "__main__":
    main()
