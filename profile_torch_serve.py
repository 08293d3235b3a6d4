#!/usr/bin/env python3
"""Where the time of one served 1920x1088 view goes, in the PyTorch port.

Run from the repository root on a machine with a CUDA card:

    python3 profile_torch_serve.py

Uses chip_smoke.py's scene (bench.py's 300k-gaussian SH-3 model) and front
camera. Prints, as JSON lines:

- ``stages``: the median CUDA-event time of each stage of the serving path
  run on its own (preprocess, binning with the expand kernel, the expand
  kernel alone, the tile compositor kernel, image assembly) and of the
  whole request;
- ``profile``: from torch.profiler over ``chip_smoke.REPS`` requests, the device
  time per op (top 15), the total device time, the wall time, and the
  device's idle share (1 - device time / wall time).
"""

from __future__ import annotations

import json
import time

import torch

import chip_smoke as cs


def cuda_ms(fn):
    return cs.cuda_ms(fn, warmup=2)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: no CUDA device")
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, expand
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection

    backend.build_kernels()
    dev = torch.device("cuda")
    raw = cs.raw_params(*cs.make_scene(cs.N))
    params = gm.params_from_jax(raw)
    state = gm.state_from_params(params, 3)
    bg = torch.zeros(3, device=dev)
    cam = cs.view_request(0.0, 0.0).params()
    render = train_lib.make_eval_render(3, cs.W, cs.H, max_instances=cs.MAX_INSTANCES,
                                        max_live=cs.MAX_LIVE)
    gx, gy = -(-cs.W // 32), -(-cs.H // 32)
    p = state.params

    with torch.no_grad():
        sh = gm.get_sh(p) * renderer.sh_band_mask(3, 3, dev)[None, None, :]
        act = (p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p), sh)

        def pre():
            return projection.preprocess(*act, 3, cam, active_mask=state.active)

        prep = pre()
        bin_args = (prep.means2d, prep.conics, prep.rgb, prep.opacities,
                    prep.tiles_touched, prep.rect_min, prep.rect_max,
                    prep.cull_thr, prep.depths)

        def bins():
            return binning.build_sorted_instances(*bin_args, gx, gy, cs.MAX_INSTANCES, 32,
                                                  max_live=cs.MAX_LIVE)

        si = bins()
        table, _ = binning.compact_table(*bin_args)
        feat = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)
        tiles = blend.blend_fwd(feat, si.binning.offsets, gx, gy)
        stages = {
            "request": cuda_ms(lambda: render(state, *train_lib.camera_arrays(cam), bg)),
            "preprocess": cuda_ms(pre),
            "binning (incl. expand)": cuda_ms(bins),
            "  compact table": cuda_ms(lambda: binning.compact_table(*bin_args)),
            "  expand kernel": cuda_ms(
                lambda: expand.expand_rows_by_segments(table, 0, cs.MAX_INSTANCES)),
            "feat_soa pad": cuda_ms(lambda: blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)),
            "blend kernel": cuda_ms(lambda: blend.blend_fwd(feat, si.binning.offsets, gx, gy)),
            "assemble": cuda_ms(lambda: blend.assemble_tiles(tiles, gx, gy, blend.TILE, bg)),
        }
    print(json.dumps({"stages": stages}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        render(state, *train_lib.camera_arrays(cam), bg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cs.REPS):
            render(state, *train_lib.camera_arrays(cam), bg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device busy time: the kernels' own intervals; per-op device time:
    # the host ops' self device time (the kernels each launched directly)
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    ops = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.sort(key=lambda kv: -kv[1])
    print(json.dumps({"profile": {
        "requests": cs.REPS,
        "wall_ms_per_request": wall_us / cs.REPS / 1e3,
        "device_ms_per_request": device_us / cs.REPS / 1e3,
        "idle_share": 1.0 - device_us / wall_us,
        "top_ops_ms_per_request": {k: us / cs.REPS / 1e3 for k, us in ops[:15]},
    }}), flush=True)


if __name__ == "__main__":
    main()
