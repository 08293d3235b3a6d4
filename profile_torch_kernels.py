#!/usr/bin/env python3
"""Time the expand kernels (K1, K6) and the AMR round kernel alone on the
card, at the front view of bench.py's 300k scene, for whichever version of
the port's package sits beside this script.

    python3 profile_torch_kernels.py [--reps 10] [--batch 20]

Each kernel is launched through its C entry point ``batch`` times back to
back into outputs allocated beforehand (no wrapper, no allocation, no
host glue between launches) and timed with CUDA events: the median over
``reps`` of the batch's time / ``batch``. The round's inputs are the
eye-tracked frame's: gaze at uv (0.55, 0.45), rings (H/8, H/4, H/2), each
round's counts zero below its level; it runs in the frame's launch order
at every split the package offers and in tile order (a package whose
round entry takes no order times it in tile order only). Besides the
wrappers' times (``expand_rows_by_segments``, ``expand_rows``,
``blend_round``), as a caller pays them. Prints one JSON object with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import (
    H, MAX_INSTANCES, N, W, make_scene, view_request)
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning, blend, expand
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess


def cuda_ms(fn, reps, batch):
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    backend.build_kernels()
    g = [torch.from_numpy(a).to(dev) for a in make_scene(N)]
    cam = view_request(0.0, 0.0).params(device=dev)
    stream = backend.stream_ptr(g[0])
    out = {"card": card, "reps": args.reps, "batch": args.batch}

    def timed(fn, batch=args.batch):
        return cuda_ms(fn, args.reps, batch)

    with torch.no_grad():
        prep = preprocess(*g, 3, cam, tile=32)
        table, _ = binning.compact_table(prep.means2d, prep.conics, prep.rgb, prep.opacities,
                                         prep.tiles_touched, prep.rect_min, prep.rect_max,
                                         prep.cull_thr, prep.depths)
        rows, nc = table.shape
        k = MAX_INSTANCES
        k1 = torch.empty((rows, k), device=dev)
        want = expand.expand_rows_by_segments(table, 0, k)
        expand.EXPAND_SEG(table.data_ptr(), rows, nc, 0, k1.data_ptr(), k, stream)
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("expand_seg launched alone differs from its wrapper")
        out["expand_seg_kernel_ms"] = timed(lambda: expand.EXPAND_SEG(
            table.data_ptr(), rows, nc, 0, k1.data_ptr(), k, stream))
        out["expand_seg_ms"] = timed(lambda: expand.expand_rows_by_segments(table, 0, k), 1)
        slots = torch.arange(k, dtype=torch.float32, device=dev)
        ck = (torch.searchsorted(table[0].contiguous(), slots, right=True) - 1).clamp_(
            0, nc - 1).to(torch.int32)
        out["expand_rows_kernel_ms"] = timed(lambda: expand.EXPAND_ROWS(
            table.data_ptr(), rows, nc, ck.data_ptr(), k1.data_ptr(), k, stream))
        out["expand_rows_ms"] = timed(lambda: expand.expand_rows(table, ck), 1)

        st = amr.fovea_step0(*g, 3, cam, max_instances=MAX_INSTANCES,
                             gaze_xy=torch.tensor([0.55 * W, 0.45 * H], device=dev),
                             gaze_radii=torch.tensor([H / 8, H / 4, H / 2], device=dev))
        gx, gy = -(-W // 32), -(-H // 32)
        counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)
        tile_ids = torch.arange(gx * gy, device=dev)
        with_order = len(blend.BLEND_ROUND.argtypes) == 12
        orders = {"tile_order": tile_ids}
        if with_order:
            orders["frame_order"] = blend.round_order(counts, st.tile_levels)
        rnd_out = torch.empty((gx * gy, 256, 8), device=dev)
        feat = st.feat_soa
        rounds = []
        for rnd in range(1, 5):
            gated = torch.where(st.tile_levels >= rnd, counts, 0).to(torch.int32)
            offx, offy = blend.ROUND_OFFX[rnd - 1], blend.ROUND_OFFY[rnd - 1]
            row = {"round": rnd, "gated_tiles": int((st.tile_levels >= rnd).sum())}

            def launch(order, split):
                if with_order:
                    blend.BLEND_ROUND(feat.data_ptr(), feat.shape[1], st.offsets.data_ptr(),
                                      gated.data_ptr(), order.data_ptr(), gx * gy, gx, offx,
                                      offy, split, rnd_out.data_ptr(), stream)
                else:
                    blend.BLEND_ROUND(feat.data_ptr(), feat.shape[1], st.offsets.data_ptr(),
                                      gated.data_ptr(), gx * gy, gx, offx, offy,
                                      rnd_out.data_ptr(), stream)

            for name, order in orders.items():
                for split in (getattr(blend, "ROUND_SPLITS", (1,)) if name == "frame_order"
                              else (1,)):
                    row[f"{name}/{split}"] = timed(lambda: launch(order, split))
            kw = dict(offx=offx, offy=offy, counts_override=gated)
            if with_order:
                kw.update(order=orders["frame_order"], split=amr.ROUND_SPLIT[rnd - 1])
            row["wrapper_ms"] = timed(lambda: blend.blend_round(feat, st.offsets, gx, gy, **kw),
                                      1)
            rounds.append(row)
        out["rounds"] = rounds
        if with_order:
            out["round_order_ms"] = timed(lambda: blend.round_order(counts, st.tile_levels), 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
