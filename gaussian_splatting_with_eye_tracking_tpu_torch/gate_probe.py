"""Why a tile compositor's pixel differs from its plain version's: for each
pixel of one frame where the tile compositor (K2) or the first AMR round
differs from its plain version by more than ``--tol``, walk the pixel's
pairs in float64 with the plain version's kept set, then with each pair
whose alpha sits within a few ulps of the 1/255 gate turned, and report
the turn that reproduces the kernel's pixel, beside what an FMA-contracted
power would decide for that pair::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.gate_probe [--ratio 2.0]

The frame is ``fps_test``'s: its synthetic 100k scene seen by its camera
at ``fps_test.sweep_size((1920, 1080), ratio)``, at the capacity that holds
it. Prints one line per pixel over ``--tol`` (the worst ``PIXELS`` of
each kernel) and a JSON summary as the last line. Runs on the card unless
``--data_device cpu`` (where the wrappers are the plain versions, so no
pixel differs).
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning, blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess

LN_GATE = math.log(1 / 255)
NEAR = 4e-6  # |power + log op - ln(1/255)| of a pair that may turn (~8 ulps)
PIXELS = 12  # pixels explained per kernel, worst first


def _fma(u, v, w):
    """fma(u, v, w) of float32 tensors, rounded once (through float64)."""
    return (u.double() * v.double() + w.double()).float()


def fma_powers(ha, nb, hc, dx, dy):
    """The four ways a compiler may contract (ha dx + nb dy) dx + (hc dy)
    dy into two FMAs."""
    inner = (_fma(ha, dx, nb * dy), _fma(nb, dy, ha * dx))
    return [p for i in inner for p in (_fma(i, dx, (hc * dy) * dy), _fma(hc * dy, dy, i * dx))]


def _kept(power, lo):
    return (power <= 0) & (torch.exp(power + lo) >= blend.ALPHA_MIN)


def walk(f, keep, alpha_raw):
    """rgb and final T (float64, 4) of the pixel's pairs front to back with
    the kept set ``keep``."""
    alpha = torch.where(keep, alpha_raw.double().clamp_max(blend.ALPHA_MAX), 0.0)
    t_before = torch.cumprod(torch.cat([alpha.new_ones(1), 1 - alpha[:-1]]), 0)
    rgb = (alpha * t_before) @ f[5:8].double().T
    return torch.cat([rgb, (t_before[-1:] * (1 - alpha[-1:]))])


def explain(feat, o, n, chunks, x, y, kernel_px, plain_px):
    """The pixel at (x, y) whose instances are feat[:, o:o+n] and of which
    the plain version ran ``chunks`` chunks: its walk with the plain
    version's kept set, and the turn of one near-gate pair that brings the
    walk closest to the kernel's pixel."""
    start = (o // blend.CHUNK) * blend.CHUNK
    ids = torch.arange(o, min(o + n, start + chunks * blend.CHUNK), device=feat.device)
    f = feat[:9, ids]
    ha, nb, hc = -0.5 * f[2], -f[3], -0.5 * f[4]
    lo = torch.log(f[8])
    dx, dy = f[0] - x, f[1] - y
    power = (ha * dx + nb * dy) * dx + (hc * dy) * dy
    g = power + lo
    alpha_raw = torch.exp(g)
    keep = (power <= 0) & (alpha_raw >= blend.ALPHA_MIN)
    base = walk(f, keep, alpha_raw)
    row = {"pixel": [x, y], "pairs": int(ids.numel()), "kept": int(keep.sum()),
           "kernel_vs_plain": float((kernel_px - plain_px).abs().max()),
           "walk_vs_plain": float((base - plain_px.double()).abs().max())}
    best = None
    for j in torch.nonzero((power <= 0) & ((g.double() - LN_GATE).abs() < NEAR)).flatten():
        turned = keep.clone()
        turned[j] = ~turned[j]
        resid = float((walk(f, turned, alpha_raw) - kernel_px.double()).abs().max())
        if best is None or resid < best["turned_vs_kernel"]:
            fma = [bool(_kept(p, lo[j])) for p in fma_powers(ha[j], nb[j], hc[j], dx[j], dy[j])]
            best = {"turned_vs_kernel": resid, "pair": int(ids[j]), "plain_keeps": bool(keep[j]),
                    "gate_offset": float(g[j].double() - LN_GATE),
                    "t_before": float(torch.prod(1 - torch.where(
                        keep[:j], alpha_raw[:j].double().clamp_max(blend.ALPHA_MAX), 0.0))),
                    "fma_keeps": fma}
    row["best_turn"] = best
    return row


def probe(feat, offsets, counts, got, want, gx, tag, stride, offx, offy, tol):
    """Rows of ``explain`` for the pixels of ``got`` (T, P, 8) over ``tol``
    from ``want``, worst first."""
    err = (got[..., 0:4] - want[..., 0:4]).abs().amax(-1)
    flat = torch.nonzero(err.flatten() > tol).flatten()
    flat = flat[torch.argsort(err.flatten()[flat], descending=True)][:PIXELS]
    side = blend.TILE // stride
    rows = []
    for i in flat.tolist():
        t, p = divmod(i, got.shape[1])
        x = (t % gx) * blend.TILE + (p % side) * stride + offx
        y = (t // gx) * blend.TILE + (p // side) * stride + offy
        row = explain(feat, int(offsets[t]), int(counts[t]), int(want[t, 0, 4]), float(x),
                      float(y), got[t, p, 0:4], want[t, p, 0:4])
        rows.append({"kernel": tag, "tile": t, "err": float(err[t, p]), **row})
        print(json.dumps(rows[-1]), flush=True)
    return rows, int((err > tol).sum())


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ratio", default=2.0, type=float)
    parser.add_argument("--tol", default=1e-4, type=float)
    parser.add_argument("--data_device", default=None, type=str)
    args = parser.parse_args(argv)
    dev = backend.resolve_device(args.data_device)
    state, deg, active = fps_test.synthetic_scene(100_000, dev)
    act = renderer.activated(state, deg)
    w, h = fps_test.sweep_size((1920, 1080), args.ratio)
    gx, gy = -(-w // blend.TILE), -(-h // blend.TILE)
    cam = fps_test.sweep_camera(w, h, dev)
    summary = {"card": fps_test.card(dev), "size": [w, h], "tiles": gx * gy}
    rows = []
    with torch.no_grad():
        prep = preprocess(*act, deg, cam, tile=blend.TILE, active_mask=active)
        cap = gm.next_pow2(int(prep.tiles_touched.sum()) + 1)
        si = binning.build_sorted_instances(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, gx, gy, cap, blend.TILE)
        feat, offsets = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK), si.binning.offsets
        counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
        got, want = blend.blend_fwd(feat, offsets, gx, gy), blend.blend_fwd_plain(
            feat, offsets, gx, gy)
        r, summary["blend_fwd_over_tol"] = probe(feat, offsets, counts, got, want, gx,
                                                 "blend_fwd", 1, 0, 0, args.tol)
        rows += r
        summary["instances"] = int(offsets[-1])
        st = amr.fovea_step0(*act, deg, cam, max_instances=cap, active_mask=active)
        counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)
        gated = torch.where(st.tile_levels >= 1, counts, 0)
        kw = dict(offx=blend.ROUND_OFFX[0], offy=blend.ROUND_OFFY[0], counts_override=gated)
        got = blend.blend_round(st.feat_soa, st.offsets, gx, gy, **kw,
                                order=blend.round_order(counts, st.tile_levels),
                                split=amr.ROUND_SPLIT[0])
        want = blend.blend_round_plain(st.feat_soa, st.offsets, gx, gy, **kw)
        r, summary["blend_round_1_over_tol"] = probe(
            st.feat_soa, st.offsets, gated, got, want, gx, "blend_round 1", 2,
            blend.ROUND_OFFX[0], blend.ROUND_OFFY[0], args.tol)
        rows += r
    summary["probed"] = len(rows)
    # a turn explains a pixel when it leaves under 5 % of the difference
    explained = [r["best_turn"] for r in rows
                 if r["best_turn"] and r["best_turn"]["turned_vs_kernel"] < 0.05 * r["err"]]
    summary["explained"] = len(explained)
    summary["explained_turns_an_fma_power_makes"] = sum(
        any(k != t["plain_keeps"] for k in t["fma_keeps"]) for t in explained)
    summary["max_walk_vs_plain"] = max((r["walk_vs_plain"] for r in rows), default=0.0)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
