"""AMR cross-check and visual comparison: the production per-tile
instance counts and refinement levels against a NumPy oracle, then the
full frame, the 5-step AMR frame, their mean difference and the level
overlay.

Port of the repository's root ``AMR_test.py`` (the reference's
``AMR_test.py`` with ``AMR_test_cuda.py:209-218``). The production side is
``amr.fovea_step0`` (preprocess, binning through its pipeline K8, the
percentile levels). The oracle re-derives from the same preprocessed
gaussians, in NumPy, every (gaussian, tile) pair of their tile rects, and
holds three things exactly:

(a) the rect pairs per tile, summed, equal binning's ``num_enumerated``;
(b) the pairs that pass binning's ellipse cull, counted per tile, equal
    the production counts (``offsets[1:] - offsets[:-1]``) and
    ``binning.bin_gaussians``' counts;
(c) NumPy's percentile levels of those kept counts equal ``tile_levels``.

The root script compares the rect counts, taken before the cull, with the
kept ones and the levels of the one with those of the other, so both its
flags read False on every scene; they are returned here too
(``rect_counts_match``, ``rect_levels_match``). The frames go through
``rasterize`` (the binning and tile-compositor kernels) and
``amr.render_amr`` (the binning pipeline, then the four AMR rounds) at
bench's front camera::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.AMR_test --synthetic --width 1920 --height 1088

writes ``full.png``, ``amr.png`` and ``levels_overlay.png`` under
``--out_dir`` and returns the flags, the per-tile counts and levels, the
level shares, the mean |AMR - full| and each frame's milliseconds,
instances and capacity beside the card. Deltas from the root script: the
like-for-like oracle, vectorized; the capacity (``study_lib``; the root
script's CPU frames also cap each tile at 2,048 and 1,024 instances);
``--data_device``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import study_lib, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_image

TILE = amr.TILE
PERCENTILES = (0.25, 0.5, 0.9)
F32 = np.float32


def tile_ellipse_kept_np(tx, ty, cx, cy, ca, cb, cc, thr, tile_px=TILE):
    """NumPy float32 form of binning's exact ellipse-vs-tile cull: True
    where some pixel of tile (tx, ty) can pass the alpha >= 1/255 gate,
    i.e. the minimum over the tile's pixel rect of the conic's quadratic
    form, pre-divided by ``thr``, is at most 1 + 1e-4. Operation for
    operation the production test, so it rounds alike."""
    inv_thr = F32(1.0) / np.maximum(thr, F32(1e-20))
    ca, cb, cc = ca * inv_thr, cb * inv_thr, cc * inv_thr
    x0 = (tx * tile_px).astype(F32) - cx
    y0 = (ty * tile_px).astype(F32) - cy
    x1 = x0 + F32(tile_px - 1)
    y1 = y0 + F32(tile_px - 1)

    def q_at(dx, dy):
        return F32(0.5) * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    cc_s = np.where(cc > F32(1e-12), cc, F32(1e-12))
    ca_s = np.where(ca > F32(1e-12), ca, F32(1e-12))
    dy_l = np.minimum(np.maximum(-cb * x0 / cc_s, y0), y1)
    dy_r = np.minimum(np.maximum(-cb * x1 / cc_s, y0), y1)
    dx_b = np.minimum(np.maximum(-cb * y0 / ca_s, x0), x1)
    dx_t = np.minimum(np.maximum(-cb * y1 / ca_s, x0), x1)
    q_edges = np.minimum(np.minimum(q_at(x0, dy_l), q_at(x1, dy_r)),
                         np.minimum(q_at(dx_b, y0), q_at(dx_t, y1)))
    q_corners = np.minimum(np.minimum(q_at(x0, y0), q_at(x1, y0)),
                           np.minimum(q_at(x0, y1), q_at(x1, y1)))
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    qmin = np.where(inside, F32(0.0), np.minimum(q_edges, q_corners))
    return qmin <= F32(1.0 + 1e-4)


def oracle_counts(prep, grid_x: int, grid_y: int, tile_px: int = TILE):
    """(rect pairs per tile, pairs kept by the ellipse cull per tile), both
    (T,) int64, from a ``projection.Preprocessed``: every gaussian with a
    radius (the reference's oracle) enumerates each tile of its rect
    [rect_min, rect_max), decoded as binning decodes a pair."""
    def host(t):
        return t.detach().cpu().numpy()

    g = np.nonzero(host(prep.radii) > 0)[0]
    rmin, rmax = host(prep.rect_min)[g].astype(np.int64), host(prep.rect_max)[g].astype(np.int64)
    width = rmax[:, 0] - rmin[:, 0]
    area = width * (rmax[:, 1] - rmin[:, 1])
    pair_g = np.repeat(np.arange(g.shape[0]), area)
    r = np.arange(pair_g.shape[0]) - np.repeat(np.cumsum(area) - area, area)
    w = width[pair_g]
    tx, ty = rmin[pair_g, 0] + r % w, rmin[pair_g, 1] + r // w
    tiles = ty * grid_x + tx
    xy, conic, thr = host(prep.means2d)[g], host(prep.conics)[g], host(prep.cull_thr)[g]
    kept = tile_ellipse_kept_np(tx, ty, xy[pair_g, 0], xy[pair_g, 1], conic[pair_g, 0],
                                conic[pair_g, 1], conic[pair_g, 2], thr[pair_g], tile_px)
    n = grid_x * grid_y
    return np.bincount(tiles, minlength=n), np.bincount(tiles[kept], minlength=n)


def percentile_levels(counts: np.ndarray) -> np.ndarray:
    """The reference oracle's levels: 1 plus the number of thresholds (the
    sorted counts at int(q n) for q = 0.25, 0.5, 0.9) a count exceeds."""
    srt = np.sort(counts)
    thr = [srt[min(int(q * len(counts)), len(counts) - 1)] for q in PERCENTILES]
    return 1 + sum((counts > t).astype(np.int64) for t in thr)


def level_overlay(image: np.ndarray, levels: np.ndarray, grid_x: int, grid_y: int):
    """The clipped image with its red channel half the tile's level,
    (level - 1) / 3."""
    h, w = image.shape[1:]
    lvl = levels.reshape(grid_y, grid_x).repeat(TILE, 0).repeat(TILE, 1)[:h, :w]
    overlay = np.clip(image, 0, 1).copy()
    overlay[0] = 0.5 * overlay[0] + 0.5 * ((lvl - 1) / 3.0)
    return overlay


def main(argv=None, device=None):
    parser = study_lib.study_parser("AMR cross-check", "amr_test_out")
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    model, deg, active, cam, bg = study_lib.study_view(args, device)
    dev = bg.device
    gx, gy = -(-cam.width // TILE), -(-cam.height // TILE)

    # production: step 0 at a capacity that holds the frame
    with torch.no_grad():
        _, st, cap = train_lib.render_grown(
            lambda c: (None, amr.fovea_step0(*model, deg, cam, active_mask=active,
                                             max_instances=c)), study_lib.CAPACITY)
        counts_prod = (st.offsets[1:] - st.offsets[:-1]).cpu().numpy().astype(np.int64)
        levels_prod = st.tile_levels.cpu().numpy().astype(np.int64)
        prep = preprocess(*model, deg, cam, tile=TILE, active_mask=active)
        b = binning.bin_gaussians(prep, gx, gy, cap, tile_px=TILE)
        counts_bin = (b.offsets[1:] - b.offsets[:-1]).cpu().numpy().astype(np.int64)
    rect, kept = oracle_counts(prep, gx, gy)
    enumerated = int(st.num_enumerated)
    doc = {
        "counts_match": int(rect.sum()) == enumerated,
        "kept_match": bool(np.array_equal(kept, counts_prod)),
        "levels_match": bool(np.array_equal(percentile_levels(kept), levels_prod)),
        "bin_gaussians_match": bool(np.array_equal(kept, counts_bin)),
        "rect_counts_match": bool(np.array_equal(rect, counts_prod)),
        "rect_levels_match": bool(np.array_equal(percentile_levels(rect), levels_prod)),
        "rect_pairs": int(rect.sum()), "enumerated": enumerated,
        "instances": int(st.num_instances), "capacity": cap,
        "tile_counts": counts_prod.tolist(), "tile_levels": levels_prod.tolist(),
        "level_shares": [float((levels_prod == k).mean()) for k in range(1, 5)],
    }
    print(f"rect pairs over all tiles: {doc['rect_pairs']}, binning enumerated {enumerated}: "
          f"match {doc['counts_match']}")
    print(f"intersection counts match: {doc['kept_match']} (kept by the ellipse cull; "
          f"bin_gaussians: {doc['bin_gaussians_match']})")
    print(f"AMR levels match: {doc['levels_match']}")
    for k, share in enumerate(doc["level_shares"], 1):
        print(f"  level {k}: {share * 100:.1f}% of tiles")

    # renders: the full frame and the 5-step AMR frame
    frames = study_lib.timed_frames({
        "full": study_lib.rasterizer(model, deg, cam, bg, active),
        "amr": lambda c: amr.render_amr(*model, deg, cam, bg, active_mask=active,
                                        max_instances=c)}, dev, cap)
    full, color = frames["full"]["image"], frames["amr"]["image"]
    doc["mean_abs_err"] = float(torch.mean(torch.abs(color - full)))
    doc["frames"] = study_lib.frame_numbers(frames)
    doc.update(width=args.width, height=args.height, **study_lib.device_record(dev))
    full_np = full.cpu().numpy()
    save_image(np.clip(full_np, 0, 1), f"{args.out_dir}/full.png")
    save_image(color.clamp(0, 1).cpu().numpy(), f"{args.out_dir}/amr.png")
    print(f"mean |AMR - full| = {doc['mean_abs_err']:.4f}")
    save_image(level_overlay(full_np, levels_prod, gx, gy), f"{args.out_dir}/levels_overlay.png")
    print(f"wrote {args.out_dir}/{{full,amr,levels_overlay}}.png")
    return doc


if __name__ == "__main__":
    main()
