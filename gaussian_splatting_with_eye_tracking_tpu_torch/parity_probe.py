"""Parity probe: the kernels against the ``impl="jnp"`` oracles on one device.

Port of the repository's root ``parity_probe.py``, extended to every
oracle::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.parity_probe [--data_device cpu]

On the JAX probe's inputs (a 256x256 camera at z = -5,
``make_random_gaussians(4000, seed=0, sh_degree=2)``, background (0.2,
0.1, 0.3), ``max_instances`` 2^15, ``max_per_tile`` 1024) it compares:

- ``rasterize``'s colour, ``"kernels"`` against ``"jnp"``, and the
  integer counters of both;
- the gradients of mean(color^2) + 0.1 mean(final_t) with respect to the
  five inputs: max |diff| and that over the ``"jnp"`` tensor's largest;
- ``binning.bin_gaussians`` against ``build_sorted_instances``, exactly,
  on num_instances, num_enumerated, overflow, offsets and
  ``gauss_id[:num_instances]``;
- ``render_naive(exact_stop=False)`` against ``render_tiles_jnp``;
- the 5-step AMR frame, ``"kernels"`` against ``"jnp"``;
- ``mean_sq_dist_3nn_blocked`` against ``mean_sq_dist_3nn`` (cKDTree) on
  50,000 uniform points, and on 5,000 points each taken twice, where the
  documented delta must appear: cKDTree counts the twin at distance 0
  (2 d1 / 3), the blocked oracle skips it ((2 d1 + d2) / 3).

It fails on a forward colour above 1e-3, a gradient's relative difference
at or above 2e-2 (the JAX probe's gate: the kernels stop a tile per
128-instance chunk, the oracle never), or any difference in the integer
counters. The dense oracle holds (tiles, pixels, instances) tensors for
autograd: keep the image this small. Runs on CUDA unless told otherwise.
"""

from __future__ import annotations

import json
from argparse import ArgumentParser

import numpy as np
import torch
from scipy.spatial import cKDTree

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test
from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene as bs
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning, blend, knn
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import reference, tile_blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess

FWD_TOL = 1e-3
GRAD_REL_TOL = 2e-2  # the root parity_probe.py's gate
DUP_RTOL = 1e-4  # the 3-NN's duplicate delta against its closed form
KNN_RTOL = 1e-5  # blocked (float32) against cKDTree (float64)
BG = (0.2, 0.1, 0.3)
GRAD_NAMES = ("means", "scales", "quats", "opacities", "sh")
COUNTERS = ("num_instances", "num_enumerated", "overflow")


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _grads(scene, cam, bg, impl, kw):
    inputs = [x.detach().clone().requires_grad_(True) for x in scene]
    out = rast.rasterize(*inputs, cam, bg, impl=impl, **kw)
    loss = torch.mean(out.color ** 2) + 0.1 * torch.mean(out.final_t)
    return torch.autograd.grad(loss, inputs)


def knn_check(dev, n_points: int, n_dup: int, seed: int = 0) -> dict:
    """The blocked 3-NN against cKDTree on ``n_points`` uniform points and
    on ``n_dup`` points each taken twice."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (n_points, 3)).astype(np.float32)
    got = knn.mean_sq_dist_3nn_blocked(torch.from_numpy(pts).to(dev)).cpu().numpy()
    want = knn.mean_sq_dist_3nn(pts)
    uniform_rel = float(np.max(np.abs(got - want) / want))

    base = rng.uniform(-1.0, 1.0, (n_dup, 3)).astype(np.float32)
    twice = np.concatenate([base, base])
    got_d = knn.mean_sq_dist_3nn_blocked(torch.from_numpy(twice).to(dev)).cpu().numpy()
    tree_d = knn.mean_sq_dist_3nn(twice)
    d, _ = cKDTree(base.astype(np.float64)).query(base, k=3)  # self, nearest, second
    d1, d2 = d[:, 1] ** 2, d[:, 2] ** 2
    blocked_rel = np.abs(got_d[:n_dup] - (2 * d1 + d2) / 3) / ((2 * d1 + d2) / 3)
    tree_rel = np.abs(tree_d[:n_dup] - 2 * d1 / 3) / (2 * d1 / 3)
    return {"uniform_points": n_points, "uniform_max_rel": uniform_rel,
            "duplicated_points": n_dup, "dup_blocked_vs_closed_form_rel": float(blocked_rel.max()),
            "dup_ckdtree_vs_closed_form_rel": float(tree_rel.max()),
            "dup_blocked_over_ckdtree_min": float(np.min(got_d / tree_d)),
            "dup_twins_equal": bool(np.array_equal(got_d[:n_dup], got_d[n_dup:]))}


def run(device=None, width: int = 256, height: int = 256, n: int = 4000, sh_degree: int = 2,
        max_instances: int = 1 << 15, max_per_tile: int = 1024, knn_points: int = 50_000,
        knn_dup: int = 5_000) -> dict:
    """Every comparison above; returns the numbers and ``ok`` (all gates
    met) with ``failed`` naming the gates that were not."""
    dev = backend.resolve_device(device)
    cam = bs.make_camera(width, height, device=dev)
    scene = [torch.from_numpy(a).to(dev)
             for a in bs.make_random_gaussians(n, seed=0, sh_degree=sh_degree)]
    bg = torch.tensor(BG, device=dev)
    kw = dict(sh_degree=sh_degree, max_instances=max_instances, max_per_tile=max_per_tile)
    out = {"width": width, "height": height, "gaussians": n, "max_instances": max_instances,
           "max_per_tile": max_per_tile}
    failed = []

    with torch.no_grad():
        fk = rast.rasterize(*scene, cam, bg, impl="kernels", **kw)
        fj = rast.rasterize(*scene, cam, bg, impl="jnp", **kw)
    out["fwd_max_abs"] = _max_abs(fk.color, fj.color)
    out["final_t_max_abs"] = _max_abs(fk.final_t, fj.final_t)
    out["counters"] = {k: [int(getattr(fk, k)), int(getattr(fj, k))] for k in COUNTERS}
    if not out["fwd_max_abs"] <= FWD_TOL:
        failed.append("forward colour")
    if any(a != b for a, b in out["counters"].values()) or not torch.equal(fk.radii, fj.radii):
        failed.append("rasterize counters")
    if bool(fj.overflow):
        failed.append("instance capacity overflow")

    gk, gj = _grads(scene, cam, bg, "kernels", kw), _grads(scene, cam, bg, "jnp", kw)
    out["grads"] = {}
    for name, a, b in zip(GRAD_NAMES, gk, gj):
        d = _max_abs(a, b)
        rel = d / (float(b.abs().max()) + 1e-12)
        out["grads"][name] = {"max_abs": d, "rel": rel}
        if not rel < GRAD_REL_TOL:
            failed.append(f"gradient {name}")

    with torch.no_grad():
        prep = preprocess(*scene, sh_degree, cam, tile=blend.TILE)
        gx, gy = -(-width // blend.TILE), -(-height // blend.TILE)
        b = binning.bin_gaussians(prep, gx, gy, max_instances, tile_px=blend.TILE)
        si = binning.build_sorted_instances(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, gx, gy, max_instances,
            blend.TILE)
        live = int(b.num_instances)
        same = {k: bool(torch.equal(getattr(b, k), getattr(si.binning, k)))
                for k in (*COUNTERS, "offsets")}
        same["gauss_id"] = bool(torch.equal(b.gauss_id[:live], si.binning.gauss_id[:live]))
        out["binning_equal"] = same
        out["binning_instances"] = live
        if not all(same.values()):
            failed.append("bin_gaussians vs build_sorted_instances")

        naive = reference.render_naive(prep, width, height, bg, exact_stop=False)
        tiles, _ = tile_blend.render_tiles_jnp(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, b.gauss_id, b.offsets, gx, gy,
            blend.TILE, bg, max_per_tile=max_per_tile)
        out["naive_vs_tiles_max_abs"] = _max_abs(naive.color, tiles[:, :height, :width])
        if not out["naive_vs_tiles_max_abs"] <= FWD_TOL:
            failed.append("render_naive vs render_tiles_jnp")

        frames = {impl: amr.render_amr(*scene, sh_degree, cam, bg, max_instances=max_instances,
                                       impl=impl, max_per_tile=max_per_tile)
                  for impl in ("kernels", "jnp")}
        out["amr_max_abs"] = _max_abs(frames["kernels"][0], frames["jnp"][0])
        out["amr_levels"] = torch.bincount(frames["kernels"][1].tile_levels,
                                           minlength=5)[1:].tolist()
        if not out["amr_max_abs"] <= FWD_TOL:
            failed.append("5-step AMR frame")

    out["knn"] = k = knn_check(dev, knn_points, knn_dup)
    if not (k["uniform_max_rel"] <= KNN_RTOL and k["dup_blocked_vs_closed_form_rel"] <= DUP_RTOL
            and k["dup_ckdtree_vs_closed_form_rel"] <= DUP_RTOL
            and k["dup_blocked_over_ckdtree_min"] > 1.0 and k["dup_twins_equal"]):
        failed.append("3-NN")
    out["failed"] = failed
    out["ok"] = not failed
    return out


def main(argv=None) -> dict:
    """Print every number and PARITY OK / FAIL; return ``run``'s dict.
    Exits non-zero (SystemExit) when a gate fails."""
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_device", default=None, type=str, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = backend.resolve_device(args.data_device)
    if dev.type == "cuda":
        print(fps_test.card(dev), flush=True)
    res = run(dev)
    print(f"fwd max abs diff: {res['fwd_max_abs']:.3e} (final_t {res['final_t_max_abs']:.3e}); "
          f"counters kernels/jnp {res['counters']}")
    for name, g in res["grads"].items():
        print(f"grad {name:9s} max abs diff {g['max_abs']:.3e}  rel {g['rel']:.3e}")
    print(f"bin_gaussians vs build_sorted_instances ({res['binning_instances']} instances): "
          f"{res['binning_equal']}")
    print(f"render_naive(exact_stop=False) vs render_tiles_jnp: "
          f"{res['naive_vs_tiles_max_abs']:.3e}")
    print(f"5-step AMR frame kernels vs jnp: {res['amr_max_abs']:.3e} (levels "
          f"{res['amr_levels']})")
    print(f"3-NN: {json.dumps(res['knn'])}")
    print("PARITY OK" if res["ok"] else f"PARITY FAIL: {res['failed']}", flush=True)
    if not res["ok"]:
        raise SystemExit(f"parity probe failed: {res['failed']}")
    return res


if __name__ == "__main__":
    main()
