"""The numerics suite's fixture and checks: the training state one
iteration before a JAX training run collapsed, and the distributions the
collapse went through.

Port of the fixture and checks of the JAX package's hardware suite
(``tests_tpu/test_numerics_tpu.py``) and of
``judge_repro/repro_step3177.py``. The JAX run (seed 0, the synthetic
24-camera scene) lost every parameter to NaN at iteration 3177: its SSIM
blur ran at bf16 precision, the variance cancellation blur(x*x) - mu^2
took the SSIM denominator through zero on that step's frame, the loss
was -inf, and one Adam step made every row NaN. That was just after an
opacity reset (3000) and a prune (3100). ``judge_repro/chkpnt3176.ckpt``
is the state before that step (8,192 slots, 2,175 active, SH degree 3),
read here without JAX by ``checkpoint.load_jax_checkpoint``.

- ``collapse_fixture``: that state, iteration 3177's camera (the
  trainer's camera order replayed) and the ``Scene``;
- ``collapse_steps``, ``mini_schedule``: the step itself, through the
  kernels and through the ``"jnp"`` oracle, and the window's shape
  (opacity reset, 30 steps, a densify step with a screen-size prune at
  the 15th);
- ``degenerate_grads``: rasterize's gradients at post-reset opacity
  (0.01) and near-degenerate scales (5e-7), through the kernels or the
  oracle;
- ``segsum_case`` / ``segsum_oracle``: K4's table route
  (``segsum.segment_sum_bounds``) on a 16-row table against float64
  prefix sums;
- ``reduce_route_records``: the per-instance gradient records that the
  backward reduces, for holding its gather route
  (``blend.segment_reduce_grads``) against the id-order table and K4's
  table route.

Each ``*_check`` function takes its readings, holds them to the limits
below and returns them with ``"failed"``, the names of the checks out of
bounds (empty when all pass); the card tests and the smoke read these.

``main`` runs the repro (``repro``): the step with the kernels held to
the oracle's, whether every active parameter stays finite, the
instances, and the SSIM map's range and distance to float64 on the
frame; run as a module it exits 1 if a check fails::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.numerics \\
        [--scene S] [--data_device cpu]

It runs on the card unless ``device="cpu"`` (or ``--data_device cpu``).
"""

from __future__ import annotations

import argparse
import math
import os
import shutil

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, bench_scene
from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig, OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, segsum
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess_plain
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINT = os.path.join(REPO, "judge_repro", "chkpnt3176.ckpt")
SCENE_CANDIDATES = (os.path.join(REPO, "logs", "train_r05", "scene"),
                    os.path.join(REPO, "logs", "train_r04", "scene"))
FIXTURE_SCENE = os.path.join(REPO, "logs", "numerics_fixture_torch", "scene")
ITERATION = 3177  # the step that collapsed; the checkpoint holds the state before it
CAPACITY = 1 << 19  # instances of the collapse step and the window
WINDOW_STEPS = 30  # the window: reset_opacity, then these steps,
DENSIFY_AFTER = 14  # with a densify step after this one
MAX_SCREEN_SIZE = 20.0  # its screen-size prune (the reference's 20 px)
DENSIFY_SEED = 7  # its split normals' generator
GRAD_CAPACITY = 1 << 16  # instances of the gradient cases
# (opacity, scale or None): post-reset opacity, near-degenerate scales, both
DEGENERATE = ((0.01, None), (0.5, 5e-7), (0.01, 5e-7))
# (columns, segments, seed) of K4's oracle cases; the last is one segment
# across every column
SEGSUM_CASES = ((1 << 14, 300, 0), (200_000, 5_000, 1), (1 << 14, 1, 2))
SEGSUM_ROWS = 16
# the reduction's rows, by the gradient they carry
REDUCE_FIELDS = (("xy", slice(0, 2)), ("conic", slice(2, 5)), ("rgb", slice(5, 8)),
                 ("opacity", slice(8, 9)))

# -- the limits ----------------------------------------------------------------
SSIM_BOUND = 1.0 + 1e-3  # |SSIM| <= 1 by construction, with rounding room
SSIM_MEAN_ATOL = 1e-3  # float32 mean SSIM against float64's, as the JAX suite asks
# and each pixel of its map: the float32 maps sit 5.4e-5 (port) and 5.1e-5
# (JAX) off float64 on the collapse frame's darkest pixels on the CPU
SSIM_PIXEL_ATOL = 1e-4
# the step through the kernels against the oracle's, at the train-step
# test's tolerances (tests/test_torch_train.py): (atol, rtol); the moments'
# atol is a fraction of the field's largest |value|, the parameters' of one
# learning-rate step, where the step's gradient clears 1e-6 of its largest
STEP_LOSS = (0.0, 1e-5)
STEP_IMAGE = (3e-4, 1e-3)
STEP_MU = (1e-4, 5e-3)  # xyz_grad_accum too
STEP_NU = (1e-4, 1e-2)
STEP_PARAM = (0.01, 1e-5)
GRAD_TOL = 1e-3  # kernel gradients against the oracle, of each field's largest |value|
SEGSUM_TOL = 1e-5  # K4 against float64, of each row's absolute sum
ROUTE_TOL = 1e-4  # the two reduction routes, of each field's largest |value|


def camera_index(n_cams: int) -> int:
    """The training camera the trainer draws at ``ITERATION``: it pops
    from ``default_rng(0)`` permutations of the cameras, a new one
    whenever the stack is empty."""
    rng = np.random.default_rng(0)
    stack = []
    for _ in range(ITERATION):
        if not stack:
            stack = list(rng.permutation(n_cams))
        idx = stack.pop()
    return int(idx)


def collapse_fixture(scene_root=None, device=None):
    """(state at 3176, iteration 3177's camera, Scene). The scene is
    ``scene_root``, else the first of ``SCENE_CANDIDATES`` on disk, else
    ``FIXTURE_SCENE``; one that does not exist is written first with
    ``scene_synth.synthesize_dataset`` (seed 3, 24 cameras, 256x256)."""
    dev = backend.resolve_device(device)
    if scene_root is None:
        scene_root = next((p for p in SCENE_CANDIDATES if os.path.isdir(p)), FIXTURE_SCENE)
    if not os.path.isdir(scene_root):
        tmp = scene_root + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        scene_synth.synthesize_dataset(tmp, device=dev)
        os.replace(tmp, scene_root)
    scene = Scene(ModelConfig(source_path=scene_root, model_path="", eval=True,
                              data_device=str(dev)), OptimizationConfig(), seed=0)
    cams = scene.get_train_cameras()
    state, iteration = ckpt.load_jax_checkpoint(CHECKPOINT, device=dev)
    if iteration != ITERATION - 1:
        raise ValueError(f"{CHECKPOINT}: iteration {iteration}, expected {ITERATION - 1}")
    return state, cams[camera_index(len(cams))], scene


def collapse_steps(state, cam, scene) -> dict:
    """{impl: (new state, ``StepAux``)}: one train step (statistics
    accumulated) on ``cam`` from ``state``, on its device, through the
    kernels and through the jnp oracle."""
    dev = state.params.xyz.device
    out = {}
    for impl in ("kernels", "jnp"):
        step = train_lib.make_train_step(
            scene.tx, OptimizationConfig(), max_sh_degree=scene.max_sh_degree, width=cam.width,
            height=cam.height, max_instances=CAPACITY, max_live=CAPACITY, device=dev, impl=impl)
        out[impl] = step(state, *train_lib.camera_arrays(cam.params(dev)), cam.gt(dev),
                         torch.zeros(3, device=dev), True)
    return out


def active_params_finite(state) -> dict:
    """{field: every active row finite}."""
    return {name: bool(torch.isfinite(getattr(state.params, name)[state.active]).all())
            for name in gm.GaussianParams._fields}


def _excess(got, want, atol: float, rtol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within the
    tolerance (0 for empty tensors, inf where a value is not finite)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if not got.numel():
        return 0.0
    e = (got - want).abs() / (atol + rtol * want.abs()).clamp_min(1e-300)
    return float(torch.nan_to_num(e, nan=math.inf).max())


def step_check(state, runs, tx) -> dict:
    """``collapse_steps``' two steps from ``state`` with the optimizer
    ``tx`` (the scene's): each healthy (finite loss, instances without
    overflow, every active parameter finite), and the kernels' against the
    oracle's at the train-step test's limits (``STEP_*``): loss, image,
    xyz_grad_accum, both Adam moments and the parameters, as each
    quantity's excess over its tolerance (within at <= 1); the active set,
    denom, max_radii2d, the instances and the Adam count exactly."""
    (ks, ka), (js, ja) = runs["kernels"], runs["jnp"]
    rows, failed = {}, []
    for impl, (new, aux) in runs.items():
        finite = active_params_finite(new)
        rows[impl] = {"loss": float(aux.loss), "psnr": float(aux.psnr),
                      "num_instances": int(aux.num_instances), "overflow": bool(aux.overflow),
                      "nan_xyz_elems": int(torch.isnan(new.params.xyz).sum()),
                      "active_params_finite": all(finite.values())}
        r = rows[impl]
        if not (math.isfinite(r["loss"]) and r["num_instances"] > 0 and not r["overflow"]
                and r["active_params_finite"]):
            failed.append(f"{impl}.healthy")
    acc_max = float(js.xyz_grad_accum.abs().max())
    excess = {"loss": _excess(ka.loss, ja.loss, *STEP_LOSS),
              "image": _excess(ka.image, ja.image, *STEP_IMAGE),
              "xyz_grad_accum": _excess(ks.xyz_grad_accum, js.xyz_grad_accum,
                                        STEP_MU[0] * acc_max, STEP_MU[1])}
    count = state.opt_state.count
    for name in gm.GaussianParams._fields:
        mu, jmu = getattr(ks.opt_state.mu, name), getattr(js.opt_state.mu, name)
        nu, jnu = getattr(ks.opt_state.nu, name), getattr(js.opt_state.nu, name)
        excess[f"mu.{name}"] = _excess(mu, jmu, STEP_MU[0] * float(jmu.abs().max()), STEP_MU[1])
        excess[f"nu.{name}"] = _excess(nu, jnu, STEP_NU[0] * float(jnu.abs().max()), STEP_NU[1])
        # the step's gradient, from the oracle's moments: g = (mu_t - 0.9 mu_{t-1}) / 0.1
        g = (jmu - 0.9 * getattr(state.opt_state.mu, name)) / 0.1
        sure = (g.abs() > 1e-6 * g.abs().max()) & js.active.reshape(-1, *[1] * (g.dim() - 1))
        if not bool(sure.any()):
            failed.append(f"params.{name}.no_gradient")
        p, jp = getattr(ks.params, name), getattr(js.params, name)
        excess[f"params.{name}"] = _excess(p[sure], jp[sure],
                                           STEP_PARAM[0] * tx.lr(name, count),
                                           STEP_PARAM[1])
    exact = {"active": bool(torch.equal(ks.active, js.active)),
             "denom": bool(torch.equal(ks.denom, js.denom)),
             "max_radii2d": bool(torch.equal(ks.max_radii2d, js.max_radii2d)),
             "num_instances": int(ka.num_instances) == int(ja.num_instances),
             "count": ks.opt_state.count == js.opt_state.count == count + 1}
    failed += [k for k, v in excess.items() if not v <= 1.0]
    failed += [k for k, v in exact.items() if not v]
    return {"steps": rows, "excess": excess, "exact": exact, "failed": failed}


def ssim_check(img: torch.Tensor, gt: torch.Tensor) -> dict:
    """SSIM of (N, C, H, W) float32 images, its map and its mean, against
    float64 SSIM of the same images: the map's range, whether it is
    finite, the means and their difference, and the map's largest
    per-pixel difference; fails "finite", "bounded" (``SSIM_BOUND``),
    "mean_f64" (``SSIM_MEAN_ATOL``) or "pixel_f64" (``SSIM_PIXEL_ATOL``)."""
    m = ssim_ops.ssim_map(img, gt)
    m64 = ssim_ops.ssim_map(img.double(), gt.double())
    r = {"min": float(m.min()), "max": float(m.max()), "finite": bool(torch.isfinite(m).all()),
         "mean": float(m.mean()), "mean_f64": float(m64.mean())}
    r["mean_diff"] = abs(r["mean"] - r["mean_f64"])
    r["pixel_diff"] = float(torch.nan_to_num((m.double() - m64).abs(), nan=math.inf).max())
    r["failed"] = [name for name, ok in (
        ("finite", r["finite"]), ("bounded", max(abs(r["min"]), abs(r["max"])) <= SSIM_BOUND),
        ("mean_f64", r["mean_diff"] < SSIM_MEAN_ATOL),
        ("pixel_f64", r["pixel_diff"] <= SSIM_PIXEL_ATOL)) if not ok]
    return r


def dark_flat_frames(device=None):
    """(1, 3, 256, 256) float32 frames near black: 0.02 plus uniform noise
    of 1e-3 from ``default_rng(0)``, against a flat 0.019."""
    dev = backend.resolve_device(device)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(0.02 + 1e-3 * rng.uniform(size=(1, 3, 256, 256))).float().to(dev)
    return img, torch.full_like(img, 0.019)


def mini_schedule(state, scene) -> dict:
    """The collapse window's shape from ``state``: ``reset_opacity``, then
    ``WINDOW_STEPS`` train steps over the training cameras in order, with
    a densify step after step ``DENSIFY_AFTER``. Returns the losses, the
    active count, whether every active parameter is finite, the densify
    counts, the final state, and "failed": "losses" if a loss is not
    finite, "alive" if no gaussian is left, "finite" if an active
    parameter is not."""
    dev = state.params.xyz.device
    opt = OptimizationConfig()
    cams = scene.get_train_cameras()
    step = train_lib.make_train_step(
        scene.tx, opt, max_sh_degree=scene.max_sh_degree, width=cams[0].width,
        height=cams[0].height, max_instances=CAPACITY, max_live=CAPACITY, device=dev)
    generator = torch.Generator(device=dev).manual_seed(DENSIFY_SEED)
    bg = torch.zeros(3, device=dev)
    state = gm.reset_opacity(state)
    losses, info = [], {}
    for i in range(WINDOW_STEPS):
        c = cams[i % len(cams)]
        state, aux = step(state, *train_lib.camera_arrays(c.params(dev)), c.gt(dev), bg, True)
        losses.append(float(aux.loss))
        if i == DENSIFY_AFTER:
            state, info = train_lib.densify_step(state, generator, opt, scene.cameras_extent,
                                                 MAX_SCREEN_SIZE)
    out = {"losses": losses, "active": int(gm.num_active(state)),
           "finite": active_params_finite(state),
           "densify": {k: int(v) for k, v in info.items()}, "state": state}
    out["failed"] = [name for name, ok in (
        ("losses", all(math.isfinite(x) for x in losses)), ("alive", out["active"] > 0),
        ("finite", all(out["finite"].values()))) if not ok]
    return out


def degenerate_inputs(opacity: float, scale, device=None):
    """512 random gaussians (seed 11, SH degree 1) with every opacity set
    to ``opacity`` and, unless None, every scale to ``scale``; a 128x128
    camera at z = -5; a target uniform in [0, 1) from ``default_rng(3)``.
    Returns ((means, scales, quats, opacities, sh), camera, target) on
    ``device``."""
    dev = backend.resolve_device(device)
    means, scales, quats, op, sh = bench_scene.make_random_gaussians(512, seed=11, sh_degree=1)
    op = np.full_like(op, opacity)
    if scale is not None:
        scales = np.full_like(scales, scale)
    target = np.random.default_rng(3).uniform(size=(3, 128, 128)).astype(np.float32)
    g = tuple(torch.from_numpy(a).to(dev) for a in (means, scales, quats, op, sh))
    return g, bench_scene.make_camera(128, 128, device=dev), torch.from_numpy(target).to(dev)


def degenerate_grads(opacity: float, scale, impl: str = "kernels", device=None):
    """Gradients of mean |color - target| with respect to the means, the
    scales and the opacities on ``degenerate_inputs(opacity, scale)``,
    through ``impl``."""
    (means, scales, quats, op, sh), cam, target = degenerate_inputs(opacity, scale, device)
    leaves = [t.detach().clone().requires_grad_(True) for t in (means, scales, op)]
    out = rast.rasterize(leaves[0], leaves[1], quats, leaves[2], sh, cam,
                         torch.zeros(3, device=means.device), sh_degree=1, impl=impl,
                         max_instances=GRAD_CAPACITY, max_live=GRAD_CAPACITY)
    loss = torch.mean(torch.abs(out.color - target))
    return torch.autograd.grad(loss, leaves)


def cull_terms(opacity: float, scale, device=None) -> dict:
    """What the compositors' per-warp cull (``blend.gate_box``, stage.cuh's
    ``gate_warps``) sees on ``degenerate_inputs(opacity, scale)``: its
    tau = ln(opacity) + ln 255 + 1e-4 (no cull at or below 0), the
    largest conditioning kappa = ac / det of a visible conic (no cull
    above 1e5), and the largest screen radius."""
    (means, scales, quats, op, sh), cam, _ = degenerate_inputs(opacity, scale, device)
    with torch.no_grad():  # the plain record, as degenerate_grads' differentiable call has it
        prep = preprocess_plain(means, scales, quats, op, sh, 1, cam)
    seen = prep.radii > 0
    a, b, c = (prep.conics[seen, i].double() for i in range(3))
    tau = float(torch.log(prep.opacities[seen].double()).max()) - math.log(blend.ALPHA_MIN) + 1e-4
    return {"tau": tau, "kappa_max": float((a * c / (a * c - b * b)).max()),
            "radius_max": int(prep.radii.max()), "visible": int(seen.sum())}


def grad_error(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def degenerate_check(opacity: float, scale, device=None) -> dict:
    """``degenerate_grads`` through the kernels against the oracle: each
    field's ``grad_error`` (fails the field's name past ``GRAD_TOL``, or
    where either side is not finite or the oracle's is all zero), and
    what the cull sees (``cull_terms``)."""
    got = degenerate_grads(opacity, scale, "kernels", device)
    want = degenerate_grads(opacity, scale, "jnp", device)
    err, failed = {}, []
    for name, a, b in zip(("means", "scales", "opacity"), got, want):
        err[name] = grad_error(a, b)
        ok = bool(torch.isfinite(a).all() and torch.isfinite(b).all() and b.abs().max() > 0)
        if not (ok and err[name] <= GRAD_TOL):
            failed.append(name)
    return {"opacity": opacity, "scale": scale, "err": err,
            "cull": cull_terms(opacity, scale, device), "failed": failed}


def segsum_case(s: int, n: int, seed: int):
    """A (16, s) standard normal float32 table and (n+1,) int32 bounds
    cutting [0, s] into n segments at sorted uniform cuts, as numpy."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((SEGSUM_ROWS, s)).astype(np.float32)
    cuts = np.sort(rng.integers(0, s + 1, n - 1)) if n > 1 else np.array([], np.int64)
    return table, np.concatenate([[0], cuts, [s]]).astype(np.int32)


def segsum_oracle(table: np.ndarray, bounds: np.ndarray):
    """The segment sums in float64 (prefix sums differenced at the bounds)
    and each row's absolute sum, (R, 1)."""
    t64 = table.astype(np.float64)
    csum = np.concatenate([np.zeros((t64.shape[0], 1)), np.cumsum(t64, axis=1)], axis=1)
    return csum[:, bounds[1:]] - csum[:, bounds[:-1]], np.abs(t64).sum(axis=1, keepdims=True)


def segsum_error(out: np.ndarray, table: np.ndarray, bounds: np.ndarray) -> float:
    """max over rows of max |out - oracle| over the row's absolute sum."""
    want, row_abs = segsum_oracle(table, bounds)
    return float(np.nan_to_num(np.abs(out.astype(np.float64) - want) / (row_abs + 1e-12),
                               nan=np.inf).max())


def segsum_check(s: int, n: int, seed: int, device=None) -> dict:
    """K4's table route (``segsum.segment_sum_bounds``) on
    ``segsum_case(s, n, seed)`` against float64: its ``segsum_error``,
    failing "err" past ``SEGSUM_TOL``."""
    dev = backend.resolve_device(device)
    table, bounds = segsum_case(s, n, seed)
    out = segsum.segment_sum_bounds(torch.from_numpy(table).to(dev),
                                    torch.from_numpy(bounds).to(dev)).cpu().numpy()
    err = segsum_error(out, table, bounds) if out.shape == (SEGSUM_ROWS, n) else math.inf
    return {"columns": s, "segments": n, "rows": SEGSUM_ROWS, "err": err,
            "failed": [] if err <= SEGSUM_TOL else ["err"]}


def reduce_route_records(gaussians, cam, target, sh_degree: int):
    """What rasterize's backward reduces for the gradients of mean |color
    - target|: K3's per-instance gradient records (``blend.blend_bwd`` on
    the cotangent of K2's tiles) and the binning's id order, as
    ``blend.segment_reduce_grads`` takes them: (dfeat, id_pos,
    gauss_start, gauss_count, max_instances)."""
    means, scales, quats, op, sh = gaussians
    gx, gy = -(-cam.width // blend.TILE), -(-cam.height // blend.TILE)
    with torch.no_grad():
        # the train step's record: its preprocess is the differentiable plain one
        prep = preprocess_plain(means, scales, quats, op, sh, sh_degree, cam, tile=blend.TILE)
        si = binning.build_sorted_instances(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, gx, gy, GRAD_CAPACITY,
            tile_px=blend.TILE, max_live=GRAD_CAPACITY)
        b = si.binning
        feat = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)
        tiles = blend.blend_fwd(feat, b.offsets, gx, gy)
    leaf = tiles.detach().requires_grad_(True)
    color, _ = blend.assemble_tiles(leaf, gx, gy, blend.TILE, torch.zeros(3, device=means.device))
    loss = torch.mean(torch.abs(color[:, :cam.height, :cam.width] - target))
    (cot,) = torch.autograd.grad(loss, leaf)
    dfeat = blend.blend_bwd(feat, b.offsets, tiles, cot.contiguous(), gx, gy)
    return dfeat, si.id_pos, b.gauss_start, b.gauss_count, GRAD_CAPACITY


def route_check(device=None) -> dict:
    """The backward's per-gaussian sums of one set of
    ``reduce_route_records`` (1,500 random gaussians, seed 9, SH degree 1;
    a 128x128 camera at z = -5; a target from ``default_rng(5)``) through
    the step's gather route (``blend.segment_reduce_grads``) and through
    the id-order table and ``segsum.segment_sum_bounds``: each field's
    ``grad_error``, failing the field past ``ROUTE_TOL`` (or where the
    table route's sums are all zero)."""
    dev = backend.resolve_device(device)
    g = bench_scene.make_random_gaussians(1500, seed=9, sh_degree=1)
    target = np.random.default_rng(5).uniform(size=(3, 128, 128)).astype(np.float32)
    red = reduce_route_records(tuple(torch.from_numpy(a).to(dev) for a in g),
                               bench_scene.make_camera(128, 128, device=dev),
                               torch.from_numpy(target).to(dev), 1)
    gather = blend.segment_reduce_grads(*red)
    table = segsum.segment_sum_bounds(*blend.id_order_table(*red))
    err = {name: grad_error(gather[rows], table[rows]) for name, rows in REDUCE_FIELDS}
    failed = [name for name, rows in REDUCE_FIELDS
              if not (float(table[rows].abs().max()) > 0 and err[name] <= ROUTE_TOL)]
    return {"gaussians": int(gather.shape[1]), "err": err, "failed": failed}


def repro(state, cam, scene) -> dict:
    """``judge_repro/repro_step3177.py`` on the fixture: prints and
    returns the camera, both steps' ``step_check``, the kernels' frame
    (clipped to [0, 1], (1, 3, H, W)) and its ``ssim_check``; "failed"
    joins theirs."""
    dev = state.params.xyz.device
    idx = camera_index(len(scene.get_train_cameras()))
    print(f"iter {ITERATION} camera idx: {idx} {cam.image_name}")
    runs = collapse_steps(state, cam, scene)
    step = step_check(state, runs, scene.tx)
    for impl, row in step["steps"].items():
        print(f"impl={impl}: loss={row['loss']:.5f} psnr={row['psnr']:.2f} "
              f"ninst={row['num_instances']} nan_xyz_elems={row['nan_xyz_elems']} "
              f"overflow={row['overflow']} active params finite={row['active_params_finite']}")
    worst = max(step["excess"], key=step["excess"].get)
    print(f"kernels vs jnp: largest excess over tolerance {step['excess'][worst]:.3g} "
          f"({worst}); exact {step['exact']}")
    frame = torch.clamp(runs["kernels"][1].image, 0.0, 1.0)[None]
    ssim = ssim_check(frame, cam.gt(dev)[None])
    print(f"ssim map: min {ssim['min']:.6f} max {ssim['max']:.6f} finite {ssim['finite']}; "
          f"mean {ssim['mean']!r} float64 {ssim['mean_f64']!r}, per pixel within "
          f"{ssim['pixel_diff']:.3g}")
    failed = step["failed"] + [f"ssim.{f}" for f in ssim["failed"]]
    print(f"failed: {failed}")
    return {"camera": cam.image_name, "camera_index": idx, "active": int(state.active.sum()),
            "slots": int(state.active.shape[0]), "step": step, "frame": frame, "ssim": ssim,
            "failed": failed}


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser(description="The step that collapsed a JAX training run "
                                 "(iteration 3177), from the state before it.")
    ap.add_argument("--scene", default=None, help="the scene (written there if missing)")
    ap.add_argument("--data_device", default=None, type=str, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = backend.resolve_device(device if device is not None else args.data_device)
    return repro(*collapse_fixture(args.scene, dev))


if __name__ == "__main__":
    raise SystemExit(1 if main()["failed"] else 0)
