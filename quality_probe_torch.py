#!/usr/bin/env python3
"""Where does the port's training quality part from the JAX package's?
One shared mid-run training state, each package's train step on it, on
the CPU.

The state is the port's own checkpoint of a training run on
``train_regression_r04.synthesize_dataset``'s scene (24 cameras at
256x256; the repository generates it). Make it on the card (about a
minute):

    python -c "from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth; \
        scene_synth.synthesize_dataset('SCENE')"
    python -m gaussian_splatting_with_eye_tracking_tpu_torch.train -s SCENE -m MODEL \
        --iterations 2000 --checkpoint_iterations 2000 --eval --disable_viewer

then, on the CPU (JAX on the CPU, its Pallas kernels in interpret mode;
the port's plain kernel versions):

    JAX_PLATFORMS=cpu python quality_probe_torch.py --scene SCENE \
        --checkpoint MODEL/chkpnt2000.ckpt [--seed 0] [--out FILE.json]

``--checkpoint`` also takes a directory of the state's active rows
(``load_state``), a third of the checkpoint's size. At 37.8k gaussians and
256x256 a view takes ~30 s (the port's plain step 17-28 s, JAX's 6-10 s
after its first, compiling, step): ~11 minutes for the 21 views.

What it does, from that one state (``state_to_jax`` carries the port's
state, Adam moments included, into a JAX ``GaussianModelState``):

1. for each training view, one step of each package's ``make_train_step``
   from the same state (nothing carried over between views), compared:
   the loss, L1 and SSIM term; the densify statistics' increments per
   gaussian (|dL/d means2d| added to ``xyz_grad_accum``, the ``denom`` and
   visibility masks, ``max_radii2d``); each parameter group's gradient
   (recovered from Adam's first moment: g = (mu' - 0.9 mu) / 0.1, the same
   arithmetic on both sides, in float64);
2. the camera draws of the trainer's next densify interval (its
   ``np.random.default_rng(seed)`` permutations) with the parameters
   frozen: each package's summed increments, and the gaussians that clear
   ``densify_grad_threshold`` as clone and as split candidates;
3. the split draw: the port's ``train_lib.densify_step`` on the state with
   the port's replayed statistics, twice from one generator (fresh (2, C, 3)
   normals each call; the split children's offsets, taken back into each
   parent's frame, against N(0, 1)); and ``densify_and_prune`` of both
   packages with JAX's own normals (the children land on the same points).

Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu import train_lib as jtrain
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import CameraParams as JCam
from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib as ttrain
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig, OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as ttf
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.scene import Scene

FIELDS = tgm.GaussianParams._fields
B1 = 0.9  # Adam's first-moment decay, both packages
MAX_INSTANCES = 1 << 19  # instance capacity of the steps: ~61k instances a 256x256 view


def state_to_jax(state: tgm.GaussianModelState, tx) -> jgm.GaussianModelState:
    """The port's training state (any device) as a JAX
    ``GaussianModelState`` whose optax state is ``tx``'s
    (``jgm.make_optimizer``), with the port's Adam step count and moments
    in every group: the mirror of the port's ``state_from_jax``."""
    def a(x):
        return jnp.asarray(x.detach().cpu().numpy())

    params = jgm.GaussianParams(**{k: a(getattr(state.params, k)) for k in FIELDS})
    opt_state = tx.init(params)
    if state.opt_state is not None:
        count = jnp.asarray(state.opt_state.count, jnp.int32)
        inner = dict(opt_state.inner_states)
        for name in FIELDS:
            masked = inner[name]
            adam, *rest = masked.inner_state
            adam = adam._replace(
                count=count,
                mu=adam.mu._replace(**{name: a(getattr(state.opt_state.mu, name))}),
                nu=adam.nu._replace(**{name: a(getattr(state.opt_state.nu, name))}))
            rest = [r._replace(count=count) if "count" in getattr(r, "_fields", ()) else r
                    for r in rest]
            inner[name] = masked._replace(inner_state=(adam, *rest))
        opt_state = opt_state._replace(inner_states=inner)
    return jgm.GaussianModelState(
        params=params, active=a(state.active), max_radii2d=a(state.max_radii2d),
        xyz_grad_accum=a(state.xyz_grad_accum), denom=a(state.denom),
        opt_state=opt_state, sh_degree=jnp.int32(state.sh_degree))


def load_state(path: str):
    """(state, iteration) on the CPU from a ``.ckpt`` checkpoint of the
    port, or from a directory holding its active rows as numpy files
    (``meta.npy``: iteration, SH degree, Adam count, capacity;
    ``active_idx.npy``; ``params.npz``, ``mu.npz``, ``nu.npz`` by field):
    the rows are put back at their slots of the full capacity, inactive
    slots inert (zero moments, log-scale -10, identity rotation). The
    densification statistics are zero, as after a densify step."""
    if path.endswith(".ckpt"):
        return ckpt.load_checkpoint(path, device="cpu")
    iteration, sh_degree, count, cap = (int(x) for x in np.load(f"{path}/meta.npy"))
    idx = torch.from_numpy(np.load(f"{path}/active_idx.npy").astype(np.int64))
    fills = {"scaling": -10.0}

    def rows(name, part):
        src = np.load(f"{path}/{part}.npz")[name]
        out = torch.full((cap,) + src.shape[1:], fills.get(name, 0.0) if part == "params"
                         else 0.0, dtype=torch.float32)
        if part == "params" and name == "rotation":
            out[:, 0] = 1.0
        out[idx] = torch.from_numpy(src)
        return out

    params, mu, nu = (tgm.GaussianParams(**{k: rows(k, part) for k in FIELDS})
                      for part in ("params", "mu", "nu"))
    active = torch.zeros(cap, dtype=torch.bool)
    active[idx] = True
    zeros = torch.zeros(cap)
    return tgm.GaussianModelState(
        params=params, active=active, max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(), opt_state=tgm.AdamState(count=count, mu=mu, nu=nu),
        sh_degree=sh_degree), iteration


def camera_draws(n_cams: int, seed: int, first: int, last: int) -> list[int]:
    """The training-camera indices the trainer draws at iterations
    first..last (its stack of ``default_rng(seed)`` permutations, popped
    from the end)."""
    rng = np.random.default_rng(seed)
    stack, out = [], []
    for it in range(1, last + 1):
        if not stack:
            stack = list(rng.permutation(n_cams))
        idx = stack.pop()
        if it >= first:
            out.append(int(idx))
    return out


def jax_camera(cp) -> JCam:
    return JCam(viewmatrix=jnp.asarray(cp.viewmatrix.numpy()),
                projmatrix=jnp.asarray(cp.projmatrix.numpy()),
                campos=jnp.asarray(cp.campos.numpy()), tan_fovx=float(cp.tan_fovx),
                tan_fovy=float(cp.tan_fovy), width=cp.width, height=cp.height)


def adam_grads(before, after):
    """{group: float64 gradient} from the first moments before and after
    one step: g = (mu' - b1 mu) / (1 - b1)."""
    return {k: (np.asarray(after[k], np.float64) - B1 * np.asarray(before[k], np.float64))
            / (1.0 - B1) for k in FIELDS}


def compare_view(tstep, jstep, state, jstate, cam, lam):
    """One step of each package from the same state on one view: the
    record of the comparison and each side's statistics' increments
    (|dL/d means2d| added to ``xyz_grad_accum``, ``denom``)."""
    cp, gt = cam.params("cpu"), cam.gt("cpu")
    bg = np.zeros(3, np.float32)
    t0 = time.perf_counter()
    ts, ta = tstep(state, *ttrain.camera_arrays(cp), gt, torch.from_numpy(bg), True)
    t_torch = time.perf_counter() - t0
    t0 = time.perf_counter()
    js, ja = jstep(jstate, *jtrain.camera_arrays(jax_camera(cp)), jnp.asarray(gt.numpy()),
                   jnp.asarray(bg), True)
    jax.block_until_ready(js)
    t_jax = time.perf_counter() - t0
    losses = {}
    for name, aux in (("torch", ta), ("jax", ja)):
        loss, l1 = float(aux.loss), float(aux.l1)
        losses[name] = {"loss": loss, "l1": l1, "ssim_term": (loss - (1.0 - lam) * l1) / lam}
    t_inc = ts.xyz_grad_accum.numpy() - state.xyz_grad_accum.numpy()
    j_inc = np.asarray(js.xyz_grad_accum) - np.asarray(jstate.xyz_grad_accum)
    t_den = ts.denom.numpy() - state.denom.numpy()
    j_den = np.asarray(js.denom) - np.asarray(jstate.denom)
    mu0 = {k: getattr(state.opt_state.mu, k).numpy() for k in FIELDS}
    tg = adam_grads(mu0, {k: getattr(ts.opt_state.mu, k).numpy() for k in FIELDS})
    jg = adam_grads(mu0, {k: np.asarray(getattr(js.opt_state.inner_states[k].inner_state[0].mu,
                                                 k)) for k in FIELDS})
    row = {
        "image": cam.image_name, "torch_s": t_torch, "jax_s": t_jax, **losses,
        "instances": [int(ta.num_instances), int(ja.num_instances)],
        "enumerated": [int(ta.num_enumerated), int(ja.num_enumerated)],
        "overflow": [bool(ta.overflow), bool(ja.overflow)],
        "visible_differ": int(((t_den > 0) != (j_den > 0)).sum()),
        "radii_differ": int((ts.max_radii2d.numpy() != np.asarray(js.max_radii2d)).sum()),
        "inc_sum": [float(t_inc.sum()), float(j_inc.sum())],
        "inc_max_abs_diff": float(np.abs(t_inc - j_inc).max()),
        "grads": {k: {"max_abs_diff": float(np.abs(tg[k] - jg[k]).max()),
                      "max_abs": float(np.abs(jg[k]).max()),
                      "sum_abs_ratio": float(np.abs(tg[k]).sum() / np.abs(jg[k]).sum())}
                  for k in FIELDS},
    }
    return row, (t_inc, t_den), (j_inc, j_den)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--seed", type=int, default=0, help="the run's random_order_seed")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if jax.default_backend() != "cpu":
        raise SystemExit("quality_probe_torch runs on the CPU: set JAX_PLATFORMS=cpu")

    opt = OptimizationConfig()
    cfg = ModelConfig(source_path=args.scene, model_path="", eval=True, data_device="cpu")
    scene = Scene(cfg, opt, seed=args.seed)
    cams = scene.get_train_cameras()
    extent = scene.cameras_extent
    state, iteration = load_state(args.checkpoint)
    jtx = jgm.make_optimizer(JOpt(), extent)
    jstate = state_to_jax(state, jtx)
    w, h = cams[0].width, cams[0].height
    tstep = ttrain.make_train_step(tgm.make_optimizer(opt, extent), opt, 3, w, h,
                                   max_instances=MAX_INSTANCES, device="cpu")
    jstep = jtrain.make_train_step(jtx, JOpt(), 3, w, h, impl="pallas",
                                   max_instances=MAX_INSTANCES)
    record = {"checkpoint": args.checkpoint, "iteration": iteration,
              "active": int(state.active.sum()), "capacity": int(state.active.shape[0]),
              "sh_degree": int(state.sh_degree), "views": []}
    incs = {"torch": [], "jax": []}
    for v, cam in enumerate(cams):
        row, t_inc, j_inc = compare_view(tstep, jstep, state, jstate, cam, opt.lambda_dssim)
        incs["torch"].append(t_inc)
        incs["jax"].append(j_inc)
        record["views"].append(row)
        print(json.dumps({"view": v, **{k: row[k] for k in (
            "torch_s", "jax_s", "torch", "jax", "instances", "visible_differ", "radii_differ",
            "inc_sum")}}), flush=True)
    draws = camera_draws(len(cams), args.seed, iteration + 1,
                         iteration + opt.densification_interval)
    record["replay"] = replay(state, incs, draws, len(cams), opt, extent)
    record["split_draw"] = split_draw(state, jstate, incs["torch"], draws, opt, extent)
    print(json.dumps({k: record[k] for k in ("replay", "split_draw")}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


def _summed(incs, draws):
    """The statistics' sums over the drawn views: (accum, denom)."""
    accum = sum(incs[v][0].astype(np.float64) for v in draws)
    denom = sum(incs[v][1].astype(np.float64) for v in draws)
    return accum, denom


def _candidates(state, accum, denom, opt, extent):
    """(clone, split) candidate masks, as densify_and_prune selects them."""
    grads = accum / np.maximum(denom, 1.0)
    high = state.active.numpy() & (grads >= opt.densify_grad_threshold)
    max_scale = np.exp(state.params.scaling.numpy().astype(np.float64)).max(axis=1)
    small = max_scale <= opt.percent_dense * extent
    return high & small, high & ~small, grads


def replay(state, incs, draws, n_views, opt, extent):
    """Each package's statistics summed over the replayed camera draws
    (parameters frozen), and the densify candidates they select."""
    out = {"iterations": len(draws), "draws": draws,
           "draws_per_view": np.bincount(draws, minlength=n_views).tolist()}
    masks = {}
    for name in ("torch", "jax"):
        accum, denom = _summed(incs[name], draws)
        clone, split, grads = _candidates(state, accum, denom, opt, extent)
        masks[name] = (clone, split, grads, denom)
        out[name] = {"clone": int(clone.sum()), "split": int(split.sum()),
                     "accum_sum": float(accum.sum()), "denom_sum": float(denom.sum())}
    (tc, ts, tg, td), (jc, js, jg, jd) = masks["torch"], masks["jax"]
    seen = (td > 0) | (jd > 0)
    rel = np.abs(tg - jg)[seen] / np.maximum(jg[seen], 1e-30)
    thr = opt.densify_grad_threshold
    out["clone_differ"] = int((tc != jc).sum())
    out["split_differ"] = int((ts != js).sum())
    out["denom_differ"] = int((td != jd).sum())
    out["mean_grad_rel_diff_p50_p99_max"] = [float(np.quantile(rel, 0.5)),
                                             float(np.quantile(rel, 0.99)), float(rel.max())]
    out["within_1pct_of_threshold"] = int((np.abs(jg - thr) <= 0.01 * thr).sum())
    return out


def split_draw(state, jstate, t_incs, draws, opt, extent):
    """The port's split draw on the state with its replayed statistics:
    two ``densify_step`` calls from one generator (fresh (2, C, 3)
    normals; the split children's offsets in each parent's frame against
    N(0, 1)), and both packages' ``densify_and_prune`` with JAX's own
    normals (children positions and masks compared)."""
    accum, denom = (torch.from_numpy(x.astype(np.float32)) for x in _summed(t_incs, draws))
    st = state._replace(xyz_grad_accum=accum, denom=denom)
    cap = st.params.xyz.shape[0]
    gen = torch.Generator().manual_seed(0)
    drawn, densify = [], tgm.densify_and_prune

    def spy(s, normals, **kw):
        drawn.append(normals)
        return densify(s, normals, **kw)

    tgm.densify_and_prune = spy
    try:
        outs = [ttrain.densify_step(st, gen, opt, extent, 0.0) for _ in range(2)]
    finally:
        tgm.densify_and_prune = densify
    _, split, _ = _candidates(st, accum.numpy().astype(np.float64),
                              denom.numpy().astype(np.float64), opt, extent)
    rows = torch.from_numpy(np.nonzero(split)[0])
    rot = ttf.quat_to_rotmat(st.params.rotation[rows]).double()
    scale = torch.exp(st.params.scaling[rows]).double()
    calls = []
    for new, _ in outs:
        off = (new.params.xyz[rows] - st.params.xyz[rows]).double()
        z = torch.einsum("nji,nj->ni", rot, off) / scale
        calls.append({"mean": float(z.mean()), "std": float(z.std()),
                      "max_abs_vs_drawn": float((z - drawn[len(calls)][0][rows]).abs().max())})
    # both packages with JAX's normals, from the same statistics
    key = jax.random.PRNGKey(2100)
    k1, k2 = jax.random.split(key)
    normals = torch.from_numpy(np.stack([np.asarray(jax.random.normal(k1, (cap, 3))),
                                         np.asarray(jax.random.normal(k2, (cap, 3)))]))
    kw = dict(grad_threshold=opt.densify_grad_threshold, min_opacity=0.005, extent=extent,
              max_screen_size=0.0, percent_dense=opt.percent_dense)
    js = jstate._replace(xyz_grad_accum=jnp.asarray(accum.numpy()),
                         denom=jnp.asarray(denom.numpy()))
    jnew, jinfo = jax.jit(lambda s, k: jgm.densify_and_prune(s, k, **kw))(js, key)
    tnew, tinfo = tgm.densify_and_prune(st, normals, **kw)
    act = np.asarray(jnew.active)
    return {
        "shapes": [list(d.shape) for d in drawn],
        "calls_differ": float((drawn[0] - drawn[1]).abs().max()),
        "split_candidates": int(split.sum()), "calls": calls,
        "jax_normals": {
            "info_torch": {k: int(v) for k, v in tinfo.items()},
            "info_jax": {k: int(v) for k, v in jinfo.items()},
            "active_differ": int((tnew.active.numpy() != act).sum()),
            "xyz_max_abs_diff": float(np.abs(tnew.params.xyz.numpy()[act]
                                             - np.asarray(jnew.params.xyz)[act]).max()),
            "scaling_max_abs_diff": float(np.abs(tnew.params.scaling.numpy()[act]
                                                 - np.asarray(jnew.params.scaling)[act]).max()),
        },
    }


if __name__ == "__main__":
    main()
