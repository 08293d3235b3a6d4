"""One rank of the port's multi-process CPU tests (gloo).

Run by ``tests/test_torch_parallel.py`` and ``tests/test_torch_multiproc.py``,
never collected by pytest:

    python tests/torch_multiproc_worker.py <port> <rank> <world> <inputs.pt> <out_dir>

``inputs.pt`` holds the training states the parent carried across from
the JAX package (``checkpoint.state_to_dict``). Every rank runs every case
below in order, on the CPU with 2 threads, and writes what it computed to
``<out_dir>/rank<r>.pt``; the parent holds it against JAX and against the
port's own single-device step.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import (  # noqa: E402
    make_camera,
    make_random_gaussians,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.config import (  # noqa: E402
    OptimizationConfig,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import collectives as cc  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost  # noqa: E402
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import sharded  # noqa: E402

CPU = torch.device("cpu")
CAPS = dict(max_instances_per_band=1 << 11, max_per_tile=64)
IMPLS = ("kernels", "jnp")


def scene_tensors(n, seed, **kw):
    return [torch.from_numpy(a) for a in make_random_gaussians(n, seed=seed, **kw)]


def step_record(state, aux, mesh=None):
    """What the parent compares after a step: the loss terms and the
    whole state's xyz, statistics (every rank's rows where ``mesh``)."""
    def full(x):
        return torch.from_numpy(multihost.process_local_value(x, mesh))

    return {"loss": float(aux["loss"]), "l1": float(aux["l1"]), "psnr": float(aux["psnr"]),
            "overflow": bool(aux["overflow"]), "xyz": full(state.params.xyz),
            "xyz_grad_accum": full(state.xyz_grad_accum),
            "max_radii2d": full(state.max_radii2d), "local_rows": state.params.xyz.shape[0]}


def run_steps(step, state, cam, gt, bg, n, mesh=None):
    out = []
    for _ in range(n):
        state, aux = step(state, *train_lib.camera_arrays(cam), gt, bg, True)
        out.append(step_record(state, aux, mesh))
    return state, out


def render_cases(mesh, states, world):
    out = {}
    h = 32 * world
    for impl in IMPLS:
        color, final_t, radii, overflow = sharded.sharded_render(
            mesh, states[0], make_camera(64, h, device=CPU), torch.tensor([0.3, 0.2, 0.1]),
            max_sh_degree=0, impl=impl, **CAPS)
        out[f"render_{impl}"] = {"color": color, "final_t": final_t, "radii": radii,
                                 "overflow": overflow}
    color, *_ = sharded.sharded_render(mesh, states[1], make_camera(64, 96, device=CPU),
                                       torch.zeros(3), max_sh_degree=0, impl="jnp", **CAPS)
    out["uneven"] = color
    color, final_t, _, overflow = sharded.sharded_render(
        mesh, saturated_state(), make_camera(64, h, device=CPU), torch.zeros(3),
        max_sh_degree=0, max_instances_per_band=1 << 16)
    out["saturated"] = {"color": color, "final_t": final_t, "overflow": overflow}
    return out


def saturated_state():
    """Large opaque gaussians: every tile takes the early exit mid-list."""
    means, scales, quats, op, sh = make_random_gaussians(1500, seed=41, spread=2.5,
                                                         scale_range=(-1.2, -0.6))
    params = gm.GaussianParams(
        xyz=torch.from_numpy(means), f_dc=torch.from_numpy(sh[:, :, :1]),
        f_rest=torch.zeros((1500, 3, 0)), scaling=torch.from_numpy(np.log(scales)),
        rotation=torch.from_numpy(quats), opacity=torch.full((1500, 1), 3.0))
    return gm.state_from_params(params, 0)


def step_cases(mesh, states, world, tx, opt):
    out = {}
    h = 32 * world
    cam = make_camera(64, h, device=CPU)
    gt = torch.full((3, h, 64), 0.4)
    gmesh = mesh._replace(axis="gauss")
    for impl in IMPLS:
        band = sharded.make_sharded_train_step(mesh, tx, opt, 0, 64, h, impl=impl, **CAPS)
        out[f"band_{impl}"] = run_steps(band, states[2], cam, gt, torch.zeros(3), 2)[1]
        gauss = sharded.make_gauss_sharded_train_step(gmesh, tx, opt, 0, 64, h, impl=impl,
                                                      **CAPS)
        sstate = sharded.shard_model_state(gmesh, states[4])
        sstate, rec = run_steps(gauss, sstate, cam, gt, torch.tensor([0.1, 0.0, 0.2]), 2,
                                gmesh)
        out[f"gauss_{impl}"] = rec
    # the gauss-sharded state of the last step, as every rank writes it
    path = os.path.join(OUT_DIR, "ckpt_gauss", "chkpnt7.shards")
    ckpt.save_checkpoint_dist(path, sstate, 7, mesh=gmesh)
    out["ckpt_gauss_full"] = {
        name: torch.from_numpy(multihost.process_local_value(v, gmesh))
        for name, v in [("xyz", sstate.params.xyz), ("f_dc", sstate.params.f_dc),
                        ("mu_opacity", sstate.opt_state.mu.opacity),
                        ("active", sstate.active), ("denom", sstate.denom)]}
    # the replicated layout: rank 0 writes the band step's state
    band_state, _ = run_steps(sharded.make_sharded_train_step(mesh, tx, opt, 0, 64, h, **CAPS),
                              states[2], cam, gt, torch.zeros(3), 1)
    ckpt.save_checkpoint_dist(os.path.join(OUT_DIR, "ckpt_band", "chkpnt3.shards"),
                              band_state, 3)
    out["ckpt_band_xyz"] = band_state.params.xyz

    # 20 band steps toward a rendered target; 10 gauss-sharded steps
    cam64 = make_camera(64, 64, device=CPU)
    with torch.no_grad():
        target = rast.rasterize(*scene_tensors(60, 9), cam64, torch.zeros(3), sh_degree=0,
                                max_instances=1 << 11).color
    band = sharded.make_sharded_train_step(mesh, tx, opt, 0, 64, 64, **CAPS)
    out["converge_band"] = [r["loss"] for r in run_steps(
        band, states[3], cam64, target, torch.zeros(3), 20)[1]]
    gauss = sharded.make_gauss_sharded_train_step(gmesh, tx, opt, 0, 64, 64, **CAPS)
    sstate, rec = run_steps(gauss, sharded.shard_model_state(gmesh, states[5]), cam64,
                            torch.full((3, 64, 64), 0.3), torch.zeros(3), 10)
    out["converge_gauss"] = [r["loss"] for r in rec]
    out["converge_gauss_rows"] = sstate.params.xyz.shape[0]

    # the band-local loss against the gathered full image's, with crops
    w, hc = 64, 100
    camc = make_camera(w, hc, device=CPU)
    gtc = torch.from_numpy(np.random.default_rng(5).uniform(size=(3, hc, w)).astype(np.float32))
    for mode in ("band", "full"):
        step = sharded.make_sharded_train_step(mesh, tx, opt, 0, w, hc, loss_mode=mode, **CAPS)
        out[f"crop_{mode}"] = run_steps(step, states[11], camc, gtc,
                                        torch.tensor([0.3, 0.1, 0.2]), 1)[1][0]
        step = sharded.make_gauss_sharded_train_step(
            gmesh, tx, opt, 0, 64, 128, loss_mode=mode, max_exchange_per_band=1 << 9, **CAPS)
        out[f"gauss_loss_{mode}"] = run_steps(
            step, sharded.shard_model_state(gmesh, states[12]), make_camera(64, 128, device=CPU),
            torch.full((3, 128, 64), 0.4), torch.zeros(3), 1, gmesh)[1][0]
    return out


def exchange_case(mesh, world, n, seed, cap, bound=0, **kw):
    """This rank's rows of a random scene, preprocessed and exchanged."""
    means, scales, quats, op, sh = scene_tensors(n, seed, **kw)
    if seed == 31:  # all-band spanners: the first 32 gaussians made giant
        scales[:32] = 1.2
    if seed == 22:  # every third gaussian behind the camera: dead rows between live ones
        means[::3, 2] = -10.0
    rows = slice(mesh.rank * n // world, (mesh.rank + 1) * n // world)
    prep = projection.preprocess(means[rows], scales[rows], quats[rows], op[rows], sh[rows], 0,
                                 make_camera(64, 32 * world, device=CPU), tile=32)
    recv, ovf = sharded._band_exchange(prep, mesh, world, 1, cap, multicast_bound=bound)
    return {"recv": recv, "overflow": bool(ovf)}


def collective_grads(mesh, world):
    """Each differentiable collective's backward against a central
    difference of the global objective, in float64. Returns the largest
    |autograd - difference| per collective on this rank."""
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    x = torch.randn(world, 3, 4, generator=gen, dtype=torch.float64)
    weights = torch.randn(world, 3, 4, generator=gen, dtype=torch.float64)
    same = torch.randn(3, 4 * world, generator=torch.Generator().manual_seed(7),
                       dtype=torch.float64)

    def objectives(v):
        """{name: the global objective as a function of this rank's input},
        identical on every rank."""
        top, bottom = v[0, :2], v[0, 1:]
        up, down = cc.ppermute_halo(top, bottom, mesh)
        return {
            # a replicated function of the sum
            "psum": (cc.psum(v[0], mesh) ** 2 * same[:, :4]).sum(),
            # local functions of what each rank received, summed over ranks
            "halo": cc.psum((up * weights[0, :2] + (down * weights[0, 1:]) ** 2).sum()
                            + (v[0] ** 3).sum(), mesh),
            "all_to_all": cc.psum((cc.all_to_all(v, mesh) ** 2 * weights).sum(), mesh),
            # a replicated function of the gathered tensor
            "all_gather": (torch.sin(cc.all_gather(v[0], mesh, dim=1)) * same).sum(),
        }

    names = list(objectives(x).keys())
    grads = {}
    for name in names:
        xv = x.clone().requires_grad_(True)
        (grads[name],) = torch.autograd.grad(objectives(xv)[name], [xv])
    fd = {name: torch.zeros_like(x) for name in names}
    eps = 1e-6
    # every rank evaluates each perturbation together; only the rank being
    # differentiated moves its input
    for r in range(world):
        for i in range(x.numel()):
            vals = []
            for sign in (1.0, -1.0):
                v = x.clone()
                if r == mesh.rank:
                    v.view(-1)[i] += sign * eps
                with torch.no_grad():
                    vals.append({k: float(o) for k, o in objectives(v).items()})
            if r == mesh.rank:
                for name in names:
                    fd[name].view(-1)[i] = (vals[0][name] - vals[1][name]) / (2 * eps)
    errs = {}
    for name in names:
        errs[name] = float((grads[name] - fd[name]).abs().max())
        errs[name + "_scale"] = float(fd[name].abs().max())
    return errs


def multihost_case(states, world, tx, opt):
    """The multihost API: the band step on a state broadcast from rank 0
    (the other ranks start from garbage), the gauss step on
    ``shard_to_mesh``'s rows; two steps each."""
    h = 32 * world
    cam = make_camera(64, h, device=CPU)
    gt = torch.full((3, h, 64), 0.4)
    mesh = multihost.make_global_mesh("tiles")
    start = states[2]
    if mesh.rank:
        start = multihost.tree_map(lambda t: torch.full_like(t, 7), start)
    state = multihost.replicate_to_mesh(start, mesh)
    step = sharded.make_sharded_train_step(mesh, tx, opt, 0, 64, h, impl="jnp", **CAPS)
    state, rec = run_steps(step, state, cam, gt, torch.zeros(3), 2)
    out = {"band_losses": [r["loss"] for r in rec],
           "band_xyz_abs_sum": float(state.params.xyz.abs().sum()),
           "band_accum_abs_sum": float(state.xyz_grad_accum.abs().sum())}
    gmesh = multihost.make_global_mesh("gauss")
    cap = states[4].params.xyz.shape[0]
    sstate = multihost.shard_to_mesh(states[4], gmesh, cap)
    step = sharded.make_gauss_sharded_train_step(gmesh, tx, opt, 0, 64, h, impl="jnp", **CAPS)
    sstate, rec = run_steps(step, sstate, cam, gt, torch.zeros(3), 2, gmesh)
    out.update(gauss_losses=[r["loss"] for r in rec],
               gauss_xyz_abs_sum=float(rec[-1]["xyz"].abs().sum()),
               local_shard_rows=sstate.params.xyz.shape[0])
    return out


def main():
    global OUT_DIR
    port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    inputs, OUT_DIR = sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    ok = multihost.maybe_initialize_distributed(
        f"tcp://127.0.0.1:{port}", world, rank, device="cpu", timeout_s=60)
    assert ok and multihost.process_count() == world
    states = {int(k): ckpt.state_from_dict(v, CPU)
              for k, v in torch.load(inputs, weights_only=True).items()}
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, 1.0)
    mesh = sharded.make_mesh()

    out = {"rank": rank}
    out.update(render_cases(mesh, states, world))
    out.update(step_cases(mesh, states, world, tx, opt))
    gmesh = sharded.make_mesh(axis="gauss")
    out["exchange"] = exchange_case(gmesh, world, 1024, 21, 512)
    out["dead_rows"] = exchange_case(gmesh, world, 1024, 22, 512)
    out["spanners"] = exchange_case(gmesh, world, 512, 31, 1024)
    out["spanners_bound"] = exchange_case(gmesh, world, 512, 31, 1024, bound=1)
    # a block per (source, band) pair as large as a rank's rows
    out["large_n"] = exchange_case(gmesh, world, 8192, 32, 8192 // world,
                                   scale_range=(-5.0, -3.5))
    out["collectives"] = collective_grads(mesh, world)
    out["multihost"] = multihost_case(states, world, tx, opt)
    if world > 1:  # a mesh of the first rank alone, as JAX's make_mesh(1)
        sub = sharded.make_mesh(1)
        out["submesh"] = {"size": sub.size, "rank": sub.rank}
    torch.save(out, os.path.join(OUT_DIR, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


OUT_DIR = ""

if __name__ == "__main__":
    main()
