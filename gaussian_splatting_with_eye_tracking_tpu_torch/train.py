"""Training CLI.

Port of ``training`` and ``main`` from the repository's root ``train.py``
(the reference's ``train.py``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.train -s <scene> [-m <model>] \
        [--iterations 30000] [--eval] [--data_device cpu] ...

It runs on the card unless ``--data_device cpu`` is given, and raises
without one. What it keeps from the JAX loop:

- the camera order from ``np.random.default_rng(seed).permutation``, so
  both packages visit the same cameras; SH degree up every 1000 steps;
- adaptive instance capacity: grow ahead of overflow at 90 %, shrink after
  200 steps under 35 %; an overflowed step rendered a truncated instance
  list, so it is redone from its pre-step state at the grown capacity and
  never kept;
- deferred resolution: step i's overflow flag, counts and loss are copied
  to the host without blocking as soon as it is queued, and read after
  step i+1 has been queued, so the host queues ahead of the card; host
  mutations (densify, reset, evaluation, save) resolve first;
- a non-finite loss saves the pre-step checkpoint and raises
  ``FloatingPointError``;
- density control between steps, the point capacity first grown to cover
  every clone and split candidate (``train_lib.grow_for_densify``), the
  split normals from a seeded ``torch.Generator``; opacity resets; test
  and train evaluation; PLY saves; checkpoints and ``--start_checkpoint``;
- the live viewer (``renderer/network_gui.py``) on ``--ip``/``--port``,
  polled at the top of every iteration (each step then resolves before
  the next poll, as in JAX); one that cannot bind prints "Viewer server
  disabled: ..." and training goes on; ``--disable_viewer`` turns it off;
- the pipeline flags (``PipelineConfig``): ``--debug`` reaches
  ``rasterize(debug=...)`` in the train step and the viewer's renders;
- multi-process runs (``torchrun --nproc_per_node N -m ...train``, or
  torchrun's variables set by hand): ``main`` joins the process group
  before the first device use (``parallel/multihost.py``), the state is
  replicated from rank 0 by broadcast, and every rank runs the same
  seeded loop, the same densify choices and the same evaluations. The
  host decisions taken from what a step read back (the overflow redo, the
  adaptive capacities, the densify capacity, the non-finite-loss stop)
  take the maximum over the ranks first, so that they come out the same
  everywhere. Rank 0 alone prints and writes ``cfg_args``, the scene's
  ``input.ply`` and ``cameras.json``, TensorBoard and the PLY snapshots;
  every rank joins each checkpoint, a ``chkpnt<N>.shards`` directory
  (``models/checkpoint.save_checkpoint_dist``; ``--start_checkpoint``
  takes it too), written in the background while the steps go on and
  drained before ``training`` returns. The viewer is off.
"""

from __future__ import annotations

import math
import os
import time
import uuid
from argparse import ArgumentParser
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    add_config_args,
    extract_config,
    save_cfg_args,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.general_utils import safe_state


class _Readback:
    """A step's loss, L1, PSNR, enumerated and live instance counts and
    overflow flag, on their way to the host: on the card a non-blocking
    copy into pinned memory and an event, so that reading them waits for
    that step only, not for the steps queued after it."""

    def __init__(self, aux: train_lib.StepAux):
        vals = torch.stack([aux.loss.double(), aux.l1.double(), aux.psnr.double(),
                            aux.num_enumerated.double(), aux.num_instances.double(),
                            aux.overflow.double()])
        self.event = None
        if vals.is_cuda:
            self.host = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        loss, l1, psnr, ne, ni, overflow = self.host.tolist()
        return loss, l1, psnr, int(ne), int(ni), bool(overflow)


class _Pending(NamedTuple):
    iteration: int
    cam: object
    prev_state: gm.GaussianModelState
    step_args: tuple
    state: gm.GaussianModelState
    vals: _Readback


def training(
    cfg: ModelConfig,
    opt: OptimizationConfig,
    pipe: Optional[PipelineConfig] = None,
    testing_iterations=(),
    saving_iterations=(),
    checkpoint_iterations=(),
    start_checkpoint=None,
    quiet=False,
    gui=None,
    random_order_seed=0,
    instance_capacity=1 << 20,
    capacity_bucket=1 << 17,
):
    """Train on ``cfg.source_path`` into ``cfg.model_path`` on
    ``cfg.data_device``, polling ``gui`` (a ``NetworkGUI``) once per
    iteration if given. Returns (scene, state, log): ``log`` holds the
    evaluations ({"test"|"train": {iteration: {"l1", "psnr"}}}), the active
    point count every 100 steps, the seconds of the loop and its last
    instance capacities."""
    dev = backend.resolve_data_device(cfg.data_device)
    pipe = PipelineConfig() if pipe is None else pipe
    distributed = multihost.is_distributed()
    is_main = multihost.process_index() == 0
    if distributed:
        gui = None  # the viewer serves one process
        mesh = multihost.make_global_mesh(device=dev)
    if not cfg.model_path:
        cfg.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    tb = None
    if is_main:
        os.makedirs(cfg.model_path, exist_ok=True)
        save_cfg_args(cfg.model_path, cfg)
        tb = _try_tensorboard(cfg.model_path)

    scene = Scene(cfg, opt, seed=random_order_seed, write=is_main)
    state = scene.gaussians
    first_iter = 0
    if start_checkpoint:
        if os.path.isdir(start_checkpoint):
            state, first_iter = ckpt.load_checkpoint_dist(start_checkpoint, device=dev)
        else:
            state, first_iter = ckpt.load_checkpoint(start_checkpoint, device=dev)
        print(f"Restored checkpoint at iteration {first_iter}")
    if distributed:
        state = multihost.replicate_to_mesh(state, mesh)

    def save_ckpt(name, state, iteration, async_save=False):
        """A checkpoint: a ``.ckpt`` file, or in a multi-process run a
        ``.shards`` directory, written in the background if ``async_save``
        (drained before the function returns, as the JAX trainer drains
        its orbax saves)."""
        path = os.path.join(cfg.model_path, name)
        if distributed:
            ckpt.save_checkpoint_dist(path + ckpt.SHARDS, state, iteration,
                                      async_save=async_save)
            return path + ckpt.SHARDS
        ckpt.save_checkpoint(path + ".ckpt", state, iteration)
        return path + ".ckpt"

    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    cams = scene.get_train_cameras()
    cam_cache = {}  # camera -> (camera arrays, ground truth) on the device

    def cam_inputs(cam):
        if id(cam) not in cam_cache:
            cam_cache[id(cam)] = (*train_lib.camera_arrays(cam.params(dev)), cam.gt(dev))
        return cam_cache[id(cam)]

    # the enumeration capacity (every gaussian x tile-in-rect pair) and the
    # live capacity (what survives the ellipse cull), on a bucket grid
    cap_bucket = capacity_bucket
    cap = max(instance_capacity, cap_bucket)
    cap_live = cap
    shrink_streak = 0
    steps = {}

    def _grow(above):
        c = cap_bucket
        while c <= above:
            c += max(cap_bucket, c // 2)  # ~x1.5 steps on the bucket grid
        return -(-c // cap_bucket) * cap_bucket

    def launch(cam, state, step_args):
        key = (cam.width, cam.height, cap, cap_live)
        if key not in steps:
            steps[key] = train_lib.make_train_step(
                scene.tx, opt, max_sh_degree=scene.max_sh_degree, width=cam.width,
                height=cam.height, max_instances=cap, max_live=min(cap_live, cap), device=dev,
                debug=pipe.debug)
        state, aux = steps[key](state, *step_args)
        return state, _Readback(aux)

    rng = np.random.default_rng(random_order_seed)
    gen = torch.Generator(device=dev).manual_seed(random_order_seed)
    stack = []
    ema_loss = 0.0
    log = {"eval": {"test": {}, "train": {}}, "points": {}}
    t_start = time.time()
    pending: Optional[_Pending] = None

    def _resolve(p: _Pending):
        """Overflow redo, capacity adaptation, the tripwire and logging for
        a queued step. Returns (post-step state, whether it was redone)."""
        nonlocal cap, cap_live, shrink_streak, ema_loss
        state_p = p.state
        loss, l1, psnr, ne, ni, overflow = p.vals.get()
        redone = False
        if distributed:
            ne, ni, overflow = _agreed(ne, ni, overflow)
        if overflow:
            cap = _grow(max(ne, cap))
            cap_live = _grow(max(ni, cap_live))
            shrink_streak = 0
            if not quiet:
                print(f"[it {p.iteration}] instance capacity -> {cap}/{cap_live} (overflow redo)")
            state_p, vals = launch(p.cam, p.prev_state, p.step_args)
            loss, l1, psnr, ne, ni, overflow = vals.get()
            if distributed:
                ne, ni, overflow = _agreed(ne, ni, overflow)
            redone = True
        elif ne > 0.9 * cap or ni > 0.9 * cap_live:
            cap = _grow(max(int(ne * 1.3), cap))  # grow ahead of overflow
            cap_live = _grow(max(int(ni * 1.3), cap_live))
            shrink_streak = 0
        elif (ne < 0.35 * cap or ni < 0.35 * cap_live) and (
                cap > cap_bucket or cap_live > cap_bucket):
            shrink_streak += 1
            if shrink_streak >= 200:  # sustained headroom: shed the waste
                cap = _grow(int(ne * 1.6))
                cap_live = _grow(int(ni * 1.6))
                shrink_streak = 0
        else:
            shrink_streak = 0

        finite = math.isfinite(loss)
        if distributed:
            finite = not multihost.agree_max([not finite])[0]
        if not finite:
            dump = save_ckpt(f"nanstep{p.iteration}", p.prev_state, p.iteration - 1)
            raise FloatingPointError(
                f"non-finite loss {loss} at iteration {p.iteration} "
                f"(camera {p.cam.image_name}); pre-step state saved to {dump}")
        ema_loss = 0.4 * loss + 0.6 * ema_loss
        if p.iteration % 100 == 0:
            n = int(gm.num_active(state_p))
            log["points"][p.iteration] = n
            if not quiet:
                print(f"[it {p.iteration}/{opt.iterations}] loss={ema_loss:.5f} "
                      f"psnr={psnr:.2f} points={n} ({(time.time() - t_start):.1f}s)")
        if tb and p.iteration % 10 == 0:
            tb.add_scalar("train_loss_patches/total_loss", loss, p.iteration)
            tb.add_scalar("train_loss_patches/l1_loss", l1, p.iteration)
        return state_p, redone

    for iteration in range(first_iter + 1, opt.iterations + 1):
        if gui is not None:
            gui.poll(state, scene, pipe, iteration, opt.iterations)
        if iteration % 1000 == 0:
            state = gm.oneup_sh_degree(state, scene.max_sh_degree)
        if not stack:
            stack = list(rng.permutation(len(cams)))
        cam = cams[stack.pop()]
        densify_phase = opt.densify_from_iter <= iteration < opt.densify_until_iter
        step_args = (*cam_inputs(cam), bg, iteration < opt.densify_until_iter)
        sync_after = (
            gui is not None
            or (iteration < opt.densify_until_iter and (
                (densify_phase and iteration % opt.densification_interval == 0)
                or iteration % opt.opacity_reset_interval == 0
                or (cfg.white_background and iteration == opt.densify_from_iter)))
            or iteration in testing_iterations
            or iteration in saving_iterations
            or iteration in checkpoint_iterations
            or iteration == opt.iterations
        )
        prev_state = state
        state, vals = launch(cam, state, step_args)
        if pending is not None:
            fixed, redone = _resolve(pending)
            if redone:
                # this step ran on a truncated predecessor: run it again on
                # the redone state, with this iteration's SH bump
                if iteration % 1000 == 0:
                    fixed = gm.oneup_sh_degree(fixed, scene.max_sh_degree)
                prev_state = fixed
                state, vals = launch(cam, prev_state, step_args)
        pending = _Pending(iteration, cam, prev_state, step_args, state, vals)
        if sync_after:
            state, _ = _resolve(pending)
            pending = None

        # density control
        if iteration < opt.densify_until_iter:
            if densify_phase and iteration % opt.densification_interval == 0:
                cap_pts = state.params.xyz.shape[0]
                state = train_lib.grow_for_densify(state, opt)
                if distributed:
                    state = gm.grow_capacity(
                        state, int(multihost.agree_max([state.params.xyz.shape[0]])[0]))
                if state.params.xyz.shape[0] != cap_pts and not quiet:
                    print(f"[it {iteration}] point capacity -> {state.params.xyz.shape[0]} "
                          f"({int(gm.num_active(state))} active)")
                max_screen = 20.0 if iteration > opt.opacity_reset_interval else 0.0
                state, _ = train_lib.densify_step(state, gen, opt, scene.cameras_extent,
                                                  max_screen)
            if iteration % opt.opacity_reset_interval == 0 or (
                    cfg.white_background and iteration == opt.densify_from_iter):
                state = gm.reset_opacity(state)

        if iteration in testing_iterations:
            for name, ev in _report(scene, state, bg, iteration, tb, cam_inputs, dev,
                                    cap, quiet).items():
                log["eval"][name][iteration] = ev
        if iteration in saving_iterations and is_main:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.gaussians = state
            scene.save(iteration)
        if iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            save_ckpt(f"chkpnt{iteration}", state, iteration, async_save=True)

    ckpt.wait_for_async_saves()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log["seconds"] = time.time() - t_start
    log["capacity"] = [cap, cap_live]
    if tb:
        tb.close()
    scene.gaussians = state
    return scene, state, log


def _report(scene, state, bg, iteration, tb, cam_inputs, dev, capacity, quiet=False):
    """Mean L1 and PSNR of the clipped renders of the test cameras and the
    first five training cameras, at the trainer's instance capacity (grown
    where a view overflows it). Returns {set: {"l1", "psnr"}}."""
    out = {}
    for name, cams in [("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:5])]:
        if not cams:
            continue
        errs = []
        for cam in cams:
            *_, gt = cam_inputs(cam)
            img, _ = train_lib.render_view(state, cam.params(dev), bg, scene.max_sh_degree,
                                           capacity)
            img = torch.clamp(img, 0, 1)
            errs.append(torch.stack([torch.mean(torch.abs(img - gt)),
                                     torch.mean((img - gt) ** 2)]))
        l1s, mses = torch.stack(errs).cpu().double().numpy().T
        psnrs = [-10 * np.log10(max(float(m), 1e-10)) for m in mses]
        out[name] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
        if quiet:
            continue
        print(f"\n[ITER {iteration}] Evaluating {name}: "
              f"L1 {out[name]['l1']:.4f} PSNR {out[name]['psnr']:.2f}")
        if tb:
            tb.add_scalar(f"{name}/loss_viewpoint - l1_loss", out[name]["l1"], iteration)
            tb.add_scalar(f"{name}/loss_viewpoint - psnr", out[name]["psnr"], iteration)
    if tb:
        tb.add_scalar("total_points", int(gm.num_active(state)), iteration)
    return out


def _agreed(ne, ni, overflow):
    """The instance counts and the overflow flag, each the maximum over the
    ranks."""
    ne, ni, overflow = multihost.agree_max([ne, ni, overflow])
    return int(ne), int(ni), bool(overflow)


def _try_tensorboard(model_path):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("Tensorboard not available: not logging progress")
        return None
    return SummaryWriter(model_path)


def main(argv=None, random_order_seed=0):
    """Parse ``argv`` and train with ``random_order_seed`` (the camera
    order and the split draws); returns ``training``'s (scene, state,
    log)."""
    args = build_parser().parse_args(argv)
    args.save_iterations.append(args.iterations)
    # a multi-process run (torchrun's variables) joins its process group
    # before the first device use; the viewer serves one process
    if multihost.maybe_initialize_distributed(device=args.data_device):
        args.disable_viewer = True
        if multihost.process_index() != 0:
            args.quiet = True

    print("Optimizing " + (args.model_path or ""))
    safe_state(args.quiet)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    gui = None
    if not args.disable_viewer:
        from gaussian_splatting_with_eye_tracking_tpu_torch.renderer import network_gui

        try:
            gui = network_gui.NetworkGUI(args.ip, args.port)
        except OSError as e:
            print(f"Viewer server disabled: {e}")

    out = training(
        extract_config(args, ModelConfig),
        extract_config(args, OptimizationConfig),
        extract_config(args, PipelineConfig),
        set(args.test_iterations),
        set(args.save_iterations),
        set(args.checkpoint_iterations),
        args.start_checkpoint,
        quiet=args.quiet,
        gui=gui,
        random_order_seed=random_order_seed,
    )
    print("\nTraining complete.")
    return out


def build_parser() -> ArgumentParser:
    """The reference's training arguments."""
    parser = ArgumentParser(description="Training script parameters")
    add_config_args(parser, ModelConfig(), "Model Parameters")
    add_config_args(parser, OptimizationConfig(), "Optimization Parameters")
    add_config_args(parser, PipelineConfig(), "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--disable_viewer", action="store_true", default=False)
    return parser


if __name__ == "__main__":
    main()
