#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one CUDA card
and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

 1. print the card's name and power limit (nvidia-smi);
 2. build the hand-written kernels from the package's ``csrc/`` with nvcc;
 3. make bench.py's scene in numpy (300,000 gaussians, SH degree 3, seed
    0), write it as a PLY snapshot with the port and load it back;
 4. serve four 1920x1088 view requests (bench.py's front camera and three
    small yaw/pitch offsets) through ``train_lib.make_eval_render`` with
    bench.py's capacities, after a capacity probe that fails on overflow;
    the kernels' launch counters are zeroed just before and read just
    after, and each kernel must have run once per request;
 5. on the front view's real inputs, hold each kernel against its plain
    PyTorch version (expand bit-exact; blend rgb/final_T within 1e-3 and
    chunks_done equal on all but 0.1% of tiles);
 6. time each view and each kernel with CUDA events (warm-up, then the
    median of 10), beside the plain versions and the library yardstick;
 7. render a small scene on the card and on the CPU (plain versions) and
    compare them (atol 3e-4 / rtol 1e-3, integer outputs exact), then its
    gradients with respect to every input (atol 2e-3 / rtol 5e-3);
 8. train: the same model with f_dc perturbed by N(0, 0.1), in a training
    state of next_pow2(300,000) = 524,288 slots with the default
    OptimizationConfig, fitted to the images served in phase 4: 8 train
    steps over the four views (stats accumulated), a densify step (the
    capacity grown first to cover every candidate), an opacity reset,
    and 2 more steps at the capacities a probe then asks for. Loss, L1
    and PSNR finite at every step; the second pass over the views has a
    lower loss than the first; the launch counters, zeroed before and read
    after, show the backward kernels once per step;
 9. on the front view's real cotangents, hold the backward kernels
    against their plain versions (blend_bwd per row within 1e-3 of the
    row's largest value plus 1e-3 of each value, and exactly 0 on chunks
    past chunks_done; segsum within 1e-5 of the row's largest value), and
    time the train step, its phases, its peak memory and the kernels;
10. print a ``{"kernels": [...]}`` line, then as the last line
    ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H, N = 1920, 1088, 300_000
MAX_INSTANCES = (1 << 20) + (1 << 19) + (1 << 16)  # bench.py's capacities
MAX_LIVE = (1 << 20) + (1 << 18) + (1 << 17)
FOV = math.radians(60.0)
VIEWS = [(0.0, 0.0), (6.0, 0.0), (-5.0, 3.0), (3.0, -4.0)]  # (yaw, pitch) degrees
REPS = 10
EXTENT = 5.0  # scene extent (the cameras' distance): xyz lr scale and densify sizes
TRAIN_STEPS = 8  # before the densify step
CAP_QUANTUM = 1 << 16  # instance capacities after densify, rounded up to this

# H100 SXM peaks: HBM 3.35 TB/s and fp32 67 TFLOP/s (NVIDIA data sheet);
# special-function units 16 results/clock/SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9

REPLACES = {
    "expand_seg": "gaussian_splatting_with_eye_tracking_tpu/ops/expand.py:74",
    "blend_fwd": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:563",
    "blend_bwd": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:600",
    "segsum": "gaussian_splatting_with_eye_tracking_tpu/ops/segsum.py:31",
}


def log(*args):
    print(*args, flush=True)


def make_scene(n, seed=0, sh_degree=3, spread=2.5, depth_range=(3.0, 7.0),
               scale_range=(-4.6, -3.0)):
    """bench.py's scene, drawn in the order tests/helpers.py draws it."""
    rng = np.random.default_rng(seed)
    means = np.stack([
        rng.uniform(-spread, spread, n),
        rng.uniform(-spread, spread, n),
        rng.uniform(depth_range[0] - 5.0, depth_range[1] - 5.0, n),
    ], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(scale_range[0], scale_range[1], (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.2, 0.95, n).astype(np.float32)
    sh = rng.normal(scale=0.3, size=(n, 3, (sh_degree + 1) ** 2)).astype(np.float32)
    sh[:, :, 0] += 0.8
    return means, scales, quats, opacities, sh


def raw_params(means, scales, quats, opacities, sh):
    """Activated scene -> the snapshot's raw (pre-activation) fields."""
    return dict(xyz=means, f_dc=sh[:, :, :1], f_rest=sh[:, :, 1:],
                scaling=np.log(scales), rotation=quats,
                opacity=np.log(opacities / (1.0 - opacities))[:, None])


def view_request(tf, MiniCam, yaw_deg, pitch_deg, width=W, height=H):
    """bench.py's camera (at z = -5 looking down +z) turned by yaw/pitch."""
    y, p = math.radians(yaw_deg), math.radians(pitch_deg)
    ry = np.array([[math.cos(y), 0, math.sin(y)], [0, 1, 0], [-math.sin(y), 0, math.cos(y)]])
    rx = np.array([[1, 0, 0], [0, math.cos(p), -math.sin(p)], [0, math.sin(p), math.cos(p)]])
    R = ry @ rx  # camera-to-world rotation
    center = np.array([0.0, 0.0, -5.0])
    view = tf.world_to_view(R, -R.T @ center)
    full = (tf.projection_matrix(0.01, 100.0, FOV, FOV) @ view).astype(np.float32)
    return MiniCam(width, height, FOV, FOV, 0.01, 100.0, view, full)


def cuda_ms(fn, reps=REPS, warmup=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


GRAD_NAMES = ("means", "scales", "quats", "opacities", "sh", "bg", "means2d_offset")


def small_scene_grads(rast, scene, cam):
    """Gradients of a fixed loss of the small scene's render with respect
    to every differentiable input, on the scene's device."""
    dev = scene[0].device
    inputs = [a.clone().requires_grad_(True) for a in scene]
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev, requires_grad=True)
    offset = torch.zeros((scene[0].shape[0], 2), device=dev, requires_grad=True)
    out = rast.rasterize(*inputs, cam, bg, sh_degree=3, max_instances=1 << 15,
                         means2d_offset=offset)
    target = torch.linspace(0.0, 1.0, out.color.numel(), device=dev).reshape(out.color.shape)
    loss = ((out.color - target) ** 2).mean() + 0.2 * out.final_t.mean()
    return torch.autograd.grad(loss, inputs + [bg, offset])


def fit_caps(state, cams, bg, caps):
    """(max_instances, max_live) that hold every view of ``state``: the
    given ones where they do, else rounded up from the largest need."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import renderer

    need_enum = need_live = 0
    with torch.no_grad():
        for cam in cams:
            out = renderer.render(cam.params(), state, bg, max_sh_degree=3,
                                  max_instances=1 << 23, max_live=1 << 23)
            need_enum = max(need_enum, int(out.num_enumerated))
            need_live = max(need_live, int(out.num_instances))
    return tuple(c if need <= c else -(-need * 5 // 4 // CAP_QUANTUM) * CAP_QUANTUM
                 for need, c in ((need_enum, caps[0]), (need_live, caps[1])))


def train_phase(params, cams, targets, bg):
    """Phase 8: the training path on the 300k model. Returns the losses,
    densify counts, the kernels' launches over the run, the capacities,
    the state after the first 8 steps and its train step."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(params.f_dc.shape, generator=gen, device="cuda")
    start = params._replace(f_dc=params.f_dc + 0.1 * noise)
    state = gm.init_training(start, 3, tx, capacity=gm.next_pow2(N))
    if state.params.xyz.shape[0] != 524_288 or int(gm.num_active(state)) != N:
        raise AssertionError("training state is not 300,000 active of 524,288 slots")
    caps = (MAX_INSTANCES, MAX_LIVE)
    step = train_lib.make_train_step(tx, opt, 3, W, H, *caps)
    views = [train_lib.camera_arrays(c.params()) for c in cams]
    losses, l1s, psnrs = [], [], []

    def run(state, step, i):
        v = i % len(cams)
        state, aux = step(state, *views[v], targets[v], bg, True)
        vals = [float(aux.loss), float(aux.l1), float(aux.psnr)]
        if not all(math.isfinite(x) for x in vals):
            raise AssertionError(f"step {i}: loss/L1/PSNR not finite: {vals}")
        if bool(aux.overflow):
            raise AssertionError(f"step {i}: instance capacity overflow at {caps}")
        for acc, x in zip((losses, l1s, psnrs), vals):
            acc.append(x)
        log(f"train step {i}: view {v}, loss {vals[0]:.6f}, L1 {vals[1]:.6f}, "
            f"PSNR {vals[2]:.3f}, instances {int(aux.num_instances)}")
        return state

    torch.cuda.synchronize()
    for kern in backend.kernels():
        kern.launches = 0
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state = run(state, step, i)
    state8 = state
    n = len(cams)
    first, second = sum(losses[:n]), sum(losses[TRAIN_STEPS - n:TRAIN_STEPS])
    if not second < first:
        raise AssertionError(f"loss did not fall: {losses}")
    state = train_lib.grow_for_densify(state, opt)
    state, info = train_lib.densify_step(state, gen, opt, EXTENT, 0.0)
    densify = {k: int(v) for k, v in info.items()}
    densify["capacity"] = state.params.xyz.shape[0]
    log(f"densify: {densify}")
    state = gm.reset_opacity(state)
    caps = fit_caps(state, cams, bg, caps)
    if caps != (MAX_INSTANCES, MAX_LIVE):
        step = train_lib.make_train_step(tx, opt, 3, W, H, *caps)
    for i in range(TRAIN_STEPS, TRAIN_STEPS + 2):
        state = run(state, step, i)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in backend.kernels()}
    log(f"trained {len(losses)} steps in {time.perf_counter() - t0:.1f} s "
        f"(probe and densify included); launches {launches}; capacities {caps}")
    for name in ("blend_bwd", "segsum"):
        if launches[name] != len(losses):
            raise AssertionError(f"{name} ran {launches[name]} times in {len(losses)} steps")
    for name in ("expand_seg", "blend_fwd"):
        if launches[name] < len(losses):
            raise AssertionError(f"{name} ran {launches[name]} times in {len(losses)} steps")
    if int(gm.num_active(state)) <= 0:
        raise AssertionError("no active gaussian left")
    return dict(losses=losses, l1=l1s, psnr=psnrs, densify=densify, launches=launches,
                caps=list(caps), state8=state8,
                step=train_lib.make_train_step(tx, opt, 3, W, H, MAX_INSTANCES, MAX_LIVE))


def splat_inputs(state, cam):
    """What the splat's forward computes for ``state`` at camera params
    ``cam``: the sorted instances, the feature array and the forward
    compositor's output."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import renderer
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, projection

    p = state.params
    with torch.no_grad():
        sh = gm.get_sh(p) * renderer.sh_band_mask(3, 3, p.xyz.device)[None, None, :]
        prep = projection.preprocess(p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p),
                                     sh, 3, cam, active_mask=state.active)
        si = binning.build_sorted_instances(
            prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, -(-W // 32),
            -(-H // 32), MAX_INSTANCES, 32, max_live=MAX_LIVE)
        feat = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)
        return si, feat, blend.blend_fwd(feat, si.binning.offsets, -(-W // 32), -(-H // 32))


def backward_checks(state, cam, target, bg, step):
    """Phase 9: the backward kernels against their plain versions on the
    front view's real cotangents, their bounds, and the timings of the
    train step (whole, by phase, peak memory) and of the kernels."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend, segsum
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops

    gx, gy = -(-W // 32), -(-H // 32)
    cp = cam.params()
    si, feat, fwd = splat_inputs(state, cp)
    b = si.binning
    tiles = fwd.clone().requires_grad_(True)
    color, _ = blend.assemble_tiles(tiles, gx, gy, 32, bg)
    color = color[:, :H, :W]
    loss = 0.8 * ssim_ops.l1_loss(color, target) + 0.2 * (1.0 - ssim_ops.ssim(color, target))
    (cot,) = torch.autograd.grad(loss, tiles)
    cot = cot.contiguous()

    with torch.no_grad():
        k3 = blend.blend_bwd(feat, b.offsets, fwd, cot, gx, gy)
        k3_work = {}
        k3_plain = blend.blend_bwd_plain(feat, b.offsets, fwd, cot, gx, gy, work=k3_work)
        torch.cuda.synchronize()
        n_live = int(b.offsets[-1])
        rowmax = k3_plain.abs().amax(dim=1, keepdim=True)
        k3_err = (k3 - k3_plain).abs()
        if (k3_err > 1e-3 * rowmax + 1e-3 * k3_plain.abs()).any():
            raise AssertionError(f"blend_bwd disagrees with its plain version: per-row max "
                                 f"|err| {k3_err.amax(dim=1).tolist()}")
        # positions in chunks at or past chunks_done must be exactly zero
        tile_of = b.tile_id[:n_live].to(torch.int64)
        start = (b.offsets[:-1].to(torch.int64) // blend.CHUNK) * blend.CHUNK
        chunk_of = (torch.arange(n_live, device=feat.device) - start[tile_of]) // blend.CHUNK
        past = chunk_of >= fwd[:, 0, 4].to(torch.int64)[tile_of]
        if k3[:, :n_live][:, past].any() or k3[:, n_live:].any():
            raise AssertionError("blend_bwd wrote gradients past chunks_done")
        log(f"blend_bwd vs plain: per-row max |err| "
            f"{[f'{e:.3g}' for e in k3_err.amax(dim=1).tolist()]} of row max "
            f"{[f'{m:.3g}' for m in rowmax[:, 0].tolist()]}; {int(past.sum())} instances "
            f"past chunks_done are 0")

        table, bounds = blend.id_order_table(k3, si.id_pos, b.gauss_start, b.gauss_count,
                                             MAX_INSTANCES)
        k4 = segsum.segment_sum_bounds(table, bounds)
        k4_plain = segsum.segment_sum_bounds_plain(table, bounds)
        lengths = (bounds[1:] - bounds[:-1]).to(torch.int64)
        b0, b1 = int(bounds[0]), int(bounds[-1])
        data = table[:, b0:b1].T.contiguous()
        k4_lib = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
        torch.cuda.synchronize()
        k4_err = (k4 - k4_plain).abs()
        k4_rowmax = k4_plain.abs().amax(dim=1, keepdim=True)
        if (k4_err > 1e-5 * k4_rowmax).any():
            raise AssertionError(f"segsum disagrees with its plain version: per-row max "
                                 f"|err| {k4_err.amax(dim=1).tolist()}")
        lib_err = float((k4_lib.T - k4_plain).abs().max())
        log(f"segsum vs plain: max |err| {float(k4_err.max()):.3g} (row max up to "
            f"{float(k4_rowmax.max()):.3g}); torch.segment_reduce vs plain {lib_err:.3g}; "
            f"{lengths.numel()} segments over {b1 - b0} columns")

        k3_ms = cuda_ms(lambda: blend.blend_bwd(feat, b.offsets, fwd, cot, gx, gy))
        k3_plain_ms = cuda_ms(lambda: blend.blend_bwd_plain(feat, b.offsets, fwd, cot, gx, gy))
        k4_ms = cuda_ms(lambda: segsum.segment_sum_bounds(table, bounds))
        k4_plain_ms = cuda_ms(lambda: segsum.segment_sum_bounds_plain(table, bounds))
        k4_lib_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=0))

    # bounds from the work this run's front view needs. K3, over the chunks
    # before chunks_done: per (pixel, in-range instance) pair the forward's
    # 10 flops; where power <= 0 an exp and 2 flops; per pair that passes
    # the gate a log, an exp and a reciprocal, and 34 flops (clamp, 1-a,
    # log-T step, weight, 3 weighted cotangents, G, d_power, S, the 9
    # moment sums); a log of opacity per staged instance. Bytes: 9 feature
    # rows of the live instances, the forward output and the cotangent
    # read, 9 gradient rows written.
    lanes, exp_lanes, kept = k3_work["lanes"], k3_work["exp_lanes"], k3_work["kept"]
    k3_sfu = exp_lanes + 3 * kept + lanes // 1024
    k3_flops = 10 * lanes + 2 * exp_lanes + 34 * kept
    k3_bytes = 4 * (9 * n_live + b.offsets.numel() + fwd.numel() + cot.numel() + 9 * n_live)
    k3_times = {"operations": max(k3_sfu / SFU_OPS_PER_S, k3_flops / FP32_FLOPS_PER_S),
                "bytes": k3_bytes / HBM_BYTES_PER_S}
    k3_by = max(k3_times, key=k3_times.get)
    # K4: the columns inside the segments read once (9 rows), the bounds
    # read, the (9, N) sums written; one add per value read
    k4_bytes = 4 * (table.shape[0] * (b1 - b0) + bounds.numel() + k4.numel())
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
    log(f"blend_bwd: pairs in range {lanes}, power <= 0 {exp_lanes}, kept {kept}; "
        f"{k3_sfu} transcendentals {k3_sfu / SFU_OPS_PER_S * 1e3:.4f} ms, {k3_flops} fp32 "
        f"flops {k3_flops / FP32_FLOPS_PER_S * 1e3:.4f} ms, {k3_bytes / 1e6:.1f} MB "
        f"{k3_times['bytes'] * 1e3:.4f} ms")
    log(f"segsum: {k4_bytes / 1e6:.1f} MB moved, bound {k4_bound:.4f} ms (bytes)")

    # the train step on the 300k model (front view): whole, by phase, memory
    args = (*train_lib.camera_arrays(cp), target, bg, True)
    step_ms = cuda_ms(lambda: step(state, *args))
    phases = {k: [] for k in ("forward", "loss", "backward", "optimizer")}
    for _ in range(REPS):
        t0 = torch.cuda.Event(enable_timing=True)
        events = []
        t0.record()
        step(state, *args, events=events)
        events[-1][1].synchronize()
        prev = t0
        for name, ev in events:
            phases[name].append(prev.elapsed_time(ev))
            prev = ev
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    step(state, *args)
    torch.cuda.synchronize()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    split = {k: statistics.median(v) for k, v in phases.items()}
    log(f"train step (front view, 524,288 slots): {step_ms:.3f} ms median of {REPS}; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        + f"; peak {peak_mib:.0f} MiB ({base_mib:.0f} MiB held before the step)")
    return {
        "blend_bwd": {"max_abs_err": float(k3_err.max()), "ms": k3_ms,
                      "plain_ms": k3_plain_ms, "bound_ms": k3_times[k3_by] * 1e3,
                      "bound_by": k3_by, "library_ms": None},
        "segsum": {"max_abs_err": float(k4_err.max()), "ms": k4_ms, "plain_ms": k4_plain_ms,
                   "bound_ms": k4_bound, "bound_by": "bytes", "library_ms": k4_lib_ms},
        "step": {"ms": step_ms, "split_ms": split, "peak_mib": peak_mib,
                 "held_mib": base_mib},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, renderer, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, expand
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as tf
    from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import MiniCam

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = backend.build_kernels()
    if built:
        log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
            + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()))
    else:
        log(f"build: libraries already up to date in {backend.BUILD_DIR}")
    for kern in backend.kernels():
        for line in backend.build_log(kern.stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kern.stem}: {line.strip()}")

    # -- 3. the model, through a PLY snapshot --------------------------------
    t0 = time.perf_counter()
    scene = make_scene(N)
    raw = raw_params(*scene)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "point_cloud.ply")
        ply_io.save_gaussians_ply(path, gm.GaussianParams(**raw), np.ones(N, bool))
        params, sh_degree = ply_io.load_gaussians_ply(path)
    for name, want in raw.items():
        got = getattr(params, name).cpu().numpy()
        if not np.array_equal(got, want.astype(np.float32)):
            raise AssertionError(f"PLY round trip changed {name}")
    if sh_degree != 3:
        raise AssertionError(f"PLY gave sh degree {sh_degree}")
    state = gm.state_from_params(params, sh_degree)
    bg = torch.zeros(3, device=dev)
    log(f"scene: {N} gaussians, SH {sh_degree}, PLY round trip ok "
        f"({time.perf_counter() - t0:.1f} s)")

    cams = [view_request(tf, MiniCam, y, p) for y, p in VIEWS]
    render = train_lib.make_eval_render(3, W, H, max_instances=MAX_INSTANCES,
                                        max_live=MAX_LIVE)

    # -- 4. capacity probe, then the served requests -------------------------
    for (yaw, pitch), cam in zip(VIEWS, cams):
        with torch.no_grad():
            out = renderer.render(cam.params(), state, bg, max_sh_degree=3,
                                  max_instances=MAX_INSTANCES, max_live=MAX_LIVE)
        log(f"view yaw {yaw} pitch {pitch}: enumerated {int(out.num_enumerated)}, "
            f"live {int(out.num_instances)}, overflow {bool(out.overflow)}")
        if bool(out.overflow):
            raise AssertionError("instance capacity overflow; raise max_instances/max_live")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in backend.kernels():
        kern.launches = 0
    images = [render(state, *train_lib.camera_arrays(cam.params()), bg, 1.0) for cam in cams]
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in backend.kernels()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    log(f"served {len(cams)} requests; launches {launches}; peak memory {peak_mb:.0f} MiB")
    for name in ("expand_seg", "blend_fwd"):
        if launches[name] < len(cams):
            raise AssertionError(f"{name} ran {launches[name]} times for {len(cams)} requests")
    if launches["blend_bwd"] or launches["segsum"]:
        raise AssertionError("serving launched a backward kernel")
    for img in images:
        if img.shape != (3, H, W) or not torch.isfinite(img).all():
            raise AssertionError(f"bad image: shape {tuple(img.shape)}")
        lo, hi = float(img.min()), float(img.max())
        if lo < 0.0 or hi > 2.0 or hi == 0.0:
            raise AssertionError(f"image range [{lo}, {hi}] is not a render")
    log("images: finite, " + ", ".join(f"mean {float(i.mean()):.4f}" for i in images))

    # -- 5. kernels vs plain versions on the front view's inputs -------------
    with torch.no_grad():
        cam = cams[0].params()
        p = state.params
        sh = gm.get_sh(p) * renderer.sh_band_mask(3, 3, dev)[None, None, :]
        prep = projection.preprocess(p.xyz, gm.get_scaling(p), p.rotation,
                                     gm.get_opacity(p), sh, 3, cam,
                                     active_mask=state.active)
        bin_args = (prep.means2d, prep.conics, prep.rgb, prep.opacities,
                    prep.tiles_touched, prep.rect_min, prep.rect_max,
                    prep.cull_thr, prep.depths)
        table, _ = binning.compact_table(*bin_args)
        k1 = expand.expand_rows_by_segments(table, 0, MAX_INSTANCES)
        k1_plain = expand.expand_rows_by_segments_plain(table, 0, MAX_INSTANCES)
        torch.cuda.synchronize()
        k1_mismatch = int((k1 != k1_plain).sum())
        finite = torch.isfinite(k1) & torch.isfinite(k1_plain)
        k1_err = float((k1 - k1_plain)[finite].abs().max())
        log(f"expand_seg vs plain: {k1_mismatch} of {k1.numel()} values differ "
            f"(max |err| {k1_err})")
        if k1_mismatch:
            raise AssertionError("expand_seg is not bit-exact")

        gx, gy = -(-W // 32), -(-H // 32)
        si = binning.build_sorted_instances(*bin_args, gx, gy, MAX_INSTANCES, 32,
                                            max_live=MAX_LIVE)
        feat_soa = blend.feat_soa_from_rows(si.feat_rows, 128)
        offsets = si.binning.offsets
        k2 = blend.blend_fwd(feat_soa, offsets, gx, gy)
        k2_work = {}  # the pairs these inputs need, counted by the plain version
        k2_plain = blend.blend_fwd_plain(feat_soa, offsets, gx, gy, work=k2_work)
        torch.cuda.synchronize()
        k2_err = float((k2[..., 0:4] - k2_plain[..., 0:4]).abs().max())
        bad_tiles = torch.nonzero(k2[:, 0, 4] != k2_plain[:, 0, 4]).flatten().tolist()
        log(f"blend_fwd vs plain: max |err| rgb/final_T {k2_err:.3g}, chunks_done "
            f"differs on {len(bad_tiles)} of {gx * gy} tiles {bad_tiles[:20]}")
        if not k2_err <= 1e-3:
            raise AssertionError("blend_fwd disagrees with its plain version")
        if len(bad_tiles) > 0.001 * gx * gy:
            raise AssertionError("blend_fwd chunks_done differs on too many tiles")
        chunks = k2[:, 0, 4].to(torch.float64)
        if not torch.equal(k2[:, :, 4], k2[:, :1, 4].expand(-1, 1024)):
            raise AssertionError("chunks_done is not tile-uniform")

        # -- 6. timings ------------------------------------------------------
        view_ms = [cuda_ms(lambda c=c: render(state, *train_lib.camera_arrays(c.params()),
                                              bg, 1.0)) for c in cams]
        log("view ms (median of 10): " + ", ".join(f"{t:.3f}" for t in view_ms))
        seg = table[0].contiguous()
        slots = torch.arange(MAX_INSTANCES, dtype=torch.float32, device=dev)

        def k1_library():
            ck = (torch.searchsorted(seg, slots, right=True) - 1).clamp_(0, table.shape[1] - 1)
            return table.index_select(1, ck)

        k1_ms = cuda_ms(lambda: expand.expand_rows_by_segments(table, 0, MAX_INSTANCES))
        k1_plain_ms = cuda_ms(lambda: expand.expand_rows_by_segments_plain(
            table, 0, MAX_INSTANCES))
        k1_lib_ms = cuda_ms(k1_library)
        k2_ms = cuda_ms(lambda: blend.blend_fwd(feat_soa, offsets, gx, gy))
        k2_plain_ms = cuda_ms(lambda: blend.blend_fwd_plain(feat_soa, offsets, gx, gy))

    # bounds from the work this run's inputs need. K1: every slot written
    # once, the live columns read once (dead ones past them are never read)
    rows = table.shape[0]
    live_cols = max(1, int(torch.isfinite(table[0]).sum()))
    k1_bytes = 4 * rows * (MAX_INSTANCES + live_cols)
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    # K2, over the chunks the tiles run: per (pixel, in-range instance) pair
    # 10 fp32 flops (offsets, the FMA-chained power, its test); where power
    # <= 0 one exp and 2 flops; per pair that passes the alpha gate a log
    # and an exp and 11 flops (clamp, weight, 3 colour FMAs, log-T update);
    # one log of opacity per in-range instance staged. 9 feature rows of
    # the live instances read once, the tiles written once
    lanes, exp_lanes, kept = k2_work["lanes"], k2_work["exp_lanes"], k2_work["kept"]
    k2_sfu = exp_lanes + 2 * kept + lanes // 1024
    k2_flops = 10 * lanes + 2 * exp_lanes + 11 * kept
    k2_bytes = 4 * (9 * int(offsets[-1]) + offsets.numel() + k2.numel())
    k2_times = {"operations": max(k2_sfu / SFU_OPS_PER_S, k2_flops / FP32_FLOPS_PER_S),
                "bytes": k2_bytes / HBM_BYTES_PER_S}
    k2_bound_by = max(k2_times, key=k2_times.get)
    log(f"expand_seg: {live_cols} live columns, {k1_bytes / 1e6:.1f} MB moved, "
        f"bound {k1_bound:.4f} ms (bytes)")
    log(f"blend_fwd: {int(chunks.sum())} chunks; pairs in range {lanes}, power <= 0 "
        f"{exp_lanes}, kept {kept}; {k2_sfu} transcendentals "
        f"{k2_sfu / SFU_OPS_PER_S * 1e3:.4f} ms, {k2_flops} fp32 flops "
        f"{k2_flops / FP32_FLOPS_PER_S * 1e3:.4f} ms, "
        f"{k2_bytes / 1e6:.1f} MB {k2_times['bytes'] * 1e3:.4f} ms")

    # -- 7. small scene: card (kernels) vs CPU (plain versions) ---------------
    small = [torch.from_numpy(a) for a in make_scene(2000, seed=1, spread=1.5,
                                                     scale_range=(-3.5, -2.0))]
    small_cam = view_request(tf, MiniCam, 4.0, -2.0, 128, 96)
    outs = {}
    with torch.no_grad():
        for d in ("cuda", "cpu"):
            outs[d] = rast.rasterize(*(a.to(d) for a in small), small_cam.params(device=d),
                                     torch.tensor([0.1, 0.2, 0.3], device=d),
                                     sh_degree=3, max_instances=1 << 15)
    g, c = outs["cuda"], outs["cpu"]
    for name in ("color", "final_t"):
        if not torch.allclose(getattr(g, name).cpu(), getattr(c, name), atol=3e-4, rtol=1e-3):
            raise AssertionError(f"small scene: {name} differs between card and CPU")
    for name in ("radii", "num_instances", "num_enumerated", "overflow"):
        if not torch.equal(getattr(g, name).cpu(), getattr(c, name)):
            raise AssertionError(f"small scene: {name} differs between card and CPU")
    small_err = float((g.color.cpu() - c.color).abs().max())
    log(f"small scene 128x96, 2000 gaussians: card vs CPU max |err| {small_err:.3g}, "
        f"{int(g.num_instances)} instances on both")
    grads = {d: small_scene_grads(rast, [a.to(d) for a in small], small_cam.params(device=d))
             for d in ("cuda", "cpu")}
    grad_errs = {}
    for name, a, b in zip(GRAD_NAMES, grads["cuda"], grads["cpu"]):
        if not (torch.allclose(a.cpu(), b, atol=2e-3, rtol=5e-3) and b.abs().max() > 0):
            raise AssertionError(f"small scene: d{name} differs between card and CPU")
        grad_errs[name] = float((a.cpu() - b).abs().max())
    log("small scene gradients card vs CPU max |err|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in grad_errs.items()))

    # -- 8. training ------------------------------------------------------
    train = train_phase(params, cams, images, bg)
    # -- 9. backward kernels vs plain versions, timings -----------------------
    bwd = backward_checks(train["state8"], cams[0], images[0], bg, train["step"])

    src = "gaussian_splatting_with_eye_tracking_tpu_torch/csrc/{}.cu"
    kernels = [
        {"name": "expand_seg", "route": "cuda", "source": src.format("expand_seg"),
         "replaces": REPLACES["expand_seg"], "launches": launches["expand_seg"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": k1_lib_ms},
        {"name": "blend_fwd", "route": "cuda", "source": src.format("blend_fwd"),
         "replaces": REPLACES["blend_fwd"], "launches": launches["blend_fwd"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_times[k2_bound_by] * 1e3, "bound_by": k2_bound_by,
         "library_ms": None},
        {"name": "blend_bwd", "route": "cuda", "source": src.format("blend_bwd"),
         "replaces": REPLACES["blend_bwd"], "launches": train["launches"]["blend_bwd"],
         **bwd["blend_bwd"]},
        {"name": "segsum", "route": "cuda", "source": src.format("segsum"),
         "replaces": REPLACES["segsum"], "launches": train["launches"]["segsum"],
         **bwd["segsum"]},
    ]
    log(json.dumps({"views_ms": view_ms, "peak_mib": peak_mb, "card": smi}))
    log(json.dumps({"train": {k: train[k] for k in ("losses", "l1", "psnr", "densify",
                                                     "launches", "caps")},
                    "step": bwd["step"], "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
