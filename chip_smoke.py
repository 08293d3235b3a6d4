#!/usr/bin/env python3
"""Drive the PyTorch port's serving, eye-tracked foveated serving and
training paths, its train -> render -> metrics CLIs, its entry points,
RITnet's training and evaluation, the kernels against the oracles, the
trained model's bench, the viewer, multi-GPU training, the study
scripts and the numerics suite, on one CUDA card and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

 1. print the card's name and power limit (nvidia-smi);
 2. build the hand-written kernels from the package's ``csrc/`` with nvcc,
    print ptxas' registers / shared memory / spills per source, and for the
    redesigned kernels (K2, K3, the AMR compositors, K4) their CTAs per SM;
 3. make bench.py's scene in numpy (300,000 gaussians, SH degree 3, seed
    0), write it as a PLY snapshot with the port and load it back;
 4. serve four 1920x1088 view requests (bench.py's front camera and three
    small yaw/pitch offsets) through ``train_lib.make_eval_render`` with
    bench.py's capacities, after a capacity probe that fails on overflow;
    the kernels' launch counters are zeroed just before and read just
    after, and each kernel must have run once per request;
 5. on the front view's real inputs, hold each kernel against its plain
    PyTorch version (expand bit-exact; blend rgb/final_T within 1e-3 and
    chunks_done equal on all but 0.1% of tiles, and a second blend launch
    bit-identical to the first); the preprocess kernel (K7) at the served
    shapes (the 300k scene; 1M of its gaussians in 4,194,304 slots, the
    rest inert and inactive): radii, tiles and rects equal on every slot,
    culled slots' opacity and colour 0, the floats within ``PREP_TOL``,
    timed with its plain version; the binning pipeline (K8) on the 300k
    front view (``max_live`` below the capacity) and on 1M of the scene's
    gaussians in 4,194,304 slots at 2^23: every field bit for bit the
    plain version's (``binning_mismatch``), its launch calls counted (2),
    timed as called and by its device operations alone (torch.profiler,
    from a capture that caught every call's), with their count, its bytes
    bound and its registers and spills, beside the plain version; the
    segment expand (K1, which the main path no longer calls) on the front
    view's compact table; the index expand (K6, which no path of the
    package calls) along the segment expand's own slot -> column map,
    bit-exact against its plain version and against the segment expand's
    output;
 6. time each view and each kernel with CUDA events (warm-up, then the
    median of 10), beside the plain versions and the library yardstick
    (the segment expand also as a share of its bytes bound);
    K2 (and K3 in phase 13) also as the kernel's launch alone, its launch
    order made beforehand, heaviest tiles first and in tile order (both
    bit-identical to the wrapper's output);
 7. eye tracking: draw a synthetic 640x400 eye (seed 0, pupil at gaze uv
    (0.55, 0.45)) and run RITnet and ``track_render.estimate_gaze`` on the
    card and on the CPU (logits within 1e-3 of their largest magnitude,
    class maps differing on at most 0.1% of pixels, gaze within 1 px);
 8. foveated frames of the served model at the front camera, gaze from
    phase 7, rings (H/8, H/4, H/2), bench.py's enumeration capacity, through
    ``track_render.foveated_view``: the 5-step frame, the fused frame
    (within 1e-3 of the 5-step one), the fused frame with decimation
    (4, 2, 1, 1) and with ``predecimate`` (fewer instances); no overflow,
    images finite and in range; the launch counters, zeroed before each
    frame, show ``blend_round`` 4 times per 5-step frame, ``blend_levels``
    once per fused frame, and no other compositor;
 9. on that view's inputs, hold the foveated kernels against their plain
    versions (each round as the 5-step frame launches it, in its one
    launch order and split; the levels kernel in its three decimation
    modes): rgb/final_T within 1e-3 on the rows rendered, zero rows above
    a tile's level, chunks run equal on all but 0.1% of tiles; each round
    at every split (final_T, chunks run and logT bit-identical to one CTA
    per tile) and in tile order (bit-identical); the levels kernel alone
    launched heaviest tiles first and in tile order, twice each,
    bit-identical to its wrapper's output, and its cost with every tile
    at level 1 and at level 4;
10. time them (each round with its gated-tile count, at every split and
    in tile order, the four rounds' total, the frame's order), and the
    foveated breakdown (``fps_foveated``: step 0, each round, each frame,
    the plain view), RITnet, and eye image -> frame;
11. render a small scene on the card and on the CPU (plain versions) and
    compare them (atol 3e-4 / rtol 1e-3, integer outputs exact), then its
    gradients with respect to every input (atol 2e-3 / rtol 5e-3);
12. train: the same model with f_dc perturbed by N(0, 0.1), in a training
    state of next_pow2(300,000) = 524,288 slots with the default
    OptimizationConfig, fitted to the images served in phase 4: 8 train
    steps over the four views (stats accumulated), a densify step (the
    capacity grown first to cover every candidate), an opacity reset,
    and 2 more steps at the capacities a probe then asks for. Loss, L1
    and PSNR finite at every step; the second pass over the views has a
    lower loss than the first; the launch counters, zeroed before and read
    after, show the backward kernels once per step;
13. on the front view's real cotangents, hold the backward kernels
    against their plain versions (blend_bwd per row within 1e-3 of the
    row's largest value plus 1e-3 of each value, and exactly 0 on chunks
    past chunks_done, and a second launch bit-identical to the first;
    the per-gaussian reduction as the step runs it, ``segment_reduce_grads``,
    and segsum on the id-order table within 1e-5 of the row's largest
    value, the reduction bit-identical between two launches), time the
    reduction as the step runs it, its kernel alone, the table route and
    the library yardsticks (``torch.segment_reduce`` on the id-order
    table, one ``index_add_`` over gauss_id), and time the train step, its
    phases, its peak memory and the kernels;
14. the CLIs on a synthesized COLMAP scene (train_regression_r04's: 24
    cameras at 256x256, GT rendered from a 3000-gaussian mixture), in one
    process through each module's ``main``: ``train`` for 1000 steps with
    the default OptimizationConfig (densify from 500 every 100, SH
    annealing, adaptive capacity) and evaluations at 500 and 1000,
    ``render``, ``metrics``. Every loss finite (the trainer raises
    otherwise); test PSNR at 1000 >= 18 dB and above the one at 500;
    ``blend_bwd`` and ``segsum`` launched at least 1000 times and
    ``binning`` / ``blend_fwd`` more; 3 test renders of 256x256;
    results.json's PSNR within 0.2 dB of the trainer's at 1000 (PNG
    quantisation); the checkpoint loads back bit for bit;
15. the serving-side entry points, in this process through each module's
    ``main``, the launch counters zeroed before and read after each:
    ``bench`` (its last line the root bench.py's four keys, value > 0;
    K8, K2-K4 launched on every timed step); ``fps_test`` on the synthetic
    100k scene at ratios 0.2, 1.0 and 2.0 (up to 3840x2144, 8,040 tiles),
    vanilla and AMR, and on the CLI model through ``-m`` alone (its
    ``cfg_args`` overlaid) at 1.0: no overflow at the capacity used, times
    finite, the JSON written; at 3840x2144 K1 bit for bit against its
    plain version at the capacities the sweeps settled on, and K2 and the
    four rounds against theirs at phase 5's and phase 9's gates;
    ``fps_foveated``
    on the CLI model with ``--gaze`` and on the synthetic scene at
    1920x1080 (a 24 px last tile row) with ``--gaze --decimate 4 2 1 1``:
    the root script's document keys, the fused frame within 1e-3 of the
    5-step frame, the rounds and the levels kernel against their plain
    versions on the rendered rows, ``--alpha bf16`` refused;
    ``track_render`` on the CLI model with the synthetic eye as a PNG, 4
    views: the renders at the camera size, ``eye_seg_pred.png`` written,
    the gaze within 1 px of phase 7's, each render within 1/255 + 1e-3 of
    ``foveated_view``'s 5-step frame, ``blend_round`` 4 times per view;
16. RITnet training and evaluation at full width (32 channels, 249,220
    parameters) on a synthetic OpenEDS-style dataset written from a seed
    (16 training and 8 validation eyes at 640x400, PNG images and .npy
    class maps of the same geometry as phase 7's eye): ``train_ritnet`` for
    2 epochs at batch 8 (every loss, parameter and BatchNorm statistic
    finite, ``running_var`` above -1e-5, both ``.npz`` files load back bit
    for bit, no hand-written kernel launched: the path is cuDNN
    convolutions); the same ``train_ritnet`` run again in another
    directory, its ``.npz`` parameters and logged losses bit for bit the
    first's (cuDNN's deterministic algorithms); one ``make_train_step``
    step on the card and on the CPU
    from the same JAX-scheme parameters on the same batch of 2 (loss within
    1e-4 relative, the card's gradients within 1e-4 of each tensor's
    largest of a float64 run on the card, updates within 1 % of a learning
    rate where the gradient is clear of rounding, at most 1 % of the
    elements not); 30 steps on one batch of 8 lower the
    loss; ``eval_ritnet`` with the trained weights and the labels (its mIoU
    line, a label map and a mask per image) and with the vendored weights
    on phase 7's eye (its class map equal to ``estimate_gaze``'s); timings:
    the train step alone at 8x1x400x640 with its peak memory and fp32
    bound, the host's time per batch of 8 by part, the eval forward per
    image and each epoch's wall time;
17. the parity probe, ``parity_probe.main``, the launch counters zeroed
    before and read after: on the root parity_probe.py's inputs (256x256,
    4,000 gaussians of SH degree 2) ``rasterize``'s kernels against its
    ``impl="jnp"`` oracle (colour within 1e-3, counters equal, the five
    gradients of mean(color^2) + 0.1 mean(final_t) within 2e-2 of the
    oracle's largest), ``bin_gaussians`` against ``build_sorted_instances``
    exactly, ``render_naive`` against ``render_tiles_jnp``, the 5-step AMR
    frame's kernels against its oracle, the blocked 3-NN against cKDTree
    on 50,000 points and its duplicate delta on 5,000 points taken twice;
    K8, K2-K4 and the round kernel launched;
18. the trained model's 1080p bench (``train_regression.trained_bench``)
    on the CLI phase's 1000-step model: live instances, ms of a forward +
    backward, Mpix/s; K8, K2-K4 on every timed step;
19. the viewer: ``train`` resumed from the CLI phase's checkpoint for 3
    iterations with ``--port`` on a free local port; a client asks for a
    256x256 view with train=False, then one with train=True so training
    goes on; both frames equal ``make_eval_render``'s image of the
    checkpoint's state at that camera, quantised to uint8 (at most one
    level apart on < 0.1 % of values), with their round-trip times;
20. multi-GPU training on the served model at 1920x1088 and phase 12's
    524,288-slot state (``parallel/``): (a) one rank on NCCL in this
    process: ``sharded_render`` at one band against phase 4's front image
    (gate 1e-6), and one step of the tile-band and the gaussian-sharded
    train steps against ``make_train_step``'s (loss within 1e-5 relative;
    each gradient, from Adam's first moment, within 1e-4 of its tensor's
    largest value; the parameters within 1 % of the group's learning rate
    where the one-device gradient is above 1e-3 of its largest, all but
    1 % of those elements), and the three steps' times; (b) two ranks
    sharing the card, as subprocesses of this script on gloo (NCCL refuses
    two ranks on one device): ``sharded_render`` at two bands against the
    same image at (a)'s gate (each band's list starts its chunks where the
    whole image's list has them, so the tile exit falls alike), the band
    exchange (each band's rows equal the live rows
    whose rect meets it, their centres equal as sets, peak memory within
    ``exchange_memory_bytes`` + 10 %), two steps of each train step against
    two one-device steps at (a)'s gates, no band over its capacity, K8 and
    K2 in each rank for each render and K3 and K4 once per rank per step
    (counters zeroed before, read after), and K1-K4 on the last rank's
    band grid (60 x 17 tiles) against their plain versions (K1 bit-exact,
    K2 and K3 at phases 5's and 13's gates, K4 within 1e-5); (c) the
    trainer as two ranks (``python -m ...train``, torchrun's variables, a
    model directory each) on the CLI phase's scene for 40 iterations:
    ``load_checkpoint_dist`` reads iteration 40 and a finite state back
    here, both ranks' states hash alike, only rank 0 wrote (``cfg_args``,
    the PLY); (d) ``scaling_bench`` at 1 device with its defaults;
21. the study scripts, in this process through each module's ``main`` at
    1920x1088, the launch counters zeroed before and read after each:
    ``AMR_test`` on fps_test's synthetic 100k scene and on the CLI
    phase's model (its oracle's three checks hold exactly: the rect pairs
    sum to ``num_enumerated``, the kept pairs per tile equal the
    production counts and ``bin_gaussians``', the percentile levels of
    those equal ``tile_levels``), its 5-step frame again through the
    plain route (every wrapper its plain version, no launch) within 1e-3;
    ``KDtree_test`` (k + 1 kept) and ``opacity_quant_test`` at 4 and 8
    bits (the identity check at 100 dB or more) on the 100k scene, the
    pruned and the quantized frame through the plain route within 1e-3;
    ``amr_quality_sweep`` on the CLI model and 100k, 400k and 1M
    gaussians: no overflow, PSNR and SSIM finite, the JSON written, and a
    (4, 2, 1, 1)-decimated levels launch of each density against its
    plain version at phase 9's gate;
22. the numerics suite (``numerics.py``, the JAX package's
    ``tests_tpu/`` and ``judge_repro/``), held to the limits of
    ``numerics``' checks: the state before a JAX training run's collapse
    read with ``load_jax_checkpoint`` (iteration 3176, 8,192 slots, 2,175
    active, finite) on the scene ``scene_synth`` writes, both once;
    ``numerics.repro``: iteration 3177's step through the kernels against
    the jnp oracle at the train-step tolerances (loss, image, moments,
    parameters, the exact counts; each healthy) and its frame's SSIM map
    bounded and within 1e-4 of float64 per pixel (1e-3 on the mean); the
    same with cuDNN's TF32 on and under bf16 autocast, the latter failing
    the per-pixel check; the dark, flat frames; ``reset_opacity``, 30
    steps and a densify step (losses finite, the model alive); the step
    and the window with launches counted as in phases 20 and 21;
    rasterize's gradients at the three degenerate distributions, kernels
    against the oracle within 1e-3 of each field's largest value; K4's
    table route on a 16-row table against float64 within 1e-5 of each
    row's absolute sum at three shapes; the backward's two reduction
    routes on one set of K3 records within 1e-4 of each field's largest
    value;
23. print a ``{"kernels": [...]}`` line (each kernel's launches on the
    main path, and over phase 20's, 21's and 22's counted runs), then as
    the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import (
    H, MAX_INSTANCES, MAX_LIVE, N, REPS, W, make_scene, raw_params, view_request)
from gsbench.eyes import GRAY, eye_label  # the synthetic eye's one definition

VIEWS = [(0.0, 0.0), (6.0, 0.0), (-5.0, 3.0), (3.0, -4.0)]  # (yaw, pitch) degrees
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
    "preprocess": "none (the JAX package's preprocess is column math that XLA fuses)",
    "binning": "none (the JAX package's build_sorted_instances is XLA ops around K1)",
    "expand_seg": "gaussian_splatting_with_eye_tracking_tpu/ops/expand.py:74",
    "expand_rows": "gaussian_splatting_with_eye_tracking_tpu/ops/expand.py:35",
    "blend_fwd": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:563",
    "blend_bwd": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:600",
    "segsum": "gaussian_splatting_with_eye_tracking_tpu/ops/segsum.py:31",
    "blend_round": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:563",
    "blend_levels": "gaussian_splatting_with_eye_tracking_tpu/ops/pallas_blend.py:1260",
}

CLI_ITERATIONS = 1000  # steps of the CLI phase's training run
CLI_PSNR_MIN = 18.0  # dB at 1000; the JAX package read 19.98 there (TRAIN_r05.json)
TRAIN_R05_POINTS_1000 = 7914  # TRAIN_r05.json's point count at 1000

EYE_H, EYE_W = 400, 640  # the OpenEDS frame that RITnet serves
EYE_GAZE_UV = (0.55, 0.45)  # where the synthetic eye's pupil sits
DECIMATION = (4, 2, 1, 1)  # the gaze-driven frame's per-level steps (ops/amr.py)


def log(*args):
    print(*args, flush=True)


def make_eye(seed=0, height=EYE_H, width=EYE_W, gaze_uv=EYE_GAZE_UV):
    """A synthetic grayscale eye (uint8): ``gsbench.eyes.eye_label``'s
    classes (skin, a sclera ellipse, an iris and a pupil centred at gaze_uv
    * (width, height)) as its gray levels (skin 150, sclera 215, iris 95,
    pupil 25), with N(0, 6) noise from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    img = GRAY[eye_label(height, width, gaze_uv)]
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_eye_dataset(root, n_train, n_val, height=EYE_H, width=EYE_W, seed=0):
    """An OpenEDS-style dataset of synthetic eyes under ``root``:
    ``{train,validation}/images/eNNN.png`` and ``labels/eNNN.npy``, each eye
    at a gaze uv drawn in [0.3, 0.7]^2 from ``default_rng(seed)``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("validation", n_val)):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
        for i in range(n):
            uv = tuple(rng.uniform(0.3, 0.7, 2))
            eye_seed = int(rng.integers(1 << 31))
            Image.fromarray(make_eye(eye_seed, height, width, uv)).save(
                os.path.join(root, split, "images", f"e{i:03d}.png"))
            np.save(os.path.join(root, split, "labels", f"e{i:03d}.npy"),
                    eye_label(height, width, uv))


def cuda_ms(fn, reps=REPS, warmup=1, batch=1):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events;
    with ``batch`` > 1 each run is ``batch`` calls back to back, divided
    by ``batch`` (a short launch then waits for no host time of its own)."""
    for _ in range(warmup):
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


GRAD_NAMES = ("means", "scales", "quats", "opacities", "sh", "bg", "means2d_offset")

PREP_TOL = 1e-6  # K7 against preprocess_plain: each float's gap over max(1, |plain|)
# K7's timed shapes: (gaussians, slots, seed): the 300k scene, and a 1M
# scene's 4,194,304 slots (create_from_points' capacity for 1M points)
PREP_SHAPES = {"300k": (N, N, 0), "4M_1M": (1_000_000, 1 << 22, 2)}


def preprocess_params(n, slots, seed, dev):
    """bench.py's scene of ``n`` gaussians (from ``seed``) in ``slots``
    slots, the rest ``_pad_params``' inert fills and inactive: (the raw
    ``GaussianParams``, the active mask or None)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    raw = raw_params(*make_scene(n, seed=seed))
    p = gm.GaussianParams(**{k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
                             for k, v in raw.items()})
    active = None
    if slots > n:
        p = gm._pad_params(p, slots)
        active = torch.arange(slots, device=p.xyz.device) < n
    return p, active


def preprocess_inputs(n, slots, seed, dev):
    """``preprocess_params``' scene activated as the renderer activates it
    at SH degree 3: ((means, scales, quats, opacities, sh), the active mask
    or None)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    p, active = preprocess_params(n, slots, seed, dev)
    return gm.activate(p, 3, 3), active


def bits_equal(a, b) -> bool:
    """Two records' field equal bit for bit (a NaN on both sides counts as
    equal, whatever its payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def raw_mismatch(raw, act, plain) -> list:
    """The fields where K7's record from the raw form (``raw``) differs
    from its record from the activated form (``act``) or from
    ``preprocess_plain``'s (``plain``), bit for bit: every field against
    K7's, every field but a culled slot's rgb (0 in K7's) against the
    plain version's."""
    bad = [f"{name} (activated form)" for name in act._fields
           if not bits_equal(getattr(raw, name), getattr(act, name))]
    drawn = plain.radii > 0
    for name in plain._fields:
        a, b = getattr(raw, name), getattr(plain, name)
        if name == "rgb":
            ok = bits_equal(a[drawn], b[drawn]) and not a[~drawn].any()
        else:
            ok = bits_equal(a, b)
        if not ok:
            bad.append(f"{name} (plain)")
    return bad


def preprocess_mismatch(got, want) -> dict:
    """K7's record (``got``) against ``preprocess_plain``'s (``want``):
    the slots whose radii, tiles_touched, rect_min or rect_max differ; the
    culled slots (plain radius 0) with an opacity or a colour that is not
    0; each float field's largest gap over max(1, |plain|), over every
    slot (``rgb``: over the drawn ones; NaN on both sides is no gap, on
    one side an infinite one)."""
    drawn = want.radii > 0
    out = {}
    for name in ("radii", "tiles_touched", "rect_min", "rect_max"):
        a, b = getattr(got, name), getattr(want, name)
        out[name] = int((a != b).reshape(a.shape[0], -1).any(-1).sum())
    out["culled_opacity"] = int((got.opacities[~drawn] != 0).sum())
    out["culled_rgb"] = int((got.rgb[~drawn] != 0).any(-1).sum())
    for name in ("means2d", "depths", "conics", "rgb", "opacities", "cull_thr"):
        a, b = getattr(got, name), getattr(want, name)
        if name == "rgb":
            a, b = a[drawn], b[drawn]
        gap = (a - b).abs() / b.abs().clamp_min(1.0)
        gap = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, gap)
        out[name] = float(torch.nan_to_num(gap, nan=math.inf).max()) if gap.numel() else 0.0
    return out


def preprocess_failures(mismatch: dict) -> list:
    """The entries of ``preprocess_mismatch`` past their gate: any count,
    and a float gap above ``PREP_TOL``."""
    return [k for k, v in mismatch.items()
            if (v > PREP_TOL if isinstance(v, float) else v != 0)]


def binning_mismatch(got, want) -> list:
    """The fields where K8's ``SortedInstances`` (``got``) differs from the
    plain version's (``want``), bit for bit: the counters, offsets and
    per-gaussian ranges everywhere; ``gauss_id`` and the feature rows on
    the listed instances (``offsets[-1]`` of them); ``tile_id`` and
    ``id_pos`` on every lane (num_tiles and max_instances past the listed
    ones on both sides); K8's rows 0-9 zero outside the listed lanes."""
    b, w = got.binning, want.binning
    bad = [name for name in ("num_instances", "num_enumerated", "overflow", "offsets",
                             "gauss_start", "gauss_count", "tile_id")
           if not torch.equal(getattr(b, name), getattr(w, name))]
    n = int(w.offsets[-1])
    if not torch.equal(b.gauss_id[:n], w.gauss_id[:n]):
        bad.append("gauss_id")
    if not torch.equal(got.id_pos, want.id_pos):
        bad.append("id_pos")
    if (got.lead, got.feat_soa.shape, got.feat_rows.shape) != (
            want.lead, want.feat_soa.shape, want.feat_rows.shape):
        return bad + ["feat_soa shape"]
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    if not torch.equal(bits(got.feat_rows[:, :n]), bits(want.feat_rows[:, :n])):
        bad.append("feat_rows")
    lanes = slice(got.lead, got.lead + n)
    if not torch.equal(bits(got.feat_soa[:10, lanes]), bits(want.feat_soa[:10, lanes])):
        bad.append("feat_soa")
    rest = torch.ones(got.feat_soa.shape[1], dtype=torch.bool, device=got.feat_soa.device)
    rest[lanes] = False
    if got.feat_soa[:10, rest].any():
        bad.append("feat_soa past the listed lanes")
    return bad


def preprocess_phase(dev):
    """Phase 5's K7 check and timing at ``PREP_SHAPES`` (a yawed and
    pitched view): per shape the mismatch against the plain version, the
    drawn slots, the wrapper's ms, the kernel alone (20 launches back to
    back into the outputs of the first), the plain version's ms and the
    byte bound: every slot's mean, scales, quaternion, opacity (and mask)
    read and its 68-byte record written, the drawn slots' SH rows read.
    The raw form too (``gm.RawGaussians``, the served view's route): its
    record bit for bit the activated form's and the plain version's
    (``raw_mismatch``), its wrapper and kernel alone timed beside the
    activation plus the activated form's wrapper (the route it replaces);
    its bytes are the activated form's."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection

    cam = view_request(6.0, -4.0).params(device=dev)
    out = {}
    for tag, (n, slots, seed) in PREP_SHAPES.items():
        params, active = preprocess_params(n, slots, seed, dev)
        g = gm.activate(params, 3, 3)
        raw = gm.RawGaussians(*params, 3)
        args, kw = (*g, 3, cam), dict(tile=32, active_mask=active)
        raw_args = (raw, None, None, None, None, 3, cam)
        launched = []
        kernel = projection.PREPROCESS
        projection.PREPROCESS = lambda *a: (launched.append(a), kernel(*a))
        try:
            with torch.no_grad():
                got = projection.preprocess_kernel(*args, **kw)
                got_raw = projection.preprocess_kernel(*raw_args, **kw)
        finally:
            projection.PREPROCESS = kernel
        with torch.no_grad():
            want = projection.preprocess_plain(*args, **kw)
            torch.cuda.synchronize()
            mismatch = preprocess_mismatch(got, want)
            if preprocess_failures(mismatch):
                raise AssertionError(f"preprocess {tag}: K7 vs plain {mismatch}")
            bad = raw_mismatch(got_raw, got, want)
            if bad:
                raise AssertionError(f"preprocess {tag}: K7's raw form differs in {bad}")
            ms = cuda_ms(lambda: projection.preprocess_kernel(*args, **kw))
            plain_ms = cuda_ms(lambda: projection.preprocess_plain(*args, **kw))
            kernel_ms = cuda_ms(lambda: kernel(*launched[0]), batch=20)
            raw_ms = cuda_ms(lambda: projection.preprocess_kernel(*raw_args, **kw))
            raw_kernel_ms = cuda_ms(lambda: kernel(*launched[1]), batch=20)
            activated_ms = cuda_ms(lambda: projection.preprocess_kernel(
                *gm.activate(params, 3, 3), 3, cam, **kw))
            if preprocess_failures(preprocess_mismatch(got, want)):
                raise AssertionError(f"preprocess {tag}: K7 launched alone differs")
            if raw_mismatch(got_raw, got, want):
                raise AssertionError(f"preprocess {tag}: K7's raw form launched alone differs")
        drawn = int((want.radii > 0).sum())
        k = g[4].shape[-1]
        nbytes = slots * (44 + (active is not None) + 68) + drawn * 4 * 3 * k
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[tag] = {"slots": slots, "active": n, "drawn": drawn, "mismatch": mismatch,
                    "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                    "raw_ms": raw_ms, "raw_kernel_ms": raw_kernel_ms,
                    "activation_and_kernel_ms": activated_ms,
                    "bound_ms": bound, "mbytes": nbytes / 1e6}
        log(f"preprocess {tag}: {slots} slots, {n} active, {drawn} drawn; K7 vs plain "
            f"{json.dumps(mismatch)}; {ms:.4f} ms, the kernel alone {kernel_ms:.4f} ms "
            f"({100 * bound / kernel_ms:.1f} % of the bound {bound:.4f} ms, "
            f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms; raw form bit for bit, "
            f"{raw_ms:.4f} ms, the kernel alone {raw_kernel_ms:.4f} ms "
            f"({100 * bound / raw_kernel_ms:.1f} % of the bound), against the activation "
            f"and K7 {activated_ms:.4f} ms")
    return out


# Sources of a pipeline of kernels, with no one occupancy to report
NO_OCCUPANCY = {"binning"}


def ptxas_report(backend, stem):
    """Registers, static shared memory and spilled bytes of the kernels of
    ``csrc/<stem>.cu`` (ptxas' report; the largest over them), and, but for
    ``NO_OCCUPANCY``, its kernel's CTAs per SM (the CUDA runtime's occupancy
    query, which the source exports)."""
    text = backend.build_log(stem)
    regs = re.findall(r"Used (\d+) registers", text)
    smem = re.findall(r"(\d+) bytes smem", text)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
    if not regs or not spills:
        raise AssertionError(f"{stem}: no ptxas report:\n{text}")
    out = {"registers": max(map(int, regs)), "smem_bytes": max(map(int, smem), default=0),
           "spill_bytes": max(int(a) + int(b) for a, b in spills)}
    if stem not in NO_OCCUPANCY:
        out["blocks_per_sm"] = backend.blocks_per_sm(stem)
    return out


# K8's timed shapes at the front view: (gaussians, slots, seed, max_instances,
# max_live): the 300k scene at bench.py's capacities, and 1M of its
# gaussians in 4,194,304 slots at the 1M scene's capacity, 2^23
BIN_SHAPES = {"300k": (N, N, 0, MAX_INSTANCES, MAX_LIVE),
              "4M_1M": (1_000_000, 1 << 22, 2, 1 << 23, None)}


def binning_ops(call, calls: int) -> list:
    """The device operations of ``calls`` calls of ``call`` (torch.profiler),
    from an attempt that caught every call's: ``calls`` times the count of
    one profiled call. Up to three attempts; AssertionError if none did."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import tracing

    def profiled(n):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        return tracing.device_ops(p.events())

    per_call = len(profiled(1))
    counts = []
    for _ in range(3):
        ops = profiled(calls)
        if len(ops) == calls * per_call:
            return ops
        counts.append(len(ops))
    raise AssertionError(f"the profiler caught {counts} device operations over {calls} calls, "
                         f"not {calls} x {per_call}")


def binning_phase(dev):
    """Phase 5's K8 check and timing at ``BIN_SHAPES``: per shape the fields
    that differ from the plain version's (none may), the wrapper's ms, the
    device time of one call's operations alone (``binning_ops``, over 10
    calls) and their count, the launch calls of one call (counted by the
    wrappers; 2), the plain version's ms, and the bytes bound:
    every slot's tiles_touched and each live gaussian's attributes read
    once, the outputs written once (rows 0-9 of the (16, kp) array,
    gauss_id, tile_id, id_pos, the offsets, the per-gaussian ranges)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, projection

    cam = view_request(0.0, 0.0).params(device=dev)
    gx, gy = -(-W // 32), -(-H // 32)
    out = {}
    for tag, (n, slots, seed, cap, live) in BIN_SHAPES.items():
        g, active = preprocess_inputs(n, slots, seed, dev)
        with torch.no_grad():
            prep = projection.preprocess(*g, 3, cam, tile=32, active_mask=active)
        args = (prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
                prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, gx, gy, cap, 32)
        kw = dict(max_live=live)
        before = binning.BINNING_SORT.launches + binning.BINNING_LAYOUT.launches
        got = binning.build_sorted_instances_kernel(*args, **kw)
        launch_calls = binning.BINNING_SORT.launches + binning.BINNING_LAYOUT.launches - before
        if launch_calls != 2:
            raise AssertionError(f"binning {tag}: {launch_calls} launch calls, not 2")
        want = binning.build_sorted_instances_plain(*args, **kw)
        torch.cuda.synchronize()
        mismatch = binning_mismatch(got, want)
        if mismatch:
            raise AssertionError(f"binning {tag}: K8 differs from the plain version in "
                                 f"{mismatch}")
        ms = cuda_ms(lambda: binning.build_sorted_instances_kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: binning.build_sorted_instances_plain(*args, **kw))
        calls = 10
        ops = binning_ops(lambda: binning.build_sorted_instances_kernel(*args, **kw), calls)
        kernel_ms = sum(e.device_time_total for e in ops) / 1e3 / calls
        b = want.binning
        live_n = int((prep.tiles_touched > 0).sum())
        kp, max_live = got.feat_soa.shape[1], got.id_pos.shape[0]
        nbytes = (4 * slots + 60 * live_n + 40 * kp + 16 * max_live + 4 * (gx * gy + 1)
                  + 8 * slots)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        out[tag] = {"slots": slots, "live": live_n, "enumerated": int(b.num_enumerated),
                    "kept": int(b.num_instances), "listed": int(b.offsets[-1]),
                    "mismatch": mismatch, "ms": ms, "kernel_ms": kernel_ms,
                    "plain_ms": plain_ms, "bound_ms": bound, "mbytes": nbytes / 1e6,
                    "device_ops": len(ops) // calls, "launch_calls": launch_calls}
        log(f"binning {tag}: {slots} slots, {live_n} live, {int(b.num_enumerated)} pairs, "
            f"{int(b.num_instances)} kept; K8 vs plain bit for bit; {ms:.4f} ms, its "
            f"{len(ops) / calls:.0f} device operations {kernel_ms:.4f} ms "
            f"({100 * bound / kernel_ms:.1f} % of the bound {bound:.4f} ms, "
            f"{nbytes / 1e6:.1f} MB), plain {plain_ms:.4f} ms")
    return out


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
    """Phase 12: the training path on the 300k model. Returns the losses,
    densify counts, the kernels' launches over the run, the capacities,
    the state after the first 8 steps and its train step."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, EXTENT)
    state, gen = train_start(params, tx)
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
    for name in ("binning", "blend_fwd"):
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
    """Phase 13: the backward kernels against their plain versions on the
    front view's real cotangents, their bounds, and the timings of the
    train step (whole, by phase, peak memory) and of the kernels."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_lib
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
        k3_again = blend.blend_bwd(feat, b.offsets, fwd, cot, gx, gy)
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
        if not torch.equal(k3.view(torch.int32), k3_again.view(torch.int32)):
            raise AssertionError("blend_bwd: two launches on the same inputs differ")
        log(f"blend_bwd vs plain: per-row max |err| "
            f"{[f'{e:.3g}' for e in k3_err.amax(dim=1).tolist()]} of row max "
            f"{[f'{m:.3g}' for m in rowmax[:, 0].tolist()]}; {int(past.sum())} instances "
            f"past chunks_done are 0; a second launch is bit-identical")

        # K4 as the step runs it: the id-order source, then one gather-and-
        # sum over K3's records; and the table route beside it (K4 on the
        # id-order table, which the step does not build)
        red = (k3, si.id_pos, b.gauss_start, b.gauss_count, MAX_INSTANCES)
        k4 = blend.segment_reduce_grads(*red)
        k4_again = blend.segment_reduce_grads(*red)
        src = blend.id_order_source(si.id_pos, MAX_INSTANCES)
        bounds = blend.id_order_bounds(b.gauss_start, b.gauss_count)
        k4_plain = segsum.segment_sum_gather_plain(k3, src, bounds)
        table, _ = blend.id_order_table(*red)
        k4_table = segsum.segment_sum_bounds(table, bounds)
        k4_table_plain = segsum.segment_sum_bounds_plain(table, bounds)
        lengths = (bounds[1:] - bounds[:-1]).to(torch.int64)
        b0, b1 = int(bounds[0]), int(bounds[-1])
        data = table[:, b0:b1].T.contiguous()
        k4_lib = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
        gid = b.gauss_id[:n_live].to(torch.int64)
        live_grads = k3[:, :n_live].contiguous()

        def k4_index_add():
            return torch.zeros_like(k4).index_add_(1, gid, live_grads)

        torch.cuda.synchronize()
        k4_rowmax = k4_plain.abs().amax(dim=1, keepdim=True)
        k4_err = (k4 - k4_plain).abs()
        k4_table_err = (k4_table - k4_table_plain).abs()
        for name, err in (("segment_reduce_grads", k4_err), ("segsum (table)", k4_table_err)):
            if (err > 1e-5 * k4_rowmax).any():
                raise AssertionError(f"{name} disagrees with its plain version: per-row max "
                                     f"|err| {err.amax(dim=1).tolist()}")
        if not torch.equal(k4.view(torch.int32), k4_again.view(torch.int32)):
            raise AssertionError("segment_reduce_grads: two launches on the same inputs differ")
        lib_err = float((k4_lib.T - k4_plain).abs().max())
        index_add_err = float((k4_index_add() - k4_plain).abs().max())
        log(f"segment_reduce_grads vs plain: max |err| {float(k4_err.max()):.3g} (row max up "
            f"to {float(k4_rowmax.max()):.3g}); a second launch is bit-identical; segsum on "
            f"the id-order table vs plain {float(k4_table_err.max()):.3g}; "
            f"torch.segment_reduce vs plain {lib_err:.3g}; index_add_ vs plain "
            f"{index_add_err:.3g}; {lengths.numel()} segments over {b1 - b0} slots, "
            f"{n_live} live instances")

        k3_ms = cuda_ms(lambda: blend.blend_bwd(feat, b.offsets, fwd, cot, gx, gy))
        k3_plain_ms = cuda_ms(lambda: blend.blend_bwd_plain(feat, b.offsets, fwd, cot, gx, gy))
        # the kernel alone, as K2's (into records allocated beforehand)
        k3_store = segsum.records(feat.shape[1], feat.device)
        k3_out = segsum.record_rows(k3_store, blend.NGRAD)

        def k3_launch(order):
            blend.BLEND_BWD(feat.data_ptr(), feat.shape[1], b.offsets.data_ptr(),
                            order.data_ptr(), gx * gy, gx, fwd.data_ptr(), cot.data_ptr(),
                            k3_store.data_ptr(), backend.stream_ptr(feat))

        k3_orders = {"kernel_ms": blend.tile_order(fwd[:, 0, 4]),
                     "tile_order_ms": torch.arange(gx * gy, device=feat.device)}
        k3_kernel = {}
        for key, order in k3_orders.items():
            k3_kernel[key] = cuda_ms(lambda: k3_launch(order))
            if not torch.equal(k3_out.view(torch.int32), k3.view(torch.int32)):
                raise AssertionError(f"blend_bwd launched in another order ({key}) differs")
        k4_ms = cuda_ms(lambda: blend.segment_reduce_grads(*red))
        # the kernel alone: its launches back to back, outputs made beforehand
        k4_out = torch.empty_like(k4)
        k4_kernel_ms = cuda_ms(lambda: segsum.SEGSUM(
            k3.data_ptr(), blend.NGRAD, k3.shape[1], src.data_ptr(), src.shape[0],
            bounds.data_ptr(), k4.shape[1], k4_out.data_ptr(), backend.stream_ptr(k3)),
            batch=20)
        k4_table_ms = cuda_ms(lambda: segsum.segment_sum_bounds(table, bounds))
        k4_table_path_ms = cuda_ms(lambda: segsum.segment_sum_bounds(
            *blend.id_order_table(*red)))
        k4_plain_ms = cuda_ms(lambda: segsum.segment_sum_gather_plain(k3, src, bounds))
        k4_lib_ms = cuda_ms(lambda: torch.segment_reduce(data, "sum", lengths=lengths, axis=0))
        k4_index_add_ms = cuda_ms(k4_index_add)

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
    # the recount: what the gate-first design cannot skip, an exp and the
    # gate's 12 flops per pair past the log-domain pre-test, and the kept
    # pairs' work as above
    gate = k3_work["gate_lanes"]
    k3_gate_ms = 1e3 * max(k3_times["bytes"], (gate + 3 * kept + lanes // 1024) / SFU_OPS_PER_S,
                           (12 * gate + 34 * kept) / FP32_FLOPS_PER_S)
    # K4 as the step runs it: the live instances' 9 gradients read once,
    # the order as one int32 sorted position per live instance, the bounds
    # read, the (9, N) sums written; one add per value read
    k4_bytes = 4 * (9 * n_live + n_live + bounds.numel() + k4.numel())
    k4_bound = k4_bytes / HBM_BYTES_PER_S * 1e3
    log(f"blend_bwd: pairs in range {lanes}, power <= 0 {exp_lanes}, past the log-domain "
        f"pre-test {gate}, kept {kept}; recounted bound {k3_gate_ms:.4f} ms; "
        f"{k3_sfu} transcendentals {k3_sfu / SFU_OPS_PER_S * 1e3:.4f} ms, {k3_flops} fp32 "
        f"flops {k3_flops / FP32_FLOPS_PER_S * 1e3:.4f} ms, {k3_bytes / 1e6:.1f} MB "
        f"{k3_times['bytes'] * 1e3:.4f} ms")
    log(f"segsum: {k4_bytes / 1e6:.1f} MB moved, bound {k4_bound:.4f} ms (bytes); "
        f"segment_reduce_grads {k4_ms:.4f} ms, the gather-and-sum kernel alone "
        f"{k4_kernel_ms:.4f} ms, on the id-order table {k4_table_ms:.4f} ms (with the "
        f"table's fill and scatter {k4_table_path_ms:.4f} ms); torch.segment_reduce "
        f"{k4_lib_ms:.4f} ms, index_add_ {k4_index_add_ms:.4f} ms")

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
                      "bound_by": k3_by, "library_ms": None, "gate_bound_ms": k3_gate_ms,
                      **k3_kernel},
        "segsum": {"max_abs_err": float(k4_err.max()), "ms": k4_ms, "plain_ms": k4_plain_ms,
                   "bound_ms": k4_bound, "bound_by": "bytes", "library_ms": k4_lib_ms,
                   "kernel_ms": k4_kernel_ms, "table_ms": k4_table_ms,
                   "table_path_ms": k4_table_path_ms, "index_add_ms": k4_index_add_ms},
        "step": {"ms": step_ms, "split_ms": split, "peak_mib": peak_mib,
                 "held_mib": base_mib},
    }


def eye_phase():
    """Phase 7: RITnet on the synthetic eye. Its preprocessing on the card
    and on the CPU equals the host NumPy reference bit for bit, and the
    card's class map and gaze equal those of the reference's input uploaded
    to the card; card against CPU, logits within 1e-3 of their largest
    magnitude, class maps differing on at most 0.1 % of pixels, gaze within
    1 px. Returns the card's model, the eye, its gaze and the numbers."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import track_render
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet

    eye = make_eye()
    models = {d: ritnet.load_pretrained(device=d) for d in ("cuda", "cpu")}
    host = torch.from_numpy(ritnet.normalise_eye_image(eye))[None, None]
    x = {d: ritnet.preprocess_eye_image(eye, device=d) for d in models}
    for d, xd in x.items():
        if xd.device.type != d or not torch.equal(xd.cpu(), host):
            raise AssertionError(f"the eye's preprocessing on {d} is not the host reference's")
    with torch.no_grad():
        logits = {d: m(x[d]).cpu() for d, m in models.items()}
        host_pred = ritnet.get_predictions(models["cuda"](host.cuda()))[0]
    scale = float(logits["cpu"].abs().max())
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not err <= 1e-3 * scale:
        raise AssertionError(f"RITnet logits differ between card and CPU by {err} (max {scale})")
    gaze = {d: track_render.estimate_gaze(eye, m, device=d) for d, m in models.items()}
    (uv, pred), (uv_cpu, pred_cpu) = gaze["cuda"], gaze["cpu"]
    host_uv = ritnet.pupil_centroid(host_pred) / np.array([EYE_W, EYE_H])
    if not (torch.equal(pred, host_pred) and np.array_equal(uv, host_uv)):
        raise AssertionError("the card's class map or gaze differs from the host input's")
    differ = float((pred.cpu() != pred_cpu).float().mean())
    gaze_err = float(np.abs((uv - uv_cpu) * np.array([EYE_W, EYE_H])).max())
    if differ > 1e-3 or gaze_err > 1.0:
        raise AssertionError(f"RITnet card vs CPU: {differ:.2%} of pixels differ, gaze off by "
                             f"{gaze_err} px")
    classes = torch.bincount(pred.flatten(), minlength=4).tolist()
    log(f"RITnet {EYE_W}x{EYE_H} synthetic eye: logits card vs CPU max |err| {err:.3g} "
        f"(max |logit| {scale:.3g}); class maps differ on {differ:.4%}; gaze uv card "
        f"{uv.round(4).tolist()} vs CPU {uv_cpu.round(4).tolist()} ({gaze_err:.3g} px); "
        f"pupil class found: {classes[3] > 0} (pixels per class {classes}; drawn at "
        f"uv {list(EYE_GAZE_UV)})")
    return models["cuda"], eye, uv, {"logit_err": err, "pred_differ": differ,
                                     "gaze_err_px": gaze_err, "gaze_uv": uv.tolist()}


def amr_bound(work, out_numel, index_numel):
    """(bound ms, bound_by) of a foveated compositor launch set from the
    work its plain version counted: K2's per-pair costs, plus per staged
    in-range instance a log of opacity, per pair whose alpha is rescaled by
    decimation an exp and 2 flops; bytes: 9 feature rows per staged
    instance, the per-tile index arrays, the output written."""
    sfu = work["exp_lanes"] + 2 * work["kept"] + work["rescaled"] + work["staged"]
    flops = 10 * work["lanes"] + 2 * work["exp_lanes"] + 11 * work["kept"] + 2 * work["rescaled"]
    nbytes = 4 * (9 * work["staged"] + index_numel + out_numel)
    times = {"operations": max(sfu / SFU_OPS_PER_S, flops / FP32_FLOPS_PER_S),
             "bytes": nbytes / HBM_BYTES_PER_S}
    by = max(times, key=times.get)
    log(f"  {work}: {sfu} transcendentals {sfu / SFU_OPS_PER_S * 1e3:.4f} ms, {flops} fp32 "
        f"flops {flops / FP32_FLOPS_PER_S * 1e3:.4f} ms, {nbytes / 1e6:.1f} MB "
        f"{times['bytes'] * 1e3:.4f} ms")
    return times[by] * 1e3, by


def compare_tiles(name, got, want, rows_valid):
    """A compositor's (T, rows, 8) output against its plain version's:
    rgb/final_T within 1e-3 on the rows rendered, chunks run equal on all
    but 0.1 % of tiles, zero rows where ``rows_valid`` is False. Returns
    the max |err|."""
    n_tiles = got.shape[0]
    row_err = (got[..., 0:4] - want[..., 0:4]).abs().amax(-1)[rows_valid]
    err = float(row_err.max())
    bad_tiles = int((got[:, 0, 4] != want[:, 0, 4]).sum())
    if not err <= 1e-3 or bad_tiles > 0.001 * n_tiles:
        raise AssertionError(f"{name}: max |err| {err}, chunks run differ on {bad_tiles} tiles")
    if got[~rows_valid].any():
        raise AssertionError(f"{name}: rows above the tile's level are not zero")
    log(f"{name} vs plain: max |err| rgb/final_T {err:.3g} (pixels over 1e-5 / 1e-4: "
        f"{int((row_err > 1e-5).sum())} / {int((row_err > 1e-4).sum())} of {row_err.numel()}), "
        f"chunks run differ on {bad_tiles} of {n_tiles} tiles")
    return err


def hold_rounds(st, gx, gy, tag, work=None):
    """The four AMR rounds of a 5-step frame's step-0 state ``st`` as the
    frame launches them (one order, ``amr.ROUND_SPLIT``) against their
    plain versions (``work`` gathers what those count). Returns each
    round's max |err|, the order, and each round's (args, kwargs as
    launched, plain output)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, blend

    counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)
    order = blend.round_order(counts, st.tile_levels)
    errs, launched = [], []
    for rnd in range(1, 5):
        a = (st.feat_soa, st.offsets, gx, gy)
        kw = dict(offx=blend.ROUND_OFFX[rnd - 1], offy=blend.ROUND_OFFY[rnd - 1],
                  counts_override=torch.where(st.tile_levels >= rnd, counts, 0))
        want = blend.blend_round_plain(*a, **kw, work=work)
        kw.update(order=order, split=amr.ROUND_SPLIT[rnd - 1])
        got = blend.blend_round(*a, **kw)
        valid = torch.ones(got.shape[:2], dtype=torch.bool, device=got.device)
        errs.append(compare_tiles(f"{tag}blend_round {rnd}", got, want, valid))
        launched.append((a, kw, want))
    return errs, order, launched


def hold_levels(st, gx, gy, tag, decimation, scale_only=False, work=None):
    """The levels kernel on the step-0 state ``st`` against its plain
    version (``work`` gathers what that counts). Returns the max |err|,
    the (args, kwargs) and the kernel's output."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend

    counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)
    a = (st.feat_soa, st.offsets, counts, st.tile_levels, gx, gy)
    kw = dict(decimation=decimation, scale_only=scale_only)
    got = blend.blend_levels(*a, **kw)
    want = blend.blend_levels_plain(*a, **kw, work=work)
    valid = (torch.arange(1024, device=counts.device) // 256)[None, :] < st.tile_levels[:, None]
    name = f"{tag}blend_levels {decimation}{' scale_only' if scale_only else ''}"
    return compare_tiles(name, got, want, valid), (a, kw), got


def foveated_phase(state, cam, bg, model, eye, gaze_uv, serve_ms):
    """Phases 8-10: the eye-tracked foveated frames on the served model,
    the foveated kernels against their plain versions on the front view's
    inputs, and the timings. Returns the two kernels' entries and a
    summary."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_foveated
    from gaussian_splatting_with_eye_tracking_tpu_torch import track_render
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, blend

    dev = cam.viewmatrix.device
    gx, gy = -(-W // 32), -(-H // 32)
    radii = (H / 8, H / 4, H / 2)
    view = dict(radii=radii, max_instances=MAX_INSTANCES)
    frames = {"five_step": dict(fused=False), "fused": dict(),
              "decimated": dict(decimation=DECIMATION),
              "predecimated": dict(decimation=DECIMATION, predecimate=True)}
    want = {"five_step": {"blend_round": 4, "blend_levels": 0},
            "fused": {"blend_round": 0, "blend_levels": 1}}
    images, states, launches = {}, {}, {}
    for name, kw in frames.items():
        torch.cuda.synchronize()
        for kern in backend.kernels():
            kern.launches = 0
        images[name], states[name] = track_render.foveated_view(
            state, cam, bg, gaze_uv, 3, **view, **kw)
        torch.cuda.synchronize()
        launches[name] = got = {kern.name: kern.launches for kern in backend.kernels()}
        need = want.get(name, want["fused"])
        bad = {k: got[k] for k in ("blend_round", "blend_levels") if got[k] != need[k]}
        bad.update({k: got[k] for k in ("blend_fwd", "blend_bwd", "segsum") if got[k]})
        if bad or got["binning"] < 1:
            raise AssertionError(f"{name} frame launched {got}")
        img, st = images[name], states[name]
        if bool(st.overflow):
            raise AssertionError(f"{name} frame: instance capacity overflow")
        lo, hi = float(img.min()), float(img.max())
        if img.shape != (3, H, W) or not torch.isfinite(img).all() or lo < 0 or hi > 2 or hi == 0:
            raise AssertionError(f"{name} frame: shape {tuple(img.shape)}, range [{lo}, {hi}]")
        log(f"foveated {name} frame: {int(st.num_instances)} instances, levels 1-4 "
            f"{torch.bincount(st.tile_levels, minlength=5)[1:].tolist()}, launches "
            f"{ {k: v for k, v in got.items() if v} }, mean {float(img.mean()):.4f}")
    fused_err = float((images["fused"] - images["five_step"]).abs().max())
    if not fused_err <= 1e-3:
        raise AssertionError(f"fused frame differs from the 5-step frame by {fused_err}")
    n_full, n_pre = (int(states[k].num_instances) for k in ("fused", "predecimated"))
    if not n_pre < n_full:
        raise AssertionError(f"predecimate kept {n_pre} of {n_full} instances")
    log(f"fused vs 5-step frame max |err| {fused_err:.3g}; predecimate kept {n_pre} of "
        f"{n_full} instances; decimated frame vs fused max |diff| "
        f"{float((images['decimated'] - images['fused']).abs().max()):.3g}")

    # the kernels against their plain versions on the front view's inputs
    st, pre = states["five_step"], states["predecimated"]
    counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)

    # the rounds as the 5-step frame launches them: one order per frame,
    # each round's tiles a prefix of it, split over amr.ROUND_SPLIT CTAs
    round_work = {}
    gated_tiles = [int((st.tile_levels >= rnd).sum()) for rnd in range(1, 5)]
    split_ms, split_err = {}, {}
    with torch.no_grad():
        round_errs, order, launched = hold_rounds(st, gx, gy, "", work=round_work)
        round_err = max(round_errs)
        for rnd, (a, kw, plain) in enumerate(launched, 1):
            valid = torch.ones(plain.shape[:2], dtype=torch.bool, device=dev)
            # every split: final_T, chunks run and logT the bits of one CTA
            # per tile, rgb within the gate of the plain version
            one = blend.blend_round(*a, **{**kw, "split": 1})
            for split in blend.ROUND_SPLITS:
                kws = {**kw, "split": split}
                out = blend.blend_round(*a, **kws)
                torch.cuda.synchronize()
                if not torch.equal(out[..., 3:6].view(torch.int32), one[..., 3:6].view(torch.int32)):
                    raise AssertionError(f"blend_round {rnd} split {split}: final_T / chunks / "
                                         f"logT differ from one CTA per tile")
                err = compare_tiles(f"blend_round {rnd} split {split}", out, plain, valid)
                split_err[f"{rnd}/{split}"] = err
                split_ms[f"{rnd}/{split}"] = cuda_ms(lambda kws=kws: blend.blend_round(*a, **kws))
            # one CTA per tile in tile order, as the parent launched it
            kws = {**kw, "split": 1, "order": torch.arange(gx * gy, device=dev)}
            if not torch.equal(blend.blend_round(*a, **kws).view(torch.int32),
                               one.view(torch.int32)):
                raise AssertionError(f"blend_round {rnd} in tile order differs")
            split_ms[f"{rnd}/tile_order"] = cuda_ms(lambda: blend.blend_round(*a, **kws))
        # the frame's four launches alone (order and counts made
        # beforehand), as the 5-step frame splits them
        rnd_out = torch.empty_like(one)
        rounds_kernel_ms = []
        for _, kw, _ in launched:
            rounds_kernel_ms.append(cuda_ms(lambda kw=kw: blend.BLEND_ROUND(
                st.feat_soa.data_ptr(), st.feat_soa.shape[1], st.offsets.data_ptr(),
                kw["counts_override"].data_ptr(), order.data_ptr(), gx * gy, gx, kw["offx"],
                kw["offy"], kw["split"], rnd_out.data_ptr(), backend.stream_ptr(counts)),
                batch=20))
        order_ms = cuda_ms(lambda: blend.round_order(counts, st.tile_levels))
        log("blend_round per round and split (ms): " + json.dumps(split_ms)
            + f"; the frame's order {order_ms:.4f} ms; gated tiles {gated_tiles}; the four "
            f"launches alone " + ", ".join(f"{t:.4f}" for t in rounds_kernel_ms)
            + f" ms, {sum(rounds_kernel_ms):.4f} ms in all")
        sub = 256
        modes = {"(1,1,1,1)": (st, (1, 1, 1, 1), False),
                 f"{DECIMATION}": (st, DECIMATION, False),
                 f"{DECIMATION} scale_only": (pre, DECIMATION, True)}
        level_work, level_err, level_ms = {}, 0.0, {}
        for mode, (s, dec, so) in modes.items():
            work = {}
            err, (a, kw), got = hold_levels(s, gx, gy, "", dec, so, work=work)
            level_err = max(level_err, err)
            level_ms[mode] = cuda_ms(lambda: blend.blend_levels(*a, **kw))
            if not level_work:
                level_work, level_args, level_out = work, (a, kw), got
        # the kernel alone (its launch order made beforehand), heaviest
        # tiles first as the wrapper orders them and in tile order, twice
        # each: the same bits as the wrapper's output
        level_orders = {"kernel_ms": blend.levels_order(counts, st.tile_levels),
                        "tile_order_ms": torch.arange(gx * gy, device=dev)}
        k5_out = torch.empty_like(level_out)

        def k5_launch(order, levels=st.tile_levels):
            blend.BLEND_LEVELS(st.feat_soa.data_ptr(), st.feat_soa.shape[1],
                               st.offsets.data_ptr(), counts.data_ptr(), levels.data_ptr(),
                               order.data_ptr(), gx * gy, gx, 1, 1, 1, 1, 0,
                               k5_out.data_ptr(), backend.stream_ptr(counts))

        level_kernel = {}
        for key, order in level_orders.items():
            for _ in range(2):
                k5_out.zero_()
                k5_launch(order)
                if not torch.equal(k5_out.view(torch.int32), level_out.view(torch.int32)):
                    raise AssertionError(f"blend_levels launched in another order ({key}) or "
                                         f"again differs")
            level_kernel[key] = cuda_ms(lambda: k5_launch(order), batch=5)
        # what a tile costs per instance at level 1 and at level 4: the
        # kernel alone with every tile of the frame at one level, the same
        # instance lists, in tile order
        n_inst = int(counts.sum())
        level_uniform = {}
        for lvl in (1, 4):
            uniform = torch.full_like(st.tile_levels, lvl)
            ms = cuda_ms(lambda: k5_launch(level_orders["tile_order_ms"], uniform), batch=5)
            level_uniform[f"level{lvl}_ms"] = ms
            level_uniform[f"level{lvl}_ns_per_instance"] = 1e6 * ms / n_inst
        log(f"blend_levels kernel alone: heaviest first {level_kernel['kernel_ms']:.4f} ms, "
            f"tile order {level_kernel['tile_order_ms']:.4f} ms (bit-identical, twice each); "
            f"every tile at level 1 / 4: {json.dumps(level_uniform)}")
        round_ms = [cuda_ms(lambda a=a, kw=kw: blend.blend_round(*a, **kw))
                    for a, kw, _ in launched]
        round_plain_ms = [cuda_ms(lambda a=a, kw=kw: blend.blend_round_plain(
            *a, offx=kw["offx"], offy=kw["offy"], counts_override=kw["counts_override"]))
                          for a, kw, _ in launched]
        a, kw = level_args
        level_plain_ms = cuda_ms(lambda: blend.blend_levels_plain(*a, **kw))
    log("blend_round ms per round " + ", ".join(f"{t:.4f}" for t in round_ms)
        + f" (splits {list(amr.ROUND_SPLIT)}, gated tiles {gated_tiles}); four rounds "
        f"{sum(round_ms):.4f} ms; plain " + ", ".join(f"{t:.2f}" for t in round_plain_ms))
    log("blend_levels ms " + ", ".join(f"{k} {v:.4f}" for k, v in level_ms.items())
        + f"; plain (1,1,1,1) {level_plain_ms:.2f}")
    log("blend_round bound over the four rounds:")
    round_bound = amr_bound(round_work, 4 * gx * gy * sub * 8, 4 * (2 * gx * gy + 1))
    log("blend_levels bound, (1,1,1,1):")
    level_bound = amr_bound(level_work, gx * gy * 4 * sub * 8, 3 * gx * gy + 1)

    # timings: the foveated breakdown, RITnet, eye image -> frame
    gaze_xy = torch.tensor([gaze_uv[0] * W, gaze_uv[1] * H], device=dev)
    fps = fps_foveated.run_foveated_breakdown(
        state, cam, bg, gaze_xy=gaze_xy, radii=torch.tensor(radii, device=dev),
        decimation=DECIMATION, max_instances=MAX_INSTANCES, max_live=MAX_LIVE, reps=REPS,
        device=dev)
    if fps["capacity"] != MAX_INSTANCES:
        raise AssertionError(f"the foveated breakdown grew its capacity to {fps['capacity']}")
    model_input = ritnet.preprocess_eye_image(eye, device=dev)
    with torch.no_grad():
        fps["ritnet_ms"] = cuda_ms(lambda: model(model_input))
    fps["estimate_gaze_ms"] = cuda_ms(lambda: track_render.estimate_gaze(eye, model, device=dev))
    fps["eye_to_frame_ms"] = cuda_ms(lambda: track_render.foveated_view(
        state, cam, bg, track_render.estimate_gaze(eye, model, device=dev)[0], 3, **view))
    fps["served_view_ms"] = serve_ms
    log("foveated timings (ms, median of 10): " + json.dumps(
        {k: v for k, v in fps.items() if k.endswith("ms") or k.endswith("_vs_plain")}))
    log(f"fused / plain served view = {fps['fused_ms'] / serve_ms:.3f}; fused / plain "
        f"frame in the breakdown = {fps['fused_undecimated_vs_plain']:.3f}; peak "
        f"{fps.get('fused_peak_mib')} MiB, {fps.get('fused_held_mib')} MiB of it held before "
        f"the frame")
    src = "gaussian_splatting_with_eye_tracking_tpu_torch/csrc/blend_amr.cu"
    kernels = [
        {"name": "blend_round", "route": "cuda", "source": src,
         "replaces": REPLACES["blend_round"], "launches": launches["five_step"]["blend_round"],
         "max_abs_err": round_err, "ms": sum(round_ms), "plain_ms": sum(round_plain_ms),
         "bound_ms": round_bound[0], "bound_by": round_bound[1], "library_ms": None,
         "rounds_ms": round_ms, "gated_tiles": gated_tiles, "splits": list(amr.ROUND_SPLIT),
         "split_ms": split_ms, "split_max_abs_err": split_err, "order_ms": order_ms,
         "kernel_ms": sum(rounds_kernel_ms), "rounds_kernel_ms": rounds_kernel_ms},
        {"name": "blend_levels", "route": "cuda", "source": src,
         "replaces": REPLACES["blend_levels"],
         "launches": sum(launches[k]["blend_levels"] for k in frames),
         "max_abs_err": level_err, "ms": level_ms["(1,1,1,1)"], "plain_ms": level_plain_ms,
         "bound_ms": level_bound[0], "bound_by": level_bound[1], "library_ms": None,
         **level_kernel, **level_uniform, **ptxas_report(backend, "blend_amr")},
    ]
    summary = {"launches": launches, "fused_vs_five_step_err": fused_err,
               "instances": n_full, "predecimated_instances": n_pre, "timings": fps,
               "levels": torch.bincount(st.tile_levels, minlength=5)[1:].tolist(),
               "blend_round_ms": round_ms, "blend_levels_ms": level_ms}
    return kernels, summary


def cli_phase(tmp):
    """Phase 14: synthesize -> train -> render -> metrics through the
    modules' ``main``s in the directory ``tmp`` (its ``scene`` and
    ``model``). Returns the numbers."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, metrics, render
    from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth
    from gaussian_splatting_with_eye_tracking_tpu_torch import train as train_cli
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
    from gaussian_splatting_with_eye_tracking_tpu_torch.train_regression import run_cli
    from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import load_image_chw

    n = CLI_ITERATIONS
    stages = {}
    scene_dir, model = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
    t0 = time.perf_counter()
    scene_synth.synthesize_dataset(scene_dir)
    stages["synthesize_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    for kern in backend.kernels():
        kern.launches = 0
    t0 = time.perf_counter()
    _, state, tlog = run_cli(train_cli.main, [
        "-s", scene_dir, "-m", model, "--iterations", str(n), "--eval",
        "--test_iterations", str(n // 2), str(n), "--save_iterations", str(n),
        "--checkpoint_iterations", str(n), "--disable_viewer", "--quiet"])
    torch.cuda.synchronize()
    stages["train_s"] = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in backend.kernels()}
    t0 = time.perf_counter()
    run_cli(render.main, ["-m", model, "--iteration", str(n), "--quiet"])
    stages["render_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = run_cli(metrics.main, ["-m", model, "--no_lpips"])[model][f"ours_{n}"]
    stages["metrics_s"] = time.perf_counter() - t0

    renders = os.path.join(model, "test", f"ours_{n}", "renders")
    shapes = [load_image_chw(os.path.join(renders, f)).shape
              for f in sorted(os.listdir(renders))]
    saved, it = ckpt.load_checkpoint(os.path.join(model, f"chkpnt{n}.ckpt"))
    a, b = ckpt.state_to_dict(saved), ckpt.state_to_dict(state)
    pairs = [(a["params"], b["params"]), (a["opt_state"]["mu"], b["opt_state"]["mu"]),
             (a["opt_state"]["nu"], b["opt_state"]["nu"]),
             ({k: a[k] for k in ("active", "max_radii2d", "xyz_grad_accum", "denom")},
              {k: b[k] for k in ("active", "max_radii2d", "xyz_grad_accum", "denom")})]
    same = (it == n and a["sh_degree"] == b["sh_degree"]
            and a["opt_state"]["count"] == b["opt_state"]["count"]
            and all(torch.equal(x[k], y[k]) for x, y in pairs for k in y))

    test = tlog["eval"]["test"]
    psnr_half, psnr_end = test[n // 2]["psnr"], test[n]["psnr"]
    points = tlog["points"][n]
    out = {"iterations": n, "stages_s": stages, "ms_per_iteration": 1e3 * tlog["seconds"] / n,
           "test_psnr": {str(k): v["psnr"] for k, v in sorted(test.items())},
           "train_psnr": {str(k): v["psnr"] for k, v in sorted(tlog["eval"]["train"].items())},
           "points": {str(k): v for k, v in sorted(tlog["points"].items())},
           "train_r05_points_1000": TRAIN_R05_POINTS_1000, "capacity": tlog["capacity"],
           "metrics": results, "launches": launches, "renders": [list(s) for s in shapes],
           "checkpoint_round_trip": same}
    log(f"CLI phase: stages {json.dumps(stages)}; {out['ms_per_iteration']:.2f} ms per "
        f"iteration of the train loop ({n} iterations, evaluations included)")
    log(f"CLI phase: test PSNR {psnr_half:.3f} dB at {n // 2}, {psnr_end:.3f} dB at {n} "
        f"(TRAIN_r05, JAX: 19.98 at 1000); results.json PSNR {results['PSNR']:.3f}, SSIM "
        f"{results['SSIM']:.4f}; points at {n}: {points} (TRAIN_r05: "
        f"{TRAIN_R05_POINTS_1000}); capacity {tlog['capacity']}; launches {launches}")
    if not (psnr_end >= CLI_PSNR_MIN and psnr_end > psnr_half):
        raise AssertionError(f"CLI training: test PSNR {psnr_half} at {n // 2}, {psnr_end} at {n}")
    for name in ("blend_bwd", "segsum"):
        if launches[name] < n:
            raise AssertionError(f"CLI training: {name} ran {launches[name]} times in {n} steps")
    for name in ("binning", "blend_fwd"):
        if launches[name] <= launches["blend_bwd"]:
            raise AssertionError(f"CLI training: {name} ran {launches[name]} times")
    if shapes != [(3, 256, 256)] * 3:
        raise AssertionError(f"CLI render: test renders {shapes}")
    if not abs(results["PSNR"] - psnr_end) <= 0.2:
        raise AssertionError(f"CLI metrics: PSNR {results['PSNR']} vs the trainer's {psnr_end}")
    if not same:
        raise AssertionError("CLI checkpoint does not load back equal to the state saved")
    return out


SWEEP_RATIOS = (0.2, 1.0, 2.0)  # of 1920x1080: 384x192, 1920x1056, 3840x2144 (8,040 tiles)
BENCH_LINE_KEYS = ["metric", "value", "unit", "vs_baseline"]
FOVEATED_KEYS = ("steps_protocol", "steps_protocol_total_ms", "fused_ms", "fused_fps",
                 "plain_forward_ms", "plain_forward_fps", "fused_vs_plain",
                 "fused_undecimated_vs_plain")


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with every launch counter zeroed just before and
    read just after: (its result, {kernel: launches})."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend

    torch.cuda.synchronize()
    for kern in backend.kernels():
        kern.launches = 0
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, {kern.name: kern.launches for kern in backend.kernels()}


def need_launches(path, launches, at_least, none_of=()):
    bad = {k: launches[k] for k, n in at_least.items() if launches[k] < n}
    bad.update({k: launches[k] for k in none_of if launches[k]})
    if bad:
        raise AssertionError(f"{path}: launches {launches}, wanted at least {at_least} and "
                             f"none of {list(none_of)}")


def entry_phase(tmp, gaze_uv):
    """Phase 15: the serving-side entry points through their ``main``s, in
    this process, on the CLI phase's model (``tmp``/model) and fps_test's
    synthetic scene. Returns the numbers."""
    import contextlib
    import io

    from PIL import Image

    from gaussian_splatting_with_eye_tracking_tpu_torch import bench, fps_foveated, fps_test
    from gaussian_splatting_with_eye_tracking_tpu_torch import renderer, track_render
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import model_config_of
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning, blend, expand
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess
    from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
    from gaussian_splatting_with_eye_tracking_tpu_torch.train_regression import run_cli
    from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import load_image_chw

    dev = torch.device("cuda")
    model = os.path.join(tmp, "model")
    out = {}
    t_phase = time.perf_counter()

    # bench: the card line, then the root script's four-key line
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, launches = counted(bench.main, [])
    card_line, line = buf.getvalue().strip().splitlines()[-2:]
    doc = json.loads(line)
    if list(doc) != BENCH_LINE_KEYS or not doc["value"] > 0 or doc != res["line"]:
        raise AssertionError(f"bench printed {line!r}")
    per_step = {"binning": res["iterations"], "blend_fwd": res["iterations"],
                "blend_bwd": res["iterations"], "segsum": res["iterations"]}
    need_launches("bench, timed steps", res["launches"], per_step)
    need_launches("bench", launches, per_step)
    out["bench"] = {"line": doc, "card": card_line, "ms": res["ms"],
                    "instances": res["instances"], "enumerated": res["enumerated"],
                    "timed_launches": res["launches"], "launches": launches}
    log(f"bench ({card_line}): {line}; {res['ms']:.3f} ms per forward + backward, "
        f"{res['instances']} instances of {res['enumerated']} enumerated; launches over "
        f"{res['iterations']} timed steps {res['launches']}")

    # the sweeps: synthetic 100k at three ratios, vanilla and AMR; the CLI
    # model through -m alone at 1920x1056
    sweeps = {}
    runs = {"vanilla": (["--synthetic"], False, SWEEP_RATIOS),
            "amr": (["--synthetic"], True, SWEEP_RATIOS),
            "model": (["-m", model], False, (1.0,))}
    for tag, (argv, amr_mode, ratios) in runs.items():
        path = os.path.join(tmp, f"fps_{tag}.json")
        results, launches = counted(fps_test.main, argv + ["--out", path], amr_mode=amr_mode,
                                    ratios=list(ratios))
        with open(path) as f:
            saved = json.load(f)
        if saved["results"] != results or saved["amr"] is not amr_mode:
            raise AssertionError(f"sweep {tag}: the JSON differs from the results")
        for r in results:
            if not (r["enumerated"] <= r["capacity"] and 0 < r["instances"]
                    and math.isfinite(r["ms"]) and r["ms"] > 0):
                raise AssertionError(f"sweep {tag}: {r}")
        renders = len(ratios) * (fps_test.REPS + 2)  # probe, warm-up, timed
        if amr_mode:
            need_launches(f"sweep {tag}", launches,
                          {"binning": renders, "blend_round": 4 * renders},
                          ("blend_fwd", "blend_levels"))
        else:
            need_launches(f"sweep {tag}", launches,
                          {"binning": renders, "blend_fwd": renders},
                          ("blend_round", "blend_levels"))
        sweeps[tag] = {"results": results, "launches": launches, "card": saved["card"]}
        log(f"sweep {tag} ({saved['card']}): " + "; ".join(
            f"{r['width']}x{r['height']} {r['ms']:.3f} ms, {r['instances']} instances of "
            f"{r['enumerated']}, capacity {r['capacity']}" for r in results)
            + f"; launches {launches}")
    out["sweeps"] = sweeps

    # the 8,040-tile frame: K1 at the capacities the sweeps settled on, bit
    # for bit; K2 and the four rounds against their plain versions
    state, deg, active = fps_test.synthetic_scene(100_000, dev)
    args = renderer.activated(state, deg)
    w, h = fps_test.sweep_size((1920, 1080), 2.0)
    gx, gy = -(-w // 32), -(-h // 32)
    cam = fps_test.sweep_camera(w, h, dev)
    cap = {tag: sweeps[tag]["results"][-1]["capacity"] for tag in ("vanilla", "amr")}
    with torch.no_grad():
        prep = preprocess(*args, deg, cam, tile=32, active_mask=active)
        bin_args = (prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
                    prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths)
        table, cum = binning.compact_table(*bin_args)
        k1 = {}
        for k in sorted(set(cap.values())):
            got = expand.expand_rows_by_segments(table, 0, k)
            differ = int((got != expand.expand_rows_by_segments_plain(table, 0, k)).sum())
            k1[k] = {"differ": differ, "values": got.numel()}
            if differ:
                raise AssertionError(f"{w}x{h}: expand_seg at {k} slots differs from its plain "
                                     f"version on {differ} values")
            del got
        log(f"{w}x{h}: expand_seg vs plain bit for bit over {table.shape[1]} columns, "
            f"{int(cum[-1])} enumerated, at " + ", ".join(
                f"{k} slots ({v['differ']} of {v['values']} values differ)" for k, v in k1.items()))
        si = binning.build_sorted_instances(*bin_args, gx, gy, cap["vanilla"], 32)
        if bool(si.binning.overflow):
            raise AssertionError(f"{w}x{h}: capacity {cap['vanilla']} overflows")
        feat, offsets = blend.feat_soa_from_rows(si.feat_rows, 128), si.binning.offsets
        k2 = compare_tiles(f"{w}x{h} blend_fwd", blend.blend_fwd(feat, offsets, gx, gy),
                           blend.blend_fwd_plain(feat, offsets, gx, gy),
                           torch.ones((gx * gy, 1024), dtype=torch.bool, device=dev))
        st = amr.fovea_step0(*args, deg, cam, max_instances=cap["amr"], active_mask=active)
        if bool(st.overflow):
            raise AssertionError(f"{w}x{h}: capacity {cap['amr']} overflows step 0")
        round_errs = hold_rounds(st, gx, gy, f"{w}x{h} ")[0]
    out["big_frame"] = {"size": [w, h], "tiles": gx * gy, "instances": int(offsets[-1]),
                        "enumerated": int(cum[-1]), "expand_seg": k1, "blend_fwd_err": k2,
                        "blend_round_err": round_errs,
                        "levels": torch.bincount(st.tile_levels, minlength=5)[1:].tolist()}
    log(f"{w}x{h}: {gx * gy} tiles, {int(offsets[-1])} instances: " + json.dumps(
        out["big_frame"]))

    # the foveated CLI: the CLI model with a gaze; the synthetic scene at
    # 1920x1080 (a 24 px last tile row) with a gaze and decimation
    fov = {}
    fov_runs = {"model_gaze": ["-m", model, "--gaze"],
                "synthetic_1080": ["--synthetic", "--width", "1920", "--height", "1080",
                                   "--gaze", "--decimate", *map(str, DECIMATION)]}
    for tag, argv in fov_runs.items():
        path = os.path.join(tmp, f"fov_{tag}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            doc, launches = counted(fps_foveated.main, argv + ["--out_json", path])
        with open(path) as f:
            if json.load(f) != doc:
                raise AssertionError(f"foveated {tag}: the JSON differs from the document")
        missing = [k for k in FOVEATED_KEYS if k not in doc]
        times = [doc[k] for k in doc if k.endswith("_ms")] + [
            s["ms"] for s in doc["steps_protocol"]]
        if missing or not all(math.isfinite(t) and t > 0 for t in times):
            raise AssertionError(f"foveated {tag}: missing {missing}, times {times}")
        need_launches(f"foveated {tag}", launches, {"binning": 1, "blend_round": 4,
                                                    "blend_levels": 1, "blend_fwd": 1})
        fov[tag] = {"doc": doc, "launches": launches}
        log(f"foveated CLI {tag}: " + json.dumps(doc))
    d = fov["synthetic_1080"]["doc"]
    if "fused_predecimated_ms" not in d or (d["width"], d["height"]) != (1920, 1080):
        raise AssertionError(f"foveated CLI at 1920x1080: {sorted(d)}")
    cam = fps_test.sweep_camera(1920, 1080, dev)
    radii = (1080 / 8, 1080 / 4, 1080 / 2)
    bg = torch.zeros(3, device=dev)
    frames = {k: track_render.foveated_view(state, cam, bg, (0.5, 0.5), deg, radii=radii,
                                            fused=k == "fused", max_instances=d["capacity"])
              for k in ("five_step", "fused")}
    if any(bool(f[1].overflow) for f in frames.values()):
        raise AssertionError("1920x1080 foveated frame: capacity overflow")
    for img, _ in frames.values():
        if img.shape != (3, 1080, 1920) or not torch.isfinite(img).all():
            raise AssertionError(f"1920x1080 foveated frame: shape {tuple(img.shape)}")
    fused_err = float((frames["fused"][0] - frames["five_step"][0]).abs().max())
    if not fused_err <= 1e-3:
        raise AssertionError(f"1920x1080: fused frame differs from the 5-step one by {fused_err}")
    st = frames["five_step"][1]
    with torch.no_grad():
        errs = {"blend_round_err": hold_rounds(st, 60, 34, "1920x1080 ")[0]}
        for dec in ((1, 1, 1, 1), DECIMATION):
            errs[f"blend_levels {dec} err"] = hold_levels(st, 60, 34, "1920x1080 ", dec)[0]
    fov["synthetic_1080_checks"] = {"fused_vs_five_step_err": fused_err, **errs}
    log(f"1920x1080 foveated: fused vs 5-step frame max |err| {fused_err:.3g}")
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            fps_foveated.main(["--synthetic", "--alpha", "bf16"])
        raise AssertionError("fps_foveated --alpha bf16 was not refused")
    except SystemExit as exc:
        if exc.code != 2 or "pallas_blend.py:291-294" not in err.getvalue():
            raise AssertionError(f"--alpha bf16: exit {exc.code}, {err.getvalue()!r}")
    out["foveated"] = fov

    # track_render's main on the CLI model with the synthetic eye
    eye_path, fov_dir = os.path.join(tmp, "eye.png"), os.path.join(tmp, "foveated")
    Image.fromarray(make_eye()).save(eye_path)
    res, launches = counted(run_cli, track_render.main, [
        "-m", model, "--eye_image", eye_path, "--num_views", "4", "--out_dir", fov_dir,
        "--quiet"])
    need_launches("track_render", launches, {"binning": 4, "blend_round": 16},
                  ("blend_fwd", "blend_levels", "blend_bwd", "segsum"))
    if launches["blend_round"] != 16 or res["capacities"] != [1 << 20] * 4:
        raise AssertionError(f"track_render: launches {launches}, capacities "
                             f"{res['capacities']}")
    gaze_err = float(np.abs((np.asarray(res["gaze_uv"]) - gaze_uv)
                            * np.array([EYE_W, EYE_H])).max())
    if gaze_err > 1.0 or not os.path.exists(os.path.join(model, "eye_seg_pred.png")):
        raise AssertionError(f"track_render: gaze {res['gaze_uv']} ({gaze_err} px from "
                             f"estimate_gaze's), segmentation written: "
                             f"{os.path.exists(os.path.join(model, 'eye_seg_pred.png'))}")
    scene = Scene(model_config_of(["-m", model]), load_iteration=-1, shuffle=False,
                  load_images=False)
    render_err = []
    for path, view in zip(res["renders"], scene.get_train_cameras()[:4], strict=True):
        c = view.params(dev)
        want, _ = track_render.foveated_view(scene.gaussians, c, bg, res["gaze_uv"],
                                             scene.max_sh_degree,
                                             radii=track_render.ring_radii(c.width),
                                             fused=False)
        got = torch.from_numpy(load_image_chw(path)).to(dev)
        if got.shape != (3, c.height, c.width):
            raise AssertionError(f"track_render: {path} is {tuple(got.shape)}")
        render_err.append(float((got - want.clamp(0, 1)).abs().max()))
    if not max(render_err) <= 1 / 255 + 1e-3:
        raise AssertionError(f"track_render renders differ from foveated_view by {render_err}")
    out["track_render"] = {"gaze_uv": res["gaze_uv"], "view_ms": res["view_ms"],
                           "render_err": render_err, "launches": launches}
    log(f"track_render: gaze {res['gaze_uv']}, ms per view {res['view_ms']}, renders vs "
        f"foveated_view max |err| {render_err}; launches {launches}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


RITNET_SPLITS = (16, 8)  # synthetic OpenEDS-style eyes: training, validation
RITNET_ARGS = ["--bs", "8", "--epochs", "2", "--lr", "1e-3", "--seed", "0"]
RITNET_FIT_STEPS = 30  # on one fixed batch of 8, as JAX's test_loss_decreases
RITNET_STEP_LOSS_RTOL = 1e-4  # card vs CPU, one step at 640x400
# the card's float32 gradient against a float64 run of the same step on the
# card, of each tensor's largest gradient. (The CPU's float32 is no yardstick
# here: its 512k-term bias sums read 1.04e-3 off float64 at out_conv1.bias.)
RITNET_GRAD_TOL = 1e-4
# Adam's first step is lr * g / (|g| + 1e-8), a sign step: held within 1 % of
# lr where the gradient is clear of rounding (|g| >= 1e-6 on the CPU and the
# card within 1 % of it); at most 1 % of the elements may fall outside that set
RITNET_UPDATE_TOL = 0.01


def ritnet_phase(tmp, model, eye):
    """Phase 16 (checks): RITnet training and evaluation at full width on a
    synthetic OpenEDS-style dataset written under ``tmp``: ``train_ritnet``
    for 2 epochs, one train step on the card against the CPU, a 30-step
    fit, ``eval_ritnet`` with the trained weights and with the vendored
    ones. ``model`` is phase 7's RITnet on the card (its device is the
    phase's), ``eye`` its synthetic eye. Returns the numbers and what the
    timings need."""
    import contextlib
    import io

    from PIL import Image

    from gaussian_splatting_with_eye_tracking_tpu_torch import eval_ritnet, track_render
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_ritnet
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet, ritnet_data
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train

    dev = next(model.parameters()).device
    root = os.path.join(tmp, "eyes")
    t0 = time.perf_counter()
    write_eye_dataset(root, *RITNET_SPLITS, seed=1)
    out = {"dataset_s": time.perf_counter() - t0}

    # train through the CLI, in tmp (it writes logs/<expname>/ under the cwd)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        (params, tlog), launches = counted(train_ritnet.main, [
            "--dataset", root, "--expname", "smoke", "--data_device", dev.type, *RITNET_ARGS])
        out["train_s"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    losses = [x for epoch in tlog["losses"] for x in epoch]
    n_params = sum(v.numel() for v in params.values())
    min_var = min(float(v.min()) for k, v in params.items() if k.endswith("running_var"))
    out.update(losses=losses, val_miou=tlog["val_miou"], epoch_s=tlog["seconds"],
               params=n_params, min_running_var=min_var, launches=launches)
    log(f"RITnet training CLI: {n_params} parameters, losses {losses}, val mIoU "
        f"{tlog['val_miou']}, epochs {tlog['seconds']} s, least running_var {min_var}; "
        f"launches {launches}")
    if n_params != 249_220 or len(losses) != 2 * (RITNET_SPLITS[0] // 8):
        raise AssertionError(f"RITnet training: {n_params} parameters, {len(losses)} steps")
    if not np.isfinite(losses).all():
        raise AssertionError(f"RITnet training: a loss is not finite: {losses}")
    if not all(bool(torch.isfinite(v).all()) for v in params.values()):
        raise AssertionError("RITnet training: a parameter or BatchNorm statistic is not finite")
    if not min_var > -ritnet.BN_EPS:
        raise AssertionError(f"RITnet training: running_var {min_var} (the square root fails)")
    need_launches("RITnet training", launches, {}, none_of=list(launches))
    logs = os.path.join(tmp, "logs", "smoke")
    saved = {k: train_ritnet.load_params_npz(os.path.join(logs, f"{k}_model.npz"), dev)
             for k in ("last", "best")}

    # the same run again, in another directory: bit for bit (cuDNN's
    # deterministic algorithms, backend.py)
    again = os.path.join(tmp, "ritnet_again")
    os.makedirs(again)
    os.chdir(again)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, tlog2 = train_ritnet.main([
                "--dataset", root, "--expname", "smoke", "--data_device", dev.type,
                *RITNET_ARGS])
    finally:
        os.chdir(cwd)
    differ = []
    for kind in ("last", "best"):
        a, b = (np.load(os.path.join(d, "logs", "smoke", f"{kind}_model.npz"))
                for d in (tmp, again))
        differ += [f"{kind}:{k}" for k in a.files if not np.array_equal(a[k], b[k])]
    losses2 = [x for epoch in tlog2["losses"] for x in epoch]
    out["repeat"] = {"losses_equal": losses2 == losses, "arrays_differ": len(differ),
                     "val_miou": tlog2["val_miou"]}
    log(f"RITnet training again from the same data and seed: losses equal {losses2 == losses}, "
        f"{len(differ)} saved arrays differ {differ[:5]}")
    if differ or losses2 != losses or tlog2["val_miou"] != tlog["val_miou"]:
        raise AssertionError(f"RITnet training does not repeat: {out['repeat']}, losses "
                             f"{losses} then {losses2}")
    if not all(torch.equal(saved["last"][k], v) for k, v in params.items()):
        raise AssertionError("RITnet training: last_model.npz does not load back bit for bit")
    if tlog["val_miou"][-1] >= max(tlog["val_miou"]) and not all(
            torch.equal(saved["best"][k], v) for k, v in params.items()):
        raise AssertionError("RITnet training: best_model.npz is not the last epoch's model")

    # one make_train_step step on the card and on the CPU, same params, same batch
    init = {k: v.numpy() for k, v in ritnet.init_params(torch.Generator().manual_seed(0)).items()}
    batch = next(ritnet_data.batches(root, "train", 2, np.random.default_rng(0)))
    tx, step = ritnet_train.make_train_step(1e-3)
    card_cpu = {}
    for d in (dev, torch.device("cpu")):
        p = {k: torch.from_numpy(v).to(d) for k, v in init.items()}
        b = train_ritnet.to_device(batch, d)
        new, _, loss = step(p, tx.init(p), b, 1.0)
        _, grads = ritnet_train.loss_and_grads(p, b, 1.0)
        card_cpu[d.type] = (float(loss), {k: (new[k] - p[k]).cpu() for k in p},
                            {k: g.cpu() for k, g in grads.items()})
    (loss_d, upd_d, grad_d), (loss_c, upd_c, grad_c) = card_cpu[dev.type], card_cpu["cpu"]
    b64 = [x.double() if x.is_floating_point() else x for x in train_ritnet.to_device(batch, dev)]
    _, grad64 = ritnet_train.loss_and_grads(
        {k: torch.from_numpy(v).to(dev, torch.float64) for k, v in init.items()}, b64, 1.0)
    grad64 = {k: g.cpu() for k, g in grad64.items()}

    def off_f64(grads):  # (largest error as a share of its tensor's largest, that tensor)
        return max((float((grads[k].double() - g).abs().max() / g.abs().max()), k)
                   for k, g in grad64.items())

    loss_rel = abs(loss_d - loss_c) / abs(loss_c)
    (grad_err, grad_at), (cpu_err, cpu_at) = off_f64(grad_d), off_f64(grad_c)
    upd_err = max(float((upd_d[k] - u).abs().max()) for k, u in upd_c.items()) / 1e-3
    clear = {k: (g.abs() >= 1e-6) & ((grad_d[k] - g).abs() <= 0.01 * g.abs())
             for k, g in grad_c.items()}
    upd_clear = max(float((upd_d[k] - u).abs().where(clear[k], 0.0).max())
                    for k, u in upd_c.items()) / 1e-3
    n_unclear = sum(int((~m).sum()) for m in clear.values())
    out["step_card_vs_cpu"] = {"loss": [loss_d, loss_c], "loss_rel": loss_rel,
                               "grad_err_vs_f64": [grad_err, grad_at],
                               "cpu_grad_err_vs_f64": [cpu_err, cpu_at], "update_err_lr": upd_err,
                               "update_err_lr_clear": upd_clear, "unclear_elements": n_unclear}
    log(f"RITnet step {dev.type} vs CPU at {tuple(batch[0].shape)}: loss {loss_d} vs {loss_c} "
        f"(rel {loss_rel:.3g}); float32 gradients vs float64 on the card, of each tensor's "
        f"largest: card {grad_err:.3g} ({grad_at}), CPU {cpu_err:.3g} ({cpu_at}); "
        f"updates within {upd_err:.3g} lr ({upd_clear:.3g} lr where the gradient is clear of "
        f"rounding; {n_unclear} of {n_params} elements are not)")
    if not (loss_rel <= RITNET_STEP_LOSS_RTOL and grad_err <= RITNET_GRAD_TOL
            and upd_clear <= RITNET_UPDATE_TOL and n_unclear <= 0.01 * n_params):
        raise AssertionError(f"RITnet step: card and CPU disagree: {out['step_card_vs_cpu']}")

    # 30 steps on one fixed batch of 8
    fixed = train_ritnet.to_device(
        next(ritnet_data.batches(root, "train", 8, np.random.default_rng(2))), dev)
    p = {k: torch.from_numpy(v).to(dev) for k, v in init.items()}
    state, fit = tx.init(p), []
    for _ in range(RITNET_FIT_STEPS):
        p, state, loss = step(p, state, fixed, 1.0)
        fit.append(float(loss))
    out["fit_losses"] = fit
    log(f"RITnet fit, {RITNET_FIT_STEPS} steps on one batch of 8: loss {fit[0]} -> {fit[-1]}")
    if not (np.isfinite(fit).all() and fit[-1] < fit[0]):
        raise AssertionError(f"RITnet fit: losses {fit}")

    # eval_ritnet with the trained weights and the labels
    val = os.path.join(root, "validation")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eval_ritnet.main(["--images", os.path.join(val, "images"), "--labels",
                          os.path.join(val, "labels"), "--weights",
                          os.path.join(logs, "best_model.npz"), "--out_dir",
                          os.path.join(tmp, "eval"), "--data_device", dev.type])
    lines = buf.getvalue().splitlines()
    written = sorted(os.listdir(os.path.join(tmp, "eval")))
    out["eval_lines"] = lines
    log(f"eval_ritnet: {lines}; {len(written)} files written")
    names = [f"e{i:03d}" for i in range(RITNET_SPLITS[1])]
    if not (lines and lines[0].startswith(f"mIoU over {RITNET_SPLITS[1]} images: ")):
        raise AssertionError(f"eval_ritnet printed {lines}")
    if written != sorted(f"{n}_{k}" for n in names for k in ("label.npy", "mask.png")):
        raise AssertionError(f"eval_ritnet wrote {written}")

    # eval_ritnet with the vendored weights against estimate_gaze on phase 7's eye
    eye_dir = os.path.join(tmp, "eye")
    os.makedirs(eye_dir)
    Image.fromarray(eye).save(os.path.join(eye_dir, "eye.png"))
    with contextlib.redirect_stdout(io.StringIO()):
        eval_ritnet.main(["--images", eye_dir, "--out_dir", os.path.join(tmp, "eye_eval"),
                          "--data_device", dev.type])
    label = np.load(os.path.join(tmp, "eye_eval", "eye_label.npy"))
    _, pred = track_render.estimate_gaze(eye, model, device=dev)
    differ = int((label != pred.cpu().numpy()).sum())
    log(f"eval_ritnet vendored weights vs estimate_gaze on the {eye.shape} eye: {differ} "
        "pixels differ")
    if label.shape != tuple(pred.shape) or differ:
        raise AssertionError(f"eval_ritnet's class map differs from estimate_gaze's on {differ} px")
    out["eval_vs_estimate_gaze_px"] = differ
    return out, {"root": root, "init": init, "fixed": fixed, "best": os.path.join(
        logs, "best_model.npz")}


def ritnet_timings(run):
    """Phase 16 (timings): the train step alone on a batch of 8 at 640x400
    (CUDA events, warm-up then the median of 10) and its peak memory, the
    host's time per ``ritnet_data.batches`` batch split into its parts, and
    the eval forward per image."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet, ritnet_data
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train

    dev = torch.device("cuda")
    tx, step = ritnet_train.make_train_step(1e-3)
    p = {k: torch.from_numpy(v).to(dev) for k, v in run["init"].items()}
    state = tx.init(p)
    step_ms = cuda_ms(lambda: step(p, state, run["fixed"], 1.0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**20
    step(p, state, run["fixed"], 1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**20
    imgs, labels = run["fixed"][:2]
    # flops of the forward, from the convolutions' shapes: 2 per multiply-add
    flops = 0
    for k, w in p.items():
        if k.endswith(".weight") and w.dim() == 4:
            level = int(k[len("down_block")]) - 1 if k.startswith("down_block") else (
                4 - int(k[len("up_block")]) if k.startswith("up_block") else 0)
            flops += 2 * w.numel() * imgs.shape[0] * imgs.shape[2] * imgs.shape[3] // 4**level
    step_bound_ms = 3 * flops / FP32_FLOPS_PER_S * 1e3

    # the host's batch of 8, part by part (one draw of ritnet_data.batches' order)
    root, split = run["root"], "train"
    names = ritnet_data.list_split(root, split)[:8]
    rng = np.random.default_rng(3)
    parts = {"load_augment": 0.0, "weight_map": 0.0, "distance_maps": 0.0}
    eyes = []
    for name in names:
        t0 = time.perf_counter()
        img, label = ritnet_data.augment(*ritnet_data.load_example(root, split, name), rng)
        t1 = time.perf_counter()
        ritnet_train.boundary_weight_map(label)
        t2 = time.perf_counter()
        ritnet_train.distance_maps(label)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key] += dt * 1e3
        eyes.append(img)
    t0 = time.perf_counter()
    ritnet.normalise_eye_images(torch.from_numpy(np.stack(eyes)))  # the batch's one call
    parts["preprocess"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    next(ritnet_data.batches(root, split, 8, np.random.default_rng(3)))
    batch_ms = (time.perf_counter() - t0) * 1e3

    model = ritnet.load_pretrained(run["best"], device=dev)
    x = imgs[:1]
    with torch.no_grad():
        eval_ms = cuda_ms(lambda: model(x))
    out = {"step_ms": step_ms, "step_flops": 3 * flops, "step_bound_ms": step_bound_ms,
           "step_peak_mib": peak, "held_mib": held, "host_batch_ms": batch_ms,
           "host_batch_parts_ms": parts, "eval_forward_ms": eval_ms}
    log(f"RITnet step at {tuple(imgs.shape)}: {step_ms:.3f} ms (fp32 bound {step_bound_ms:.3f} "
        f"ms for {3 * flops:.3e} flop), peak {peak:.0f} MiB ({held:.0f} held before); host "
        f"batch of 8 {batch_ms:.1f} ms, parts {json.dumps(parts)}; eval forward "
        f"{eval_ms:.3f} ms per image; labels {tuple(labels.shape)}")
    return out


PROBE_GRAD_GATE = 2e-2  # the root parity_probe.py's gate, relative to the oracle's largest


def parity_phase():
    """Phase 17: ``parity_probe.main`` (kernels against the jnp oracles at
    256x256, 4,000 gaussians; the 3-NN oracle against cKDTree), its own
    gates, and K1-K4 and the round kernel launched by it."""
    import contextlib
    import io

    from gaussian_splatting_with_eye_tracking_tpu_torch import parity_probe

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res, launches = counted(parity_probe.main, [])
    for line in buf.getvalue().strip().splitlines():
        log(f"  parity probe: {line}")
    need_launches("parity probe", launches, {"binning": 1, "blend_fwd": 1, "blend_bwd": 1,
                                             "segsum": 1, "blend_round": 4})
    worst = max(g["rel"] for g in res["grads"].values())
    if not (res["ok"] and worst < PROBE_GRAD_GATE):
        raise AssertionError(f"parity probe: {res['failed']}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t0
    return res


def trained_bench_phase(tmp):
    """Phase 18: ``train_regression.trained_bench`` on the CLI phase's
    1000-step model: its three numbers, K1-K4 launched on every timed
    step."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_regression

    ply = os.path.join(tmp, "model", "point_cloud", f"iteration_{CLI_ITERATIONS}",
                       "point_cloud.ply")
    res, launches = counted(train_regression.trained_bench, ply)
    steps = train_regression.BENCH_REPS + 1
    need_launches("trained bench", launches, {"binning": steps, "blend_fwd": steps,
                                              "blend_bwd": steps, "segsum": steps})
    log(f"trained-model 1080p bench ({CLI_ITERATIONS}-step CLI model): "
        f"{json.dumps(res)}; launches {launches}")
    if not (res["live_instances"] > 0 and 0 < res["fwd_bwd_ms"] < math.inf):
        raise AssertionError(f"trained bench: {res}")
    return {**res, "launches": launches}


VIEWER_SIZE = 256
VIEWER_LEVEL_SHARE = 1e-3  # of the channel values allowed 1 level apart (reduction order)


def viewer_phase(tmp):
    """Phase 19: ``train.main`` resumed from the CLI phase's checkpoint for
    3 iterations with the viewer on a free local port; a client asks for a
    256x256 view with train=False, then another with train=True. Both
    frames against ``make_eval_render``'s image of the checkpoint's state
    at that camera, clipped and quantised to uint8."""
    import socket
    import struct
    import threading

    from gaussian_splatting_with_eye_tracking_tpu_torch import train as train_cli, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
    from gaussian_splatting_with_eye_tracking_tpu_torch.renderer.network_gui import image_bytes
    from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import MiniCam
    from gaussian_splatting_with_eye_tracking_tpu_torch.train_regression import run_cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    size, fov = VIEWER_SIZE, math.radians(60)
    cam = make_camera(size, size, device="cpu")
    msg = {"resolution_x": size, "resolution_y": size, "fov_y": fov, "fov_x": fov,
           "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": False, "scaling_modifier": 1.0,
           "view_matrix": cam.viewmatrix.T.reshape(-1).tolist(),
           "view_projection_matrix": cam.projmatrix.T.reshape(-1).tolist()}
    got = {}

    def client():
        deadline = time.time() + 60
        while True:
            try:
                conn = socket.create_connection(("127.0.0.1", port), timeout=60)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.005)
        with conn:
            for name, train_flag in (("paused", False), ("train", True)):
                payload = json.dumps({**msg, "train": train_flag}).encode()
                t0 = time.perf_counter()
                conn.sendall(struct.pack("I", len(payload)) + payload)
                img = b""
                while len(img) < size * size * 3:
                    part = conn.recv(size * size * 3 - len(img))
                    if not part:
                        raise ConnectionError("the viewer bridge closed the connection")
                    img += part
                n = struct.unpack("I", conn.recv(4))[0]
                source = conn.recv(n).decode()
                got[name] = (img, (time.perf_counter() - t0) * 1e3, source)

    start = os.path.join(tmp, "model", f"chkpnt{CLI_ITERATIONS}.ckpt")
    model = os.path.join(tmp, "viewer_model")
    t = threading.Thread(target=client)
    t.start()
    _, launches = counted(run_cli, train_cli.main, [
        "-s", os.path.join(tmp, "scene"), "-m", model, "--iterations", str(CLI_ITERATIONS + 3),
        "--start_checkpoint", start, "--ip", "127.0.0.1", "--port", str(port), "--quiet"])
    t.join(timeout=60)
    if t.is_alive() or set(got) != {"paused", "train"}:
        raise AssertionError(f"viewer: the client got {sorted(got)}")

    state, _ = ckpt.load_checkpoint(start)
    view = MiniCam(size, size, fov, fov, 0.01, 100.0,
                   np.reshape(msg["view_matrix"], (4, 4)).T,
                   np.reshape(msg["view_projection_matrix"], (4, 4)).T).params()
    render = train_lib.make_eval_render(3, size, size)
    want = np.frombuffer(image_bytes(render(state, *train_lib.camera_arrays(view),
                                            torch.zeros(3, device=view.viewmatrix.device),
                                            1.0)), np.uint8)
    out = {"port": port, "launches": launches, "round_trip_ms": {}, "levels_off": {}}
    for name, (img, ms, source) in got.items():
        diff = np.abs(np.frombuffer(img, np.uint8).astype(np.int16) - want)
        out["round_trip_ms"][name] = ms
        out["levels_off"][name] = {"max": int(diff.max()), "share": float((diff > 0).mean())}
        if diff.max() > 1 or (diff > 0).mean() >= VIEWER_LEVEL_SHARE or source != model:
            raise AssertionError(f"viewer: the {name} frame differs from make_eval_render's "
                                 f"({out['levels_off'][name]}, source {source!r})")
    if len(set(want.tolist())) < 2:
        raise AssertionError("viewer: make_eval_render's frame is blank")
    need_launches("viewer training", launches, {"binning": 5, "blend_fwd": 5,
                                                "blend_bwd": 3, "segsum": 3})
    log(f"viewer on port {port}: frames equal make_eval_render's to {out['levels_off']}; "
        f"round trips {out['round_trip_ms']} ms (host clock, 256x256); launches {launches}")
    return out


# -- phase 20: multi-GPU training ------------------------------------------------

MP_RANKS = 2  # ranks sharing the card in (b) and (c)
MP_STEPS = 2  # steps of each train step held in (b), one per view
MP_TRAIN_ITERATIONS = 40  # of the two-rank trainer in (c)
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-4  # of each gradient's largest value
STEP_CLEAR = 1e-3  # a gradient clear of rounding: above this share of its tensor's largest
STEP_UPDATE_TOL = 0.01  # of the group's learning rate, where the gradient is clear
STEP_OUTSIDE = 0.01  # share of those elements allowed outside the update gate
RENDER_TOL = 1e-6  # a band render against the one-device render
N_SLOTS = 1 << 19  # next_pow2(N): phase 12's capacity
GRID_Y = -(-H // 32)  # the served view's tile rows


def train_start(params, tx):
    """Phase 12's training state: the model with f_dc perturbed by N(0,
    0.1) from a seeded card generator, in next_pow2(N) = 524,288 slots.
    Returns (state, the generator)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(params.f_dc.shape, generator=gen, device="cuda")
    start = params._replace(f_dc=params.f_dc + 0.1 * noise)
    return gm.init_training(start, 3, tx, capacity=gm.next_pow2(N)), gen


def step_record(loss, state):
    """What the multi-device steps are held to: the loss, the parameters and
    Adam's first moment (on the CPU)."""
    return {"loss": float(loss),
            "params": {k: v.detach().cpu() for k, v in state.params._asdict().items()},
            "mu": {k: v.detach().cpu() for k, v in state.opt_state.mu._asdict().items()}}


def hold_steps(tag, got, want, tx):
    """Hold a run of steps (``step_record``s) against the one-device
    step's: the loss within STEP_LOSS_RTOL relative; each gradient (from
    Adam's first moments: g_k = (mu_k - b1 mu_{k-1}) / (1 - b1)) within
    STEP_GRAD_TOL of its tensor's largest value; the parameters within
    STEP_UPDATE_TOL of the group's learning rate wherever the one-device
    gradient is clear of rounding, all but STEP_OUTSIDE of those elements.
    Returns the worst numbers; raises past a gate."""
    worst = {"loss_rel": 0.0, "grad_rel": 0.0, "update_outside": 0.0}
    prev = {"got": None, "want": None}
    for k, (g, w) in enumerate(zip(got, want)):
        worst["loss_rel"] = max(worst["loss_rel"], abs(g["loss"] - w["loss"]) / abs(w["loss"]))
        for name in w["mu"]:
            grads = {}
            for who, rec in (("got", g), ("want", w)):
                mu = rec["mu"][name].cuda()
                before = prev[who][name].cuda() if prev[who] else torch.zeros_like(mu)
                grads[who] = (mu - 0.9 * before) / 0.1
            gmax = float(grads["want"].abs().max())
            if gmax == 0.0:
                continue
            worst["grad_rel"] = max(worst["grad_rel"],
                                    float((grads["got"] - grads["want"]).abs().max()) / gmax)
            clear = grads["want"].abs() > STEP_CLEAR * gmax
            dp = (g["params"][name].cuda() - w["params"][name].cuda()).abs()
            lr = tx.lr(name, k)
            outside = float((dp[clear] > STEP_UPDATE_TOL * lr).float().mean()) if clear.any() \
                else 0.0
            worst["update_outside"] = max(worst["update_outside"], outside)
        prev = {"got": g["mu"], "want": w["mu"]}
    log(f"{tag}: {len(got)} step(s) vs one device: {json.dumps(worst)}")
    if not (worst["loss_rel"] <= STEP_LOSS_RTOL and worst["grad_rel"] <= STEP_GRAD_TOL
            and worst["update_outside"] <= STEP_OUTSIDE):
        raise AssertionError(f"{tag}: the steps depart from the one-device step: {worst}")
    return worst


def concat_shards(shards):
    """Gaussian-sharded step records of every rank as one record."""
    return [{"loss": parts[0]["loss"],
             **{key: {k: torch.cat([p[key][k] for p in parts]) for k in parts[0][key]}
                for key in ("params", "mu")}}
            for parts in zip(*shards)]


def timed_steps(step, state, views, targets, bg, mesh=None):
    """Run ``step`` once per view: (step records, ms per step on the host
    clock around a synchronize, the final state, launches per step)."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend

    recs, ms, launches = [], [], []
    for view, target in zip(views, targets):
        torch.cuda.synchronize()
        for kern in backend.kernels():
            kern.launches = 0
        t0 = time.perf_counter()
        state, aux = step(state, *view, target, bg, True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({kern.name: kern.launches for kern in backend.kernels()})
        if bool(aux["overflow"]):
            raise AssertionError("a multi-device step overflowed its capacities")
        recs.append(step_record(aux["loss"], state))
    return recs, ms, state, launches


def mp_caps(n_bands, slots=None, max_instances=MAX_INSTANCES):
    """The band steps' capacities: bench.py's enumeration capacity in every
    band (it holds the whole front view), and exchange blocks of a rank's
    rows (no source sends a band more rows than it holds)."""
    return dict(max_instances_per_band=max_instances,
                max_exchange_per_band=(slots or N_SLOTS) // n_bands)


def one_rank_checks(state, start, tx, opt, cams, targets, bg, width, height, caps,
                    reference_image):
    """Phase 20 (a) on a one-rank mesh: ``sharded_render`` at one band
    against ``reference_image`` (``make_eval_render``'s), then each train
    step (tile band, gaussian-sharded) one step against
    ``make_train_step``'s from ``start``. Returns the numbers, the
    one-device steps' records over ``cams`` and the three steps with the
    sharded start state."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh()
    gmesh = sharded.make_mesh(axis="gauss")
    out = {}
    (color, _, _, overflow), launches = counted(
        sharded.sharded_render, mesh, state, cams[0].params(), bg, max_sh_degree=3,
        max_instances_per_band=caps["max_instances_per_band"])
    err = float((color - reference_image).abs().max())
    log(f"multi-GPU (a): sharded_render at 1 band vs make_eval_render: max |diff| {err} "
        f"(gate {RENDER_TOL}); launches {launches}")
    if err > RENDER_TOL or bool(overflow.any()):
        raise AssertionError(f"multi-GPU (a): band render differs by {err}")
    need_launches("multi-GPU (a) render", launches, {"binning": 1, "blend_fwd": 1},
                  none_of=("blend_bwd", "segsum"))
    out["render"] = {"max_abs_diff": err, "launches": launches}

    views = [train_lib.camera_arrays(c.params()) for c in cams]
    single = train_lib.make_train_step(tx, opt, 3, width, height,
                                       caps["max_instances_per_band"])
    want, st = [], start
    for view, target in zip(views, targets):
        st, aux = single(st, *view, target, bg, True)
        want.append(step_record(aux.loss, st))
    band = sharded.make_sharded_train_step(
        mesh, tx, opt, 3, width, height,
        max_instances_per_band=caps["max_instances_per_band"])
    gauss = sharded.make_gauss_sharded_train_step(
        gmesh, tx, opt, 3, width, height, **caps)
    for kind, step, st0 in (("band", band, start),
                            ("gauss", gauss, sharded.shard_model_state(gmesh, start))):
        recs, _, _, launches = timed_steps(step, st0, views[:1], targets[:1], bg)
        need_launches(f"multi-GPU (a) {kind} step", launches[0],
                      {"binning": 1, "blend_fwd": 1, "blend_bwd": 1, "segsum": 1})
        if launches[0]["blend_bwd"] != 1 or launches[0]["segsum"] != 1:
            raise AssertionError(f"multi-GPU (a) {kind}: launches {launches[0]}")
        out[kind] = {**hold_steps(f"multi-GPU (a) {kind} step", recs, want[:1], tx),
                     "launches": launches[0]}
    steps = {"make_train_step": (single, start), "band_1rank": (band, start),
             "gauss_1rank": (gauss, sharded.shard_model_state(gmesh, start))}
    return out, want, steps


def band_kernel_checks(state, cam, target, bg, band, n_bands, cap):
    """K1-K4 on band ``band`` of ``n_bands`` (its grid, its rects, its
    shifted centres) against their plain versions: K1 bit-exact, K2 and K3
    at phases 5's and 13's gates, K4 at 1e-5 of each row's largest."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import renderer
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, expand
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection, segsum
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import sharded

    gx, gy = -(-cam.width // 32), -(-cam.height // 32)
    gyl = -(-gy // n_bands)
    with torch.no_grad():
        prep = projection.preprocess(*renderer.activated(state, 3), 3, cam,
                                     active_mask=state.active)
        local = sharded.band_local(prep, torch.zeros_like(prep.means2d), band, 32, gyl)
        args = (local.means2d, local.conics, local.rgb, local.opacities, local.tiles_touched,
                local.rect_min, local.rect_max, local.cull_thr, local.depths)
        table, _ = binning.compact_table(*args)
        k1 = expand.expand_rows_by_segments(table, 0, cap)
        k1_plain = expand.expand_rows_by_segments_plain(table, 0, cap)
        k1_diff = int((k1.view(torch.int32) != k1_plain.view(torch.int32)).sum())
        si = binning.build_sorted_instances(*args, gx, gyl, cap, 32, max_live=cap)
        b = si.binning
        feat = blend.feat_soa_from_rows(si.feat_rows, blend.CHUNK)
        k2 = blend.blend_fwd(feat, b.offsets, gx, gyl)
        k2_plain = blend.blend_fwd_plain(feat, b.offsets, gx, gyl)
        k2_err = float((k2[..., 0:4] - k2_plain[..., 0:4]).abs().max())
        k2_tiles = int((k2[:, 0, 4] != k2_plain[:, 0, 4]).sum())
    tiles = k2.clone().requires_grad_(True)
    color, _ = blend.assemble_tiles(tiles, gx, gyl, 32, bg)
    rows = slice(band * gyl * 32, min((band + 1) * gyl * 32, cam.height))
    color = color[:, :rows.stop - rows.start, :cam.width]
    loss = 0.8 * ssim_ops.l1_loss(color, target[:, rows]) + 0.2 * (
        1.0 - ssim_ops.ssim(color, target[:, rows]))
    (cot,) = torch.autograd.grad(loss, tiles)
    with torch.no_grad():
        cot = cot.contiguous()
        k3 = blend.blend_bwd(feat, b.offsets, k2, cot, gx, gyl)
        k3_plain = blend.blend_bwd_plain(feat, b.offsets, k2, cot, gx, gyl)
        k3_rowmax = k3_plain.abs().amax(dim=1, keepdim=True)
        k3_bad = bool(((k3 - k3_plain).abs() > 1e-3 * k3_rowmax + 1e-3 * k3_plain.abs()).any())
        red = (k3, si.id_pos, b.gauss_start, b.gauss_count, cap)
        k4 = blend.segment_reduce_grads(*red)
        k4_plain = segsum.segment_sum_gather_plain(
            k3, blend.id_order_source(si.id_pos, cap),
            blend.id_order_bounds(b.gauss_start, b.gauss_count))
        k4_rowmax = k4_plain.abs().amax(dim=1, keepdim=True)
        k4_bad = bool(((k4 - k4_plain).abs() > 1e-5 * k4_rowmax).any())
        torch.cuda.synchronize()
    out = {"grid": [gx, gyl], "instances": int(b.offsets[-1]), "k1_values_differ": k1_diff,
           "k2_max_abs_err": k2_err, "k2_chunks_done_tiles_differ": k2_tiles,
           "k3_max_abs_err": float((k3 - k3_plain).abs().max()),
           "k4_max_abs_err": float((k4 - k4_plain).abs().max())}
    if (k1_diff or not k2_err <= 1e-3 or k2_tiles > 0.001 * gx * gyl or k3_bad or k4_bad
            or bool(b.overflow)):
        raise AssertionError(f"band {band}: a kernel disagrees with its plain version: {out}")
    return out


def mp_worker(port, rank, world, tmp):
    """One rank of phase 20 (b), sharing the card with the others on gloo
    (NCCL places one rank on a device): the band render, the exchange with
    its peak memory, MP_STEPS steps of each train step, and on the last
    rank K1-K4 on its band. Writes ``rank<r>.pt`` into ``tmp``."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import renderer, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost, sharded

    multihost.maybe_initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                                           backend="gloo", timeout_s=300)
    ref = torch.load(os.path.join(tmp, "ref.pt"), weights_only=True)
    targets = [t.cuda() for t in ref["targets"]]
    raw = raw_params(*make_scene(N))
    params = gm.GaussianParams(**{k: torch.tensor(v, device="cuda") for k, v in raw.items()})
    state = gm.state_from_params(params, 3)
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, EXTENT)
    start, _ = train_start(params, tx)
    bg = torch.zeros(3, device="cuda")
    cams = [view_request(y, p) for y, p in VIEWS[:MP_STEPS]]
    views = [train_lib.camera_arrays(c.params()) for c in cams]
    mesh = sharded.make_mesh()
    gmesh = sharded.make_mesh(axis="gauss")
    caps = mp_caps(world)
    out = {"rank": rank, "backend": torch.distributed.get_backend()}

    (color, _, _, overflow), out["render_launches"] = counted(
        sharded.sharded_render, mesh, state, cams[0].params(), bg, max_sh_degree=3,
        max_instances_per_band=caps["max_instances_per_band"])
    out["render_overflow"] = overflow.tolist()
    if rank == 0:
        out["image"] = color.cpu()

    # the exchange: its rows per band against the whole preprocess's, and
    # its peak memory against exchange_memory_bytes
    gyl = -(-GRID_Y // world)
    sstart = sharded.shard_model_state(gmesh, start)
    with torch.no_grad():
        cp = cams[0].params()
        local = projection.preprocess(*renderer.activated(sstart, 3), 3, cp,
                                      active_mask=sstart.active)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        recv, ex_overflow = sharded._band_exchange(local, gmesh, world, gyl,
                                                   caps["max_exchange_per_band"])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        full = projection.preprocess(*renderer.activated(start, 3), 3, cp,
                                     active_mask=start.active)
        lo, hi = full.rect_min[:, 1], full.rect_max[:, 1]
        inter = (full.tiles_touched > 0) & (lo < (rank + 1) * gyl) & (hi > rank * gyl)
        got = recv[recv[:, 15] > 0.5]
        same = all(torch.equal(torch.sort(got[:, c]).values,
                               torch.sort(full.means2d[inter, c]).values) for c in (0, 1))
    out["exchange"] = {
        "rows": int(got.shape[0]), "want_rows": int(inter.sum()), "means2d_equal": same,
        "overflow": bool(ex_overflow), "peak_bytes": int(peak),
        "model_bytes": sharded.exchange_memory_bytes(N_SLOTS // world, world,
                                                     caps["max_exchange_per_band"])}
    del recv, got, full, local

    band = sharded.make_sharded_train_step(
        mesh, tx, opt, 3, W, H, max_instances_per_band=caps["max_instances_per_band"])
    gauss = sharded.make_gauss_sharded_train_step(gmesh, tx, opt, 3, W, H, **caps)
    recs, out["band_ms"], _, out["band_launches"] = timed_steps(band, start, views, targets,
                                                                bg)
    if rank == 0:
        out["band"] = recs
    out["gauss"], out["gauss_ms"], _, out["gauss_launches"] = timed_steps(
        gauss, sstart, views, targets, bg)
    if rank == world - 1:
        out["kernels"] = band_kernel_checks(state, cams[0].params(), targets[0], bg, rank,
                                            world, caps["max_instances_per_band"])
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def start_ranks(argvs, envs, cwd, timeout=600):
    """Run one subprocess per argument list and wait for all, at most
    ``timeout`` seconds; kill them all and raise if one runs into it or
    fails. Returns their output."""
    import subprocess

    procs = [subprocess.Popen(argv, env={**os.environ, **env}, cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for argv, env in zip(argvs, envs)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                        .decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"ranks ran past {timeout} s")
    if any(p.returncode for p in procs):
        raise AssertionError("ranks failed:\n" + "\n".join(
            f"--- rank {i} (exit {p.returncode}) ---\n{log_[-6000:]}"
            for i, (p, log_) in enumerate(zip(procs, logs))))
    return logs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_gpu_phase(tmp, params, state, images, bg):
    """Phase 20: multi-GPU training on the 300k model at 1920x1088 and
    phase 12's 524,288-slot state. (a) one rank on NCCL, in this process;
    (b) two ranks sharing the card (subprocesses, gloo); (c) the two-rank
    trainer on the CLI phase's scene; (d) scaling_bench at 1 device."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import scaling_bench, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost

    t_phase = time.perf_counter()
    out = {}
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, EXTENT)
    start, _ = train_start(params, tx)
    cams = [view_request(y, p) for y, p in VIEWS[:MP_STEPS]]
    targets = images[:MP_STEPS]

    # -- (a) one rank, NCCL ----------------------------------------------
    multihost.maybe_initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, 0)
    if torch.distributed.get_backend() != "nccl":
        raise AssertionError(f"one rank on the card runs {torch.distributed.get_backend()}")
    out["a"], want, steps = one_rank_checks(state, start, tx, opt, cams, targets, bg, W, H,
                                            mp_caps(1), images[0])
    view = train_lib.camera_arrays(cams[0].params())
    out["a"]["step_ms"] = {name: cuda_ms(lambda: step(st, *view, targets[0], bg, True))
                           for name, (step, st) in steps.items()}
    del steps
    log(f"multi-GPU (a) step times (front view, median of {REPS}, CUDA events): "
        f"{json.dumps(out['a']['step_ms'])}")

    # -- (b) two ranks sharing the card -----------------------------------
    wdir = os.path.join(tmp, "mp")
    os.makedirs(wdir)
    torch.save({"targets": [t.cpu() for t in targets]}, os.path.join(wdir, "ref.pt"))
    port = free_port()
    t0 = time.perf_counter()
    start_ranks([[sys.executable, os.path.abspath(__file__), "--mp-rank", str(port), str(r),
                  str(MP_RANKS), wdir] for r in range(MP_RANKS)],
                [{}] * MP_RANKS, cwd=os.path.dirname(os.path.abspath(__file__)))
    ranks = [torch.load(os.path.join(wdir, f"rank{r}.pt"), weights_only=True)
             for r in range(MP_RANKS)]
    b = {"seconds": time.perf_counter() - t0, "backend": ranks[0]["backend"]}
    b["render_max_abs_diff"] = float((ranks[0]["image"].cuda() - images[0]).abs().max())
    log(f"multi-GPU (b): {MP_RANKS} ranks on {b['backend']}; sharded_render at "
        f"{MP_RANKS} bands vs one device: max |diff| {b['render_max_abs_diff']} (gate "
        f"{RENDER_TOL})")
    if b["render_max_abs_diff"] > RENDER_TOL or any(any(r["render_overflow"]) for r in ranks):
        raise AssertionError("multi-GPU (b): the band render departs from one device's")
    b["exchange"] = [r["exchange"] for r in ranks]
    for r, ex in enumerate(b["exchange"]):
        log(f"multi-GPU (b) rank {r} exchange: {json.dumps(ex)}")
        if (ex["rows"] != ex["want_rows"] or not ex["means2d_equal"] or ex["overflow"]
                or ex["peak_bytes"] > 1.1 * ex["model_bytes"]):
            raise AssertionError(f"multi-GPU (b): rank {r}'s exchange: {ex}")
    b["band"] = hold_steps(f"multi-GPU (b) band step, {MP_RANKS} ranks", ranks[0]["band"],
                           want, tx)
    b["gauss"] = hold_steps(f"multi-GPU (b) gauss step, {MP_RANKS} ranks",
                            concat_shards([r["gauss"] for r in ranks]), want, tx)
    b["launches"] = {r["rank"]: {"render": r["render_launches"], "band": r["band_launches"],
                                 "gauss": r["gauss_launches"]} for r in ranks}
    for r in ranks:
        need_launches(f"rank {r['rank']} render", r["render_launches"],
                      {"binning": 1, "blend_fwd": 1})
        for kind in ("band", "gauss"):
            for per_step in r[f"{kind}_launches"]:
                if per_step["blend_bwd"] != 1 or per_step["segsum"] != 1:
                    raise AssertionError(f"rank {r['rank']} {kind} step: {per_step}")
                need_launches(f"rank {r['rank']} {kind} step", per_step,
                              {"binning": 1, "blend_fwd": 1})
    b["step_ms"] = {kind: [r[f"{kind}_ms"] for r in ranks] for kind in ("band", "gauss")}
    b["kernels"] = ranks[-1]["kernels"]
    log(f"multi-GPU (b): step ms per rank (host clock, ranks sharing one card: no speed "
        f"figure) {json.dumps(b['step_ms'])}; K1-K4 on rank {MP_RANKS - 1}'s band "
        f"{json.dumps(b['kernels'])}; launches {json.dumps(b['launches'])}")
    out["b"] = b

    # -- (c) the two-rank trainer ----------------------------------------
    scene_dir = os.path.join(tmp, "scene")
    models = [os.path.join(tmp, f"mp_model{r}") for r in range(MP_RANKS)]
    n = MP_TRAIN_ITERATIONS
    port = free_port()
    t0 = time.perf_counter()
    start_ranks([[sys.executable, "-m", "gaussian_splatting_with_eye_tracking_tpu_torch.train",
                  "-s", scene_dir, "-m", models[r], "--iterations", str(n),
                  "--save_iterations", str(n), "--checkpoint_iterations", str(n),
                  "--test_iterations", str(n), "--eval", "--quiet"]
                 for r in range(MP_RANKS)],
                [dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                      LOCAL_RANK=str(r), WORLD_SIZE=str(MP_RANKS),
                      LOCAL_WORLD_SIZE=str(MP_RANKS)) for r in range(MP_RANKS)],
                cwd=os.path.dirname(os.path.abspath(__file__)))
    c = {"seconds": time.perf_counter() - t0}
    path = ckpt.latest_checkpoint(models[0])
    meta = ckpt.checkpoint_meta(path)
    st, it = ckpt.load_checkpoint_dist(path)
    c.update(checkpoint=os.path.basename(path), iteration=it, layout=meta["layout"],
             ranks_agree=len(set(meta["digests"])) == 1 and len(meta["digests"]) == MP_RANKS,
             finite=bool(torch.isfinite(st.params.xyz[st.active]).all()),
             points=int(st.active.sum()), rank1_wrote=os.path.exists(models[1]),
             rank0_wrote=sorted(os.listdir(models[0])))
    log(f"multi-GPU (c): two-rank trainer, {n} iterations: {json.dumps(c)}")
    ply = os.path.join(models[0], "point_cloud", f"iteration_{n}", "point_cloud.ply")
    if not (it == n and c["ranks_agree"] and c["finite"] and not c["rank1_wrote"]
            and os.path.exists(os.path.join(models[0], "cfg_args")) and os.path.exists(ply)):
        raise AssertionError(f"multi-GPU (c): {c}")
    out["c"] = c

    # -- (d) scaling_bench at 1 device -------------------------------------
    res = scaling_bench.main(["--devices", "1", "--out", os.path.join(tmp, "scaling.json")])
    out["d"] = res
    log(f"multi-GPU (d): scaling_bench {json.dumps(res)}")
    if not (len(res) == 1 and res[0]["devices"] == 1 and res[0]["rays_per_s"] > 0):
        raise AssertionError(f"scaling_bench: {res}")
    torch.distributed.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- phase 21: the study scripts --------------------------------------------------

STUDY_W, STUDY_H = 1920, 1088
STUDY_N = 100_000  # fps_test's synthetic scene
STUDY_DENSITIES = (100_000, 400_000, 1_000_000)  # amr_quality_sweep's defaults
STUDY_GATE = 1e-3  # a frame through the kernels against the plain route (phase 4's gate)


class plain_route:
    """Within it every kernel wrapper is its plain PyTorch version, on
    any device: a path then runs the plain route on the card's tensors,
    launching no kernel."""

    def __enter__(self):
        from gaussian_splatting_with_eye_tracking_tpu_torch.ops import (
            binning, blend, expand, projection)

        self.saved = [(expand, "expand_rows_by_segments"), (blend, "blend_fwd"),
                      (blend, "blend_round"), (blend, "blend_levels"),
                      (projection, "preprocess_kernel"),
                      (binning, "build_sorted_instances_kernel")]
        self.saved = [(m, name, getattr(m, name)) for m, name in self.saved]
        expand.expand_rows_by_segments = expand.expand_rows_by_segments_plain
        projection.preprocess_kernel = projection.preprocess_plain
        binning.build_sorted_instances_kernel = binning.build_sorted_instances_plain
        blend.blend_fwd = blend.blend_fwd_plain

        def round_plain(*a, offx, offy, counts_override=None, order=None, split=1):
            return blend.blend_round_plain(*a, offx=offx, offy=offy,
                                           counts_override=counts_override)

        def levels_plain(feat, offsets, counts, levels, gx, gy, **kw):
            return blend.blend_levels_plain(feat, offsets, counts.to(torch.int32),
                                            levels.to(torch.int32), gx, gy, **kw)

        blend.blend_round, blend.blend_levels = round_plain, levels_plain
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def hold_frame(tag, render, cap):
    """``render(capacity) -> (image, counters)`` at ``cap`` through the
    kernels and through the plain route (which must launch none): images
    within ``STUDY_GATE``, the instance counters equal. Returns the max
    |err|."""
    with torch.no_grad():
        got, got_c = render(cap)
        with plain_route():
            (want, want_c), launches = counted(render, cap)
    if any(launches.values()):
        raise AssertionError(f"{tag}: the plain route launched {launches}")
    err = float((got - want).abs().max())
    counters = [(int(got_c.num_instances), int(want_c.num_instances)),
                (int(got_c.num_enumerated), int(want_c.num_enumerated))]
    if not err <= STUDY_GATE or any(a != b for a, b in counters) or bool(got_c.overflow):
        raise AssertionError(f"{tag}: kernels vs plain route max |err| {err}, counters "
                             f"{counters}, overflow {bool(got_c.overflow)}")
    log(f"{tag}: kernels vs plain route max |err| {err:.3g}, {counters[0][0]} instances")
    return err


def studies_phase(tmp):
    """Phase 21: the four study modules' ``main``s in this process at
    1920x1088, on fps_test's synthetic 100k scene and the CLI phase's
    model (``tmp``/model), and the sweep's three densities. Returns the
    numbers, with each run's launches."""
    import contextlib
    import io

    from gaussian_splatting_with_eye_tracking_tpu_torch import AMR_test, KDtree_test, fps_test
    from gaussian_splatting_with_eye_tracking_tpu_torch import amr_quality_sweep, renderer
    from gaussian_splatting_with_eye_tracking_tpu_torch import opacity_quant_test, study_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr

    model_dir = os.path.join(tmp, "model")
    synthetic = ["--synthetic", "--num_gaussians", str(STUDY_N)]
    size = ["--width", str(STUDY_W), "--height", str(STUDY_H)]
    out = {"launches": {}}
    t_phase = time.perf_counter()

    def run(tag, fn, argv):
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            doc, launches = counted(fn, argv)
        out["launches"][tag] = launches
        log(f"{tag}: launches {launches}; " + buf.getvalue().strip().replace("\n", " | "))
        return doc, launches

    def view(argv):
        return study_lib.study_view(study_lib.study_parser("", "").parse_args(argv + size))

    # AMR_test: the like-for-like cross-check (a)-(c), and the 5-step frame
    # against the plain route
    amr_docs = {}
    for tag, argv in (("synthetic_100k", synthetic), ("cli_model", ["-m", model_dir])):
        doc, launches = run(f"AMR_test {tag}", AMR_test.main,
                            argv + size + ["--out_dir", os.path.join(tmp, f"amr_{tag}")])
        flags = {k: doc[k] for k in ("counts_match", "kept_match", "levels_match",
                                     "bin_gaussians_match")}
        if not all(flags.values()) or doc["rect_pairs"] != doc["enumerated"]:
            raise AssertionError(f"AMR_test {tag}: {flags}, rect pairs {doc['rect_pairs']} "
                                 f"of {doc['enumerated']} enumerated")
        need_launches(f"AMR_test {tag}", launches,
                      {"binning": 3, "blend_fwd": 2, "blend_round": 4}, ("blend_levels",))
        model, deg, active, cam, bg = view(argv)
        doc["amr_frame_err"] = hold_frame(
            f"AMR_test {tag} 5-step frame",
            lambda c: amr.render_amr(*model, deg, cam, bg, active_mask=active, max_instances=c),
            doc["frames"]["amr"]["capacity"])
        amr_docs[tag] = {k: v for k, v in doc.items() if k not in ("tile_counts", "tile_levels")}
    out["AMR_test"] = amr_docs

    # KDtree_test and opacity_quant_test (4 and 8 bits) on the 100k scene;
    # one frame of each through the plain route
    model, deg, active, cam, bg = view(synthetic)
    doc, launches = run("KDtree_test", KDtree_test.main,
                        synthetic + size + ["--out_dir", os.path.join(tmp, "kdtree")])
    if doc["kept"] != int(0.5 * doc["active_gaussians"]) + 1:
        raise AssertionError(f"KDtree_test kept {doc['kept']} of {doc['active_gaussians']}")
    need_launches("KDtree_test", launches, {"binning": 3, "blend_fwd": 3},
                  ("blend_round", "blend_levels"))
    keep = KDtree_test.nearest(model[0], cam.campos, active, 0.5)
    doc["pruned_frame_err"] = hold_frame(
        "KDtree_test pruned frame", study_lib.rasterizer(model, deg, cam, bg, keep),
        doc["frames"]["pruned"]["capacity"])
    out["KDtree_test"] = doc
    out["opacity_quant_test"] = {}
    for bits in (4, 8):
        doc, launches = run(f"opacity_quant_test {bits} bits", opacity_quant_test.main,
                            synthetic + size + ["--bits", str(bits), "--out_dir",
                                                      os.path.join(tmp, f"opq{bits}")])
        if not (doc["psnr_quantized_residual_db"] >= 100
                and math.isfinite(doc["psnr_quantized_db"])):
            raise AssertionError(f"opacity_quant_test {bits} bits: {doc}")
        need_launches(f"opacity_quant_test {bits}", launches, {"binning": 4, "blend_fwd": 4},
                      ("blend_round", "blend_levels"))
        doc["quantized_frame_err"] = hold_frame(
            f"opacity_quant_test {bits} bits quantized frame",
            opacity_quant_test.renders(model, deg, cam, bg, active, bits)["quantized"],
            doc["frames"]["quantized"]["capacity"])
        out["opacity_quant_test"][bits] = doc

    # the sweep: the CLI model and the three densities; the states it loads
    # are kept, and a decimated frame of each held against the plain K5
    loaded = {}
    load = fps_test.load_or_synthetic

    def keep_loaded(flags):
        loaded[flags.num_gaussians] = load(flags)
        return loaded[flags.num_gaussians]

    fps_test.load_or_synthetic = keep_loaded
    try:
        doc, launches = run("amr_quality_sweep", amr_quality_sweep.main, [
            "-m", model_dir, "--densities", *map(str, STUDY_DENSITIES), *size,
            "--out", os.path.join(tmp, "amr_quality.json"),
            "--png", os.path.join(tmp, "amr_quality.png")])
    finally:
        fps_test.load_or_synthetic = load
    rows = doc["results"]
    if [r["workload"] for r in rows] != ["trained"] + [f"synthetic_{n}" for n in
                                                         STUDY_DENSITIES]:
        raise AssertionError(f"amr_quality_sweep rows {[r['workload'] for r in rows]}")
    for r in rows:
        values = [d[k] for d in r["decimation"] for k in ("psnr_db", "ssim",
                                                            "predecimate_psnr_db",
                                                            "predecimate_ssim")]
        if r["overflow"] or r["enumerated"] > r["capacity"] or not all(
                math.isfinite(v) for v in values):
            raise AssertionError(f"amr_quality_sweep {r['workload']}: {r}")
    frames = len(rows) * 9  # a workload's capacity probe, then its 8 frames
    need_launches("amr_quality_sweep", launches,
                  {"binning": frames, "blend_levels": frames},
                  ("blend_fwd", "blend_round"))
    with open(os.path.join(tmp, "amr_quality.json")) as f:
        if json.load(f) != json.loads(json.dumps(doc)):
            raise AssertionError("amr_quality_sweep: the JSON differs from the document")
    gx, gy = -(-STUDY_W // 32), -(-STUDY_H // 32)
    held = {}
    for r in rows[1:]:
        state, deg, active = loaded[int(r["workload"].split("_")[1])]
        cam, gaze, radii = amr_quality_sweep.gaze_view(STUDY_W, STUDY_H, state.params.xyz.device)
        with torch.no_grad():
            st = amr.fovea_step0(*renderer.activated(state, deg), deg, cam, active_mask=active,
                                 max_instances=r["capacity"], gaze_xy=gaze, gaze_radii=radii)
            if bool(st.overflow):
                raise AssertionError(f"{r['workload']}: capacity {r['capacity']} overflows")
            held[r["workload"]] = hold_levels(st, gx, gy, f"{r['workload']} ", (4, 2, 1, 1))[0]
        del st
    loaded.clear()
    out["amr_quality_sweep"] = {"results": rows, "blend_levels_err": held}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"studies: {out['seconds']:.1f} s")
    return out


# -- phase 22: the numerics suite -------------------------------------------------

NUMERICS_STATE = (3176, 8192, 2175)  # the collapse state's iteration, slots, active


def numerics_clean(what, r):
    """Raise unless a ``numerics`` check's readings ``r`` failed nothing."""
    if r["failed"]:
        shown = {k: v for k, v in r.items() if k != "state"}
        raise AssertionError(f"numerics: {what} failed {r['failed']}: {shown}")


def numerics_phase(tmp):
    """Phase 22: the JAX package's hardware numerics suite on the card,
    through ``numerics``' checks and their limits. The scene written and
    the collapse state read (``load_jax_checkpoint``) once, before any
    count; ``numerics.repro`` (the step through the kernels and the jnp
    oracle, held to each other, and the SSIM of its frame against
    float64) and the 30-step window, launches counted; the SSIM checks'
    controls (the frame with cuDNN's TF32 on, and under bf16 autocast);
    the dark, flat frames; the degenerate-distribution gradients, K4's
    table route against float64 and the two reduction routes. Returns the
    readings with each counted run's launches."""
    import contextlib
    import io

    from gaussian_splatting_with_eye_tracking_tpu_torch import numerics as nm

    t_phase = time.perf_counter()
    out = {"launches": {}}
    state, cam, scene = nm.collapse_fixture(os.path.join(tmp, "scene"))
    out["reader"] = {"iteration": nm.ITERATION - 1, "device": str(state.params.xyz.device),
                     "slots": int(state.active.shape[0]), "active": int(state.active.sum()),
                     "adam_count": state.opt_state.count, "sh_degree": state.sh_degree,
                     "finite": all(nm.active_params_finite(state).values())}
    r = out["reader"]
    log(f"numerics: load_jax_checkpoint {json.dumps(r)}")
    if (r["device"] != "cuda:0" or (r["iteration"], r["slots"], r["active"]) != NUMERICS_STATE
            or r["adam_count"] != NUMERICS_STATE[0] or not r["finite"]):
        raise AssertionError(f"numerics: the collapse state read back as {r}")

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        doc, launches = counted(nm.repro, state, cam, scene)
    for line in buf.getvalue().strip().splitlines():
        log(f"numerics repro: {line}")
    out["launches"]["repro"] = launches
    frame = doc.pop("frame")
    out["repro"] = doc
    log(f"numerics: step {nm.ITERATION}, kernels vs jnp oracle, excess over tolerance "
        f"{json.dumps(doc['step']['excess'])}; exact {json.dumps(doc['step']['exact'])}; "
        f"launches {launches}")
    numerics_clean(f"step {nm.ITERATION}", doc)
    need_launches("numerics repro", launches, {k: 1 for k in ("binning", "blend_fwd",
                                                              "blend_bwd", "segsum")})

    # the SSIM checks' controls: the fault they guard, made on purpose
    gt = cam.gt()[None]
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = nm.ssim_check(frame, gt)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    with torch.autocast("cuda", dtype=torch.bfloat16):
        bf16 = nm.ssim_check(frame, gt)
    dark = nm.ssim_check(*nm.dark_flat_frames())
    out["ssim"] = {"frame": doc["ssim"], "tf32_control": tf32, "bf16_control": bf16,
                   "dark": dark}
    for name, c in out["ssim"].items():
        log(f"numerics: SSIM, {name}: map in [{c['min']!r}, {c['max']!r}], mean {c['mean']!r} "
            f"vs float64 {c['mean_f64']!r} (|diff| {c['mean_diff']:.3g}), per pixel within "
            f"{c['pixel_diff']:.3g}; failed {c['failed']}")
    numerics_clean("SSIM on the dark, flat frames", dark)
    if "pixel_f64" not in bf16["failed"]:
        raise AssertionError(f"numerics: the SSIM checks do not see bf16 blurs: {bf16}")

    window, launches = counted(nm.mini_schedule, state, scene)
    out["launches"]["window"] = launches
    out["window"] = {k: v for k, v in window.items() if k != "state"}
    log(f"numerics: reset_opacity + 30 steps + densify at 14: losses {window['losses'][0]:.5f} "
        f"... {window['losses'][-1]:.5f}, densify {window['densify']}, active "
        f"{window['active']}; launches {launches}")
    numerics_clean("the window", window)
    need_launches("numerics window", launches, {k: nm.WINDOW_STEPS for k in (
        "binning", "blend_fwd", "blend_bwd", "segsum")})

    out["degenerate"] = [nm.degenerate_check(opacity, scale) for opacity, scale in nm.DEGENERATE]
    for d in out["degenerate"]:
        log(f"numerics: gradients at opacity {d['opacity']}, scale {d['scale']}: kernels vs jnp "
            f"oracle, max |err| / max |value| {json.dumps(d['err'])}; the cull sees "
            f"{json.dumps(d['cull'])}")
        numerics_clean(f"gradients at ({d['opacity']}, {d['scale']})", d)
    out["segsum"] = [nm.segsum_check(*case) for case in nm.SEGSUM_CASES]
    for d in out["segsum"]:
        log(f"numerics: K4 table route, {d['rows']} rows x {d['columns']} columns, "
            f"{d['segments']} segments: max |err| over the row's absolute sum vs float64 "
            f"{d['err']:.3g}")
        numerics_clean("K4 against float64", d)
    out["routes"] = nm.route_check()
    log(f"numerics: gather route vs table route on one set of K3 records, max |err| / max "
        f"|value| {json.dumps(out['routes']['err'])}")
    numerics_clean("the reduction routes", out["routes"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"numerics: {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test, renderer, train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, expand
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = fps_test.card(dev)
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
    for stem in sorted({kern.stem for kern in backend.kernels()}):
        for line in backend.build_log(stem).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {stem}: {line.strip()}")
    build = {stem: ptxas_report(backend, stem)
             for stem in ("blend_fwd", "blend_bwd", "blend_amr", "segsum", "preprocess")}
    log(f"redesigned kernels: {json.dumps(build)}")

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

    cams = [view_request(y, p) for y, p in VIEWS]
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
    for name in ("preprocess", "binning", "blend_fwd"):
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

        # K6 along K1's own slot -> column map: the same table by another route
        seg = table[0].contiguous()
        slots = torch.arange(MAX_INSTANCES, dtype=torch.float32, device=dev)
        ck = (torch.searchsorted(seg, slots, right=True) - 1).clamp_(
            0, table.shape[1] - 1).to(torch.int32)
        k6 = expand.expand_rows(table, ck)
        k6_plain = expand.expand_rows_plain(table, ck)
        torch.cuda.synchronize()
        k6_mismatch = int((k6 != k6_plain).sum())
        k6_vs_k1 = int((k6 != k1).sum())
        k6_err = float((k6 - k6_plain)[finite].abs().max())
        log(f"expand_rows vs plain: {k6_mismatch} of {k6.numel()} values differ "
            f"(max |err| {k6_err}); vs expand_seg's output: {k6_vs_k1} differ")
        if k6_mismatch or k6_vs_k1:
            raise AssertionError("expand_rows is not bit-exact")

        gx, gy = -(-W // 32), -(-H // 32)
        si = binning.build_sorted_instances(*bin_args, gx, gy, MAX_INSTANCES, 32,
                                            max_live=MAX_LIVE)
        feat_soa = blend.feat_soa_from_rows(si.feat_rows, 128)
        offsets = si.binning.offsets
        k2 = blend.blend_fwd(feat_soa, offsets, gx, gy)
        k2_again = blend.blend_fwd(feat_soa, offsets, gx, gy)
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
        if not torch.equal(k2.view(torch.int32), k2_again.view(torch.int32)):
            raise AssertionError("blend_fwd: two launches on the same inputs differ")
        log("blend_fwd: a second launch is bit-identical")
        chunks = k2[:, 0, 4].to(torch.float64)
        if not torch.equal(k2[:, :, 4], k2[:, :1, 4].expand(-1, 1024)):
            raise AssertionError("chunks_done is not tile-uniform")

        prep_k7 = preprocess_phase(dev)
        bin_k8 = binning_phase(dev)

        # -- 6. timings ------------------------------------------------------
        view_ms = [cuda_ms(lambda c=c: render(state, *train_lib.camera_arrays(c.params()),
                                              bg, 1.0)) for c in cams]
        log("view ms (median of 10): " + ", ".join(f"{t:.3f}" for t in view_ms))

        def k1_library():
            ck = (torch.searchsorted(seg, slots, right=True) - 1).clamp_(0, table.shape[1] - 1)
            return table.index_select(1, ck)

        k1_ms = cuda_ms(lambda: expand.expand_rows_by_segments(table, 0, MAX_INSTANCES))
        k1_plain_ms = cuda_ms(lambda: expand.expand_rows_by_segments_plain(
            table, 0, MAX_INSTANCES))
        k1_lib_ms = cuda_ms(k1_library)
        # the kernels alone: their launches back to back into an output
        # allocated beforehand (the wrappers' host time is not in it)
        k16 = torch.empty_like(k1)
        k1_kernel_ms = cuda_ms(lambda: expand.EXPAND_SEG(
            table.data_ptr(), table.shape[0], table.shape[1], 0, k16.data_ptr(), MAX_INSTANCES,
            backend.stream_ptr(table)), batch=20)
        k6_kernel_ms = cuda_ms(lambda: expand.EXPAND_ROWS(
            table.data_ptr(), table.shape[0], table.shape[1], ck.data_ptr(), k16.data_ptr(),
            MAX_INSTANCES, backend.stream_ptr(table)), batch=20)
        if not torch.equal(k16.view(torch.int32), k1.view(torch.int32)):
            raise AssertionError("expand_rows launched alone differs from expand_seg's output")
        k6_ms = cuda_ms(lambda: expand.expand_rows(table, ck))
        k6_plain_ms = cuda_ms(lambda: expand.expand_rows_plain(table, ck))
        k6_lib_ms = cuda_ms(lambda: table.index_select(1, ck))
        k2_ms = cuda_ms(lambda: blend.blend_fwd(feat_soa, offsets, gx, gy))
        k2_plain_ms = cuda_ms(lambda: blend.blend_fwd_plain(feat_soa, offsets, gx, gy))
        # the kernel alone (its launch order made beforehand), heaviest
        # tiles first as the wrapper orders them and in tile order
        k2_out = torch.empty_like(k2)
        tile_ids = torch.arange(gx * gy, device=dev)

        def k2_launch(order):
            blend.BLEND_FWD(feat_soa.data_ptr(), feat_soa.shape[1], offsets.data_ptr(),
                            order.data_ptr(), gx * gy, gx, k2_out.data_ptr(),
                            backend.stream_ptr(feat_soa))

        k2_orders = {"kernel_ms": blend.tile_order(offsets[1:] - offsets[:-1]),
                     "tile_order_ms": tile_ids}
        k2_kernel = {}
        for key, order in k2_orders.items():
            k2_kernel[key] = cuda_ms(lambda: k2_launch(order))
            if not torch.equal(k2_out.view(torch.int32), k2.view(torch.int32)):
                raise AssertionError(f"blend_fwd launched in another order ({key}) differs")

    # bounds from the work this run's inputs need. K1: every slot written
    # once, the live columns read once (dead ones past them are never read)
    rows = table.shape[0]
    live_cols = max(1, int(torch.isfinite(table[0]).sum()))
    k1_bytes = 4 * rows * (MAX_INSTANCES + live_cols)
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    # K6: the same, and ck read once (4 bytes a slot)
    k6_bytes = k1_bytes + 4 * MAX_INSTANCES
    k6_bound = k6_bytes / HBM_BYTES_PER_S * 1e3
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
    # the recount, as K3's: an exp and 12 flops per pair past the pre-test
    gate = k2_work["gate_lanes"]
    k2_gate_ms = 1e3 * max(k2_times["bytes"], (gate + 2 * kept + lanes // 1024) / SFU_OPS_PER_S,
                           (12 * gate + 11 * kept) / FP32_FLOPS_PER_S)
    log(f"expand_seg: {live_cols} live columns, {k1_bytes / 1e6:.1f} MB moved, "
        f"bound {k1_bound:.4f} ms (bytes); {k1_ms:.4f} ms, the kernel alone {k1_kernel_ms:.4f} "
        f"ms ({100 * k1_bound / k1_kernel_ms:.1f} % of the bound), plain {k1_plain_ms:.4f} ms, "
        f"searchsorted + index_select {k1_lib_ms:.4f} ms")
    log(f"expand_rows: {k6_bytes / 1e6:.1f} MB moved, bound {k6_bound:.4f} ms (bytes); "
        f"{k6_ms:.4f} ms, the kernel alone {k6_kernel_ms:.4f} ms, plain {k6_plain_ms:.4f} ms, index_select {k6_lib_ms:.4f} ms; "
        f"launches on the main path {launches['expand_rows']} (no path of the package "
        f"calls it, as in the JAX package)")
    log(f"blend_fwd: {int(chunks.sum())} chunks; pairs in range {lanes}, power <= 0 "
        f"{exp_lanes}, past the log-domain pre-test {gate}, kept {kept}; recounted bound "
        f"{k2_gate_ms:.4f} ms; {k2_sfu} transcendentals "
        f"{k2_sfu / SFU_OPS_PER_S * 1e3:.4f} ms, {k2_flops} fp32 flops "
        f"{k2_flops / FP32_FLOPS_PER_S * 1e3:.4f} ms, "
        f"{k2_bytes / 1e6:.1f} MB {k2_times['bytes'] * 1e3:.4f} ms")

    # -- 7-10. eye tracking, foveated frames, their kernels and timings --------
    model, eye, gaze_uv, eye_info = eye_phase()
    fov_kernels, fov = foveated_phase(state, cams[0].params(), bg, model, eye, gaze_uv,
                                      view_ms[0])

    # -- 11. small scene: card (kernels) vs CPU (plain versions) --------------
    small = [torch.from_numpy(a) for a in make_scene(2000, seed=1, spread=1.5,
                                                     scale_range=(-3.5, -2.0))]
    small_cam = view_request(4.0, -2.0, 128, 96)
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

    # -- 12. training -----------------------------------------------------
    train = train_phase(params, cams, images, bg)
    # -- 13. backward kernels vs plain versions, timings ----------------------
    bwd = backward_checks(train["state8"], cams[0], images[0], bg, train["step"])
    # -- 14-15. the CLIs on a synthesized COLMAP scene, then the serving-side
    # entry points on the model they trained and on fps_test's scene ---------
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_phase(tmp)
        entries = entry_phase(tmp, gaze_uv)
        # -- 16. RITnet training and evaluation ----------------------------
        t0 = time.perf_counter()
        rit, rit_run = ritnet_phase(tmp, model, eye)
        rit.update(ritnet_timings(rit_run))
        rit["seconds"] = time.perf_counter() - t0
        # -- 17-19. the parity probe, the trained bench, the viewer ----------
        parity = parity_phase()
        trained = trained_bench_phase(tmp)
        viewer = viewer_phase(tmp)
        # -- 20. multi-GPU training -----------------------------------------
        multi = multi_gpu_phase(tmp, params, state, images, bg)
        # -- 21. the study scripts ------------------------------------------
        studies = studies_phase(tmp)
    # -- 22. the numerics suite ------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        numerics = numerics_phase(tmp)
    band = {"a": multi["a"], "b": multi["b"]["launches"]}

    def band_launches(name):
        """The kernel's launches over phase 20's counted runs, every rank."""
        a = band["a"]
        n = a["render"]["launches"][name] + a["band"]["launches"][name] + \
            a["gauss"]["launches"][name]
        for per_rank in band["b"].values():
            n += per_rank["render"][name] + sum(s[name] for kind in ("band", "gauss")
                                                for s in per_rank[kind])
        return n

    band_grid = multi["b"]["kernels"]["grid"]
    band_errs = {"expand_seg": multi["b"]["kernels"]["k1_values_differ"],
                 "blend_fwd": multi["b"]["kernels"]["k2_max_abs_err"],
                 "blend_bwd": multi["b"]["kernels"]["k3_max_abs_err"],
                 "segsum": multi["b"]["kernels"]["k4_max_abs_err"]}

    src = "gaussian_splatting_with_eye_tracking_tpu_torch/csrc/{}.cu"
    kernels = [
        {"name": "preprocess", "route": "cuda", "source": src.format("preprocess"),
         "replaces": REPLACES["preprocess"], "launches": launches["preprocess"],
         **{k: prep_k7["300k"][k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None, "shapes": prep_k7, **build["preprocess"]},
        {"name": "binning", "route": "cuda", "source": src.format("binning"),
         "replaces": REPLACES["binning"], "launches": launches["binning"],
         **{k: bin_k8["300k"][k] for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None, "shapes": bin_k8,
         **ptxas_report(backend, "binning")},
        {"name": "expand_seg", "route": "cuda", "source": src.format("expand_seg"),
         "replaces": REPLACES["expand_seg"], "launches": launches["expand_seg"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": k1_lib_ms,
         "kernel_ms": k1_kernel_ms},
        {"name": "blend_fwd", "route": "cuda", "source": src.format("blend_fwd"),
         "replaces": REPLACES["blend_fwd"], "launches": launches["blend_fwd"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_times[k2_bound_by] * 1e3, "bound_by": k2_bound_by,
         "library_ms": None, "gate_bound_ms": k2_gate_ms, **k2_kernel, **build["blend_fwd"]},
        {"name": "blend_bwd", "route": "cuda", "source": src.format("blend_bwd"),
         "replaces": REPLACES["blend_bwd"], "launches": train["launches"]["blend_bwd"],
         **bwd["blend_bwd"], **build["blend_bwd"]},
        {"name": "segsum", "route": "cuda", "source": src.format("segsum"),
         "replaces": REPLACES["segsum"], "launches": train["launches"]["segsum"],
         **bwd["segsum"], **build["segsum"]},
        *fov_kernels,
        {"name": "expand_rows", "route": "cuda", "source": src.format("expand_seg"),
         "replaces": REPLACES["expand_rows"], "launches": launches["expand_rows"],
         "max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain_ms,
         "bound_ms": k6_bound, "bound_by": "bytes", "library_ms": k6_lib_ms,
         "kernel_ms": k6_kernel_ms},
    ]
    log(json.dumps({"views_ms": view_ms, "peak_mib": peak_mb, "card": smi}))
    log(json.dumps({"train": {k: train[k] for k in ("losses", "l1", "psnr", "densify",
                                                     "launches", "caps")},
                    "step": bwd["step"], "card": smi}))
    log(json.dumps({"foveated": fov, "eye": eye_info, "card": smi}))
    log(json.dumps({"cli": cli, "card": smi}))
    log(json.dumps({"entry_points": entries, "card": smi}))
    log(json.dumps({"ritnet": rit, "card": smi}))
    log(json.dumps({"parity_probe": parity, "trained_bench_1080p": trained, "viewer": viewer,
                    "card": smi}))
    for k in kernels:
        if k["name"] in band_errs:
            k.update(band_launches=band_launches(k["name"]), band_grid=band_grid,
                     band_max_abs_err=band_errs[k["name"]])
    log(json.dumps({"multi_gpu": {k: v for k, v in multi.items()}, "card": smi}))
    for k in kernels:
        k["studies_launches"] = sum(run[k["name"]] for run in studies["launches"].values())
    log(json.dumps({"studies": studies, "card": smi}))
    for k in kernels:
        k["numerics_launches"] = sum(run[k["name"]] for run in numerics["launches"].values())
    log(json.dumps({"numerics": numerics, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mp-rank"]:  # one rank of phase 20 (b)
        port, rank, world, tmp = sys.argv[2:6]
        sys.exit(mp_worker(port, int(rank), int(world), tmp))
    sys.exit(main())
