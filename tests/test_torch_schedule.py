"""A short training schedule in both packages: train steps, a densify
step, more steps, an opacity reset, more steps, the port (CPU, plain
kernel versions) and the JAX package (``impl="pallas"``, kernels in
interpret mode) each on its own trajectory from one state.

The scene is tests/test_torch_train.py's (150 random SH-3 gaussians, one
64x64 camera), in a fixed capacity of 512 slots, which holds every
clone and split child (the packages grow capacity by different policies
on purpose). The port's split draws are JAX's normals, as
``densify_and_prune(normals=...)`` takes them. Each density-control
threshold sits in the middle of the widest gap of JAX's values near the
quantile it aims at, so rounding between the packages cannot move a
gaussian across it: the active mask, the densify counts and every
step's instance counts are compared exactly. Losses rtol 1e-5 (measured
4.7e-7); after the last step the Adam moments within 1e-4 of each
field's largest value (tests/test_torch_train.py's gradient tolerance;
measured 3.3e-5) and the parameters within 5 % of one learning-rate step
of their group (measured 1.4 %)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu import train_lib as jtrain
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib as ttrain
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, cam_to_torch, to_torch

N, CAP, W, H = 150, 512, 64, 64
BG = np.array([0.15, 0.25, 0.35], np.float32)
STAGE_STEPS = 3  # train steps before the densify, between it and the reset, after
FIELDS = tgm.GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Keep the port's CPU plain paths to two threads beside the suite's
    other workers (as tests/test_torch_cli.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_state():
    """tests/test_torch_train.py's 150 gaussians (active degree 2) in CAP
    slots of inert padding, with a fresh optimizer."""
    means, scales, quats, op, sh = (np.asarray(x) for x in make_random_gaussians(
        N, seed=11, sh_degree=3))
    raw = dict(xyz=means, f_dc=sh[:, :, :1], f_rest=sh[:, :, 1:], scaling=np.log(scales),
               rotation=quats, opacity=np.log(op / (1 - op))[:, None])
    fills = dict(scaling=-10.0, opacity=float(np.log(0.1 / 0.9)))
    padded = {}
    for k, v in raw.items():
        out = np.full((CAP,) + v.shape[1:], fills.get(k, 0.0), np.float32)
        out[:N] = v
        padded[k] = out
    padded["rotation"][N:, 0] = 1.0
    params = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in padded.items()})
    tx = jgm.make_optimizer(JOpt(), 1.0)
    z = jnp.zeros(CAP)
    return jgm.GaussianModelState(
        params=params, active=jnp.arange(CAP) < N, max_radii2d=z, xyz_grad_accum=z,
        denom=z, opt_state=tx.init(params), sh_degree=jnp.int32(2)), tx


def _gap_threshold(values, quantile):
    """A threshold in the middle of the widest gap between consecutive
    sorted ``values`` among the 20 around ``quantile``."""
    v = np.sort(np.asarray(values, np.float64))
    i = int(quantile * (len(v) - 1))
    lo, hi = max(i - 10, 0), min(i + 10, len(v) - 1)
    j = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
    return float(0.5 * (v[j] + v[j + 1]))


@pytest.fixture(scope="module")
def schedule():
    """Both packages through the schedule; the JAX reference runs once."""
    js, tx = _jax_state()
    cam = make_camera(W, H)
    gt = np.random.default_rng(1).uniform(size=(3, H, W)).astype(np.float32)
    jstep = jtrain.make_train_step(tx, JOpt(), 3, W, H, impl="pallas", max_instances=1 << 12)
    opt = OptimizationConfig()
    tstep = ttrain.make_train_step(tgm.make_optimizer(opt, 1.0), opt, 3, W, H,
                                   max_instances=1 << 12, device="cpu")
    jargs = (*jtrain.camera_arrays(cam), jnp.asarray(gt), jnp.asarray(BG), True)
    targs = (*ttrain.camera_arrays(cam_to_torch(cam)), to_torch(gt), to_torch(BG), True)
    ts = tgm.state_from_jax(js, device="cpu")
    jaux, taux = [], []

    def train(js, ts):
        for _ in range(STAGE_STEPS):
            js, a = jstep(js, *jargs)
            jaux.append(a)
            ts, a = tstep(ts, *targs)
            taux.append(a)
        return js, ts

    js, ts = train(js, ts)
    # thresholds from JAX's state, each clear of its neighbours
    act = np.asarray(js.active)
    grads = np.asarray(js.xyz_grad_accum / jnp.maximum(js.denom, 1.0))[act]
    max_scale = np.exp(np.asarray(js.params.scaling)[act]).max(axis=1)
    opacity = 1.0 / (1.0 + np.exp(-np.asarray(js.params.opacity)[act, 0]))
    kw = dict(grad_threshold=_gap_threshold(grads, 0.5),
              min_opacity=_gap_threshold(opacity, 0.1),
              extent=_gap_threshold(max_scale, 0.5) / 0.01, max_screen_size=20.0,
              percent_dense=0.01)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)  # as densify_and_prune draws them
    normals = np.stack([np.asarray(jax.random.normal(k1, (CAP, 3))),
                        np.asarray(jax.random.normal(k2, (CAP, 3)))])
    js, jinfo = jax.jit(lambda s, k: jgm.densify_and_prune(s, k, **kw))(js, key)
    ts, tinfo = tgm.densify_and_prune(ts, to_torch(normals), **kw)
    dens = dict(jactive=np.asarray(js.active), tactive=ts.active.clone())
    js, ts = train(js, ts)
    js, ts = jgm.reset_opacity(js), tgm.reset_opacity(ts)
    reset = dict(jactive=np.asarray(js.active), tactive=ts.active.clone())
    js, ts = train(js, ts)
    return dict(jstate=js, tstate=ts, jaux=jaux, taux=taux, jinfo=jinfo, tinfo=tinfo,
                densified=dens, reset=reset)


def test_schedule_masks_and_counts_match_jax(schedule):
    s = schedule
    for name in ("cloned", "split", "pruned", "active", "overflow"):
        assert int(s["tinfo"][name]) == int(s["jinfo"][name]), name
    info = {k: int(v) for k, v in s["tinfo"].items()}
    assert info["cloned"] > 0 and info["split"] > 0 and info["pruned"] > 0, info
    assert info["overflow"] == 0, info
    for stage in ("densified", "reset"):
        assert_equal(s[stage]["tactive"], s[stage]["jactive"], msg=stage)
    assert_equal(s["tstate"].active, s["jstate"].active)
    assert len(s["taux"]) == 3 * STAGE_STEPS
    for i, (ta, ja) in enumerate(zip(s["taux"], s["jaux"])):
        for name in ("num_instances", "num_enumerated", "overflow"):
            assert_equal(getattr(ta, name), getattr(ja, name), msg=f"step {i} {name}")
        assert not bool(ta.overflow)
        for name in ("loss", "l1", "psnr"):
            assert_close(getattr(ta, name), getattr(ja, name), atol=0, rtol=1e-5,
                         msg=f"step {i} {name}")
    w = tgm.state_from_jax(s["jstate"], device="cpu")
    assert_equal(s["tstate"].denom, w.denom)
    assert s["tstate"].opt_state.count == 3 * STAGE_STEPS


def test_schedule_params_and_moments_match_jax(schedule):
    ts = schedule["tstate"]
    w = tgm.state_from_jax(schedule["jstate"], device="cpu")
    tx = tgm.make_optimizer(OptimizationConfig(), 1.0)
    act = w.active
    for name in FIELDS:
        for moment in ("mu", "nu"):
            got = getattr(getattr(ts.opt_state, moment), name)
            want = getattr(getattr(w.opt_state, moment), name)
            assert want[act].abs().max() > 0, (name, moment)
            assert_close(got, want, atol=1e-4 * float(want.abs().max()), msg=f"{name} {moment}")
        assert_close(getattr(ts.params, name), getattr(w.params, name),
                     atol=0.05 * tx.lr(name, 0), msg=name)
