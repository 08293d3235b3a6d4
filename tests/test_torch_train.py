"""The training slice, PyTorch port (CPU, plain kernel versions) vs JAX
package (``impl="pallas"``, kernels in interpret mode): rasterize
gradients, the losses, the learning-rate schedule, one and two train
steps from the same state, density control, opacity reset, capacity
growth and point-cloud initialization.

Tolerances: rasterize gradients atol 1e-4 / rtol 5e-3
(tests/test_pallas_blend.py's end-to-end gradient test; measured below
1e-6 relative); losses 1e-6; the train step's image atol 3e-4 / rtol
1e-3, its loss rtol 1e-5, the Adam moments (0.1·g and 0.001·g² after one
step) at the gradient tolerance. Adam's first steps are sign steps (with
eps 1e-15, lr·m̂/(√v̂+eps) ≈ ±lr whatever |g| is), so a gradient at
rounding level can move a parameter by 2·lr: parameters are compared only
where every step's |g| exceeds 1e-6 of its field's largest, to 1 % of
one learning-rate step (measured 0.7 %, on a row whose two gradients
nearly cancel in the second step's moment). Density
control is compared exactly on the mask, the counts and the Adam rows,
and to the last ulp of exp/log on the parameters."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gaussian_splatting_with_eye_tracking_tpu import train_lib as jtrain
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu.ops import knn as jknn
from gaussian_splatting_with_eye_tracking_tpu.ops import rasterize as jrast
from gaussian_splatting_with_eye_tracking_tpu.ops import ssim as jssim
from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib as ttrain
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import knn as tknn
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as trast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as tssim
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, cam_to_torch, to_torch

BG = np.array([0.15, 0.25, 0.35], np.float32)
FIELDS = tgm.GaussianParams._fields


@pytest.mark.parametrize("deg", [0, 3])
def test_rasterize_grads_match_jax(deg):
    w = h = 64
    n = 150
    cam = make_camera(w, h)
    g = make_random_gaussians(n, seed=5, sh_degree=deg)
    kw = dict(sh_degree=deg, max_instances=1 << 12)
    target = np.random.default_rng(deg).uniform(size=(3, h, w)).astype(np.float32)

    def jloss(means, scales, quats, op, sh, bg, off):
        out = jrast.rasterize(means, scales, quats, op, sh, cam, bg, impl="pallas",
                              means2d_offset=off, **kw)
        return jnp.mean((out.color - target) ** 2) + 0.1 * jnp.mean(out.final_t)

    want = jax.grad(jloss, argnums=tuple(range(7)))(*g, jnp.asarray(BG), jnp.zeros((n, 2)))
    inputs = [to_torch(x).requires_grad_(True) for x in (*g, BG, np.zeros((n, 2), np.float32))]
    out = trast.rasterize(*inputs[:5], cam_to_torch(cam), inputs[5],
                          means2d_offset=inputs[6], **kw)
    loss = ((out.color - to_torch(target)) ** 2).mean() + 0.1 * out.final_t.mean()
    got = torch.autograd.grad(loss, inputs)
    names = ("means", "scales", "quats", "opacities", "sh", "bg", "means2d_offset")
    for name, a, b in zip(names, got, want):
        assert np.abs(np.asarray(b)).max() > 0, name
        assert_close(a, b, atol=1e-4, rtol=5e-3, msg=name)


def _images(seed, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("batched", [False, True])
def test_losses_match_jax(batched):
    a, b = _images(1, (2, 3, 40, 56) if batched else (3, 40, 56))
    ta, tb, ja, jb = to_torch(a), to_torch(b), jnp.asarray(a), jnp.asarray(b)
    for fn in ("l1_loss", "l2_loss", "psnr", "ssim"):
        assert_close(getattr(tssim, fn)(ta, tb), getattr(jssim, fn)(ja, jb), atol=1e-6,
                     rtol=1e-6, msg=fn)
    assert_close(tssim.dssim_l1_loss(ta, tb, 0.3), jssim.dssim_l1_loss(ja, jb, 0.3),
                 atol=1e-6, rtol=1e-6)
    # per pixel the variance cancellation leaves a few ulp (measured 2.4e-6)
    a4, b4 = (a, b) if batched else (a[None], b[None])
    assert_close(tssim.ssim_map(to_torch(a4), to_torch(b4)),
                 jssim.ssim_map(jnp.asarray(a4), jnp.asarray(b4)), atol=1e-5)


def test_ssim_blur_runs_without_tf32(monkeypatch):
    """cuDNN's TF32 is off whenever the SSIM blur convolves."""
    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    a, b = _images(2)
    assert torch.isfinite(tssim.ssim(to_torch(a), to_torch(b)))
    assert len(seen) == 10 and set(seen) == {(False, False)}


@pytest.mark.parametrize("delay_steps", [0, 500])
def test_expon_lr_schedule_matches_jax(delay_steps):
    args = (1.6e-4 * 2.5, 1.6e-6 * 2.5, 0.01, 30_000)
    want = jgm.expon_lr_schedule(*args, lr_delay_steps=delay_steps)
    got = tgm.expon_lr_schedule(*args, lr_delay_steps=delay_steps)
    for step in (-1, 0, 1, 7, 250, 499, 500, 501, 15_000, 29_999, 30_000, 40_000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=0), step
    assert tgm.expon_lr_schedule(0.0, 0.0, 0.01, 100)(10) == 0.0
    assert float(jgm.expon_lr_schedule(0.0, 0.0, 0.01, 100)(10)) == 0.0


# --- train steps ----------------------------------------------------------

N, CAP, W, H = 150, 256, 64, 64


def _jax_state():
    """150 random SH-3 gaussians in 256 slots (inert padding), active
    degree 2, a fresh optimizer."""
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


@pytest.fixture(scope="module")
def steps():
    """Two train steps (stats accumulated) from one state in both
    packages; the JAX reference runs once."""
    js0, tx = _jax_state()
    cam = make_camera(W, H)
    gt = np.random.default_rng(1).uniform(size=(3, H, W)).astype(np.float32)
    jstep = jtrain.make_train_step(tx, JOpt(), 3, W, H, impl="pallas", max_instances=1 << 12)
    jstates, jaux = [js0], []
    for _ in range(2):
        s, a = jstep(jstates[-1], *jtrain.camera_arrays(cam), jnp.asarray(gt),
                     jnp.asarray(BG), True)
        jstates.append(s)
        jaux.append(a)
    opt = OptimizationConfig()
    tstep = ttrain.make_train_step(tgm.make_optimizer(opt, 1.0), opt, 3, W, H,
                                   max_instances=1 << 12, device="cpu")
    tcam = cam_to_torch(cam)
    tstates, taux = [tgm.state_from_jax(js0, device="cpu")], []
    for _ in range(2):
        s, a = tstep(tstates[-1], *ttrain.camera_arrays(tcam), to_torch(gt), to_torch(BG), True)
        tstates.append(s)
        taux.append(a)
    return dict(jstates=jstates, jaux=jaux, tstates=tstates, taux=taux)


def test_state_from_jax_carries_everything(steps):
    js, ts = steps["jstates"][1], tgm.state_from_jax(steps["jstates"][1], device="cpu")
    assert ts.sh_degree == 2 and ts.opt_state.count == 1
    assert_equal(ts.active, js.active)
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert_equal(getattr(ts, name), getattr(js, name))
    for name in FIELDS:
        adam = js.opt_state.inner_states[name].inner_state[0]
        assert_equal(getattr(ts.params, name), getattr(js.params, name))
        assert_equal(getattr(ts.opt_state.mu, name), getattr(adam.mu, name))
        assert_equal(getattr(ts.opt_state.nu, name), getattr(adam.nu, name))


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_matches_jax(steps, k):
    ta, ja = steps["taux"][k - 1], steps["jaux"][k - 1]
    ts, js = steps["tstates"][k], tgm.state_from_jax(steps["jstates"][k], device="cpu")
    for name in ("loss", "l1", "psnr"):
        assert_close(getattr(ta, name), getattr(ja, name), atol=0, rtol=1e-5, msg=name)
    for name in ("num_instances", "num_enumerated", "overflow"):
        assert_equal(getattr(ta, name), getattr(ja, name), msg=name)
    assert int(ta.num_instances) > 0 and not bool(ta.overflow)
    assert_close(ta.image, ja.image, atol=3e-4, rtol=1e-3)
    assert ts.opt_state.count == k
    assert_equal(ts.denom, js.denom)
    assert_equal(ts.max_radii2d, js.max_radii2d)
    assert_close(ts.xyz_grad_accum, js.xyz_grad_accum,
                 atol=1e-4 * float(js.xyz_grad_accum.abs().max()), rtol=5e-3)
    jsteps = [tgm.state_from_jax(s, device="cpu") for s in steps["jstates"][:k + 1]]
    for name in FIELDS:
        mu, nu = getattr(ts.opt_state.mu, name), getattr(ts.opt_state.nu, name)
        jmu, jnu = getattr(js.opt_state.mu, name), getattr(js.opt_state.nu, name)
        assert_close(mu, jmu, atol=1e-4 * float(jmu.abs().max()), rtol=5e-3, msg=name)
        assert_close(nu, jnu, atol=1e-4 * float(jnu.abs().max()), rtol=1e-2, msg=name)
        # every step's gradient, from JAX's moments: g_t = (mu_t - 0.9 mu_{t-1}) / 0.1
        mus = [getattr(s.opt_state.mu, name) for s in jsteps]
        grads = [(mus[i + 1] - 0.9 * mus[i]) / 0.1 for i in range(k)]
        sure = torch.stack([g.abs() > 1e-6 * g.abs().max() for g in grads]).all(dim=0)
        assert sure.any(), name
        # within 1 % of one step of that group's learning rate (a step of
        # near-cancelling gradients amplifies their rounding)
        p, jp = getattr(ts.params, name), getattr(js.params, name)
        lr = tgm.make_optimizer(OptimizationConfig(), 1.0).lr(name, 0)
        assert_close(p[sure], jp[sure], atol=0.01 * lr, rtol=1e-5, msg=name)
        # inactive rows get no gradient and do not move
        assert_equal(p[CAP - 1], getattr(jsteps[0].params, name)[CAP - 1])


@pytest.mark.parametrize("quantile", [0.5, 0.15])
def test_densify_and_prune_matches_jax(steps, quantile):
    """Clone, split and prune from the state after two steps; the 0.15
    quantile leaves candidates without a free slot (overflow)."""
    js = steps["jstates"][2]
    grads = np.asarray(js.xyz_grad_accum / jnp.maximum(js.denom, 1.0))[:N]
    max_scale = np.exp(np.asarray(js.params.scaling)[:N]).max(axis=1)
    kw = dict(grad_threshold=float(np.quantile(grads, quantile)), min_opacity=0.3,
              extent=float(np.median(max_scale)) / 0.01, max_screen_size=20.0,
              percent_dense=0.01)
    key = jax.random.PRNGKey(7)
    want, winfo = jax.jit(lambda s, k: jgm.densify_and_prune(s, k, **kw))(js, key)
    k1, k2 = jax.random.split(key)  # as densify_and_prune draws them
    normals = np.stack([np.asarray(jax.random.normal(k1, (CAP, 3))),
                        np.asarray(jax.random.normal(k2, (CAP, 3)))])
    got, info = tgm.densify_and_prune(tgm.state_from_jax(js, device="cpu"),
                                      to_torch(normals), **kw)
    for name in ("cloned", "split", "pruned", "active", "overflow"):
        assert int(info[name]) == int(winfo[name]), name
    assert int(info["cloned"]) > 0 and int(info["split"]) > 0 and int(info["pruned"]) > 0
    assert (int(info["overflow"]) > 0) == (quantile < 0.5)
    w = tgm.state_from_jax(want, device="cpu")
    assert_equal(got.active, w.active)
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(got, name).any()
    for name in FIELDS:
        assert_close(getattr(got.params, name), getattr(w.params, name), atol=1e-7,
                     rtol=1e-6, msg=name)
        for moment in ("mu", "nu"):
            assert_equal(getattr(getattr(got.opt_state, moment), name),
                         getattr(getattr(w.opt_state, moment), name), msg=name)


def test_reset_opacity_matches_jax(steps):
    js = steps["jstates"][2]
    want = tgm.state_from_jax(jgm.reset_opacity(js), device="cpu")
    got = tgm.reset_opacity(tgm.state_from_jax(js, device="cpu"))
    assert_equal(got.params.opacity, want.params.opacity)
    for name in FIELDS:
        assert_equal(getattr(got.opt_state.mu, name), getattr(want.opt_state.mu, name))
        assert_equal(getattr(got.opt_state.nu, name), getattr(want.opt_state.nu, name))
    assert not got.opt_state.mu.opacity.any() and got.opt_state.mu.xyz.any()


def test_grow_capacity_pads_by_name(steps):
    """Params, mask and accumulators as JAX pads them; every Adam moment
    padded by field name (JAX pads any optimizer leaf whose leading
    dimension equals the capacity, which the port does not copy)."""
    js = steps["jstates"][2]
    ts = tgm.state_from_jax(js, device="cpu")
    assert tgm.grow_capacity(ts, CAP) is ts
    got = tgm.grow_capacity(ts, 4 * CAP)
    want = tgm.state_from_jax(jgm.grow_capacity(js, 4 * CAP), device="cpu")
    assert_equal(got.active, want.active)
    for name in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert_equal(getattr(got, name), getattr(want, name))
    assert got.opt_state.count == ts.opt_state.count and got.sh_degree == ts.sh_degree
    for name in FIELDS:
        assert_equal(getattr(got.params, name), getattr(want.params, name))
        for moment in ("mu", "nu"):
            m = getattr(getattr(got.opt_state, moment), name)
            assert m.shape[0] == 4 * CAP and not m[CAP:].any()
            assert_equal(m[:CAP], getattr(getattr(ts.opt_state, moment), name))


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    assert_close(to_torch(tknn.mean_sq_dist_3nn(pts)), jknn.mean_sq_dist_3nn(pts),
                 atol=0, rtol=1e-5)
    opt = OptimizationConfig()
    want, _ = jgm.create_from_points(pts, cols, 3, JOpt(), 2.0)
    got, tx = tgm.create_from_points(pts, cols, 3, opt, 2.0, device="cpu")
    w = tgm.state_from_jax(want, device="cpu")
    assert got.params.xyz.shape[0] == w.params.xyz.shape[0] == 4096  # next_pow2(8n)
    assert_equal(got.active, w.active)
    assert got.sh_degree == 0 and int(tgm.num_active(got)) == 300
    for name in FIELDS:
        assert_close(getattr(got.params, name), getattr(w.params, name), atol=0,
                     rtol=1e-5, msg=name)
        assert not getattr(got.opt_state.mu, name).any()
    assert tx.lr("xyz", 0) == pytest.approx(opt.position_lr_init * 2.0)
    assert tx.lr("f_rest", 0) == opt.feature_lr / 20
    assert tgm.oneup_sh_degree(tgm.oneup_sh_degree(got, 1), 1).sh_degree == 1
    small, _ = tgm.create_from_points(pts[:5], cols[:5], 0, opt, 1.0, capacity=3, device="cpu")
    assert small.params.xyz.shape[0] == 8  # never below next_pow2(n)


def test_densify_step_and_capacity_growth(steps):
    """densify_step draws its normals from the generator it is given, and
    the capacity grows to cover every candidate first."""
    opt = OptimizationConfig(densify_grad_threshold=0.0)  # every active gaussian
    ts = steps["tstates"][2]
    grown = ttrain.grow_for_densify(ts, opt)
    assert grown.params.xyz.shape[0] == tgm.next_pow2(2 * N) == 512
    outs = [ttrain.densify_step(grown, torch.Generator().manual_seed(3), opt, 5.0, 0.0)
            for _ in range(2)]
    (a, ia), (b, ib) = outs
    assert int(ia["overflow"]) == 0 and int(ia["cloned"]) + int(ia["split"]) == N
    assert_equal(a.params.xyz, b.params.xyz.numpy())
    assert math.isclose(float(a.active.sum()), float(ia["active"]))
