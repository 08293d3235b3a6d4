"""PyTorch port vs JAX package: every ``Preprocessed`` field on the same
inputs, including the extreme inputs of tests/test_math_ops.py (behind the
camera, FOV-clamped, degenerate scale, low opacity). Floats to atol 1e-5 /
rtol 1e-4; the integer fields (radii, tiles_touched, rect_min, rect_max)
exactly. The gradient (torch autograd through the port's forward) against
JAX's hand-derived VJP on the same inputs and cotangents, finite and to
the tolerance JAX holds its hand VJP to against autodiff (atol 2e-5 of the
largest value, rtol 1e-4). On CPU tensors ``preprocess`` is its plain
version, with or without a gradient, and counts no kernel rows; the
kernel's wrapper refuses them and launches nothing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import projection as jproj
from gaussian_splatting_with_eye_tracking_tpu_torch import backend, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection as tproj
from tests.helpers import make_camera, make_orbit_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, cam_to_torch, to_torch

INT_FIELDS = ("radii", "tiles_touched", "rect_min", "rect_max")


def _scene(n, seed, sh_degree, extreme):
    means, scales, quats, op, sh = make_random_gaussians(n, seed=seed, sh_degree=sh_degree)
    if extreme:
        means = means.at[:n // 8, 2].set(-6.0)  # behind the near plane
        means = means.at[n // 8:n // 4, 0].add(40.0)  # FOV clamp region
        scales = scales.at[n // 4:n // 3].set(5e-7)  # degenerate det
        op = op.at[n // 3:n // 2].set(0.002)  # ln(255 op) = 0 extents
    return means, scales, quats, op, sh


def _compare(got, want):
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        if name in INT_FIELDS:
            assert g.dtype.is_floating_point is False, name
            assert_equal(g, w, msg=name)
        else:
            assert_close(g, w, atol=1e-5, rtol=1e-4, msg=name)


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("extreme", [False, True])
def test_preprocess_matches_jax(sh_degree, extreme):
    means, scales, quats, op, sh = _scene(400, 0, sh_degree, extreme)
    cam = make_camera(96, 80)
    mask = np.arange(400) < 400 - 7  # some padded slots
    want = jproj.preprocess(means, scales, quats, op, sh, sh_degree, cam,
                            active_mask=jnp.asarray(mask))
    got = tproj.preprocess(
        *(to_torch(x) for x in (means, scales, quats, op, sh)), sh_degree,
        cam_to_torch(cam), active_mask=to_torch(mask))
    _compare(got, want)
    if extreme:
        assert (got.radii[:50] == 0).all()  # behind the camera: culled


def test_preprocess_orbit_camera_scale_modifier():
    means, scales, quats, op, sh = make_random_gaussians(600, seed=4, sh_degree=2)
    cam = make_orbit_camera(0.7, elevation=0.4, width=80, height=64)
    want = jproj.preprocess(means, scales, quats, op, sh, 2, cam, scale_modifier=0.7)
    got = tproj.preprocess(*(to_torch(x) for x in (means, scales, quats, op, sh)), 2,
                           cam_to_torch(cam), scale_modifier=0.7)
    _compare(got, want)


def test_rect_truncates_toward_zero():
    """Centers left of / above the image: the int casts truncate toward
    zero (not floor), so rect_min is 0 where floor would give -1."""
    means, scales, quats, op, sh = make_random_gaussians(64, seed=9)
    means = means.at[:, 0].set(jnp.linspace(-2.9, -2.6, 64))
    cam = make_camera(64, 64)
    want = jproj.preprocess(means, scales, quats, op, sh, 0, cam)
    got = tproj.preprocess(*(to_torch(x) for x in (means, scales, quats, op, sh)), 0,
                           cam_to_torch(cam))
    _compare(got, want)
    assert (got.means2d[:, 0] < 0).any()


@pytest.mark.parametrize("sh_degree", [0, 3])
@pytest.mark.parametrize("extreme", [False, True])
def test_preprocess_vjp_matches_jax(sh_degree, extreme):
    g = _scene(400, 0, sh_degree, extreme)
    cam = make_camera(96, 80)
    mask = np.arange(400) < 400 - 7
    rng = np.random.default_rng(42)
    fields = ("means2d", "depths", "conics", "rgb", "opacities")
    want_prep = jproj.preprocess(*g, sh_degree, cam, active_mask=jnp.asarray(mask))
    cots = [rng.standard_normal(getattr(want_prep, f).shape).astype(np.float32)
            for f in fields]

    def jloss(*x):
        prep = jproj.preprocess(*x, sh_degree, cam, active_mask=jnp.asarray(mask))
        return sum(jnp.vdot(getattr(prep, f), c) for f, c in zip(fields, cots))

    want = jax.grad(jloss, argnums=tuple(range(5)))(*g)
    inputs = [to_torch(x).requires_grad_(True) for x in g]
    prep = tproj.preprocess(*inputs, sh_degree, cam_to_torch(cam), active_mask=to_torch(mask))
    loss = sum((getattr(prep, f) * to_torch(c)).sum() for f, c in zip(fields, cots))
    got = torch.autograd.grad(loss, inputs)
    for name, a, b in zip(("means3d", "scales", "quats", "opacities", "sh"), got, want):
        b = np.asarray(b)
        assert torch.isfinite(a).all(), name
        assert_close(a, b, atol=2e-5 * np.abs(b).max(), rtol=1e-4, msg=name)



def _cpu_inputs():
    """300 gaussians with the extreme rows, as CPU tensors; a 96x80 camera;
    the last 10 slots inactive."""
    g = [to_torch(x) for x in _scene(300, 1, 3, extreme=True)]
    return g, cam_to_torch(make_camera(96, 80)), torch.arange(300) < 290


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_preprocess_is_the_plain_version(monkeypatch, grad):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(tproj, "preprocess_kernel", refuse)
    g, cam, mask = _cpu_inputs()
    if grad:
        g[0].requires_grad_(True)
    got = tproj.preprocess(*g, 3, cam, active_mask=mask)
    want = tproj.preprocess_plain(*g, 3, cam, active_mask=mask)
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.means2d.requires_grad == grad


def test_cpu_preprocess_counts_no_kernel_rows():
    g, cam, mask = _cpu_inputs()
    tracing._records.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            tproj.preprocess(*g, 3, cam, active_mask=mask)
    counts = [(c.name, c.value) for c in tracing.counters()]
    tracing._records.clear()
    assert counts == [("gs.preprocess.rows", 300), ("gs.preprocess.active", 290)]


def test_tracing_lists_the_kernel_counter():
    assert "``gs.preprocess.kernel``" in tracing.__doc__
    assert "gs.preprocess.kernel" in tproj.preprocess.__doc__


def test_preprocess_kernel_refuses_cpu_tensors():
    g, cam, mask = _cpu_inputs()
    before = tproj.PREPROCESS.launches
    with pytest.raises(ValueError, match="CUDA"):
        tproj.preprocess_kernel(*g, 3, cam, active_mask=mask)
    with pytest.raises(ValueError, match="sh_degree 4"):
        tproj.preprocess_kernel(*g, 4, cam)
    assert tproj.PREPROCESS.launches == before


def test_preprocess_kernel_builds_without_fma_contraction():
    """K7's source and K8's (whose cull decides which pairs exist) alone
    are compiled with -fmad=false (their integers follow the plain
    versions' per-op rounding); the other sources keep the flags, and so
    their libraries' names."""
    for stem in ("preprocess", "binning"):
        assert backend._flags(backend.CSRC / f"{stem}.cu") == \
            backend.NVCC_FLAGS + ["-fmad=false"]
    for src in backend.CSRC.glob("*.cu"):
        if src.stem not in ("preprocess", "binning"):
            assert backend._flags(src) == backend.NVCC_FLAGS, src.name
