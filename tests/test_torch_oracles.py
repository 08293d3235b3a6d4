"""PyTorch port vs JAX package: the ``impl="jnp"`` oracles on the CPU.

``bin_gaussians`` (every field exact, with capacity and ``max_live``
truncation, and against the port's ``build_sorted_instances``),
``render_tiles_jnp`` (colour / final_t within 1e-4, ``n_contrib`` equal on
>= 99.9 % of pixels and within 1 elsewhere; the AMR round's stride-2
subgrids at all four offsets with a counts override), ``render_naive``
(both stops), ``rasterize(impl="jnp")`` (forward and gradients) and
``render_amr(impl="jnp")`` against JAX's, and the oracles against the
port's own kernel path; the blocked 3-NN against JAX's and, on duplicated
points, its documented delta from ``cKDTree``. All on JAX's preprocessed
inputs at 64x64 with 150 gaussians (``max_per_tile`` 256), where the
exact stop bites on a few pixels; each JAX
reference runs once per module, jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import amr as jamr
from gaussian_splatting_with_eye_tracking_tpu.ops import binning as jbin
from gaussian_splatting_with_eye_tracking_tpu.ops import knn as jknn
from gaussian_splatting_with_eye_tracking_tpu.ops import rasterize as jrast
from gaussian_splatting_with_eye_tracking_tpu.ops import reference as jref
from gaussian_splatting_with_eye_tracking_tpu.ops import tile_blend as jtb
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import preprocess
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr as tamr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as tbin
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import knn as tknn
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as trast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import reference as tref
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import tile_blend as ttb
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import Preprocessed
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, cam_to_torch, to_torch

W = H = 64
N = 150
SH = 1
CAP = 1 << 10  # the scene enumerates 397 tile pairs and keeps 359
MPT = 256  # max_per_tile
BG = np.array([0.2, 0.1, 0.3], np.float32)
# (max_instances, max_live): room for all, max_live truncating the sorted
# list, and the enumeration itself overflowing
BIN_CASES = {"fits": (CAP, None), "max_live": (CAP, 250), "max_instances": (300, None)}
# dense enough that the exact stop (T < 1e-4) bites on 4 pixels, where it
# moves the colour by 8.3e-5; with larger gaussians the skipped stopping
# contribution (T up to 1e-2 at alpha 0.99) reaches 1.4e-3, past the 1e-4
# that JAX's tile_blend docstring states
SCENE = dict(spread=0.8, scale_range=(-2.5, -1.5))
GRAD_NAMES = ("means", "scales", "quats", "opacities", "sh")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _loss_jax(color, final_t):
    return jnp.mean(color ** 2) + 0.1 * jnp.mean(final_t)


@pytest.fixture(scope="module")
def ref():
    """JAX's results on the scene, each computed once."""
    cam = make_camera(W, H)
    g = make_random_gaussians(N, seed=3, sh_degree=SH, **SCENE)
    bg = jnp.asarray(BG)
    prep = preprocess(*g, SH, cam)
    out = {"cam": cam, "g": g, "prep": prep}
    out["bin"] = {k: jbin.bin_gaussians(prep, 2, 2, cap, tile_px=32, max_live=live)
                  for k, (cap, live) in BIN_CASES.items()}
    b = out["bin"]["fits"]
    tiles = jax.jit(jtb.render_tiles_jnp, static_argnames=(
        "grid_x", "grid_y", "tile", "max_per_tile", "stride", "offx", "offy",
        "return_n_contrib"))
    targs = (prep.means2d, prep.conics, prep.rgb, prep.opacities, b.gauss_id, b.offsets)
    out["tiles"] = tiles(*targs, grid_x=2, grid_y=2, tile=32, bg=bg, max_per_tile=MPT,
                         return_n_contrib=True)
    counts = jnp.asarray(np.array([5, 0, 40, 1000], np.int32))
    counts = jnp.minimum(counts, b.offsets[1:] - b.offsets[:-1])
    out["round_counts"] = counts
    out["rounds"] = {
        (ox, oy): tiles(*targs, grid_x=2, grid_y=2, tile=32, bg=jnp.zeros(3),
                        max_per_tile=MPT, stride=2, offx=ox, offy=oy, counts=counts)
        for ox, oy in tamr.ROUND_OFFSET.values()}
    out["naive"] = {stop: jref.render_naive(prep, W, H, bg, exact_stop=stop)
                    for stop in (True, False)}

    kw = dict(sh_degree=SH, max_instances=CAP, max_per_tile=MPT, impl="jnp")
    rast = jax.jit(lambda *a: jrast.rasterize(*a, cam, bg, **kw))
    out["rast"] = rast(*g)
    out["grads"] = jax.jit(jax.grad(
        lambda *a: _loss_jax(*jrast.rasterize(*a, cam, bg, **kw)[:2]),
        argnums=(0, 1, 2, 3, 4)))(*g)
    amr_cam = make_camera(128, 96)
    out["amr"] = jax.jit(lambda *a: jamr.render_amr(
        *a, SH, amr_cam, bg, max_instances=CAP * 4, max_per_tile=MPT, impl="jnp"))(*g)
    out["amr_cam"] = amr_cam
    return out


def _tprep(prep):
    return Preprocessed(*(to_torch(x) for x in prep))


def _tscene(ref):
    return [to_torch(x) for x in ref["g"]]


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_bin_gaussians_matches_jax(ref, case):
    cap, live = BIN_CASES[case]
    want = ref["bin"][case]
    got = tbin.bin_gaussians(_tprep(ref["prep"]), 2, 2, cap, tile_px=32, max_live=live)
    for name in want._fields:
        assert_equal(getattr(got, name), getattr(want, name), msg=name)
    assert bool(got.overflow) == (case != "fits")
    assert got.gauss_id.shape == (cap if live is None else live,)


def test_bin_gaussians_matches_build_sorted_instances(ref):
    p = _tprep(ref["prep"])
    got = tbin.bin_gaussians(p, 2, 2, CAP, tile_px=32)
    si = tbin.build_sorted_instances(p.means2d, p.conics, p.rgb, p.opacities, p.tiles_touched,
                                     p.rect_min, p.rect_max, p.cull_thr, p.depths, 2, 2, CAP, 32)
    n = int(got.num_instances)
    assert n > 0
    assert_equal(got.gauss_id[:n], si.binning.gauss_id[:n].numpy())
    for name in ("offsets", "num_instances", "num_enumerated", "overflow", "gauss_start",
                 "gauss_count"):
        assert_equal(getattr(got, name), getattr(si.binning, name).numpy(), msg=name)


def _tiles_args(ref):
    p, b = _tprep(ref["prep"]), ref["bin"]["fits"]
    return (p.means2d, p.conics, p.rgb, p.opacities, to_torch(b.gauss_id), to_torch(b.offsets))


def test_render_tiles_jnp_matches_jax(ref):
    color, final_t, nc = ttb.render_tiles_jnp(*_tiles_args(ref), 2, 2, 32, to_torch(BG),
                                              max_per_tile=MPT, return_n_contrib=True)
    want_c, want_t, want_nc = (np.asarray(x) for x in ref["tiles"])
    assert_close(color, want_c, atol=1e-4)
    assert_close(final_t, want_t, atol=1e-4)
    off = np.abs(nc.numpy().astype(np.int64) - want_nc)
    assert (off == 0).mean() >= 0.999 and off.max() <= 1
    assert want_nc.max() > 1


@pytest.mark.parametrize("offset", list(tamr.ROUND_OFFSET.values()))
def test_render_tiles_jnp_round_matches_jax(ref, offset):
    ox, oy = offset
    color, final_t = ttb.render_tiles_jnp(*_tiles_args(ref), 2, 2, 32, torch.zeros(3),
                                          max_per_tile=MPT, stride=2, offx=ox, offy=oy,
                                          counts=to_torch(ref["round_counts"]))
    want_c, want_t = (np.asarray(x) for x in ref["rounds"][offset])
    assert color.shape == (3, 32, 32) and final_t.shape == (32, 32)
    assert_close(color, want_c, atol=1e-4)
    assert_close(final_t, want_t, atol=1e-4)
    # the tile whose count is overridden to 0 is background only
    assert (final_t[:16, 16:] == 1).all()


@pytest.mark.parametrize("exact_stop", [True, False])
def test_render_naive_matches_jax(ref, exact_stop):
    got = tref.render_naive(_tprep(ref["prep"]), W, H, to_torch(BG), exact_stop=exact_stop)
    want = ref["naive"][exact_stop]
    assert_close(got.color, want.color, atol=1e-5, rtol=1e-4)
    assert_close(got.final_t, want.final_t, atol=1e-5, rtol=1e-4)
    assert_equal(got.n_contrib, want.n_contrib)


def test_render_naive_matches_render_tiles_jnp(ref):
    naive = tref.render_naive(_tprep(ref["prep"]), W, H, to_torch(BG), exact_stop=True)
    relaxed = tref.render_naive(_tprep(ref["prep"]), W, H, to_torch(BG), exact_stop=False)
    assert (naive.n_contrib != relaxed.n_contrib).any()  # the stop bites somewhere
    color, final_t = ttb.render_tiles_jnp(*_tiles_args(ref), 2, 2, 32, to_torch(BG),
                                          max_per_tile=MPT)
    assert float((color - naive.color).abs().max()) <= 1e-4
    assert float((final_t - naive.final_t).abs().max()) <= 1e-4


def _rasterize(scene, cam, impl, **kw):
    return trast.rasterize(*scene, cam, to_torch(BG), sh_degree=SH, max_instances=CAP,
                           max_per_tile=MPT, impl=impl, **kw)


def test_rasterize_jnp_matches_jax(ref):
    out = _rasterize(_tscene(ref), cam_to_torch(ref["cam"]), "jnp")
    want = ref["rast"]
    assert_close(out.color, want.color, atol=1e-4)
    assert_close(out.final_t, want.final_t, atol=1e-4)
    for name in ("radii", "num_instances", "num_enumerated", "overflow"):
        assert_equal(getattr(out, name), getattr(want, name), msg=name)


def test_rasterize_jnp_gradients_match_jax(ref):
    inputs = [x.requires_grad_(True) for x in _tscene(ref)]
    out = _rasterize(inputs, cam_to_torch(ref["cam"]), "jnp")
    loss = torch.mean(out.color ** 2) + 0.1 * torch.mean(out.final_t)
    grads = torch.autograd.grad(loss, inputs)
    for name, got, want in zip(GRAD_NAMES, grads, ref["grads"]):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        assert float(np.abs(got.numpy() - want).max()) <= 1e-3 * scale, name


def test_rasterize_jnp_matches_kernels_path(ref):
    scene, cam = _tscene(ref), cam_to_torch(ref["cam"])
    oracle, kernels = _rasterize(scene, cam, "jnp"), _rasterize(scene, cam, "kernels")
    assert float((oracle.color - kernels.color).abs().max()) <= 1e-3
    assert float((oracle.final_t - kernels.final_t).abs().max()) <= 1e-3
    for name in ("radii", "num_instances", "num_enumerated", "overflow"):
        assert torch.equal(getattr(oracle, name), getattr(kernels, name)), name
    assert torch.equal(_rasterize(scene, cam, "auto").color, kernels.color)
    with pytest.raises(ValueError, match="impl"):
        _rasterize(scene, cam, "pallas")


def test_render_amr_jnp_matches_jax(ref):
    scene = _tscene(ref)
    cam = cam_to_torch(ref["amr_cam"])
    color, state = tamr.render_amr(*scene, SH, cam, to_torch(BG), max_instances=CAP * 4,
                                   max_per_tile=MPT, impl="jnp")
    want_c, want_s = ref["amr"]
    assert_close(color, want_c, atol=1e-4)
    assert_close(state.final_t, want_s.final_t, atol=1e-4)
    for name in ("tile_levels", "tile_levels_last", "offsets", "num_instances", "overflow"):
        assert_equal(getattr(state, name), getattr(want_s, name), msg=name)
    assert sorted(set(state.tile_levels.tolist())) == [1, 2, 3, 4]
    kernels, _ = tamr.render_amr(*scene, SH, cam, to_torch(BG), max_instances=CAP * 4)
    assert float((kernels - color).abs().max()) <= 1e-3


@pytest.mark.parametrize("n,block", [(700, 256), (1024, 1024)])
def test_blocked_3nn_matches_jax(n, block):
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jknn.mean_sq_dist_3nn_jax(jnp.asarray(pts), block=block))
    got = tknn.mean_sq_dist_3nn_blocked(to_torch(pts), block=block)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), tknn.mean_sq_dist_3nn(pts), rtol=1e-5)


def test_blocked_3nn_skips_duplicates_unlike_ckdtree():
    """Each point twice: cKDTree counts the twin at distance 0, the
    blocked oracle (as JAX's) excludes it, so the oracle reads (2 d1 +
    d2) / 3 where cKDTree reads 2 d1 / 3 (d1, d2 the nearest distinct
    points' squared distances, the nearest taken twice)."""
    pts = np.random.default_rng(5).uniform(-1, 1, (300, 3)).astype(np.float32)
    twice = np.concatenate([pts, pts])
    got = tknn.mean_sq_dist_3nn_blocked(to_torch(twice), block=256).numpy()
    want_jax = np.asarray(jknn.mean_sq_dist_3nn_jax(jnp.asarray(twice), block=256))
    tree = tknn.mean_sq_dist_3nn(twice)
    d2 = ((pts[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nearest = np.sort(d2, axis=1)[:, :2]
    np.testing.assert_allclose(got, want_jax, rtol=1e-5)
    np.testing.assert_allclose(got[:300], (2 * nearest[:, 0] + nearest[:, 1]) / 3, rtol=1e-5)
    np.testing.assert_allclose(tree[:300], 2 * nearest[:, 0] / 3, rtol=1e-5)
    assert (got > tree).all()


def test_parity_probe_gates_pass_on_the_cpu(monkeypatch):
    """The card probe's comparisons at a CPU size (the plain versions in
    place of the kernels): every gate met, the counters equal, and its
    entry point needs a card unless told otherwise."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import parity_probe

    res = parity_probe.run("cpu", width=64, height=64, n=150, max_instances=1 << 11,
                           max_per_tile=256, knn_points=600, knn_dup=200)
    assert res["ok"], res["failed"]
    assert all(res["binning_equal"].values()) and res["binning_instances"] > 0
    assert res["fwd_max_abs"] <= 1e-3 and max(g["rel"] for g in res["grads"].values()) < 2e-2
    assert res["knn"]["dup_blocked_over_ckdtree_min"] > 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        parity_probe.main([])
