"""PyTorch port vs JAX package: the foveated (AMR) serving path. Levels,
gaze rings, binning-time decimation masks and counters exactly; the plain
versions of the round and levels compositors (kernels ``blend_round`` and
``blend_levels``) against the TPU kernels in interpret mode
(``blend_round_pallas`` / ``blend_levels_fused_pallas``) and the 5-step and
fused frames against JAX's ``impl="pallas"`` frames: rgb/final_T and
colour atol 3e-4 / rtol 1e-3 (fp32 sums in another order, as in
tests/test_torch_blend.py), chunks run exact. Each JAX reference runs once
per module, at 128x96 with 500 gaussians, or at 64x64 with 3,000 (the
dense case, where tiles run several chunks and decimation bites)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import amr as jamr
from gaussian_splatting_with_eye_tracking_tpu.ops import binning as jbin
from gaussian_splatting_with_eye_tracking_tpu.ops import pallas_blend as jpb
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr as tamr
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as tbin
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend as tblend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import (
    preprocess as tpreprocess,
)
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, cam_to_torch, to_torch

BG = np.array([0.1, 0.2, 0.3], np.float32)
CAP = 1 << 10  # the scene enumerates 857 tile pairs
GAZE = np.array([30.0, 40.0], np.float32)
RADII = np.array([20.0, 40.0, 70.0], np.float32)
DEC = (4, 2, 1, 1)
STATE_EXACT = ("tile_levels", "tile_levels_last", "offsets", "num_instances", "overflow")


def _jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def scene():
    cam = make_camera(128, 96)
    g = make_random_gaussians(500, seed=7)
    return g, cam, [to_torch(x) for x in g], cam_to_torch(cam)


def _jit_record(fn, *args, record=None):
    """``fn(*args)`` under ``jax.jit`` (one compile for the frame, not one
    per operation), and the calls it makes to ``pallas_blend.<record>``:
    [(arguments by name, output)]."""
    calls = []

    def traced(*a):
        with pytest.MonkeyPatch.context() as mp:
            if record:
                orig = getattr(jpb, record)

                def rec(*r_args, **r_kwargs):
                    bound = inspect.signature(orig).bind(*r_args, **r_kwargs)
                    bound.apply_defaults()
                    out = orig(*r_args, **r_kwargs)
                    calls.append(dict(bound.arguments, _out=out))
                    return out

                mp.setattr(jpb, record, rec)
            result = fn(*a)
        # the traced arrays leave jit as outputs
        return result, [{k: v for k, v in c.items() if hasattr(v, "shape")} for c in calls]

    result, arrays = jax.jit(traced)(*args)
    recorded = []
    for c, arr in zip(calls, arrays):
        arguments = {**c, **arr}
        recorded.append((arguments, arguments.pop("_out")))
    return result, recorded


@pytest.fixture(scope="module")
def jax_frames(scene):
    """JAX's frames, each computed once: the 5-step frame with percentile
    and with gaze levels, the fused frame on each of their step-0 states,
    with decimation, and with binning-time decimation. The compositor
    calls of the gaze frames are kept with their inputs ("rounds": the
    5-step frame's four ``blend_round_pallas`` calls; "levels": the gaze
    fused frames' ``blend_levels_fused_pallas`` calls)."""
    g, cam, _, _ = scene
    bg = jnp.asarray(BG)
    gaze = _jnp(dict(gaze_xy=GAZE, gaze_radii=RADII))
    kw = dict(max_instances=CAP, interpret=True)
    out = {}
    out["five_pct"], _ = _jit_record(
        lambda *a: jamr.render_amr(*a, 0, cam, bg, impl="pallas", **kw), *g)
    out["five_gaze"], out["rounds"] = _jit_record(
        lambda *a: jamr.render_amr(*a, 0, cam, bg, impl="pallas", **kw, **gaze), *g,
        record="blend_round_pallas")
    out["fused_pct"], _ = _jit_record(
        lambda st: jamr.render_amr_fused(*g, 0, cam, bg, state=st, **kw), out["five_pct"][1])
    out["levels"] = []
    for name, extra in (("fused_gaze", {}), ("fused_dec", dict(decimation=DEC))):
        out[name], rec = _jit_record(
            lambda st, extra=extra: jamr.render_amr_fused(*g, 0, cam, bg, state=st, **kw,
                                                          **gaze, **extra),
            out["five_gaze"][1], record="blend_levels_fused_pallas")
        out["levels"] += rec
    out["fused_pre"], rec = _jit_record(
        lambda *a: jamr.render_amr_fused(*a, 0, cam, bg, decimation=DEC, predecimate=True,
                                         **kw, **gaze), *g, record="blend_levels_fused_pallas")
    out["levels"] += rec
    assert len(out["rounds"]) == 4 and len(out["levels"]) == 3
    return out


def _check_frame(got, want):
    (gc, gs), (wc, ws) = got, want
    assert_close(gc, wc, atol=3e-4, rtol=1e-3)
    for name in STATE_EXACT:
        assert_equal(getattr(gs, name), getattr(ws, name), msg=name)
    n = int(ws.num_instances)
    assert_equal(gs.gauss_id[:n], np.asarray(ws.gauss_id)[:n])


# --- levels and gaze rings ------------------------------------------------


@pytest.mark.parametrize("n,seed", [(12, 0), (400, 1), (2040, 2)])
def test_assign_levels_matches_jax(n, seed):
    counts = np.random.default_rng(seed).integers(0, 60, n).astype(np.int32)  # many ties
    want = jamr.assign_levels(jnp.asarray(counts))
    got = tamr.assign_levels(to_torch(counts))
    assert_equal(got, want)
    assert got.dtype == torch.int32 and set(got.tolist()) <= {1, 2, 3, 4}


@pytest.mark.parametrize("case", ["rings", "knife_edge", "decreasing_radii"])
def test_gaze_levels_matches_jax(case):
    gx, gy = 8, 6
    levels = np.random.default_rng(3).integers(1, 5, gx * gy).astype(np.int32)
    gaze, radii = {
        "rings": ([100.0, 70.0], [40.0, 80.0, 120.0]),
        # tile centres at exactly 32 and 64 px from the gaze: d2 == r2
        "knife_edge": ([16.0, 16.0], [32.0, 64.0, 96.0]),
        # track_render.py's [W/2, W/4, W/8] for a 256 px wide view
        "decreasing_radii": ([128.0, 96.0], [128.0, 64.0, 32.0]),
    }[case]
    gaze, radii = np.float32(gaze), np.float32(radii)
    want = np.asarray(jamr.gaze_levels(jnp.asarray(levels), gx, gy, 32, jnp.asarray(gaze),
                                       jnp.asarray(radii)))
    got = tamr.gaze_levels(to_torch(levels), gx, gy, to_torch(gaze), to_torch(radii))
    assert_equal(got, want)
    if case == "decreasing_radii":  # rings 3 and 2 are empty there
        assert set(want.tolist()) <= {1, 4} and 1 in want and 4 in want
    if case == "knife_edge":
        assert want[1] == 4 and want[2] < 4  # (48, 16) on the ring, (80, 16) past it


@pytest.mark.parametrize("case", ["rings", "knife_edge", "decreasing_radii"])
def test_gaze_decimation_keep_matches_jax(case):
    rng = np.random.default_rng(4)
    tx = rng.integers(0, 8, 5000).astype(np.int32)
    ty = rng.integers(0, 6, 5000).astype(np.int32)
    gid = rng.integers(0, 3000, 5000).astype(np.int32)
    gaze, radii = {"rings": ([100.0, 70.0], [40.0, 80.0, 120.0]),
                   "knife_edge": ([16.0, 16.0], [32.0, 64.0, 96.0]),
                   "decreasing_radii": ([128.0, 96.0], [128.0, 64.0, 32.0])}[case]
    gaze, radii = np.float32(gaze), np.float32(radii)
    want = np.asarray(jbin.gaze_decimation_keep(
        jnp.asarray(tx), jnp.asarray(ty), jnp.asarray(gid), jnp.asarray(gaze),
        jnp.asarray(radii), DEC, 32))
    got = tbin.gaze_decimation_keep(to_torch(tx).long(), to_torch(ty).long(),
                                    to_torch(gid).long(), to_torch(gaze), to_torch(radii),
                                    DEC, 32)
    assert_equal(got, want)
    assert 0 < want.mean() < 1


def test_build_sorted_instances_gaze_decim_matches_jax(scene, jax_frames):
    """The port's binning with ``gaze_decim`` against the instance list of
    JAX's predecimated frame (its step 0 bins with the same gaze_decim)."""
    _, _, tg, tc = scene
    prep = tpreprocess(*tg, 0, tc)
    args = (prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, 4, 3, CAP)
    got = tbin.build_sorted_instances(*args, tile_px=32, gaze_decim=(
        to_torch(GAZE), to_torch(RADII), DEC)).binning
    full = tbin.build_sorted_instances(*args, tile_px=32).binning
    want = jax_frames["fused_pre"][1]
    n = int(want.num_instances)
    assert 0 < n < int(full.num_instances)
    for name in ("offsets", "num_instances", "overflow"):
        assert_equal(getattr(got, name), getattr(want, name), msg=name)
    assert_equal(got.gauss_id[:n], np.asarray(want.gauss_id)[:n])
    assert torch.equal(got.num_enumerated, full.num_enumerated)


# --- the compositors --------------------------------------------------------


@pytest.fixture(scope="module")
def dense():
    """3,000 instances over four 32x32 tiles (2x2), in a (16, K') feature
    array as binning lays it out: ranges not chunk-aligned, every tile
    running several 64-wide chunks."""
    rng = np.random.default_rng(4)
    offsets = np.array([5, 760, 1500, 2260, 3005], np.int32)
    k = 3008
    feat = np.zeros((16, k), np.float32)
    tile = np.repeat(np.arange(4), np.diff(offsets))
    live = slice(offsets[0], offsets[-1])
    feat[0, live] = (tile % 2) * 32 + rng.uniform(-6, 38, tile.size)
    feat[1, live] = (tile // 2) * 32 + rng.uniform(-6, 38, tile.size)
    sx, sy = rng.uniform(1.5, 6.0, (2, tile.size))
    th = rng.uniform(0, np.pi, tile.size)
    c, s_ = np.cos(th), np.sin(th)
    cov = np.stack([np.stack([c * c * sx**2 + s_ * s_ * sy**2, c * s_ * (sx**2 - sy**2)]),
                    np.stack([c * s_ * (sx**2 - sy**2), s_ * s_ * sx**2 + c * c * sy**2])])
    inv = np.linalg.inv(cov.transpose(2, 0, 1))
    feat[2, live], feat[3, live], feat[4, live] = inv[:, 0, 0], inv[:, 0, 1], inv[:, 1, 1]
    feat[5:8, live] = rng.uniform(size=(3, tile.size))
    feat[8, live] = rng.uniform(0.05, 0.5, tile.size)
    feat[9, live] = rng.integers(0, 1000, tile.size)
    return feat, offsets


def _check_rows(got, want, rows_valid=None):
    want = np.asarray(want)
    assert got.shape == want.shape
    if rows_valid is not None:
        got, want = got[rows_valid], want[rows_valid]
    assert_close(got[..., 0:4], want[..., 0:4], atol=3e-4, rtol=1e-3)
    assert_equal(got[..., 4], want[..., 4])


def test_blend_round_plain_matches_jax(jax_frames):
    """Chunk 128: the four round calls of JAX's gaze 5-step frame, gated
    by level as each step gates them."""
    for a, want in jax_frames["rounds"]:
        counts = np.asarray(a["counts_override"])
        got = tblend.blend_round_plain(to_torch(a["feat_soa"]), to_torch(a["offsets"]),
                                       a["grid_x"], a["grid_y"], offx=a["offx"], offy=a["offy"],
                                       counts_override=to_torch(counts), chunk=a["chunk"])
        _check_rows(got, want)
        assert (got[:, 0, 4] == 0).sum() == (counts == 0).sum()
    assert {(a["offx"], a["offy"]) for a, _ in jax_frames["rounds"]} == set(
        jamr.ROUND_OFFSET.values())


def test_blend_round_plain_matches_jax_chunk64(dense):
    feat, offsets = dense
    counts = np.diff(offsets).astype(np.int32)
    counts[0], counts[2] = 0, counts[2] // 2
    for rnd, (ox, oy) in jamr.ROUND_OFFSET.items():
        want = jpb.blend_round_pallas(jnp.asarray(feat), jnp.asarray(offsets), 2, 2, 32,
                                      stride=2, offx=ox, offy=oy, chunk=64, interpret=True,
                                      counts_override=jnp.asarray(counts))
        got = tblend.blend_round_plain(to_torch(feat), to_torch(offsets), 2, 2, offx=ox,
                                       offy=oy, counts_override=to_torch(counts), chunk=64)
        _check_rows(got, want)
        assert got[0, 0, 4] == 0 and got[1:, 0, 4].min() > 1


def _check_levels(feat, offsets, counts, levels, grid, kw, want):
    work = {}
    got = tblend.blend_levels_plain(to_torch(feat), to_torch(offsets), to_torch(counts),
                                    to_torch(levels), *grid, decimation=kw["decimation"],
                                    scale_only=kw["scale_only"], chunk=kw["chunk"], work=work)
    below = torch.from_numpy((np.arange(1024)[None, :] // 256) < levels[:, None])
    _check_rows(got, want, below)
    assert not got[~below].any()
    assert (work["rescaled"] > 0) == (tuple(kw["decimation"]) != (1, 1, 1, 1))
    return got


@pytest.mark.parametrize("call", [0, 1, 2])
def test_blend_levels_plain_matches_jax(jax_frames, call):
    """Chunk 128: the levels calls of JAX's gaze fused frames, decimation
    (1,1,1,1), (4,2,1,1), and (4,2,1,1) with scale_only."""
    a, want = jax_frames["levels"][call]
    assert (tuple(a["decimation"]), a["scale_only"]) == [
        ((1, 1, 1, 1), False), (DEC, False), (DEC, True)][call]
    _check_levels(*(np.asarray(a[k]) for k in ("feat_soa", "offsets", "counts", "levels")),
                  (a["grid_x"], a["grid_y"]), a, want)


def test_blend_levels_plain_matches_jax_dense(dense):
    """Chunk 64, decimation (4,2,1,1) on the dense tiles at levels 1..4,
    so every step runs on multi-chunk streams: chunk strides and the
    tail's rep. (scale_only's factor is the same for every chunk; the
    chunk-128 case holds it.)"""
    feat, offsets = dense
    counts = np.diff(offsets).astype(np.int32)
    levels = np.array([1, 2, 3, 4], np.int32)
    kw = dict(decimation=DEC, scale_only=False, chunk=64)
    want = jpb.blend_levels_fused_pallas(
        jnp.asarray(feat), jnp.asarray(offsets), jnp.asarray(counts), jnp.asarray(levels),
        2, 2, 32, interpret=True, **kw)
    got = _check_levels(feat, offsets, counts, levels, (2, 2), kw, want)
    n_chunks = -(-(offsets[1] - offsets[0] // 64 * 64) // 64)
    assert n_chunks > 8 and int(got[1, 0, 4]) > 1
    assert 0 < int(got[0, 0, 4]) <= -(-n_chunks // 4)  # the level-1 tile: every 4th chunk


def test_blend_levels_and_rounds_on_cpu_are_plain(dense):
    """The wrappers on CPU tensors, and blend_rounds_fused as blend_levels
    with every level n_rounds."""
    feat, offsets = dense
    f, o = tblend.feat_soa_from_rows(to_torch(feat)[:10], 128), to_torch(offsets)
    counts = o[1:] - o[:-1]
    levels = torch.tensor([4, 3, 2, 1], dtype=torch.int32)
    got = tblend.blend_levels(f, o, counts, levels, 2, 2, decimation=DEC)
    assert torch.equal(got, tblend.blend_levels_plain(f, o, counts.int(), levels, 2, 2,
                                                      decimation=DEC))
    fused = tblend.blend_rounds_fused(f, o, counts, 2, 2, 2)
    two = tblend.blend_levels_plain(f, o, counts.int(), torch.full((4,), 2, dtype=torch.int32),
                                    2, 2)
    assert fused.shape == (4, 512, 8) and torch.equal(fused, two[:, :512])
    rnd = tblend.blend_round(f, o, 2, 2, offx=1, offy=1)
    assert torch.equal(rnd, two[:, 256:512])  # round 2 alone and round 2 of a level-2 pass


# --- the frames ---------------------------------------------------------------


@pytest.mark.parametrize("gaze", [False, True])
def test_render_amr_matches_jax(scene, jax_frames, gaze):
    _, _, tg, tc = scene
    kw = dict(gaze_xy=to_torch(GAZE), gaze_radii=to_torch(RADII)) if gaze else {}
    got = tamr.render_amr(*tg, 0, tc, to_torch(BG), max_instances=CAP, **kw)
    _check_frame(got, jax_frames["five_gaze" if gaze else "five_pct"])
    assert_equal(got[1].tile_levels_last, got[1].tile_levels)


@pytest.mark.parametrize("config", ["fused_pct", "fused_gaze", "fused_dec", "fused_pre"])
def test_render_amr_fused_matches_jax(scene, jax_frames, config):
    _, _, tg, tc = scene
    kw = {} if config == "fused_pct" else dict(gaze_xy=GAZE, gaze_radii=RADII)
    kw.update({"fused_dec": dict(decimation=DEC),
               "fused_pre": dict(decimation=DEC, predecimate=True)}.get(config, {}))
    got = tamr.render_amr_fused(*tg, 0, tc, to_torch(BG), max_instances=CAP, **kw)
    _check_frame(got, jax_frames[config])
    if config == "fused_pre":
        assert int(got[1].num_instances) < int(jax_frames["fused_gaze"][1].num_instances)


@pytest.mark.parametrize("gaze", [False, True])
def test_fused_frame_equals_five_step_frame(scene, gaze):
    _, _, tg, tc = scene
    kw = dict(gaze_xy=GAZE, gaze_radii=RADII, max_instances=CAP) if gaze else dict(
        max_instances=CAP)
    five, st5 = tamr.render_amr(*tg, 0, tc, to_torch(BG), **kw)
    fused, stf = tamr.render_amr_fused(*tg, 0, tc, to_torch(BG), **kw)
    assert torch.allclose(fused, five, atol=2e-5, rtol=1e-5)
    assert torch.equal(stf.tile_levels, st5.tile_levels)
    assert set(st5.tile_levels.tolist()) >= {1, 4}


def test_interpolation_copy_semantics(scene):
    """In a level-1 tile all four pixels of each 2x2 cell equal its (0,0)
    pixel; in a level-3 tile the round-4 pixel (0,1) copies (1,1)."""
    _, _, tg, tc = scene
    color, st = tamr.render_amr(*tg, 0, tc, to_torch(BG), max_instances=CAP)
    lv = st.tile_levels.numpy()
    c = color.numpy()
    checked = 0
    for t in np.nonzero(np.isin(lv, (1, 3)))[0]:
        ty, tx = divmod(int(t), 4)
        b = c[:, ty * 32:(ty + 1) * 32, tx * 32:(tx + 1) * 32]
        if lv[t] == 1:
            for sub in (b[:, 1::2, 0::2], b[:, 0::2, 1::2], b[:, 1::2, 1::2]):
                np.testing.assert_array_equal(sub, b[:, 0::2, 0::2])
        else:
            np.testing.assert_array_equal(b[:, 1::2, 0::2], b[:, 1::2, 1::2])
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("gaze", [False, True])
def test_five_step_frame_sorts_its_launch_order_once(scene, gaze, monkeypatch):
    """The 5-step frame's four rounds launch in one order, made by the
    first round (``blend.round_order`` of the frame's counts and levels)
    and carried in the state; each round passes its split."""
    _, _, tg, tc = scene
    kw = dict(gaze_xy=to_torch(GAZE), gaze_radii=to_torch(RADII)) if gaze else {}
    calls, sorts = [], []
    blend_round, round_order = tblend.blend_round, tblend.round_order

    def spy_round(*a, **k):
        calls.append((k["order"], k["split"]))
        return blend_round(*a, **k)

    def spy_order(*a):
        sorts.append(a)
        return round_order(*a)

    monkeypatch.setattr(tblend, "blend_round", spy_round)
    monkeypatch.setattr(tblend, "round_order", spy_order)
    _, st = tamr.render_amr(*tg, 0, tc, to_torch(BG), max_instances=CAP, **kw)
    assert len(sorts) == 1 and len(calls) == 4
    counts = st.offsets[1:] - st.offsets[:-1]
    assert_equal(st.round_order, round_order(counts, st.tile_levels).numpy())
    assert all(order is st.round_order for order, _ in calls)
    assert [split for _, split in calls] == list(tamr.ROUND_SPLIT)
