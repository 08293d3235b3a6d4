"""PyTorch port vs JAX package: the plain version of the backward tile
compositor (kernel K3) against the TPU kernel run in interpret mode
(``_bwd_call(..., interpret=True)``) on the same feature array, offsets,
forward output (JAX's ``_fwd_call``) and cotangent; and the per-gaussian
reduction after it against ``_segment_reduce_grads``.

The TPU kernel writes each tile's gradients into a private chunk-aligned
region (``grad_region_offsets``); the port writes them at the sorted
positions, so the JAX output is mapped through the regions before the
comparison. Tolerance atol 2e-3 / rtol 5e-3 (tests/test_pallas_blend.py's
gradient tolerance), and per row 3e-4 of the row's largest value plus
1e-3 of each value. Measured: at most 1.4e-4 of the row's largest value
(the conic rows of the multi-chunk scene, where the TPU kernel forms the
sums from tile-local moment matmuls), elsewhere below 6e-5."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import binning as jbin
from gaussian_splatting_with_eye_tracking_tpu.ops import pallas_blend as jpb
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import preprocess
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as tbin
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend as tblend
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, to_torch


@functools.lru_cache
def _scene(chunk):
    """A real scene's instance list: several chunks per tile, ranges not
    chunk-aligned. Returns the feature array, offsets and the JAX
    preprocess output (made once per chunk size)."""
    cam = make_camera(64, 64)
    means, scales, quats, op, sh = make_random_gaussians(500, seed=1)
    prep = preprocess(means, scales, quats, op, sh, 0, cam)
    si = jbin.build_sorted_instances(
        prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
        prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, 2, 2,
        max_instances=1 << 12, tile_px=32, interpret=True)
    return np.asarray(jpb._feat_soa_from_rows(si.feat_rows, chunk)), \
        np.asarray(si.binning.offsets), prep, si


def _mid_chunk():
    """Hand-built ranges that start and end inside 64-wide chunks, share
    chunks with their neighbours, and include an empty tile."""
    k = 200
    rng = np.random.default_rng(3)
    feat = np.zeros((16, 256), np.float32)
    feat[0:2, :k] = rng.uniform(-8, 72, (2, k))
    conic = rng.uniform(0.01, 0.2, (2, k))
    feat[2, :k], feat[4, :k] = conic
    feat[3, :k] = rng.uniform(-0.5, 0.5, k) * np.sqrt(conic[0] * conic[1])
    feat[5:8, :k] = rng.uniform(size=(3, k))
    feat[8, :k] = rng.uniform(0.1, 0.99, k)
    feat[9, :k] = np.arange(k)
    return feat, np.array([3, 70, 70, 133, 197], np.int32)


def _saturated():
    """An opaque wall: the tile saturates and exits after 2 of 10 chunks."""
    n = 600
    rng = np.random.default_rng(2)
    feat = np.zeros((16, 640), np.float32)
    feat[0:2, :n] = rng.uniform(0, 32, (2, n))
    feat[2, :n], feat[4, :n] = 0.01, 0.01
    feat[5:8, :n] = rng.uniform(size=(3, n))
    feat[8, :n] = 0.95
    feat[9, :n] = np.arange(n)
    return feat, np.array([0, n], np.int32)


CASES = {
    "multi_chunk_32": lambda: (*_scene(32)[:2], 2, 2, 32),
    "mid_chunk_64": lambda: (*_mid_chunk(), 2, 2, 64),
    "saturated_64": lambda: (*_saturated(), 1, 1, 64),
}


def _jax_bwd_sorted(feat, offsets, fwd, cot, gx, gy, chunk):
    """JAX ``_bwd_call`` in interpret mode, each tile's private region
    mapped back to the sorted positions of its range (checking the
    gaussian-id tags the kernel writes beside the gradients)."""
    off = jnp.asarray(offsets, jnp.int32)
    gaoff = jpb.grad_region_offsets(off, chunk)
    d = np.asarray(jpb._bwd_call(jnp.asarray(feat), off, off[1:] - off[:-1], gaoff,
                                 jnp.asarray(cot), jnp.asarray(fwd), gx, gy, 32, chunk,
                                 True))
    out = np.zeros((tblend.NGRAD, feat.shape[1]), np.float32)
    gaoff = np.asarray(gaoff)
    for t in range(gx * gy):
        ids = np.arange(offsets[t], offsets[t + 1])
        cols = gaoff[t] + ids - offsets[t] // chunk * chunk
        out[:, ids] = d[:tblend.NGRAD, cols]
        np.testing.assert_array_equal(d[tblend.GID_ROW, cols], feat[tblend.GID_ROW, ids])
    return out, d, gaoff


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One case through both packages; the JAX reference runs once."""
    feat, offsets, gx, gy, chunk = CASES[request.param]()
    off = jnp.asarray(offsets, jnp.int32)
    fwd = np.asarray(jpb._fwd_call(jnp.asarray(feat), off, off[1:] - off[:-1], gx, gy,
                                   32, chunk, True))
    cot = np.zeros_like(fwd)
    cot[..., 0:4] = np.random.default_rng(len(request.param)).normal(size=fwd.shape[:2] + (4,))
    want, raw, gaoff = _jax_bwd_sorted(feat, offsets, fwd, cot, gx, gy, chunk)
    got = tblend.blend_bwd_plain(to_torch(feat), to_torch(offsets), to_torch(fwd),
                                 to_torch(cot), gx, gy, 32, chunk)
    return dict(name=request.param, feat=feat, offsets=offsets, fwd=fwd, cot=cot,
                grid=(gx, gy), chunk=chunk, want=want, raw=raw, gaoff=gaoff, got=got)


def test_blend_bwd_plain_matches_jax(case):
    got, want = case["got"], case["want"]
    assert got.shape == want.shape
    assert_close(got, want, atol=2e-3, rtol=5e-3)
    rowmax = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got.numpy() - want) <= 3e-4 * rowmax + 1e-3 * np.abs(want)).all()
    n_live = case["offsets"][-1]
    assert not got[:, n_live:].any()
    assert (rowmax[:, 0] > 0).all()


def test_blend_bwd_plain_chunk_semantics(case):
    """Zero exactly on chunks at or past chunks_done; the hand-built
    ranges run the global 64-aligned chunks."""
    got, fwd, chunk = case["got"], case["fwd"], case["chunk"]
    if case["name"] == "saturated_64":
        done = int(fwd[0, 0, 4])
        assert 0 < done < 10
        assert not got[:, done * chunk:].any()
        assert got[:, :8].any(axis=0).all()  # the wall's front layers
    elif case["name"] == "mid_chunk_64":
        np.testing.assert_array_equal(fwd[:, 0, 4], [2, 0, 2, 2])
        assert got[:, 3:197].any() and not got[:, :3].any() and not got[:, 197:].any()
    else:
        assert fwd[:, 0, 4].min() > 3  # several chunks per tile


def test_segment_reduce_grads_matches_jax():
    """Per-gaussian sums: the port's permutation into id order + segment
    sum against JAX's id sort + prefix differences, on the same per-
    instance gradients."""
    feat, offsets, prep, si = _scene(32)
    off = jnp.asarray(offsets, jnp.int32)
    fwd = np.asarray(jpb._fwd_call(jnp.asarray(feat), off, off[1:] - off[:-1], 2, 2, 32,
                                   32, True))
    cot = np.zeros_like(fwd)
    cot[..., 0:4] = np.random.default_rng(9).normal(size=fwd.shape[:2] + (4,))
    sorted_grads, raw, gaoff = _jax_bwd_sorted(feat, offsets, fwd, cot, 2, 2, 32)
    b = si.binning
    want = np.asarray(jpb._segment_reduce_grads(jnp.asarray(raw), jnp.asarray(gaoff), off,
                                                b.gauss_start, b.gauss_count))
    tsi = tbin.build_sorted_instances(
        *(to_torch(x) for x in (prep.means2d, prep.conics, prep.rgb, prep.opacities,
                                prep.tiles_touched, prep.rect_min, prep.rect_max,
                                prep.cull_thr, prep.depths)),
        2, 2, 1 << 12, tile_px=32)
    n_live = int(offsets[-1])
    np.testing.assert_array_equal(tsi.binning.gauss_id[:n_live].numpy(),
                                  np.asarray(b.gauss_id)[:n_live])
    got = tblend.segment_reduce_grads(
        to_torch(sorted_grads), tsi.id_pos, tsi.binning.gauss_start,
        tsi.binning.gauss_count, 1 << 12)
    assert got.shape == (tblend.NGRAD, want.shape[0])
    assert_close(got.T, want, atol=1e-5, rtol=1e-5)
    # id_pos is a permutation of [0, n_live) on the live instances
    pos = np.sort(tsi.id_pos[:n_live].numpy())
    np.testing.assert_array_equal(pos, np.arange(n_live))
    assert (tsi.id_pos[n_live:] == 1 << 12).all()


def test_blend_bwd_wrapper_on_cpu_is_plain():
    feat, offsets = _saturated()
    f, o = to_torch(feat)[:, :640], to_torch(offsets)
    fwd = tblend.blend_fwd(f, o, 1, 1)
    cot = torch.ones_like(fwd)
    before = tblend.BLEND_BWD.launches
    np.testing.assert_array_equal(tblend.blend_bwd(f, o, fwd, cot, 1, 1).numpy(),
                                  tblend.blend_bwd_plain(f, o, fwd, cot, 1, 1).numpy())
    assert tblend.BLEND_BWD.launches == before


def test_segment_reduce_grads_with_dropped_instances():
    """``max_live`` below the kept instances drops the sorted tail: each
    gaussian still sums exactly its own rendered instances (a direct sum
    over gauss_id), empty segments give 0, and JAX's
    ``_segment_reduce_grads`` on the same gradients agrees on every
    gaussian below the first one that lost an instance (past it, JAX's
    bounds assume the dropped instances are the id-order tail)."""
    _, _, prep, _ = _scene(32)
    args = [to_torch(x) for x in (prep.means2d, prep.conics, prep.rgb, prep.opacities,
                                  prep.tiles_touched, prep.rect_min, prep.rect_max,
                                  prep.cull_thr, prep.depths)]
    args[4][::7] = 0  # every seventh gaussian culled: empty segments
    kept = int(tbin.build_sorted_instances(*args, 2, 2, 1 << 12, tile_px=32)
               .binning.offsets[-1])
    si = tbin.build_sorted_instances(*args, 2, 2, 1 << 12, tile_px=32, max_live=kept - 150)
    b = si.binning
    n_live = int(b.offsets[-1])
    assert n_live == kept - 150 and bool(b.overflow)
    rng = np.random.default_rng(4)
    grads = np.zeros((tblend.NGRAD, -(-n_live // 128) * 128 + 128), np.float32)
    grads[:, :n_live] = rng.normal(size=(tblend.NGRAD, n_live))
    got = tblend.segment_reduce_grads(to_torch(grads), si.id_pos, b.gauss_start,
                                      b.gauss_count, 1 << 12).numpy()
    gid = b.gauss_id[:n_live].numpy().astype(np.int64)
    n = b.gauss_start.shape[0]
    want = np.zeros((tblend.NGRAD, n))
    np.add.at(want.T, gid, grads[:, :n_live].T.astype(np.float64))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    empty = b.gauss_count.numpy() == 0
    assert empty.any() and not got[:, empty].any()
    # JAX's reduction on the same sorted gradients, tagged with their ids
    raw = np.zeros((16, grads.shape[1]), np.float32)
    raw[:tblend.NGRAD] = grads
    raw[tblend.GID_ROW, :n_live] = gid
    jax_sums = np.asarray(jpb._segment_reduce_grads(
        jnp.asarray(raw), jnp.asarray([n_live], jnp.int32),
        jnp.asarray(b.offsets.numpy()), jnp.asarray(b.gauss_start.numpy()),
        jnp.asarray(b.gauss_count.numpy()))).T
    lost = np.bincount(gid, minlength=n) < b.gauss_count.numpy()
    first = int(np.argmax(lost))
    assert lost.any() and first > 0
    np.testing.assert_allclose(got[:, :first], jax_sums[:, :first], atol=1e-5, rtol=1e-5)
    assert not np.allclose(got, jax_sums, atol=1e-5, rtol=1e-5)
