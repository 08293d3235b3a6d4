"""PyTorch port vs JAX package: the run-length expand (plain version of
kernel K1) and the index expand (plain version of kernel K6, against JAX's
``expand_rows`` in interpret mode) bit-exact on every slot, and the fused
instance-list construction on the
same preprocessed inputs (integer outputs exact, kept instances'
``gauss_id`` and feature rows bit-exact; dead slots may tie in another
order, so only ``[:num_instances]`` is compared there)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatting_with_eye_tracking_tpu.ops import binning as jbin
from gaussian_splatting_with_eye_tracking_tpu.ops import expand as jexp
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import preprocess
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning as tbin
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import expand as texp
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_equal, to_torch

CAP = 1 << 13


def _seg_table(nc, seed, dead_frac):
    """(16, nc) compact table: live columns first with exact-int segment
    starts in row 0, +inf on the dead tail; other rows random."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, nc)
    n_live = int(nc * (1.0 - dead_frac))
    table = rng.normal(size=(16, nc)).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts[:n_live])[:-1]]).astype(np.float32)
    table[0, :n_live] = starts
    table[0, n_live:] = np.inf
    total = int(counts[:n_live].sum()) if n_live else 0
    return table, total


@pytest.mark.parametrize("dead_frac", [0.0, 0.3, 1.0])
def test_expand_plain_matches_jax(dead_frac):
    table, total = _seg_table(300, 1, dead_frac)
    k = total + 37  # slots past the enumeration resolve to the last live column
    want = np.asarray(jexp.expand_rows_by_segments(
        jnp.asarray(table), seg_row=0, k=k, interpret=True))
    got = texp.expand_rows_by_segments_plain(to_torch(table), 0, k)
    assert_equal(got, want)
    assert_equal(texp.expand_rows_by_segments(to_torch(table), 0, k), want)
    if dead_frac == 1.0:  # every column dead: all slots copy column 0
        assert np.isinf(got[0].numpy()).all()


@pytest.mark.parametrize("pattern", ["runs", "clamped"])
def test_expand_rows_plain_matches_jax(pattern):
    """A nondecreasing ck (each column repeated 1-5 times); "clamped"
    starts below 0 and ends past the last column."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(16, 300)).astype(np.float32)
    table[3, 7] = np.inf
    ck = np.repeat(np.arange(300), rng.integers(1, 6, 300)).astype(np.int32)
    if pattern == "clamped":
        ck = np.concatenate([[-5, -1], ck, [300, 412]]).astype(np.int32)
    want = np.asarray(jexp.expand_rows(jnp.asarray(table), jnp.asarray(ck), interpret=True))
    got = texp.expand_rows_plain(to_torch(table), to_torch(ck))
    assert got.shape == (16, ck.shape[0])
    assert_equal(got, want)
    assert_equal(texp.expand_rows(to_torch(table), to_torch(ck)), want)


def _prep(n, seed):
    cam = make_camera(64, 64)
    means, scales, quats, op, sh = make_random_gaussians(n, seed=seed)
    prep = preprocess(means, scales, quats, op, sh, 0, cam)
    args = (prep.means2d, prep.conics, prep.rgb, prep.opacities,
            prep.tiles_touched, prep.rect_min, prep.rect_max, prep.cull_thr,
            prep.depths)
    return args, 2, 2


def _build_both(n, seed, max_live=None):
    args, gx, gy = _prep(n, seed)
    want = jbin.build_sorted_instances(
        *args, gx, gy, max_instances=CAP, tile_px=32, max_live=max_live,
        interpret=True)
    got = tbin.build_sorted_instances(
        *(to_torch(a) for a in args), gx, gy, max_instances=CAP, tile_px=32,
        max_live=max_live)
    return got, want


def test_build_sorted_instances_matches_jax():
    got, want = _build_both(700, 11)
    g, w = got.binning, want.binning
    for name in ("offsets", "tile_id", "gauss_start", "gauss_count",
                 "num_instances", "num_enumerated", "overflow"):
        assert_equal(getattr(g, name), getattr(w, name), msg=name)
    n_live = int(w.num_instances)
    assert 0 < n_live < CAP and not bool(w.overflow)
    assert_equal(g.gauss_id[:n_live], w.gauss_id[:n_live])
    assert_equal(got.feat_rows[:, :n_live], np.asarray(want.feat_rows)[:, :n_live])
    assert g.gauss_id.dtype == g.offsets.dtype == g.tile_id.dtype


def test_truncation_max_live():
    full, _ = _build_both(700, 12)
    cap = int(full.binning.num_instances) // 2
    got, want = _build_both(700, 12, max_live=cap)
    assert bool(got.binning.overflow) and bool(want.binning.overflow)
    assert got.feat_rows.shape == (10, cap)
    assert_equal(got.binning.offsets, want.binning.offsets)
    assert_equal(got.binning.tile_id, want.binning.tile_id)
    assert_equal(got.binning.gauss_id[:cap], want.binning.gauss_id[:cap])


def test_enumeration_overflow():
    """max_instances below the rect enumeration: the enumeration is cut at
    capacity and both packages report overflow and the same lists."""
    args, gx, gy = _prep(700, 13)
    total = int(np.asarray(args[4]).sum())
    cap = total // 2
    want = jbin.build_sorted_instances(*args, gx, gy, max_instances=cap,
                                       tile_px=32, interpret=True)
    got = tbin.build_sorted_instances(*(to_torch(a) for a in args), gx, gy,
                                      max_instances=cap, tile_px=32)
    for name in ("offsets", "tile_id", "gauss_start", "gauss_count",
                 "num_instances", "num_enumerated", "overflow"):
        assert_equal(getattr(got.binning, name), getattr(want.binning, name), msg=name)
    assert bool(got.binning.overflow)


def test_cpu_tensors_take_the_plain_route(monkeypatch):
    """On CPU tensors ``build_sorted_instances`` is the plain version,
    field for field, K8's wrapper never called; ``feat_soa`` is the
    compositors' padding of ``feat_rows`` after ``lane_offset``'s lanes."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend as tblend

    def refuse(*args, **kwargs):
        raise AssertionError("K8's wrapper was called on the CPU")

    monkeypatch.setattr(tbin, "build_sorted_instances_kernel", refuse)
    args, gx, gy = _prep(700, 14)
    args = [to_torch(a) for a in args]
    got = tbin.build_sorted_instances(*args, gx, gy, CAP, 32, lane_offset=lambda n: 37)
    want = tbin.build_sorted_instances_plain(*args, gx, gy, CAP, 32)
    for name in want.binning._fields:
        assert_equal(getattr(got.binning, name), getattr(want.binning, name), msg=name)
    assert_equal(got.id_pos, want.id_pos)
    assert got.lead == 37 and want.lead == 0
    assert_equal(got.feat_soa, tblend.feat_soa_from_rows(want.feat_rows, tblend.CHUNK, 37))
    assert_equal(want.feat_soa, tblend.feat_soa_from_rows(want.feat_rows, tblend.CHUNK))


def test_kernel_route_refuses_cpu_tensors():
    args, gx, gy = _prep(50, 15)
    args = [to_torch(a) for a in args]
    before = tbin.BINNING_SORT.launches, tbin.BINNING_LAYOUT.launches
    with pytest.raises(ValueError, match="CUDA"):
        tbin.build_sorted_instances_kernel(*args, gx, gy, CAP, 32)
    assert (tbin.BINNING_SORT.launches, tbin.BINNING_LAYOUT.launches) == before
