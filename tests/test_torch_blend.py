"""PyTorch port vs JAX package: the plain version of the forward tile
compositor (kernel K2) against the TPU kernel run in interpret mode
(``_fwd_call(..., interpret=True)``) on the same feature array and
offsets. rgb, final_T and logT to atol 1e-4 (fp32 sums in another order:
the TPU kernel scans with split-bf16 MXU products, the plain version with
cumsum); ``chunks_done`` exact."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import binning as jbin
from gaussian_splatting_with_eye_tracking_tpu.ops import pallas_blend as jpb
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import preprocess
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend as tblend
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close, assert_equal, to_torch


def _run_both(feat_soa, offsets, gx, gy, chunk):
    offsets = jnp.asarray(offsets, jnp.int32)
    counts = (offsets[1:] - offsets[:-1]).astype(jnp.int32)
    want = np.asarray(jpb._fwd_call(jnp.asarray(feat_soa), offsets, counts, gx, gy,
                                    32, chunk, True))
    got = tblend.blend_fwd_plain(to_torch(feat_soa), to_torch(offsets), gx, gy, 32, chunk)
    assert got.shape == want.shape
    assert_close(got[..., 0:4], want[..., 0:4], atol=1e-4)
    assert_close(got[..., 5], want[..., 5], atol=1e-4)
    assert_equal(got[..., 4], want[..., 4])
    assert not got[..., 6:].any()
    return got, want


def test_multi_chunk_scene():
    """A real scene's instance list in 32-wide chunks: several chunks per
    tile, ranges not chunk-aligned, the carry across chunks."""
    cam = make_camera(64, 64)
    means, scales, quats, op, sh = make_random_gaussians(500, seed=1)
    prep = preprocess(means, scales, quats, op, sh, 0, cam)
    si = jbin.build_sorted_instances(
        prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
        prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, 2, 2,
        max_instances=1 << 12, tile_px=32, interpret=True)
    feat_soa = np.asarray(jpb._feat_soa_from_rows(si.feat_rows, 32))
    assert_equal(tblend.feat_soa_from_rows(to_torch(si.feat_rows), 32), feat_soa)
    got, _ = _run_both(feat_soa, si.binning.offsets, 2, 2, 32)
    assert got[:, 0, 4].max() > 3  # several chunks per tile


def test_saturated_tile_exits_early():
    """An opaque wall: the whole tile saturates and exits after a few of
    its 10 chunks."""
    n = 600
    rng = np.random.default_rng(2)
    feat = np.zeros((16, 640), np.float32)
    feat[0:2, :n] = rng.uniform(0, 32, (2, n))
    feat[2, :n], feat[4, :n] = 0.01, 0.01
    feat[5:8, :n] = rng.uniform(size=(3, n))
    feat[8, :n] = 0.95
    feat[9, :n] = np.arange(n)
    got, _ = _run_both(feat, [0, n], 1, 1, 64)
    done = got[0, :, 4]
    assert (done == done[0]).all() and 0 < done[0] < 10
    assert got[0, :, 3].max() < 1e-3


def test_ranges_start_mid_chunk():
    """Hand-built CSR ranges that start and end inside chunks, share
    chunks with their neighbours, and include an empty tile."""
    k = 200
    rng = np.random.default_rng(3)
    feat = np.zeros((16, 256), np.float32)
    feat[0:2, :k] = rng.uniform(-8, 72, (2, k))
    conic = rng.uniform(0.01, 0.2, (2, k))
    feat[2], feat[4] = np.pad(conic[0], (0, 56)), np.pad(conic[1], (0, 56))
    feat[3, :k] = rng.uniform(-0.5, 0.5, k) * np.sqrt(conic[0] * conic[1])
    feat[5:8, :k] = rng.uniform(size=(3, k))
    feat[8, :k] = rng.uniform(0.1, 0.99, k)
    feat[9, :k] = np.arange(k)
    offsets = [3, 70, 70, 133, 197]
    got, _ = _run_both(feat, offsets, 2, 2, 64)
    assert_equal(got[:, 0, 4], [2, 0, 2, 2])  # global 64-aligned chunks
    assert (got[1, :, 3] == 1.0).all()  # the empty tile stays transparent


def test_plain_counts_its_work():
    """The work counts K2's bound is computed from, against a direct count
    over each tile's own range (two tiles share a chunk; none exits)."""
    rng = np.random.default_rng(6)
    k = 200
    feat = np.zeros((16, 256), np.float32)
    feat[0:2, :k] = rng.uniform(-8, 72, (2, k))
    feat[2, :k], feat[4, :k] = rng.uniform(0.01, 0.1, (2, k))
    feat[5:8, :k] = rng.uniform(size=(3, k))
    feat[8, :k] = rng.uniform(0.05, 0.3, k)
    offsets = [3, 70, 200]
    work = {}
    got = tblend.blend_fwd_plain(to_torch(feat), to_torch(np.array(offsets, np.int32)),
                                 2, 1, 32, 64, work=work)
    assert_equal(got[:, 0, 4], [2, 3])
    want = {"lanes": 0, "exp_lanes": 0, "gate_lanes": 0, "kept": 0}
    ys, xs = np.mgrid[0:32, 0:32]
    for t in range(2):
        f = to_torch(feat[:, offsets[t]:offsets[t + 1]])
        px = to_torch((xs + 32 * t).reshape(-1, 1).astype(np.float32))
        py = to_torch(ys.reshape(-1, 1).astype(np.float32))
        dx, dy = f[0] - px, f[1] - py
        power = (-0.5 * f[2] * dx + -f[3] * dy) * dx + (-0.5 * f[4] * dy) * dy
        alpha_raw = (power + f[8].log()).exp()
        want["lanes"] += power.numel()
        want["exp_lanes"] += int((power <= 0).sum())
        want["gate_lanes"] += int(((power <= 0) & (power + f[8].log() >= tblend.LOG_GATE)).sum())
        want["kept"] += int(((power <= 0) & (alpha_raw >= tblend.ALPHA_MIN)).sum())
    assert work == want
    assert 0 < want["kept"] <= want["gate_lanes"] < want["exp_lanes"] <= want["lanes"]


def test_blend_fwd_wrapper_on_cpu_is_plain():
    feat = np.zeros((16, 128), np.float32)
    feat[0:2, :40] = np.random.default_rng(4).uniform(0, 32, (2, 40))
    feat[2], feat[4], feat[8] = 0.05, 0.05, 0.5
    args = (to_torch(feat), to_torch(np.array([0, 40], np.int32)), 1, 1)
    assert_equal(tblend.blend_fwd(*args), tblend.blend_fwd_plain(*args).numpy())


@pytest.mark.parametrize("gx,gy", [(2, 2), (3, 1)])
def test_assemble_tiles(gx, gy):
    tiles = np.random.default_rng(5).uniform(size=(gx * gy, 1024, 8)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    wc, wt = jpb._assemble_tiles(jnp.asarray(tiles), gx, gy, 32, jnp.asarray(bg))
    gc, gt = tblend.assemble_tiles(to_torch(tiles), gx, gy, 32, to_torch(bg))
    assert_close(gc, wc, atol=1e-7)
    assert_equal(gt, wt)


# -- the CUDA compositors' launch order and gate cull, mirrored in plain
# PyTorch (the kernels themselves are held in tests/test_torch_cuda.py) --


@pytest.mark.parametrize("counts", [
    np.random.default_rng(7).integers(0, 6, 2040),  # many ties
    np.full(37, 3),
    np.array([0]),
    np.arange(50)[::-1] % 7,
])
def test_tile_order_is_heaviest_first_and_stable(counts):
    c = torch.from_numpy(counts.astype(np.int64))
    order = tblend.tile_order(c)
    assert order.dtype == torch.int64 and torch.equal(order, tblend.tile_order(c))
    o = order
    assert torch.equal(torch.sort(o).values, torch.arange(c.numel()))
    k = c[o]
    assert (k[1:] <= k[:-1]).all()
    ties = k[1:] == k[:-1]
    assert (o[1:][ties] > o[:-1][ties]).all()  # equal counts in tile order


def test_tile_order_keys_of_the_wrappers():
    """What the CUDA wrappers sort by: the forward by instances per tile,
    the backward by the chunks the forward ran (float column 4)."""
    offsets = torch.tensor([0, 127, 129, 129, 600, 601], dtype=torch.int32)
    assert tblend.tile_order(offsets[1:] - offsets[:-1]).tolist() == [3, 0, 1, 4, 2]
    fwd = torch.zeros((5, 1024, 8))
    fwd[:, :, 4] = torch.tensor([1.0, 2.0, 0.0, 2.0, 1.0])[:, None]
    assert tblend.tile_order(fwd[:, 0, 4]).tolist() == [1, 3, 0, 4, 2]


def _conics(rng, n, ratio_max):
    """n float32 conics (a, b, c) of covariances with eigenvalues 0.3 * (1,
    r) * s, r up to ratio_max, s in [1, 60], random rotations."""
    theta = rng.uniform(0, np.pi, n)
    s = rng.uniform(1, 60, n)
    r = np.exp(rng.uniform(0, np.log(ratio_max), n))
    l1, l2 = 0.3 * s, 0.3 * s * r
    l2 = np.minimum(l2, 55.0 ** 2 / 8)  # keeps the gate extent inside the grid below
    cs, sn = np.cos(theta), np.sin(theta)
    cxx = l1 * cs ** 2 + l2 * sn ** 2
    cyy = l1 * sn ** 2 + l2 * cs ** 2
    cxy = (l2 - l1) * cs * sn
    det = cxx * cyy - cxy ** 2
    return [torch.from_numpy(v.astype(np.float32)) for v in (cyy / det, -cxy / det, cxx / det)]


@pytest.mark.parametrize("kind", ["round", "needle", "near_threshold"])
def test_gate_box_holds_every_kept_pixel(kind):
    """Every integer pixel within 64 px of an instance that passes the
    exact alpha gate (float32, as the plain versions compute it) passes the
    log-domain pre-test and lies in the instance's gate box; the box is
    close to the ellipse's own where the conic is well conditioned."""
    rng = np.random.default_rng({"round": 0, "needle": 1, "near_threshold": 2}[kind])
    n = 160
    a, b, c = _conics(rng, n, {"round": 3.0, "needle": 3e4, "near_threshold": 3.0}[kind])
    if kind == "near_threshold":  # opacities 1/255 +- 4 ulp, centres on pixels
        op = np.nextafter(np.float32(tblend.ALPHA_MIN), np.float32(1), dtype=np.float32)
        steps = rng.integers(-5, 4, n)
        op = np.array([np.float32(tblend.ALPHA_MIN) + k * (op - np.float32(tblend.ALPHA_MIN))
                       for k in steps], np.float32)
        centre = rng.integers(0, 2000, (2, n)).astype(np.float32)
    else:
        op = rng.uniform(0.002, 1.0, n).astype(np.float32)
        centre = rng.uniform(0, 2000, (2, n)).astype(np.float32)
    op, x, y = torch.from_numpy(op), torch.from_numpy(centre[0]), torch.from_numpy(centre[1])
    grid = torch.arange(-64, 65, dtype=torch.float32)
    px = (torch.round(x)[:, None, None] + grid[None, None, :]).expand(n, 129, 129)
    py = (torch.round(y)[:, None, None] + grid[None, :, None]).expand(n, 129, 129)
    dx, dy = x[:, None, None] - px, y[:, None, None] - py
    ha, nb, hc = (v[:, None, None] for v in (-0.5 * a, -b, -0.5 * c))
    power = (ha * dx + nb * dy) * dx + (hc * dy) * dy
    log_alpha = power + torch.log(op)[:, None, None]
    kept = (power <= 0) & (torch.exp(log_alpha) >= tblend.ALPHA_MIN)
    assert kept.any()
    assert (log_alpha[kept] >= tblend.LOG_GATE).all()
    x0, x1, y0, y1 = (v[:, None, None] for v in tblend.gate_box(x, y, a, b, c, op))
    inside = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
    assert inside[kept].all()
    if kind == "near_threshold":  # extents of a pixel or less: nothing to measure
        return
    # not vacuous: finite boxes, within a few percent of the exact extent
    tau = torch.log(op).double() - math.log(tblend.ALPHA_MIN)
    det = a.double() * c.double() - b.double() ** 2
    exact = torch.sqrt((2 * tau * c.double() / det).clamp_min(0))
    half = (x1 - x0)[:, 0, 0] / 2
    live = tau > 1e-3
    kappa = a.double() * c.double() / det
    assert torch.isfinite(half[live & (kappa <= 1e5)]).all()
    well = live & (kappa < 10)
    assert well.any()
    assert (half[well] <= 1.02 * exact[well] + 0.05).all()


def test_levels_order_heaviest_first():
    """What the fused foveated wrapper sorts by: level x instances per
    tile, descending, equal work in tile order."""
    counts = torch.tensor([100, 40, 0, 50, 400, 25], dtype=torch.int32)
    levels = torch.tensor([1, 4, 4, 2, 1, 4], dtype=torch.int32)
    order = tblend.levels_order(counts, levels)
    assert order.dtype == torch.int64
    assert order.tolist() == [4, 1, 0, 3, 5, 2]


@pytest.mark.parametrize("seed", [0, 1])
def test_round_order_prefix_per_round(seed):
    """The 5-step frame's one launch order: for each round r, the tiles it
    renders (level >= r) come first, heaviest first among equal levels
    (descending (level, instances), ties in tile order), and the tiles it
    skips form the tail."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 6, (200,), generator=gen, dtype=torch.int32) * 100
    levels = torch.randint(1, 5, (200,), generator=gen, dtype=torch.int32)
    order = tblend.round_order(counts, levels)
    assert order.dtype == torch.int64
    want = sorted(range(200), key=lambda t: (-int(levels[t]), -int(counts[t]), t))
    assert order.tolist() == want
    for rnd in range(1, 5):
        gated = int((levels >= rnd).sum())
        assert bool((levels[order[:gated]] >= rnd).all())
        assert not bool((levels[order[gated:]] >= rnd).any())


def test_round_order_small_example():
    counts = torch.tensor([100, 40, 0, 50, 400, 25, 40], dtype=torch.int32)
    levels = torch.tensor([1, 4, 4, 2, 1, 4, 4], dtype=torch.int32)
    assert tblend.round_order(counts, levels).tolist() == [1, 6, 5, 2, 3, 4, 0]


@pytest.mark.parametrize("turned", [2, 4])
def test_gate_probe_finds_the_turned_pair(turned):
    """gate_probe.explain, given a pixel that differs from the plain walk
    by one pair at the 1/255 gate kept on one side only, names that pair
    and reproduces the pixel."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import gate_probe

    rng = np.random.default_rng(turned)
    n, x, y = 7, 10.0, 20.0
    f = np.zeros((16, 128), np.float32)
    f[0, :n], f[1, :n] = x + rng.uniform(-2, 2, n), y + rng.uniform(-2, 2, n)
    f[2, :n], f[3, :n], f[4, :n] = rng.uniform(0.2, 1, n), 0.05, rng.uniform(0.2, 1, n)
    f[5:8, :n] = rng.uniform(size=(3, n))
    f[8, :n] = rng.uniform(0.3, 0.9, n)
    dx, dy = np.float64(f[0, turned] - x), np.float64(f[1, turned] - y)
    power = -0.5 * f[2, turned] * dx * dx - f[3, turned] * dx * dy - 0.5 * f[4, turned] * dy * dy
    f[8, turned] = np.exp(gate_probe.LN_GATE + 1e-7 - power)
    feat = torch.from_numpy(f)
    t = feat[:9, :n]
    power = (-0.5 * t[2] * (t[0] - x) - t[3] * (t[1] - y)) * (t[0] - x) \
        + (-0.5 * t[4] * (t[1] - y)) * (t[1] - y)
    alpha_raw = torch.exp(power + torch.log(t[8]))
    keep = (power <= 0) & (alpha_raw >= tblend.ALPHA_MIN)
    plain = gate_probe.walk(t, keep, alpha_raw).float()
    keep[turned] = ~keep[turned]
    kernel = gate_probe.walk(t, keep, alpha_raw).float()
    assert float((kernel - plain).abs().max()) > 1e-4
    row = gate_probe.explain(feat, 0, n, 1, x, y, kernel, plain)
    assert row["walk_vs_plain"] < 1e-6 and row["best_turn"]["pair"] == turned
    assert row["best_turn"]["turned_vs_kernel"] < 1e-6
