"""The hand-written kernels on a CUDA card against their plain PyTorch
versions (marked ``cuda``; they skip where there is no card). The file
imports no JAX, so it also runs on a CUDA machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

both expands are held bit-exact on every slot (the index expand also
against the segment expand of the same table); the forward compositor to atol
1e-4 on rgb/final_T (fp32 sums in another order, exp/log to a few ulp)
with ``chunks_done`` equal; the backward compositor per gradient row to
1e-4 of the row's largest value plus 1e-3 of each value, and exactly 0
past ``chunks_done``; the segment sum to 1e-5 of each row's largest
value; the foveated compositors (each AMR round, the levels kernel in
every decimation mode) to atol 1e-4 on rgb/final_T with chunks run equal;
the whole render, its gradients, a train step, a fused foveated frame and
RITnet on the card against the same on the CPU (forward atol 3e-4 / rtol
1e-3 with the integer outputs exact; gradients atol 2e-3 / rtol 5e-3, the
tolerance of tests/test_pallas_blend.py's gradient tests; RITnet logits
within 1e-3 of their largest magnitude); the compositors on a frame
whose sides are not multiples of 32, and the frame-rate sweep's capacity
regrow on the card. The compositors keep exactly the plain versions'
pairs at the 1/255 gate, on inputs where an FMA-contracted power would
turn some (checked on the host)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning, blend, expand, segsum
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as trast
from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import preprocess
from tests.torch_helpers import to_torch

pytestmark = pytest.mark.cuda


def random_scene(n, seed, sh_degree):
    """tests/helpers.make_random_gaussians' recipe, as CPU tensors."""
    return [torch.from_numpy(a) for a in cs.make_scene(
        n, seed=seed, sh_degree=sh_degree, spread=1.5, scale_range=(-3.5, -2.0))]


def front_camera(width, height, device="cpu"):
    """tests/helpers.make_camera's camera (z = -5, looking down +z)."""
    return cs.view_request(0.0, 0.0, width, height).params(device=device)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dead_frac", [0.0, 0.3, 1.0])
def test_expand_kernel_bit_exact(dev, dead_frac):
    rng = np.random.default_rng(0)
    nc = 5000
    n_live = int(nc * (1 - dead_frac))
    counts = rng.integers(1, 9, nc)
    table = rng.normal(size=(16, nc)).astype(np.float32)
    table[0, :n_live] = np.concatenate([[0], np.cumsum(counts[:n_live])[:-1]])
    table[0, n_live:] = np.inf
    k = int(counts[:n_live].sum()) + 1000
    t = to_torch(table).to(dev)
    got = expand.expand_rows_by_segments(t, 0, k)
    want = expand.expand_rows_by_segments_plain(t, 0, k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dead_frac", [0.0, 0.3])
def test_expand_rows_kernel_bit_exact(dev, dead_frac):
    """K6 along K1's own slot -> column map: equal to its plain version
    and to K1's output, bit for bit; clamps indices out of range."""
    rng = np.random.default_rng(1)
    nc = 5000
    n_live = int(nc * (1 - dead_frac))
    counts = rng.integers(1, 9, nc)
    table = rng.normal(size=(16, nc)).astype(np.float32)
    table[0, :n_live] = np.concatenate([[0], np.cumsum(counts[:n_live])[:-1]])
    table[0, n_live:] = np.inf
    k = int(counts[:n_live].sum()) + 1000
    t = to_torch(table).to(dev)
    slots = torch.arange(k, dtype=torch.float32, device=dev)
    ck = (torch.searchsorted(t[0].contiguous(), slots, right=True) - 1).clamp(0, nc - 1)
    ck = ck.to(torch.int32)
    before = expand.EXPAND_ROWS.launches
    got = expand.expand_rows(t, ck)
    assert expand.EXPAND_ROWS.launches == before + 1
    assert torch.equal(got, expand.expand_rows_plain(t, ck))
    assert torch.equal(got, expand.expand_rows_by_segments(t, 0, k))
    wild = torch.tensor([-3, 0, nc - 1, nc + 7], dtype=torch.int32, device=dev)
    assert torch.equal(expand.expand_rows(t, wild), t[:, [0, 0, nc - 1, nc - 1]])
    with pytest.raises(ValueError):
        expand.expand_rows(t, ck.to(torch.int64))


def _scene_features(dev, n=3000, w=256, h=192, max_instances=1 << 16):
    g = [x.to(dev) for x in random_scene(n, seed=3, sh_degree=1)]
    prep = preprocess(*g, 1, front_camera(w, h, dev))
    gx, gy = -(-w // 32), -(-h // 32)
    si = binning.build_sorted_instances(
        prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
        prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, gx, gy,
        max_instances=max_instances, tile_px=32)
    assert not bool(si.binning.overflow)
    return blend.feat_soa_from_rows(si.feat_rows, 128), si.binning.offsets, gx, gy


def test_blend_kernel_matches_plain(dev):
    feat, offsets, gx, gy = _scene_features(dev)
    got = blend.blend_fwd(feat, offsets, gx, gy)
    want = blend.blend_fwd_plain(feat, offsets, gx, gy)
    torch.cuda.synchronize()
    assert (want[:, 0, 4] > 1).any()
    assert torch.equal(got[..., 4], want[..., 4])
    assert torch.allclose(got[..., 0:4], want[..., 0:4], atol=1e-4, rtol=0)
    assert not got[..., 6:].any()


def _foveated_inputs(dev):
    feat, offsets, gx, gy = _scene_features(dev)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    gen = torch.Generator().manual_seed(5)
    levels = torch.randint(1, 5, (gx * gy,), generator=gen, dtype=torch.int32).to(dev)
    return feat, offsets, counts, levels, gx, gy


def _assert_rows_match(got, want, rows=None):
    torch.cuda.synchronize()
    assert torch.equal(got[..., 4], want[..., 4])
    if rows is not None:
        got, want = got[rows], want[rows]
    assert torch.allclose(got[..., 0:4], want[..., 0:4], atol=1e-4, rtol=0)


@pytest.mark.parametrize("rnd", [1, 2, 3, 4])
def test_round_kernel_matches_plain(dev, rnd):
    feat, offsets, counts, levels, gx, gy = _foveated_inputs(dev)
    kw = dict(offx=blend.ROUND_OFFX[rnd - 1], offy=blend.ROUND_OFFY[rnd - 1],
              counts_override=torch.where(levels >= rnd, counts, 0))
    before = blend.BLEND_ROUND.launches
    got = blend.blend_round(feat, offsets, gx, gy, **kw)
    want = blend.blend_round_plain(feat, offsets, gx, gy, **kw)
    assert blend.BLEND_ROUND.launches == before + 1
    assert got.shape == (gx * gy, 256, 8) and (want[:, 0, 4] > 1).any()
    _assert_rows_match(got, want)


@pytest.mark.parametrize("decimation,scale_only", [((1, 1, 1, 1), False),
                                                   ((4, 2, 1, 1), False),
                                                   ((4, 2, 1, 1), True),
                                                   ((2, 2, 2, 2), False)])
def test_levels_kernel_matches_plain(dev, decimation, scale_only):
    feat, offsets, counts, levels, gx, gy = _foveated_inputs(dev)
    kw = dict(decimation=decimation, scale_only=scale_only)
    before = blend.BLEND_LEVELS.launches
    got = blend.blend_levels(feat, offsets, counts, levels, gx, gy, **kw)
    want = blend.blend_levels_plain(feat, offsets, counts, levels, gx, gy, **kw)
    assert blend.BLEND_LEVELS.launches == before + 1
    rows = (torch.arange(1024, device=dev)[None, :] // 256) < levels[:, None]
    _assert_rows_match(got, want, rows)
    assert not got[~rows].any()


def test_fused_frame_card_matches_cpu(dev):
    """The gaze-driven fused frame and the 5-step frame of a small scene
    on the card and on the CPU."""
    g = random_scene(2000, seed=4, sh_degree=3)
    bg = torch.tensor([0.1, 0.2, 0.3])
    kw = dict(max_instances=1 << 15, gaze_xy=torch.tensor([80.0, 48.0]),
              gaze_radii=torch.tensor([24.0, 48.0, 80.0]))
    for fn, extra in ((amr.render_amr_fused, dict(decimation=(4, 2, 1, 1))),
                      (amr.render_amr_fused, dict(decimation=(4, 2, 1, 1), predecimate=True)),
                      (amr.render_amr, {})):
        want, ws = fn(*g, 3, front_camera(160, 96), bg, **kw, **extra)
        got, gs = fn(*(x.to(dev) for x in g), 3, front_camera(160, 96, dev), bg.to(dev),
                     **{k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in kw.items()},
                     **extra)
        assert torch.allclose(got.cpu(), want, atol=3e-4, rtol=1e-3)
        for name in ("tile_levels", "offsets", "num_instances", "overflow"):
            assert torch.equal(getattr(gs, name).cpu(), getattr(ws, name)), name
        assert len(set(ws.tile_levels.tolist())) >= 3


def test_ritnet_card_matches_cpu(dev):
    from gaussian_splatting_with_eye_tracking_tpu_torch import track_render
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet

    eye = cs.make_eye(height=96, width=128)
    models = {d: ritnet.load_pretrained(device=d) for d in ("cpu", dev)}
    x = ritnet.preprocess_eye_image(eye, device="cpu")
    with torch.no_grad():
        want, got = (models[d](x.to(d)).cpu() for d in ("cpu", dev))
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()
    (uv, pred), (uv_c, pred_c) = (track_render.estimate_gaze(eye, models[d], device=d)
                                  for d in (dev, "cpu"))
    assert (pred.cpu() != pred_c).float().mean() <= 1e-3
    assert np.abs((uv - uv_c) * np.array([128, 96])).max() <= 1.0
    assert torch.backends.cudnn.allow_tf32 is False  # the backend's setting


def _saturated_tile(dev):
    """One tile under an opaque wall of 1195 instances (range [5, 1200))."""
    n = 1200
    rng = np.random.default_rng(2)
    feat = np.zeros((16, 1280), np.float32)
    feat[0:2, :n] = rng.uniform(0, 32, (2, n))
    feat[2, :n], feat[4, :n] = 0.01, 0.01
    feat[5:8, :n] = rng.uniform(size=(3, n))
    feat[8, :n] = 0.95
    return to_torch(feat).to(dev), torch.tensor([5, n], dtype=torch.int32, device=dev)


def test_blend_kernel_saturated_tile_exits_early(dev):
    f, offsets = _saturated_tile(dev)
    got = blend.blend_fwd(f, offsets, 1, 1)
    want = blend.blend_fwd_plain(f, offsets, 1, 1)
    assert torch.equal(got[..., 4], want[..., 4]) and 0 < float(got[0, 0, 4]) < 10
    assert torch.allclose(got[..., 0:4], want[..., 0:4], atol=1e-4, rtol=0)


def _cotangent(fwd, seed):
    """A random (T, P, 8) cotangent: dL/dcolor and dL/dfinal_T."""
    g = torch.zeros_like(fwd)
    gen = torch.Generator().manual_seed(seed)
    g[..., 0:4] = torch.randn(fwd.shape[:2] + (4,), generator=gen).to(fwd.device)
    return g


def assert_rows_close(got, want, rel_max=1e-4, rtol=1e-3):
    """Per row: |got - want| <= rel_max * max|want| + rtol * |want|."""
    bound = rel_max * want.abs().amax(dim=1, keepdim=True) + rtol * want.abs()
    bad = (got - want).abs() > bound
    assert not bad.any(), f"{int(bad.sum())} values off; rows {bad.any(dim=1).tolist()}"


def test_blend_bwd_kernel_matches_plain(dev):
    feat, offsets, gx, gy = _scene_features(dev)
    fwd = blend.blend_fwd(feat, offsets, gx, gy)
    cot = _cotangent(fwd, 0)
    got = blend.blend_bwd(feat, offsets, fwd, cot, gx, gy)
    want = blend.blend_bwd_plain(feat, offsets, fwd, cot, gx, gy)
    torch.cuda.synchronize()
    n_live = int(offsets[-1])
    assert got.shape == (blend.NGRAD, feat.shape[1]) and not got[:, n_live:].any()
    assert_rows_close(got, want)
    assert (want[:, :n_live] != 0).any(dim=1).all()


def test_blend_bwd_kernel_saturated_tile(dev):
    f, offsets = _saturated_tile(dev)
    fwd = blend.blend_fwd(f, offsets, 1, 1)
    cot = _cotangent(fwd, 1)
    got = blend.blend_bwd(f, offsets, fwd, cot, 1, 1)
    want = blend.blend_bwd_plain(f, offsets, fwd, cot, 1, 1)
    done = int(fwd[0, 0, 4])
    assert 0 < done < 10
    assert not got[:, done * blend.CHUNK:].any()  # chunks past chunks_done
    assert got[:, 5:done * blend.CHUNK].any(dim=1).all()
    assert_rows_close(got, want)


@pytest.mark.parametrize("n", [1000, 300_001])
def test_segsum_kernel_matches_plain(dev, n):
    """Segment lengths as the backward gives them (a few columns each, a
    fifth empty), one long segment, and empty segments at S."""
    rng = np.random.default_rng(n)
    lengths = rng.integers(0, 10, n) * (rng.uniform(size=n) > 0.2)
    lengths[n // 2] = 3000
    lengths[-5:] = 0
    bounds = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    s = int(bounds[-1])
    table = to_torch(rng.normal(size=(9, s)).astype(np.float32)).to(dev)
    b = to_torch(bounds).to(dev)
    got = segsum.segment_sum_bounds(table, b)
    want = segsum.segment_sum_bounds_plain(table, b)
    torch.cuda.synchronize()
    assert got.shape == (9, n)
    assert not got[:, torch.from_numpy(lengths == 0).to(dev)].any()
    assert_rows_close(got, want, rel_max=1e-5, rtol=0)


def test_kernels_refuse_bad_inputs(dev):
    feat, offsets, gx, gy = _scene_features(dev, n=500, w=64, h=64)
    fwd = blend.blend_fwd(feat, offsets, gx, gy)
    before = (blend.BLEND_BWD.launches, segsum.SEGSUM.launches)
    with pytest.raises(ValueError):
        blend.blend_bwd(feat, offsets, fwd[:, :512].contiguous(), fwd, gx, gy)
    with pytest.raises(ValueError):
        segsum.segment_sum_bounds(torch.zeros((17, 8), device=dev),
                                  torch.zeros(3, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):
        segsum.segment_sum_bounds(torch.zeros((9, 8), device=dev),
                                  torch.zeros(3, dtype=torch.int64, device=dev))
    assert (blend.BLEND_BWD.launches, segsum.SEGSUM.launches) == before


def test_launch_counters_and_input_checks(dev):
    feat, offsets, gx, gy = _scene_features(dev, n=500, w=64, h=64)
    before_b, before_e = blend.BLEND_FWD.launches, expand.EXPAND_SEG.launches
    blend.blend_fwd(feat, offsets, gx, gy)
    expand.expand_rows_by_segments(feat[:, :4].contiguous(), 0, 10)
    assert blend.BLEND_FWD.launches == before_b + 1
    assert expand.EXPAND_SEG.launches == before_e + 1
    with pytest.raises(ValueError):
        blend.blend_fwd(feat[:, :100].contiguous(), offsets, gx, gy)
    with pytest.raises(ValueError):
        blend.blend_fwd(feat, offsets.to(torch.int64), gx, gy)
    odd = torch.zeros(feat.numel() + 1, device=dev)[1:].view(feat.shape)  # 4-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        blend.blend_fwd(odd, offsets, gx, gy)
    assert blend.BLEND_FWD.launches == before_b + 1


def test_rasterize_card_matches_cpu(dev):
    g = random_scene(2000, seed=4, sh_degree=3)
    bg = torch.tensor([0.1, 0.2, 0.3])
    kw = dict(sh_degree=3, max_instances=1 << 15)
    want = trast.rasterize(*g, front_camera(160, 96), bg, **kw)
    got = trast.rasterize(*(x.to(dev) for x in g), front_camera(160, 96, dev), bg.to(dev),
                          **kw)
    assert torch.allclose(got.color.cpu(), want.color, atol=3e-4, rtol=1e-3)
    assert torch.allclose(got.final_t.cpu(), want.final_t, atol=3e-4, rtol=1e-3)
    for name in ("radii", "num_instances", "num_enumerated", "overflow"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


def test_rasterize_grads_card_match_cpu(dev):
    """chip_smoke.py's gradient check on another scene and camera."""
    g = random_scene(2000, seed=4, sh_degree=3)
    want = cs.small_scene_grads(trast, g, front_camera(160, 96))
    got = cs.small_scene_grads(trast, [x.to(dev) for x in g], front_camera(160, 96, dev))
    for name, a, b in zip(cs.GRAD_NAMES, got, want):
        assert torch.allclose(a.cpu(), b, atol=2e-3, rtol=5e-3), name
        assert b.abs().max() > 0, name



def test_train_step_card_matches_cpu(dev):
    """One train step (render, loss, backward through K3 and K4, Adam,
    densification stats) from the same state on the card and the CPU."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    opt = OptimizationConfig()
    raw = cs.raw_params(*(x.numpy() for x in random_scene(2000, seed=6, sh_degree=3)))
    gt = torch.rand((3, 96, 160), generator=torch.Generator().manual_seed(0))
    out = {}
    for d in ("cpu", dev):
        tx = gm.make_optimizer(opt, 1.0)
        state = gm.init_training(gm.params_from_jax(raw, device=d), 3, tx, capacity=4096)
        step = train_lib.make_train_step(tx, opt, 3, 160, 96, max_instances=1 << 15, device=d)
        out[str(d)] = step(state, *train_lib.camera_arrays(front_camera(160, 96, d)),
                           gt.to(d), torch.zeros(3, device=d), True)
    (cs_, ca), (gs, ga) = out["cpu"], out[str(dev)]
    assert torch.allclose(ga.loss.cpu(), ca.loss, rtol=1e-4, atol=0)
    assert torch.allclose(ga.image.cpu(), ca.image, atol=3e-4, rtol=1e-3)
    assert int(ga.num_instances) == int(ca.num_instances) > 0
    assert torch.equal(gs.denom.cpu(), cs_.denom)
    assert torch.allclose(gs.xyz_grad_accum.cpu(), cs_.xyz_grad_accum, atol=2e-3 * 0.1, rtol=5e-3)
    for name in gm.GaussianParams._fields:
        g_mu, c_mu = getattr(gs.opt_state.mu, name).cpu(), getattr(cs_.opt_state.mu, name)
        # mu = 0.1 g after one step: the gradient tolerance, scaled
        assert torch.allclose(g_mu, c_mu, atol=0.1 * 2e-3, rtol=5e-3), name
        assert c_mu.abs().max() > 0, name


def _csr(tiles):
    """Per-tile instance lists [(9, m_t) float32] -> the (16, kp) feature
    array in CSR order (kp a multiple of 128) and the (T+1) offsets."""
    sizes = [f.shape[1] for f in tiles]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    feat = np.zeros((16, max(128, -(-int(offsets[-1]) // 128) * 128)), np.float32)
    for f, o in zip(tiles, offsets[:-1]):
        feat[:9, o:o + f.shape[1]] = f
    return feat, offsets


def _instances(rng, n, x, y, conic, op):
    f = np.zeros((9, n), np.float32)
    f[0], f[1] = x, y
    f[2:5] = conic
    f[5:8] = rng.uniform(size=(3, n))
    f[8] = op
    return f


def _needle_conics(rng, n, long_var):
    """Conics of covariances with variances 0.3 and long_var, rotated to
    near 0, 45 and 90 degrees."""
    theta = rng.choice([0.0, np.pi / 4, np.pi / 2], n) + rng.uniform(-0.05, 0.05, n)
    cs, sn = np.cos(theta), np.sin(theta)
    cxx = 0.3 * cs ** 2 + long_var * sn ** 2
    cyy = 0.3 * sn ** 2 + long_var * cs ** 2
    cxy = (long_var - 0.3) * cs * sn
    det = cxx * cyy - cxy ** 2
    return np.stack([cyy / det, -cxy / det, cxx / det])


def _edge_inputs(kind, dev):
    """Inputs at the edges of the compositors' design, (feat, offsets, gx,
    gy): "order", one tile with ~12 chunks beside near-empty ones;
    "gate_edge", opacities at 1/255 +- 4 ulp centred on pixels (only the
    centre can pass the gate); "cull_edge", ellipses larger than a tile
    and needle-thin ones straddling the warps' 16x8 blocks, each tile's
    range holding all of them."""
    rng = np.random.default_rng({"order": 10, "gate_edge": 11, "cull_edge": 12}[kind])
    if kind == "order":
        gx, gy = 4, 2
        tiles = []
        for t in range(gx * gy):
            m = 1500 if t == 5 else int(rng.integers(0, 4))
            ox, oy = (t % gx) * 32, (t // gx) * 32
            conic = np.stack([rng.uniform(0.05, 0.5, m), np.zeros(m), rng.uniform(0.05, 0.5, m)])
            tiles.append(_instances(rng, m, rng.uniform(ox, ox + 32, m),
                                    rng.uniform(oy, oy + 32, m), conic,
                                    rng.uniform(0.005, 0.05, m)))
    elif kind == "gate_edge":
        gx, gy = 2, 1
        step = np.nextafter(np.float32(1 / 255), np.float32(1)) - np.float32(1 / 255)
        tiles = []
        for t in range(gx * gy):
            pix = rng.choice(1024, 600, replace=False)
            op = np.float32(1 / 255) + rng.integers(-4, 5, 600).astype(np.float32) * step
            conic = np.stack([np.full(600, 50.0), np.zeros(600), np.full(600, 50.0)])
            tiles.append(_instances(rng, 600, 32 * t + pix % 32, pix // 32, conic, op))
    else:
        gx, gy = 2, 2
        big = _instances(rng, 60, rng.uniform(-60, 124, 60), rng.uniform(-60, 124, 60),
                         np.stack([rng.uniform(1e-3, 5e-3, 60), rng.uniform(-5e-4, 5e-4, 60),
                                   rng.uniform(1e-3, 5e-3, 60)]),
                         rng.uniform(0.02, 0.1, 60))
        bx = 16.0 * rng.integers(0, 5, 200) + rng.uniform(-0.5, 0.5, 200)
        by = 8.0 * rng.integers(0, 9, 200) + rng.uniform(-0.5, 0.5, 200)
        needle = _instances(rng, 200, bx, by, _needle_conics(rng, 200, rng.uniform(400, 3000, 200)),
                            rng.uniform(0.3, 0.9, 200))
        both = np.concatenate([big, needle], 1)
        tiles = [both[:, rng.permutation(both.shape[1])] for _ in range(gx * gy)]
    feat, offsets = _csr(tiles)
    return to_torch(feat).to(dev), to_torch(offsets).to(dev), gx, gy


def _power_edge_inputs(dev):
    """16 instances a tile (16 x 8 tiles), each 0.3-1.3 px off its own
    target pixel (even x and y: K2's, round 1's and every level's), with
    a random conic and its opacity within 3 ulps of the value at which the
    target's power + log op, rounded as the plain version rounds it, meets
    ln(1/255). Returns (feat, offsets, gx, gy) and the number of targets
    whose gate decision an FMA-contracted power would turn."""
    rng = np.random.default_rng(13)
    gx, gy, m = 16, 8, 16
    f32 = np.float32
    tiles, turned = [], 0
    for t in range(gx * gy):
        k = np.arange(m)
        px = ((t % gx) * 32 + 2 + 8 * (k % 4)).astype(f32)
        py = ((t // gx) * 32 + 2 + 8 * (k // 4)).astype(f32)
        x = (px + rng.uniform(0.3, 1.3, m) * rng.choice([-1, 1], m)).astype(f32)
        y = (py + rng.uniform(0.3, 1.3, m) * rng.choice([-1, 1], m)).astype(f32)
        a, c = rng.uniform(0.3, 1.5, m), rng.uniform(0.3, 1.5, m)
        b = rng.uniform(-0.5, 0.5, m) * np.sqrt(a * c)
        conic = np.stack([a, b, c]).astype(f32)
        ha, nb, hc = f32(-0.5) * conic[0], -conic[1], f32(-0.5) * conic[2]
        dx, dy = x - px, y - py
        power = (ha * dx + nb * dy) * dx + (hc * dy) * dy
        op = (np.exp(np.log(1 / 255) - power.astype(np.float64))
              * (1 + rng.integers(-3, 4, m) * 2.0 ** -23)).astype(f32)
        lo = np.log(op)

        def fma(u, v, w):
            return (u.astype(np.float64) * v + w.astype(np.float64)).astype(f32)

        def kept(pw):
            return (pw <= 0) & (np.exp(pw + lo) >= f32(1 / 255))

        inner = (fma(ha, dx, nb * dy), fma(nb, dy, ha * dx))
        fused = [p for i in inner for p in (fma(i, dx, (hc * dy) * dy), fma(hc * dy, dy, i * dx))]
        turned += int(np.any([kept(p) != kept(power) for p in fused], axis=0).sum())
        tiles.append(_instances(rng, m, x, y, conic, op))
    feat, offsets = _csr(tiles)
    return (to_torch(feat).to(dev), to_torch(offsets).to(dev), gx, gy), turned


def test_power_edge_inputs_can_turn_the_gate():
    """The power-edge inputs hold pairs whose gate an FMA-contracted power
    decides otherwise than the plain version's (computed on the host)."""
    (_, offsets, gx, gy), turned = _power_edge_inputs("cpu")
    assert int(offsets[-1]) == 16 * gx * gy and turned >= 20


def test_compositors_keep_the_plain_gate_set(dev):
    """On the power-edge inputs K2, K3, the four rounds and K5 keep the
    pairs the plain versions keep: a pair kept on one side only moves its
    target pixel by ~1/255 of the transmittance, 40x the tolerance."""
    (feat, offsets, gx, gy), _ = _power_edge_inputs(dev)
    got = blend.blend_fwd(feat, offsets, gx, gy)
    want = blend.blend_fwd_plain(feat, offsets, gx, gy)
    _assert_rows_match(got, want)
    cot = _cotangent(got, 4)
    assert_rows_close(blend.blend_bwd(feat, offsets, got, cot, gx, gy),
                      blend.blend_bwd_plain(feat, offsets, got, cot, gx, gy))
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    levels = torch.full_like(counts, 4)
    order = blend.round_order(counts, levels)
    for rnd in range(1, 5):
        kw = dict(offx=blend.ROUND_OFFX[rnd - 1], offy=blend.ROUND_OFFY[rnd - 1],
                  counts_override=counts)
        _assert_rows_match(blend.blend_round(feat, offsets, gx, gy, **kw, order=order,
                                             split=amr.ROUND_SPLIT[rnd - 1]),
                           blend.blend_round_plain(feat, offsets, gx, gy, **kw))
    _assert_rows_match(blend.blend_levels(feat, offsets, counts, levels, gx, gy),
                       blend.blend_levels_plain(feat, offsets, counts, levels, gx, gy))


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_compositors_are_deterministic(dev):
    """Two launches of each redesigned compositor on the same inputs give
    the same bits (K3 sums in a fixed order, with no atomics)."""
    feat, offsets, gx, gy = _scene_features(dev)
    fwd = blend.blend_fwd(feat, offsets, gx, gy)
    assert torch.equal(_bits(fwd), _bits(blend.blend_fwd(feat, offsets, gx, gy)))
    cot = _cotangent(fwd, 2)
    bwd = blend.blend_bwd(feat, offsets, fwd, cot, gx, gy)
    assert torch.equal(_bits(bwd), _bits(blend.blend_bwd(feat, offsets, fwd, cot, gx, gy)))


@pytest.mark.parametrize("kind", ["order", "gate_edge", "cull_edge"])
def test_compositors_on_edge_inputs(dev, kind):
    feat, offsets, gx, gy = _edge_inputs(kind, dev)
    got = blend.blend_fwd(feat, offsets, gx, gy)
    want = blend.blend_fwd_plain(feat, offsets, gx, gy)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 4], want[..., 4])
    assert torch.allclose(got[..., 0:4], want[..., 0:4], atol=1e-4, rtol=0)
    assert (want[..., 0:3] > 0).any()
    if kind == "order":
        chunks = want[:, 0, 4].tolist()
        assert chunks[5] > 3 and max(chunks[:5] + chunks[6:]) <= 2
    cot = _cotangent(got, 3)
    dgot = blend.blend_bwd(feat, offsets, got, cot, gx, gy)
    dwant = blend.blend_bwd_plain(feat, offsets, got, cot, gx, gy)
    torch.cuda.synchronize()
    assert_rows_close(dgot, dwant)
    # (on the gate edge every kept pair sits at dx = dy = 0: rows x, y and
    # the conic's are 0)
    assert (dwant[[5, 6, 7, 8] if kind == "gate_edge" else slice(None)] != 0).any(dim=1).all()
    assert torch.equal(_bits(dgot), _bits(blend.blend_bwd(feat, offsets, got, cot, gx, gy)))


def _gather_case(kind, dev):
    """Records, src and bounds as the train step hands them to the
    gather-and-sum: segments of 0-9 slots (half empty), one of 5000
    slots ("long"), none at all ("all_empty"), or a fifth of the slots
    dropped (src -1, "dropped")."""
    rng = np.random.default_rng(len(kind))
    n = 300_001
    lengths = rng.integers(0, 10, n) * (rng.uniform(size=n) > 0.5)
    if kind == "long":
        lengths[n // 3] = 5000
    if kind == "all_empty":
        lengths[:] = 0
    bounds = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    total = int(bounds[-1])
    k = total + 256
    src = rng.permutation(k)[:total].astype(np.int32)
    if kind == "dropped":
        src[rng.uniform(size=total) < 0.2] = -1
    storage = segsum.records(k, dev)
    storage.copy_(to_torch(rng.normal(size=(k, segsum.REC)).astype(np.float32)))
    return (segsum.record_rows(storage, blend.NGRAD), to_torch(src).to(dev),
            to_torch(bounds).to(dev), lengths)


@pytest.mark.parametrize("kind", ["typical", "long", "all_empty", "dropped"])
def test_segsum_gather_kernel_matches_plain(dev, kind):
    """The train step's gather-and-sum against its plain version (1e-5 of
    each row's largest value), empty segments exactly 0, two launches
    bit-identical, and the same bits from a contiguous (non-record)
    copy of the values."""
    values, src, bounds, lengths = _gather_case(kind, dev)
    before = segsum.SEGSUM.launches
    got = segsum.segment_sum_gather(values, src, bounds)
    assert segsum.SEGSUM.launches == before + 1
    want = segsum.segment_sum_gather_plain(values, src, bounds)
    torch.cuda.synchronize()
    assert got.shape == (blend.NGRAD, lengths.shape[0])
    assert not got[:, torch.from_numpy(lengths == 0).to(dev)].any()
    if kind != "all_empty":
        assert_rows_close(got, want, rel_max=1e-5, rtol=0)
    assert torch.equal(_bits(got), _bits(segsum.segment_sum_gather(values, src, bounds)))
    assert torch.equal(_bits(got),
                       _bits(segsum.segment_sum_gather(values.contiguous(), src, bounds)))


def test_segment_reduce_grads_kernel_with_dropped_instances(dev):
    """The whole reduction as the train step runs it (K3's records, the
    id-order source, the gather-and-sum) on a real scene whose max_live
    drops 300 instances: each gaussian sums exactly its own rendered
    instances, as the CPU computes them; bit-identical between launches."""
    g = [x.to(dev) for x in random_scene(3000, seed=3, sh_degree=1)]
    prep = preprocess(*g, 1, front_camera(256, 192, dev))
    args = (prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched,
            prep.rect_min, prep.rect_max, prep.cull_thr, prep.depths, 8, 6)
    kept = int(binning.build_sorted_instances(*args, 1 << 16, 32).binning.offsets[-1])
    si = binning.build_sorted_instances(*args, 1 << 16, 32, max_live=kept - 300)
    b = si.binning
    feat = blend.feat_soa_from_rows(si.feat_rows, 128)
    fwd = blend.blend_fwd(feat, b.offsets, 8, 6)
    dfeat = blend.blend_bwd(feat, b.offsets, fwd, _cotangent(fwd, 4), 8, 6)
    red = (si.id_pos, b.gauss_start, b.gauss_count, 1 << 16)
    got = blend.segment_reduce_grads(dfeat, *red)
    again = blend.segment_reduce_grads(dfeat, *red)
    n_live = int(b.offsets[-1])
    want = torch.zeros(got.shape, dtype=torch.float64)
    want.index_add_(1, b.gauss_id[:n_live].cpu().to(torch.int64),
                    dfeat[:, :n_live].cpu().to(torch.float64))
    cpu = blend.segment_reduce_grads(dfeat.cpu(), *(x.cpu() for x in red[:3]), 1 << 16)
    torch.cuda.synchronize()
    assert bool(b.overflow) and n_live == kept - 300
    assert_rows_close(got.cpu(), want.to(torch.float32), rel_max=1e-5, rtol=0)
    assert_rows_close(got.cpu(), cpu, rel_max=1e-5, rtol=0)
    assert torch.equal(_bits(got), _bits(again))


def test_levels_kernel_launch_orders_bit_identical(dev):
    """The fused foveated kernel launched heaviest tiles first (as its
    wrapper orders them) and in tile order, twice each: the same bits."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend

    feat, offsets, counts, levels, gx, gy = _foveated_inputs(dev)
    want = blend.blend_levels(feat, offsets, counts, levels, gx, gy, decimation=(4, 2, 1, 1))
    out = torch.empty_like(want)
    for order in (blend.levels_order(counts, levels), torch.arange(gx * gy, device=dev)) * 2:
        out.zero_()
        blend.BLEND_LEVELS(feat.data_ptr(), feat.shape[1], offsets.data_ptr(),
                           counts.data_ptr(), levels.data_ptr(), order.data_ptr(), gx * gy,
                           gx, 4, 2, 1, 1, 0, out.data_ptr(), backend.stream_ptr(feat))
        assert torch.equal(_bits(out), _bits(want))


def _k1_table(case):
    """(table, k) for K1's edge cases: segment starts in row 0 (exact-int
    float32, nondecreasing, +inf on the dead tail), other rows random."""
    rng = np.random.default_rng(11)
    nc = 6000
    table = rng.normal(size=(16, nc)).astype(np.float32)
    counts = rng.integers(1, 12, nc)
    n_live = nc
    if case == "all_dead":
        n_live = 0
    elif case == "one_column_100k":  # one column owns more slots than many runs
        counts[nc // 3] = 100_000
    elif case == "one_slot_columns":  # windows wider than the staged columns
        counts[:] = 1
    elif case == "inf_between_live":
        # columns that own no slot between live ones (a start equal to the
        # next one's), +inf and NaN values in the data rows, a dead tail
        counts[rng.uniform(size=nc) < 0.3] = 0
        n_live = nc - 500
        table[5, ::7] = np.inf
        table[6, ::11] = -np.inf
        table[7, ::13] = np.nan
    table[0, :n_live] = np.cumsum(counts[:n_live]) - counts[:n_live]
    table[0, n_live:] = np.inf
    total = int(counts[:n_live].sum())
    k = {"k_not_a_run_multiple": total + 777, "k_not_a_multiple_of_4": total + 1023}.get(
        case, total + 4096)
    if case == "k_not_a_multiple_of_4":
        k += (k % 4 == 0)
    return table, k


@pytest.mark.parametrize("case", ["all_dead", "one_column_100k", "k_not_a_run_multiple",
                                  "k_not_a_multiple_of_4", "inf_between_live",
                                  "one_slot_columns"])
def test_expand_kernel_edge_cases_bit_exact(dev, case):
    table, k = _k1_table(case)
    t = to_torch(table).to(dev)
    got = expand.expand_rows_by_segments(t, 0, k)
    want = expand.expand_rows_by_segments_plain(t, 0, k)
    torch.cuda.synchronize()
    assert got.shape == (16, k)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _front_view_prep(dev):
    """The 300k bench scene's front view (1920x1088), preprocessed."""
    g = [torch.from_numpy(a).to(dev) for a in cs.make_scene(cs.N)]
    return g, preprocess(*g, 3, cs.view_request(0.0, 0.0).params(device=dev), tile=32)


def test_expand_kernel_front_view_bit_exact(dev):
    _, prep = _front_view_prep(dev)
    table, _ = binning.compact_table(prep.means2d, prep.conics, prep.rgb, prep.opacities,
                                     prep.tiles_touched, prep.rect_min, prep.rect_max,
                                     prep.cull_thr, prep.depths)
    got = expand.expand_rows_by_segments(table, 0, cs.MAX_INSTANCES)
    want = expand.expand_rows_by_segments_plain(table, 0, cs.MAX_INSTANCES)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _gated_counts(counts, n_gated, seed=0):
    """counts with all but n_gated tiles (drawn from a seed) set to 0."""
    gen = torch.Generator().manual_seed(seed)
    keep = torch.randperm(counts.shape[0], generator=gen)[:n_gated].to(counts.device)
    out = torch.zeros_like(counts)
    out[keep] = counts[keep]
    return out


@pytest.mark.parametrize("n_gated", [0, 1, 56])
@pytest.mark.parametrize("split", blend.ROUND_SPLITS)
def test_round_kernel_gated_tiles_match_plain(dev, n_gated, split):
    feat, offsets, gx, gy = _scene_features(dev, n=6000, w=512, h=384, max_instances=1 << 19)
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    gated = _gated_counts(counts, n_gated)
    kw = dict(offx=1, offy=0, counts_override=gated)
    want = blend.blend_round_plain(feat, offsets, gx, gy, **kw)
    levels = torch.where(gated > 0, 4, 1).to(torch.int32)
    for order in (blend.round_order(counts, levels), torch.arange(gx * gy, device=dev)):
        got = blend.blend_round(feat, offsets, gx, gy, **kw, order=order, split=split)
        _assert_rows_match(got, want)
    assert int((want[:, 0, 4] > 0).sum()) == int((gated > 0).sum())


def test_round_kernel_front_view_four_rounds(dev):
    """The 300k bench scene's front view with gaze rings as the eye-tracked
    frame sets them, each round in the frame's launch order at every split:
    chunks run equal to the plain version's on every tile, rgb/final_T
    within chip_smoke's 1e-3 of it (a pair at the 1/255 alpha gate, kept
    on one side only, moved one round-1 tile by 1.4e-4 at every split); the
    splits' final_T, chunks run and logT the bits of one CTA per tile, rgb
    within 1e-5 of it (exp(logT) * exp(local) for exp(logT + local))."""
    g, _ = _front_view_prep(dev)
    st = amr.fovea_step0(*g, 3, cs.view_request(0.0, 0.0).params(device=dev),
                         max_instances=cs.MAX_INSTANCES,
                         gaze_xy=torch.tensor([0.55 * cs.W, 0.45 * cs.H], device=dev),
                         gaze_radii=torch.tensor([cs.H / 8, cs.H / 4, cs.H / 2], device=dev))
    assert not bool(st.overflow)
    gx, gy = cs.W // 32, cs.H // 32
    counts = (st.offsets[1:] - st.offsets[:-1]).to(torch.int32)
    order = blend.round_order(counts, st.tile_levels)
    for rnd in range(1, 5):
        kw = dict(offx=blend.ROUND_OFFX[rnd - 1], offy=blend.ROUND_OFFY[rnd - 1],
                  counts_override=torch.where(st.tile_levels >= rnd, counts, 0))
        want = blend.blend_round_plain(st.feat_soa, st.offsets, gx, gy, **kw)
        one = blend.blend_round(st.feat_soa, st.offsets, gx, gy, **kw, order=order, split=1)
        torch.cuda.synchronize()
        assert torch.equal(one[..., 4], want[..., 4])
        assert torch.allclose(one[..., 0:4], want[..., 0:4], atol=1e-3, rtol=0)
        for split in blend.ROUND_SPLITS[1:]:
            got = blend.blend_round(st.feat_soa, st.offsets, gx, gy, **kw, order=order,
                                    split=split)
            torch.cuda.synchronize()
            assert torch.equal(got[..., 3:6].view(torch.int32), one[..., 3:6].view(torch.int32))
            assert torch.allclose(got[..., 0:3], one[..., 0:3], atol=1e-5, rtol=0)


def test_round_kernel_refuses_bad_split_and_order(dev):
    feat, offsets, gx, gy = _scene_features(dev, n=500, w=64, h=64)
    before = blend.BLEND_ROUND.launches
    with pytest.raises(ValueError):
        blend.blend_round(feat, offsets, gx, gy, offx=0, offy=0, split=3)
    with pytest.raises(ValueError):
        blend.blend_round(feat, offsets, gx, gy, offx=0, offy=0,
                          order=torch.arange(gx * gy, dtype=torch.int32, device=dev))
    assert blend.BLEND_ROUND.launches == before


def test_kernels_on_a_frame_not_a_multiple_of_32(dev):
    """A 200x136 frame (7x5 tiles; the last column and row 8 px): K2, the
    four AMR rounds (the frame's one launch order, split as the 5-step
    frame splits them) and K5 against their plain versions, and the whole
    frames (rasterize, the 5-step and the fused foveated frame) on the
    card against the CPU, cropped to 200x136."""
    w, h = 200, 136
    feat, offsets, gx, gy = _scene_features(dev, w=w, h=h)
    assert (gx, gy) == (7, 5)
    _assert_rows_match(blend.blend_fwd(feat, offsets, gx, gy),
                       blend.blend_fwd_plain(feat, offsets, gx, gy))
    counts = (offsets[1:] - offsets[:-1]).to(torch.int32)
    gen = torch.Generator().manual_seed(5)
    levels = torch.randint(1, 5, (gx * gy,), generator=gen, dtype=torch.int32).to(dev)
    order = blend.round_order(counts, levels)
    for rnd in range(1, 5):
        kw = dict(offx=blend.ROUND_OFFX[rnd - 1], offy=blend.ROUND_OFFY[rnd - 1],
                  counts_override=torch.where(levels >= rnd, counts, 0))
        got = blend.blend_round(feat, offsets, gx, gy, **kw, order=order,
                                split=amr.ROUND_SPLIT[rnd - 1])
        _assert_rows_match(got, blend.blend_round_plain(feat, offsets, gx, gy, **kw))
    rows = (torch.arange(1024, device=dev)[None, :] // 256) < levels[:, None]
    got = blend.blend_levels(feat, offsets, counts, levels, gx, gy)
    _assert_rows_match(got, blend.blend_levels_plain(feat, offsets, counts, levels, gx, gy),
                       rows)
    assert not got[~rows].any()

    g = random_scene(3000, seed=3, sh_degree=1)
    bg = torch.tensor([0.1, 0.2, 0.3])
    gaze = dict(gaze_xy=torch.tensor([150.0, 100.0]), gaze_radii=torch.tensor([20.0, 40.0, 80.0]))
    frames = {"rasterize": lambda a, cam, b, d: trast.rasterize(
                  *a, cam, b, sh_degree=1, max_instances=1 << 16).color,
              "five_step": lambda a, cam, b, d: amr.render_amr(
                  *a, 1, cam, b, max_instances=1 << 16,
                  **{k: v.to(d) for k, v in gaze.items()})[0],
              "fused": lambda a, cam, b, d: amr.render_amr_fused(
                  *a, 1, cam, b, max_instances=1 << 16,
                  **{k: v.to(d) for k, v in gaze.items()})[0]}
    for name, fn in frames.items():
        want = fn(g, front_camera(w, h), bg, "cpu")
        got = fn([x.to(dev) for x in g], front_camera(w, h, dev), bg.to(dev), dev)
        assert got.shape == want.shape == (3, h, w), name
        assert torch.allclose(got.cpu(), want, atol=3e-4, rtol=1e-3), name


@pytest.mark.parametrize("amr_mode", [False, True], ids=["vanilla", "amr"])
def test_sweep_regrows_an_overflowing_capacity(dev, amr_mode, tmp_path, monkeypatch):
    """fps_test's sweep started at a capacity the view overflows: it
    renders again at the next power of two that holds the view, the same
    bits as a render at a capacity that holds it from the start."""
    monkeypatch.setattr(fps_test, "REPS", 1)
    state, deg, active = fps_test.synthetic_scene(1000, dev)
    (r,) = fps_test.run_sweep(state, deg, active, base=(128, 96), ratios=[1.0],
                              amr_mode=amr_mode, out_json=str(tmp_path / "fps.json"),
                              max_instances=256, device=dev)
    assert r["enumerated"] > 256 and r["capacity"] == tgm.next_pow2(r["enumerated"] + 1)
    args = renderer.activated(state, deg)
    cam, bg = fps_test.sweep_camera(128, 96, dev), torch.zeros(3, device=dev)
    grown = fps_test.render_at_capacity(args, deg, active, cam, bg, 256, amr_mode)
    want = fps_test.render_at_capacity(args, deg, active, cam, bg, 1 << 14, amr_mode)
    assert grown[1:] == (r["capacity"], r["instances"], r["enumerated"])
    assert want[1:] == (1 << 14, r["instances"], r["enumerated"])
    assert torch.equal(grown[0], want[0])


def test_parity_probe_gates(dev):
    """The card parity probe (kernels against the jnp oracles at 256x256,
    4,000 gaussians): every gate met, K1-K4 and the round kernel launched."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, parity_probe

    for kern in backend.kernels():
        kern.launches = 0
    res = parity_probe.run(dev, knn_points=5_000, knn_dup=1_000)
    launches = {kern.name: kern.launches for kern in backend.kernels()}
    assert res["ok"], res["failed"]
    assert all(launches[k] >= 1 for k in ("expand_seg", "blend_fwd", "blend_bwd", "segsum"))
    assert launches["blend_round"] >= 4


def test_bin_gaussians_matches_build_sorted_instances_front_view(dev):
    """The gather-route binning oracle against the kernel route on bench's
    300k front view: the counters, offsets and live ids exactly."""
    gx, gy = -(-cs.W // 32), -(-cs.H // 32)
    _, prep = _front_view_prep(dev)
    b = binning.bin_gaussians(prep, gx, gy, cs.MAX_INSTANCES, 32, max_live=cs.MAX_LIVE)
    si = binning.build_sorted_instances(
        prep.means2d, prep.conics, prep.rgb, prep.opacities, prep.tiles_touched, prep.rect_min,
        prep.rect_max, prep.cull_thr, prep.depths, gx, gy, cs.MAX_INSTANCES, 32,
        max_live=cs.MAX_LIVE)
    n = int(b.num_instances)
    assert n > 1_000_000 and not bool(b.overflow)
    for name in ("num_instances", "num_enumerated", "overflow", "offsets", "gauss_start",
                 "gauss_count"):
        assert torch.equal(getattr(b, name), getattr(si.binning, name)), name
    assert torch.equal(b.gauss_id[:n], si.binning.gauss_id[:n])


def test_blocked_3nn_matches_ckdtree(dev):
    from gaussian_splatting_with_eye_tracking_tpu_torch.ops import knn

    pts = np.random.default_rng(0).uniform(-1, 1, (20_000, 3)).astype(np.float32)
    got = knn.mean_sq_dist_3nn_blocked(torch.from_numpy(pts).to(dev)).cpu().numpy()
    np.testing.assert_allclose(got, knn.mean_sq_dist_3nn(pts), rtol=1e-5)
