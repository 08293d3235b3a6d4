"""The port's multi-device path (``…_torch/parallel``) against the JAX
package's ``parallel/sharded.py`` and against the port's own single-device
step, on the CPU.

The port's ranks are processes on gloo (``tests/torch_multiproc_worker.py``,
2 and 4 of them, 2 threads each, started once per module); JAX's mesh is
the 8 virtual CPU devices of ``tests/conftest.py``, ``impl="jnp"``, its
references computed once per module while the ranks run. The inputs are
JAX's ``small_state`` (60 gaussians, capacity 64, SH 0) carried across by
``state_from_jax``, and ``make_random_gaussians`` scenes drawn from seeds.

Tolerances are ``tests/test_parallel.py``'s: renders atol 2e-5 / rtol
1e-3 against a single device (1e-5 between the port's two ``impl``s and
against JAX's jnp render); steps: loss rel 1e-4, ``xyz`` atol 1e-5,
``xyz_grad_accum`` atol 1e-5 / rtol 1e-3, ``max_radii2d`` exact; the
band-local loss rel 1e-5 of the full-image loss; the exchange's per-band
counts and contents exact; the collectives' backwards within 1e-6 of a
float64 central difference's largest value.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu import train_lib as jtrain_lib
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import preprocess as jpreprocess
from gaussian_splatting_with_eye_tracking_tpu.parallel import make_gauss_sharded_train_step
from gaussian_splatting_with_eye_tracking_tpu.parallel import make_mesh as jmake_mesh
from gaussian_splatting_with_eye_tracking_tpu.parallel import make_sharded_train_step
from gaussian_splatting_with_eye_tracking_tpu.parallel import shard_model_state as jshard
from gaussian_splatting_with_eye_tracking_tpu.parallel import sharded as jsharded
from gaussian_splatting_with_eye_tracking_tpu.parallel import sharded_render as jsharded_render
from gaussian_splatting_with_eye_tracking_tpu_torch import renderer, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import (
    make_camera,
    make_random_gaussians,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import projection
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import collectives as cc
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost, sharded
from tests.helpers import make_camera as jmake_camera
from tests.test_parallel import small_state
from tests.torch_helpers import free_port, start_ranks, wait_ranks

WORLDS = (2, 4)
SEEDS = (0, 1, 2, 3, 4, 5, 11, 12)  # small_state seeds the cases use
CPU = torch.device("cpu")
CAPS = dict(max_instances_per_band=1 << 11, max_per_tile=64)
SINGLE = dict(max_instances=1 << 12)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_refs():
    """JAX's sharded results on the virtual CPU devices, impl="jnp"."""
    refs = {}
    state0, _, _ = small_state(seed=0)

    def render(n, state, cam, bg):  # jitted: shard_map runs op by op otherwise
        return np.asarray(jax.jit(lambda s, b: jsharded_render(
            jmake_mesh(n), s, cam, b, max_sh_degree=0, impl="jnp", **CAPS)[0])(state, bg))

    for n in WORLDS:
        refs[f"render{n}"] = render(n, state0, jmake_camera(64, 32 * n),
                                    jnp.array([0.3, 0.2, 0.1]))
    refs["uneven"] = render(4, small_state(seed=1)[0], jmake_camera(64, 96), jnp.zeros(3))
    for n in WORLDS:
        h = 32 * n
        cam_args = jtrain_lib.camera_arrays(jmake_camera(64, h))
        gt = jnp.full((3, h, 64), 0.4)
        state, tx, opt = small_state(seed=2)
        step = make_sharded_train_step(jmake_mesh(n), tx, opt, max_sh_degree=0, width=64,
                                       height=h, impl="jnp", **CAPS)
        state, aux = step(state, *cam_args, gt, jnp.zeros(3), True)
        refs[f"band{n}"] = {"loss": float(aux["loss"]), "xyz": np.asarray(state.params.xyz),
                            "xyz_grad_accum": np.asarray(state.xyz_grad_accum)}
        state, tx, opt = small_state(seed=4)
        mesh = jmake_mesh(n, axis="gauss")
        step = make_gauss_sharded_train_step(mesh, tx, opt, max_sh_degree=0, width=64,
                                             height=h, impl="jnp", **CAPS)
        state, aux = step(jshard(mesh, state), *cam_args, gt, jnp.array([0.1, 0.0, 0.2]), True)
        refs[f"gauss{n}"] = {"loss": float(aux["loss"]), "xyz": np.asarray(state.params.xyz),
                             "xyz_grad_accum": np.asarray(state.xyz_grad_accum),
                             "max_radii2d": np.asarray(state.max_radii2d)}
    state, tx, opt = small_state(seed=11)
    step = make_sharded_train_step(jmake_mesh(4), tx, opt, max_sh_degree=0, width=64,
                                   height=100, impl="jnp", **CAPS)
    gt = jnp.asarray(np.random.default_rng(5).uniform(size=(3, 100, 64)), jnp.float32)
    _, aux = step(state, *jtrain_lib.camera_arrays(jmake_camera(64, 100)), gt,
                  jnp.array([0.3, 0.1, 0.2]), True)
    refs["crop_band"] = {k: float(aux[k]) for k in ("loss", "l1", "psnr")}
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the states, JAX's references, {world: [each rank's results]}):
    the ranks run while JAX computes."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    states = {s: gm.state_from_jax(jax.device_get(small_state(seed=s)[0]), device="cpu")
              for s in SEEDS}
    inputs = str(tmp / "inputs.pt")
    torch.save({s: ckpt.state_to_dict(st) for s, st in states.items()}, inputs)
    worker = os.path.join(os.path.dirname(__file__), "torch_multiproc_worker.py")
    procs = {}
    for world in WORLDS:
        out = tmp / f"w{world}"
        out.mkdir()
        port = free_port()
        procs[world] = (out, start_ranks([
            ["python", worker, str(port), str(r), str(world), inputs, str(out)]
            for r in range(world)]))
    refs = _jax_refs()
    results = {}
    for world, (out, ps) in procs.items():
        wait_ranks(ps, timeout=120)
        results[world] = [torch.load(out / f"rank{r}.pt", weights_only=False)
                          for r in range(world)]
        results[world][0]["dir"] = str(out)
    return states, refs, results


def _opt():
    opt = OptimizationConfig()
    return opt, gm.make_optimizer(opt, 1.0)


def _single_steps(state, h, gt_value, bg, n=2):
    """The port's single-device step, ``n`` times: [(loss, state)]."""
    opt, tx = _opt()
    step = train_lib.make_train_step(tx, opt, 0, 64, h, device="cpu", **SINGLE)
    cam_args = train_lib.camera_arrays(make_camera(64, h, device=CPU))
    gt = torch.full((3, h, 64), gt_value)
    out = []
    for _ in range(n):
        state, aux = step(state, *cam_args, gt, bg, True)
        out.append((float(aux.loss), state))
    return out


def _close_step(got, want_loss, want_state, xyz_atol=1e-5):
    assert got["loss"] == pytest.approx(want_loss, rel=1e-4)
    np.testing.assert_allclose(got["xyz"], np.asarray(want_state["xyz"]), atol=xyz_atol)
    np.testing.assert_allclose(got["xyz_grad_accum"], np.asarray(want_state["xyz_grad_accum"]),
                               atol=1e-5, rtol=1e-3)


def _as_numpy(state):
    return {"xyz": state.params.xyz.numpy(), "xyz_grad_accum": state.xyz_grad_accum.numpy(),
            "max_radii2d": state.max_radii2d.numpy()}


# --- the render -------------------------------------------------------------


@pytest.mark.parametrize("impl", ["kernels", "jnp"])
@pytest.mark.parametrize("world", WORLDS)
def test_render_matches_single_device(run, world, impl):
    states, refs, results = run
    bg = torch.tensor([0.3, 0.2, 0.1])
    with torch.no_grad():
        want = renderer.render(make_camera(64, 32 * world, device=CPU), states[0], bg,
                               max_sh_degree=0, impl=impl, max_per_tile=64, **SINGLE)
    for res in results[world]:
        got = res[f"render_{impl}"]
        np.testing.assert_allclose(got["color"], want.color, atol=2e-5, rtol=1e-3)
        np.testing.assert_array_equal(got["radii"], want.radii)
        assert not got["overflow"].any() and got["overflow"].shape == (world,)
    # against JAX's sharded render, and the port's two impls against each other
    np.testing.assert_allclose(results[world][0][f"render_{impl}"]["color"],
                               refs[f"render{world}"], atol=1e-5)
    np.testing.assert_allclose(results[world][0]["render_kernels"]["color"],
                               results[world][0]["render_jnp"]["color"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_render_uneven_grid_rows(run, world):
    """96 rows are 3 tile rows: over 2 or 4 bands the last band is padding."""
    states, refs, results = run
    with torch.no_grad():
        want = renderer.render(make_camera(64, 96, device=CPU), states[1], torch.zeros(3),
                               max_sh_degree=0, impl="jnp", max_per_tile=64, **SINGLE)
    np.testing.assert_allclose(results[world][0]["uneven"], want.color, atol=2e-5, rtol=1e-3)
    np.testing.assert_allclose(results[world][0]["uneven"], refs["uneven"], atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_render_of_saturated_tiles_equals_single_device(run, world):
    """Every tile stops at the early exit (every pixel's T under 1e-4 after
    a whole chunk of 128). Each band's list starts with empty lanes up to
    where the whole image's list has its first tile, so its chunks, and
    the exit, fall as on one device: the render is bit-equal."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_multiproc_worker import saturated_state

    with torch.no_grad():
        want = renderer.render(make_camera(64, 32 * world, device=CPU), saturated_state(),
                               torch.zeros(3), max_sh_degree=0, max_instances=1 << 16)
    tiles = want.final_t.reshape(world, 32, 2, 32).amax(dim=(1, 3))
    assert (tiles[1:] < 1e-4).any(), "the scene must hold exit tiles past the first band"
    for res in run[2][world]:
        got = res["saturated"]
        assert not got["overflow"].any()
        np.testing.assert_array_equal(got["color"], want.color)
        np.testing.assert_array_equal(got["final_t"], want.final_t)


# --- the tile-band train step ------------------------------------------------


@pytest.mark.parametrize("impl", ["kernels", "jnp"])
@pytest.mark.parametrize("world", WORLDS)
def test_band_step_matches_single_device(run, world, impl):
    states, refs, results = run
    single = _single_steps(states[2], 32 * world, 0.4, torch.zeros(3))
    for res in results[world]:  # every rank holds the same replicated state
        for got, (loss, st) in zip(res[f"band_{impl}"], single):
            _close_step(got, loss, _as_numpy(st))
            assert not got["overflow"]
        _close_step(res[f"band_{impl}"][0], refs[f"band{world}"]["loss"], refs[f"band{world}"])


@pytest.mark.parametrize("world", WORLDS)
def test_band_steps_lower_the_loss(run, world):
    losses = run[2][world][0]["converge_band"]
    assert len(losses) == 20 and losses[-1] < losses[0], losses


@pytest.mark.parametrize("world", WORLDS)
def test_band_loss_matches_full_image_loss(run, world):
    """h = 100 crops the last band; the band-local loss (SSIM halo, masks)
    equals the gathered full image's."""
    _, refs, results = run
    band, full = results[world][0]["crop_band"], results[world][0]["crop_full"]
    for key in ("loss", "l1", "psnr"):
        assert band[key] == pytest.approx(full[key], rel=1e-5), key
        assert band[key] == pytest.approx(refs["crop_band"][key], rel=1e-5), key
    np.testing.assert_allclose(band["xyz"], full["xyz"], atol=1e-6)
    np.testing.assert_allclose(band["xyz_grad_accum"], full["xyz_grad_accum"],
                               atol=1e-6, rtol=1e-4)


# --- the gaussian-sharded train step -----------------------------------------


@pytest.mark.parametrize("impl", ["kernels", "jnp"])
@pytest.mark.parametrize("world", WORLDS)
def test_gauss_step_matches_single_device(run, world, impl):
    states, refs, results = run
    single = _single_steps(states[4], 32 * world, 0.4, torch.tensor([0.1, 0.0, 0.2]))
    cap = states[4].params.xyz.shape[0]
    for res in results[world]:
        for got, (loss, st) in zip(res[f"gauss_{impl}"], single):
            want = _as_numpy(st)
            _close_step(got, loss, want)
            np.testing.assert_array_equal(got["max_radii2d"], want["max_radii2d"])
            assert got["local_rows"] == cap // world and not got["overflow"]
        first, ref = res[f"gauss_{impl}"][0], refs[f"gauss{world}"]
        _close_step(first, ref["loss"], ref)
        np.testing.assert_array_equal(first["max_radii2d"], ref["max_radii2d"])


@pytest.mark.parametrize("world", WORLDS)
def test_gauss_state_stays_sharded_across_steps(run, world):
    res = run[2][world][0]
    assert res["converge_gauss"][-1] < res["converge_gauss"][0]
    assert res["converge_gauss_rows"] == 64 // world


@pytest.mark.parametrize("world", WORLDS)
def test_gauss_band_loss_matches_full_image_loss(run, world):
    band, full = run[2][world][0]["gauss_loss_band"], run[2][world][0]["gauss_loss_full"]
    assert band["loss"] == pytest.approx(full["loss"], rel=1e-5)
    assert band["psnr"] == pytest.approx(full["psnr"], rel=1e-4)


def test_shard_model_state_rejects_indivisible():
    state = gm.state_from_jax(jax.device_get(small_state(n=5, cap=8)[0]), device="cpu")
    mesh = cc.Mesh(None, "gauss", 3, 0, CPU)
    with pytest.raises(ValueError):
        sharded.shard_model_state(mesh, state)


# --- the band exchange ------------------------------------------------------


def _scene(n, seed, giant=False, dead=False, **kw):
    means, scales, quats, op, sh = (torch.from_numpy(a) for a in
                                    make_random_gaussians(n, seed=seed, **kw))
    if giant:
        scales[:32] = 1.2
    if dead:
        means[::3, 2] = -10.0
    return means, scales, quats, op, sh


def _truth(n, seed, world, **kw):
    """The port's preprocess of the whole scene, and which rows meet each
    band (one tile row per band at 32*world rows)."""
    means, scales, quats, op, sh = _scene(n, seed, **kw)
    prep = projection.preprocess(means, scales, quats, op, sh, 0,
                                 make_camera(64, 32 * world, device=CPU), tile=32)
    live = (prep.tiles_touched > 0).numpy()
    lo, hi = prep.rect_min[:, 1].numpy(), prep.rect_max[:, 1].numpy() - 1
    return prep, live, [live & (lo <= d) & (hi >= d) for d in range(world)]


def _received(results, key, world):
    recv = [res[key]["recv"].numpy() for res in results[world]]
    return recv, np.array([(r[:, 15] > 0.5).sum() for r in recv])


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_counts_and_contents_per_band(run, world):
    n = 1024
    prep, live, inter = _truth(n, 21, world)
    recv, counts = _received(run[2], "exchange", world)
    assert not any(res["exchange"]["overflow"] for res in run[2][world])
    for d in range(world):
        assert counts[d] == inter[d].sum(), (d, counts[d], inter[d].sum())
        got = np.sort(recv[d][recv[d][:, 15] > 0.5][:, 0])
        np.testing.assert_array_equal(got, np.sort(prep.means2d[inter[d], 0].numpy()))
    # each rank holds the rows of its band, far below the scene's (the
    # scene sits in the middle bands: 61 % and 55 % of it at 2 and 4)
    assert counts.max() < 0.65 * n, counts
    assert counts.sum() >= live.sum()
    # the same per-band counts as JAX's preprocess of the scene
    jprep = jax.tree.map(np.asarray, jpreprocess(
        *make_random_gaussians(n, seed=21), 0, jmake_camera(64, 32 * world), tile=32))
    jlive = jprep.tiles_touched > 0
    for d in range(world):
        assert counts[d] == (jlive & (jprep.rect_min[:, 1] <= d)
                             & (jprep.rect_max[:, 1] - 1 >= d)).sum()


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_with_dead_rows_between_live_ones(run, world):
    """Every third gaussian behind the camera: the port routes each live
    row to its bands exactly. JAX's ``_band_exchange`` marks only live
    rows' first slots, so after a dead row its slots name the wrong
    gaussian (ROADMAP §C): its bands miss live rows."""
    n, cap = 1024, 512
    prep, live, inter = _truth(n, 22, world, dead=True)
    assert not live[::3].any() and live[1::3].any()
    recv, counts = _received(run[2], "dead_rows", world)
    for d in range(world):
        assert counts[d] == inter[d].sum()
        got = np.sort(recv[d][recv[d][:, 15] > 0.5][:, 0])
        np.testing.assert_array_equal(got, np.sort(prep.means2d[inter[d], 0].numpy()))

    from jax.sharding import PartitionSpec as P

    mesh = jmake_mesh(world, axis="gauss")
    cam = jmake_camera(64, 32 * world)

    def dev_fn(m, s, q, o, shh):
        jprep = jpreprocess(m, s, q, o, shh, 0, cam, tile=32)
        return jsharded._band_exchange(jprep, "gauss", world, 1, cap)[0]

    jrecv = np.asarray(jax.jit(jax.shard_map(
        dev_fn, mesh=mesh, in_specs=(P("gauss"),) * 5, out_specs=P("gauss"),
        check_vma=False))(*(a.numpy() for a in _scene(n, 22, dead=True))))
    jrecv = jrecv.reshape(world, world * cap, 16)
    jax_sets = [np.sort(r[r[:, 15] > 0.5][:, 0]) for r in jrecv]
    truth = [np.sort(prep.means2d[inter[d], 0].numpy()) for d in range(world)]
    assert any(a.shape != b.shape or not np.allclose(a, b, atol=1e-3)
               for a, b in zip(jax_sets, truth))


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_all_band_spanners(run, world):
    """Giant gaussians span every band: each reaches all of them; a
    multicast bound of one band per gaussian flags the overflow on every
    rank instead of truncating."""
    _, live, inter = _truth(512, 31, world, giant=True)
    recv, counts = _received(run[2], "spanners", world)
    assert not any(res["spanners"]["overflow"] for res in run[2][world])
    spans = np.sum(inter, axis=0)
    assert spans.max() == world, "the scene must hold all-band spanners"
    for d in range(world):
        assert counts[d] == inter[d].sum()
    assert counts.sum() == spans.sum() > live.sum()
    assert all(res["spanners_bound"]["overflow"] for res in run[2][world])


@pytest.mark.parametrize("world", WORLDS)
def test_exchange_large_n_stays_band_local(run, world):
    n = 8192
    _, live, _ = _truth(n, 32, world, scale_range=(-5.0, -3.5))
    _, counts = _received(run[2], "large_n", world)
    assert not any(res["large_n"]["overflow"] for res in run[2][world])
    assert counts.sum() >= live.sum()
    assert counts.max() < 0.65 * n, counts


def test_exchange_packed_key_overflow_raises():
    """(n_bands, n_local) whose packed key needs more than 31 bits raises
    before anything is allocated."""
    big = 1 << 29
    meta = torch.empty((big, 2), device="meta")
    prep = projection.Preprocessed(
        means2d=meta, depths=meta[:, 0], conics=meta, rgb=meta, opacities=meta[:, 0],
        radii=meta[:, 0], tiles_touched=meta[:, 0], rect_min=meta, rect_max=meta,
        cull_thr=meta[:, 0])
    with pytest.raises(ValueError, match="key overflow"):
        sharded._band_exchange(prep, cc.Mesh(None, "gauss", 1, 0, CPU), 8, 1, 16)


@pytest.mark.parametrize("n_local,n_bands,cap_exch,bound", [
    (78_125, 64, 2_048, 4),  # 5M gaussians over 64 devices (config 5)
    (78_125, 64, 2_048, 0),
    (1 << 16, 8, (int(1.3 * (1 << 16) / 8) + 256), 4),
    (262_144, 2, 262_144, 0),  # the card's two ranks (chip_smoke)
    (1000, 1, 1000, 0),
])
def test_exchange_memory_bytes_is_jax_arithmetic(n_local, n_bands, cap_exch, bound):
    assert sharded.exchange_memory_bytes(n_local, n_bands, cap_exch, bound) == \
        jsharded.exchange_memory_bytes(n_local, n_bands, cap_exch, bound)


# --- the collectives ----------------------------------------------------------


@pytest.mark.parametrize("name", ["psum", "halo", "all_to_all", "all_gather"])
@pytest.mark.parametrize("world", WORLDS)
def test_collective_backward_matches_finite_difference(run, world, name):
    for res in run[2][world]:
        errs = res["collectives"]
        assert errs[name + "_scale"] > 0.1
        assert errs[name] <= 1e-6 * errs[name + "_scale"], errs


def test_one_rank_mesh_without_a_group():
    mesh = sharded.make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(cc.psum(x, mesh), x)
    assert torch.equal(cc.all_gather(x, mesh, dim=1), x)
    up, down = cc.ppermute_halo(x[:1], x[1:], mesh)
    assert not up.any() and not down.any()


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_of_the_first_ranks(run, world):
    """make_mesh(1) among several ranks: rank 0 alone is on it."""
    for r, res in enumerate(run[2][world]):
        assert res["submesh"] == {"size": 1, "rank": 0 if r == 0 else -1}


# --- multihost ----------------------------------------------------------------


def test_maybe_initialize_distributed_without_settings(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_matches_single_process(run, world):
    """The ranks' band step on a state broadcast from rank 0 (the others
    start from garbage) and gauss step on shard_to_mesh's rows, two steps
    each, against one process on a one-rank mesh."""
    states = run[0]
    opt, tx = _opt()
    h = 32 * world
    cam_args = train_lib.camera_arrays(make_camera(64, h, device=CPU))
    gt = torch.full((3, h, 64), 0.4)
    mesh = sharded.make_mesh(device="cpu")
    want = {}
    for kind, seed, make in (("band", 2, sharded.make_sharded_train_step),
                             ("gauss", 4, sharded.make_gauss_sharded_train_step)):
        step = make(mesh, tx, opt, 0, 64, h, impl="jnp", **CAPS)
        state, losses = states[seed], []
        for _ in range(2):
            state, aux = step(state, *cam_args, gt, torch.zeros(3), True)
            losses.append(float(aux["loss"]))
        want[kind] = (losses, state)
    for res in run[2][world]:
        got = res["multihost"]
        np.testing.assert_allclose(got["band_losses"], want["band"][0], rtol=1e-5)
        np.testing.assert_allclose(got["band_xyz_abs_sum"],
                                   float(want["band"][1].params.xyz.abs().sum()), rtol=1e-5)
        np.testing.assert_allclose(got["band_accum_abs_sum"],
                                   float(want["band"][1].xyz_grad_accum.abs().sum()), rtol=1e-4)
        np.testing.assert_allclose(got["gauss_losses"], want["gauss"][0], rtol=1e-5)
        np.testing.assert_allclose(got["gauss_xyz_abs_sum"],
                                   float(want["gauss"][1].params.xyz.abs().sum()), rtol=1e-5)
        assert got["local_shard_rows"] == 64 // world


# --- checkpoints --------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_gauss_sharded_checkpoint_loads_in_one_process(run, world):
    res = run[2][world][0]
    path = os.path.join(res["dir"], "ckpt_gauss", "chkpnt7.shards")
    assert ckpt.latest_checkpoint(os.path.dirname(path)) == path
    meta = ckpt.checkpoint_meta(path)
    assert meta["layout"] == "sharded" and meta["world_size"] == world
    assert meta["rows"] == [[r * 64 // world, (r + 1) * 64 // world] for r in range(world)]
    state, it = ckpt.load_checkpoint_dist(path, device="cpu")
    assert it == 7 and state.params.xyz.shape == (64, 3)
    full = res["ckpt_gauss_full"]
    for got, want in ((state.params.xyz, full["xyz"]), (state.params.f_dc, full["f_dc"]),
                      (state.opt_state.mu.opacity, full["mu_opacity"]),
                      (state.active, full["active"]), (state.denom, full["denom"])):
        assert torch.equal(got, want)
    assert state.opt_state.count == 2


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_checkpoint_written_once(run, world):
    res = run[2][world][0]
    path = os.path.join(res["dir"], "ckpt_band", "chkpnt3.shards")
    meta = ckpt.checkpoint_meta(path)
    assert meta["layout"] == "replicated" and meta["rows"] == [[0, 64]]
    assert sorted(os.listdir(path)) == ["meta.pt", "shard0.pt"]
    # every rank's state hashed alike: the replicas agree bit for bit
    assert len(meta["digests"]) == world and len(set(meta["digests"])) == 1
    state, it = ckpt.load_checkpoint_dist(path, device="cpu")
    assert it == 3 and torch.equal(state.params.xyz, res["ckpt_band_xyz"])


def test_latest_checkpoint_picks_shards_and_skips_sidecars(tmp_path):
    (tmp_path / "chkpnt5.ckpt").write_bytes(b"")
    (tmp_path / "chkpnt8.shards").mkdir()
    (tmp_path / "chkpnt9.shards.tmp").mkdir()
    (tmp_path / "chkpnt9.orbax.treedef.pkl").write_bytes(b"")
    (tmp_path / "nanstep12.ckpt").write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "chkpnt8.shards")
    (tmp_path / "chkpnt8.ckpt").write_bytes(b"")  # a tie: the single file first
    assert ckpt.latest_checkpoint(str(tmp_path)) == str(tmp_path / "chkpnt8.ckpt")


def test_multi_device_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Like every entry point of the port, the meshes, the distributed
    checkpoint's loader and scaling_bench run on the card unless told
    otherwise, and raise without one."""
    from gaussian_splatting_with_eye_tracking_tpu_torch import scaling_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    path = str(tmp_path / "chkpnt1.shards")
    ckpt.save_checkpoint_dist(path, gm.state_from_jax(jax.device_get(small_state()[0]),
                                                      device="cpu"), 1)
    for call in (sharded.make_mesh, multihost.make_global_mesh,
                 lambda: ckpt.load_checkpoint_dist(path),
                 lambda: scaling_bench.main(["--devices", "1", "--out", str(tmp_path / "s.json")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert ckpt.load_checkpoint_dist(path, device="cpu")[1] == 1
