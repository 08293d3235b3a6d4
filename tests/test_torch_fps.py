"""The port's frame-rate sweep and foveated timing CLI against the JAX
package's root scripts (``fps_test.py``, ``fps_test_amr_foveated.py``), on
the CPU at test scale.

- The sweep's resolutions and cameras equal the root script's
  (``make_camera``), view and projection matrices to 1e-6.
- ``load_or_synthetic --synthetic`` draws the root script's scene: xyz
  and colours exact, log-scales within 1e-5 (the kNN distances in float64
  on both sides, then float32 logs); ``-m`` alone finds the source path
  through the model directory's ``cfg_args``.
- The sweep's images, vanilla and AMR, against JAX's ``rasterize`` /
  ``amr.render_amr`` (``impl="pallas"``, interpret mode) on the same
  1,000-gaussian scene: atol 1e-3, the repository's tolerance between
  implementations.
- A view that overflows the starting capacity renders again at the next
  power of two that holds it: the same image as at a large capacity, and
  the JSON records the capacity.
- The foveated CLI writes the root script's document keys, its
  percentile levels equal JAX's ``fovea_step0`` levels, and it refuses the
  TPU's bf16 alpha modes.

Torch keeps to two threads (the suite runs several workers at once)."""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fps_test as jax_fps_test
from gaussian_splatting_with_eye_tracking_tpu import renderer as jrnd
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu.ops import amr as jamr
from gaussian_splatting_with_eye_tracking_tpu.ops import rasterize as jrast
from gaussian_splatting_with_eye_tracking_tpu_torch import fps_foveated, fps_test, renderer
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig, save_cfg_args
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io as tply
from tests.helpers import make_camera
from tests.test_scene_io import make_colmap_scene
from tests.torch_helpers import assert_close, assert_equal

BASE = (128, 96)
RATIOS = (0.5, 1.0)
CAP = 1 << 14  # the 1,000-gaussian scene enumerates 3,941 tile pairs at 128x96


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _synthetic_args(n):
    return Namespace(synthetic=True, num_gaussians=n, model_path="", source_path="",
                     iteration=-1, data_device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """The 1,000-gaussian synthetic scene of both packages."""
    return jax_fps_test.load_or_synthetic(_synthetic_args(1000)), fps_test.synthetic_scene(
        1000, "cpu")


@pytest.fixture
def one_rep(monkeypatch):
    monkeypatch.setattr(fps_test, "REPS", 1)


def test_sweep_resolutions_and_cameras_match_jax(monkeypatch, tmp_path):
    """The root script's sweep run with its timer stubbed out: every
    resolution it visits and every camera it makes."""
    import tests.helpers

    made = []

    def recording_camera(w, h, **kw):
        made.append(make_camera(w, h, **kw))
        return made[-1]

    monkeypatch.setattr(tests.helpers, "make_camera", recording_camera)
    monkeypatch.setattr(jax_fps_test, "chain_timer", lambda fn, x0, iters=5: 1e-3)
    state, deg, active = jax_fps_test.load_or_synthetic(_synthetic_args(64))
    for amr_mode in (False, True):
        made.clear()
        results = jax_fps_test.run_sweep(state, deg, active, amr_mode=amr_mode,
                                         out_json=str(tmp_path / "jax.json"))
        assert [r["ratio"] for r in results] == list(fps_test.RATIOS)
        for r, cam in zip(results, made, strict=True):
            assert fps_test.sweep_size((1920, 1080), r["ratio"]) == (r["width"], r["height"])
            got = fps_test.sweep_camera(r["width"], r["height"], "cpu")
            assert (got.width, got.height) == (cam.width, cam.height)
            for name in ("viewmatrix", "projmatrix", "campos"):
                assert_close(getattr(got, name), getattr(cam, name), atol=1e-6, msg=name)
            assert abs(got.tan_fovx - cam.tan_fovx) <= 1e-6
            assert abs(got.tan_fovy - cam.tan_fovy) <= 1e-6
    assert (results[0]["width"], results[0]["height"]) == (384, 192)
    assert (results[-1]["width"], results[-1]["height"]) == (3840, 2144)


def test_load_or_synthetic_matches_jax():
    (jstate, jdeg, jact), (tstate, tdeg, tact) = (
        load(_synthetic_args(512)) for load in (jax_fps_test.load_or_synthetic,
                                                fps_test.load_or_synthetic))
    assert jdeg == tdeg == 3 and int(jstate.sh_degree) == tstate.sh_degree == 3
    assert_equal(tact, jact)
    assert int(tact.sum()) == 512 and tstate.params.xyz.shape[0] == jstate.params.xyz.shape[0]
    for name in ("xyz", "f_dc", "f_rest", "rotation", "opacity"):
        assert_equal(getattr(tstate.params, name), getattr(jstate.params, name), msg=name)
    assert_close(tstate.params.scaling, jstate.params.scaling, atol=1e-5)


def test_load_or_synthetic_overlays_cfg_args(tmp_path):
    """``-m`` alone: the source path and the device come from the model
    directory's ``cfg_args`` (the root script reads neither)."""
    root = make_colmap_scene(str(tmp_path / "scene"), n_cams=2, n_pts=20)
    model = str(tmp_path / "model")
    state, _, _ = fps_test.synthetic_scene(40, "cpu")
    params = tgm.GaussianParams(*(x[:40] for x in state.params))
    ply_dir = tmp_path / "model" / "point_cloud" / "iteration_7"
    ply_dir.mkdir(parents=True)
    tply.save_gaussians_ply(str(ply_dir / "point_cloud.ply"), params,
                            torch.ones(40, dtype=torch.bool))
    save_cfg_args(model, ModelConfig(source_path=root, model_path=model, data_device="cpu"))
    args = Namespace(synthetic=False, num_gaussians=0, model_path=model, source_path="",
                     iteration=-1)
    got, deg, active = fps_test.load_or_synthetic(args)
    assert deg == 3 and int(active.sum()) == 40 and got.params.xyz.device.type == "cpu"
    for name in tgm.GaussianParams._fields:
        assert_equal(getattr(got.params, name)[:40], getattr(params, name), msg=name)


def _jax_frame(jstate, deg, jact, w, h, amr_mode):
    """The root script's render body for one resolution, kernels in
    interpret mode."""
    p = jstate.params
    sh = jgm.get_sh(p) * jrnd.sh_band_mask(jstate.sh_degree, deg)[None, None, :]
    args = (p.xyz, jgm.get_scaling(p), p.rotation, jgm.get_opacity(p), sh)
    cam = make_camera(w, h, cam_z=-5.0)
    bg = jnp.zeros(3)
    if amr_mode:
        fn = jax.jit(lambda *a: jamr.render_amr(*a, deg, cam, bg, impl="pallas",
                                                interpret=True, active_mask=jact,
                                                max_instances=CAP)[0])
    else:
        fn = jax.jit(lambda *a: jrast.rasterize(*a, cam, bg, sh_degree=deg, impl="pallas",
                                                max_instances=CAP, active_mask=jact).color)
    return fn(*args)


@pytest.mark.parametrize("amr_mode", [False, True], ids=["vanilla", "amr"])
def test_sweep_images_match_jax(scenes, one_rep, amr_mode, tmp_path):
    """Each resolution's frame as the sweep renders it
    (``render_at_capacity``) against the root script's render body."""
    (jstate, jdeg, jact), (tstate, tdeg, tact) = scenes
    out = tmp_path / "fps.json"
    results = fps_test.run_sweep(tstate, tdeg, tact, base=BASE, ratios=RATIOS,
                                 amr_mode=amr_mode, out_json=str(out), max_instances=CAP,
                                 device="cpu", card_line=fps_test.card(torch.device("cpu")))
    doc = json.loads(out.read_text())
    assert doc["amr"] is amr_mode and doc["results"] == results and doc["card"] == "cpu"
    assert [(r["width"], r["height"]) for r in results] == [(64, 32), (128, 96)]
    args = renderer.activated(tstate, tdeg)
    for r in results:
        w, h = r["width"], r["height"]
        assert r["capacity"] == CAP and 0 < r["instances"] <= r["enumerated"] <= CAP
        assert np.isfinite(r["ms"]) and r["fps"] == pytest.approx(1e3 / r["ms"])
        got, cap, n, enum = fps_test.render_at_capacity(
            args, tdeg, tact, fps_test.sweep_camera(w, h, "cpu"), torch.zeros(3), CAP, amr_mode)
        assert (cap, n, enum) == (r["capacity"], r["instances"], r["enumerated"])
        assert got.shape == (3, h, w) and float(got.max()) > 0
        assert_close(got, _jax_frame(jstate, jdeg, jact, w, h, amr_mode), atol=1e-3)


@pytest.mark.parametrize("amr_mode", [False, True], ids=["vanilla", "amr"])
def test_sweep_regrows_an_overflowing_capacity(scenes, one_rep, amr_mode, tmp_path):
    _, (tstate, tdeg, tact) = scenes
    out = tmp_path / "fps.json"
    (r,) = fps_test.run_sweep(tstate, tdeg, tact, base=BASE, ratios=[1.0], amr_mode=amr_mode,
                              out_json=str(out), max_instances=256, device="cpu")
    assert r["enumerated"] > 256 and r["capacity"] == tgm.next_pow2(r["enumerated"] + 1)
    assert json.loads(out.read_text())["results"][0]["capacity"] == r["capacity"]
    args = renderer.activated(tstate, tdeg)
    cam = fps_test.sweep_camera(*BASE, "cpu")
    grown = fps_test.render_at_capacity(args, tdeg, tact, cam, torch.zeros(3), 256, amr_mode)
    want = fps_test.render_at_capacity(args, tdeg, tact, cam, torch.zeros(3), CAP, amr_mode)
    assert grown[1:] == (r["capacity"], r["instances"], r["enumerated"])
    assert want[1:] == (CAP, r["instances"], r["enumerated"])
    assert torch.equal(grown[0], want[0])


@pytest.mark.parametrize("gaze", [False, True], ids=["percentile", "gaze"])
def test_foveated_cli_writes_the_root_document(scenes, one_rep, gaze, tmp_path):
    out = tmp_path / "fov.json"
    argv = ["--synthetic", "--num_gaussians", "1000", "--width", "96", "--height", "72",
            "--max_instances", str(CAP), "--data_device", "cpu", "--out_json", str(out)]
    doc = fps_foveated.main(argv + (["--gaze", "--decimate", "4", "2", "1", "1"] if gaze
                                    else []))
    assert json.loads(out.read_text()) == doc
    keys = {"steps_protocol", "steps_protocol_total_ms", "fused_ms", "fused_fps",
            "plain_forward_ms", "plain_forward_fps", "fused_vs_plain",
            "fused_undecimated_vs_plain"}
    if gaze:
        keys |= {"decimation", "fused_decimated_ms", "fused_decimated_fps",
                 "fused_predecimated_ms", "fused_predecimated_fps"}
    assert keys <= set(doc)
    assert [s["step"] for s in doc["steps_protocol"]] == [0, 1, 2, 3, 4]
    assert doc["steps_protocol_total_ms"] == pytest.approx(
        sum(s["ms"] for s in doc["steps_protocol"]))
    assert doc["levels"] == ("gaze+percentile" if gaze else "percentile(25/50/90)")
    assert doc["width"] == 96 and doc["height"] == 72 and doc["capacity"] == CAP
    assert sum(doc["level_histogram"]) == 3 * 3
    if not gaze:
        jstate, deg, jact = scenes[0]
        p = jstate.params
        sh = jgm.get_sh(p) * jrnd.sh_band_mask(jstate.sh_degree, deg)[None, None, :]
        levels = jax.jit(lambda *a: jamr.fovea_step0(
            *a, deg, make_camera(96, 72, cam_z=-5.0), active_mask=jact,
            max_instances=CAP).tile_levels)(
            p.xyz, jgm.get_scaling(p), p.rotation, jgm.get_opacity(p), sh)
        want = np.bincount(np.asarray(levels), minlength=5)[1:].tolist()
        assert doc["level_histogram"] == want and len(set(want) - {0}) >= 2


@pytest.mark.parametrize("mode", ["bf16", "bf16x"])
def test_foveated_cli_refuses_bf16_alpha(mode, capsys):
    with pytest.raises(SystemExit) as exc:
        fps_foveated.main(["--synthetic", "--data_device", "cpu", "--alpha", mode])
    assert exc.value.code == 2 and "pallas_blend.py:291-294" in capsys.readouterr().err
