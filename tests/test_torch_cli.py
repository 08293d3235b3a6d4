"""The port's train -> render -> metrics CLIs against the JAX package's, on
the CPU (``--data_device cpu``), at test scale.

- 6 training steps of both packages on the same 4-camera COLMAP scene
  (densify off, instance capacity 4096 in both, which nothing overflows):
  equal ``cameras.json`` and active counts; Adam moments within 1e-3 of
  the field's largest value (rtol 5e-3 for mu, 1e-2 for nu): the train
  step's 1e-4 holds after one step (measured 2.7e-5), and each later step
  feeds the parameters' differences back into the gradients (measured
  2.7e-4 after six); parameters within 6
  learning-rate steps of their group (Adam's first steps are sign steps,
  so a gradient at rounding level can move a parameter by a whole step
  either way) and 99 % of them within atol 1e-5 / rtol 1e-3. The JAX CLI
  renders through its ``impl="jnp"`` path on the CPU, whose per-pixel
  stop differs from the chunk exit only in saturated tiles; this scene's
  opacities start at 0.1.
- The port's render CLI on the JAX-trained model directory writes PNGs
  within 1 level of 255 of JAX's render CLI, at most 0.1 % of values at 2.
- PLY snapshots load unchanged in the other package.
- A 30-step port CLI run with densify from step 10 writes cfg_args,
  cameras.json, the PLY and the checkpoint, resumes from the checkpoint,
  and renders and scores (PSNR > 5); the overflow redo; the failures.
- LPIPS's arithmetic with seeded random weights within 1e-5 of JAX's.
- track_render's main on the 30-step model: the gaze within 1 px of
  JAX's, each 5-step foveated render within 1/255 + 1e-3 of JAX's.
- RITnet: both ``train_ritnet`` mains for one epoch from one JAX-written
  init ``.npz`` with the same seed on a small synthetic OpenEDS-style
  folder (the same batches): the printed loss within rtol 1e-5 (measured
  5e-7), the validation mIoU within 2e-3 (measured 1e-4: the untrained
  model's logits reach thousands, where JAX's float32 gradients depart
  from float64 by 1.4e-4 of their largest value and a few near-zero ones
  turn Adam's sign step, ``tests/test_torch_ritnet_train.py``); each
  package's ``.npz`` loads in the other. ``eval_ritnet`` with the vendored
  weights: label maps equal on all but 0.1 % of pixels (measured 0), the
  same mIoU line; a ``module.``-prefixed torch ``.pkl`` loads into both
  packages as the same arrays.
- ``full_eval``: the commands equal JAX's one for one with the port's
  module paths, and each parses under the port's own CLI.
- ``convert``: the missing-colmap exit, and with a stand-in ``colmap`` on
  PATH the same COLMAP calls, sparse layout and LANCZOS downscales as JAX.
"""

import json
import os
import re
import shlex
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke as cs
import convert as jax_convert
import eval_ritnet as jax_eval_ritnet
import full_eval as jax_full_eval
import render as jax_render_cli
import track_render as jax_track_render
import train as jax_train_cli
import train_ritnet as jax_train_ritnet
from gaussian_splatting_with_eye_tracking_tpu import metrics_lib as jmetrics
from gaussian_splatting_with_eye_tracking_tpu.config import ModelConfig as JModelConfig
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.config import PipelineConfig as JPipe
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu.models import ply_io as jply
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet as jrit
from gaussian_splatting_with_eye_tracking_tpu.ops import amr as jamr
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import CameraParams as JCameraParams
from gaussian_splatting_with_eye_tracking_tpu_torch import (
    convert,
    eval_ritnet,
    full_eval,
    metrics,
    metrics_lib,
    render,
    track_render,
    train,
    train_ritnet,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.config import ModelConfig, OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io as tply
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet as trit
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.dataset_readers import (
    detect_and_read_scene,
)
from tests.test_scene_io import make_colmap_scene
from tests.torch_helpers import assert_equal

STEPS = 6
CAP = 4096  # instance capacity and bucket of the parity runs
FIELDS = tgm.GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several worker processes on one machine: this file's
    CPU plain paths keep to two threads so that they do not crowd the
    other workers out (at 8 threads each, torch's spinning workers
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _levels(path):
    """An 8-bit RGB image file as int (H, W, 3)."""
    with Image.open(path) as im:
        assert im.mode == "RGB", path
        return np.asarray(im).astype(int)


def _cli(fn, argv):
    """A CLI's main with sys.stdout restored after it (the CLIs timestamp
    or silence it for the rest of the process)."""
    saved = sys.stdout
    try:
        return fn(argv)
    finally:
        sys.stdout = saved


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both packages trained STEPS steps on one scene; JAX's model dir is
    also rendered by JAX's CLI (once per module)."""
    root = make_colmap_scene(str(tmp_path_factory.mktemp("scene")), n_cams=4, n_pts=150)
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_model", "port_model"))
    common = dict(testing_iterations=[], saving_iterations=[STEPS],
                  checkpoint_iterations=[STEPS], start_checkpoint=None, quiet=True,
                  instance_capacity=CAP, capacity_bucket=CAP)
    _, jstate = jax_train_cli.training(
        JModelConfig(source_path=root, model_path=jdir, eval=True),
        JOpt(iterations=STEPS, densify_from_iter=100), JPipe(), **common)
    _, tstate, log = train.training(
        ModelConfig(source_path=root, model_path=tdir, eval=True, data_device="cpu"),
        OptimizationConfig(iterations=STEPS, densify_from_iter=100), **common)
    rdir = str(tmp_path_factory.mktemp("jax_model_port_render"))
    shutil.copytree(jdir, rdir, dirs_exist_ok=True)
    _cli(jax_render_cli.main, ["-m", jdir, "--quiet", "--iteration", str(STEPS)])
    return dict(root=root, jdir=jdir, tdir=tdir, rdir=rdir, jstate=jstate, tstate=tstate,
                log=log)


def test_training_matches_jax(parity):
    with open(os.path.join(parity["jdir"], "cameras.json")) as f:
        want = json.load(f)
    with open(os.path.join(parity["tdir"], "cameras.json")) as f:
        assert json.load(f) == want
    assert len(want) == 4
    ts, js = parity["tstate"], tgm.state_from_jax(parity["jstate"], device="cpu")
    assert_equal(ts.active, js.active)
    assert int(ts.active.sum()) == 150 and ts.opt_state.count == js.opt_state.count == STEPS
    extent = detect_and_read_scene(parity["root"], eval_split=True).nerf_norm_radius
    tx = tgm.make_optimizer(OptimizationConfig(), extent)  # xyz's lr scales with the extent
    for name in FIELDS:
        mu, nu = getattr(ts.opt_state.mu, name), getattr(ts.opt_state.nu, name)
        jmu, jnu = getattr(js.opt_state.mu, name), getattr(js.opt_state.nu, name)
        assert (jmu.abs().max() > 0) == (name != "f_rest"), name  # SH degree 0 for 6 steps
        torch.testing.assert_close(mu, jmu, atol=1e-3 * float(jmu.abs().max()), rtol=5e-3,
                                   msg=name)
        torch.testing.assert_close(nu, jnu, atol=1e-3 * float(jnu.abs().max()), rtol=1e-2,
                                   msg=name)
        p, jp = getattr(ts.params, name), getattr(js.params, name)
        assert float((p - jp).abs().max()) <= 6 * tx.lr(name, 0), name
        close = (p - jp).abs() <= 1e-5 + 1e-3 * jp.abs()
        assert float(close.float().mean()) >= 0.99, (name, float(close.float().mean()))


def test_render_cli_on_jax_model_matches_jax(parity):
    """The port renders JAX's model dir (its cfg_args says data_device
    'tpu', which the command line overrides)."""
    with pytest.raises(ValueError, match="data_device 'tpu'"):
        _cli(render.main, ["-m", parity["rdir"], "--quiet", "--iteration", str(STEPS)])
    _cli(render.main, ["-m", parity["rdir"], "--quiet", "--iteration", str(STEPS),
                       "--data_device", "cpu"])
    n = 0
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            sub = os.path.join(split, f"ours_{STEPS}", kind)
            names = sorted(os.listdir(os.path.join(parity["jdir"], sub)))
            assert names == sorted(os.listdir(os.path.join(parity["rdir"], sub)))
            for fname in names:
                want = _levels(os.path.join(parity["jdir"], sub, fname))
                got = _levels(os.path.join(parity["rdir"], sub, fname))
                diff = np.abs(got - want)
                assert diff.max() <= 2 and (diff == 2).mean() <= 1e-3, (sub, fname)
                if kind == "gt":
                    assert_equal(torch.from_numpy(got), want)
                n += 1
    assert n == 8  # 3 train and 1 test view, renders and ground truth


def test_ply_snapshots_load_in_both_packages(parity):
    tply_path = os.path.join(parity["tdir"], "point_cloud", f"iteration_{STEPS}",
                             "point_cloud.ply")
    jply_path = os.path.join(parity["jdir"], "point_cloud", f"iteration_{STEPS}",
                             "point_cloud.ply")
    ts, js = parity["tstate"], parity["jstate"]
    for path in (tply_path, jply_path):
        want, deg = jply.load_gaussians_ply(path)
        got, tdeg = tply.load_gaussians_ply(path, device="cpu")
        assert deg == tdeg == 3
        for name in FIELDS:
            assert_equal(getattr(got, name), getattr(want, name), msg=name)
    got, _ = jply.load_gaussians_ply(tply_path)
    act = ts.active
    for name in FIELDS:
        assert_equal(getattr(ts.params, name)[act], getattr(got, name), msg=name)
    want, _ = tply.load_gaussians_ply(jply_path, device="cpu")
    jact = np.asarray(js.active)
    for name in FIELDS:
        assert_equal(getattr(want, name), np.asarray(getattr(js.params, name))[jact], msg=name)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 30-step run of the port's train CLI with densify from step 10."""
    root = make_colmap_scene(str(tmp_path_factory.mktemp("scene30")), n_cams=8, n_pts=200)
    model = str(tmp_path_factory.mktemp("model30"))
    _, _, log = _cli(train.main, [
        "-s", root, "-m", model, "--iterations", "30", "--test_iterations", "20",
        "--save_iterations", "30", "--checkpoint_iterations", "30", "--eval",
        "--disable_viewer", "--quiet", "--densify_from_iter", "10",
        "--densification_interval", "10", "--data_device", "cpu"])
    return root, model, log


def test_cli_run_writes_its_outputs(cli_run):
    root, model, log = cli_run
    for rel in ("cfg_args", "cameras.json", "input.ply", "chkpnt30.ckpt",
                os.path.join("point_cloud", "iteration_30", "point_cloud.ply")):
        assert os.path.exists(os.path.join(model, rel)), rel
    with open(os.path.join(model, "cfg_args")) as f:
        assert "data_device='cpu'" in f.read()
    assert set(log["eval"]["test"]) == {20} and set(log["eval"]["train"]) == {20}
    assert np.isfinite(log["eval"]["test"][20]["psnr"])
    assert ckpt.latest_checkpoint(model) == os.path.join(model, "chkpnt30.ckpt")


def test_cli_resumes_from_checkpoint(cli_run, tmp_path):
    root, model, _ = cli_run
    state, it = ckpt.load_checkpoint(os.path.join(model, "chkpnt30.ckpt"), device="cpu")
    assert it == 30 and state.opt_state.count == 30 and state.sh_degree == 0
    resumed = str(tmp_path / "resumed")
    _cli(train.main, ["-s", root, "-m", resumed, "--iterations", "32", "--test_iterations",
                      "32", "--save_iterations", "32", "--checkpoint_iterations", "32",
                      "--start_checkpoint", os.path.join(model, "chkpnt30.ckpt"),
                      "--disable_viewer", "--quiet", "--data_device", "cpu"])
    state2, it2 = ckpt.load_checkpoint(os.path.join(resumed, "chkpnt32.ckpt"), device="cpu")
    assert it2 == 32 and state2.opt_state.count == 32
    assert torch.equal(state2.active, state.active)
    assert torch.isfinite(state2.params.xyz).all()
    assert not torch.equal(state2.params.xyz, state.params.xyz)


def test_checkpoint_round_trip_is_exact(cli_run, tmp_path):
    _, model, _ = cli_run
    state, it = ckpt.load_checkpoint(os.path.join(model, "chkpnt30.ckpt"), device="cpu")
    path = str(tmp_path / "again.ckpt")
    ckpt.save_checkpoint(path, state, it)
    assert os.listdir(tmp_path) == ["again.ckpt"]  # the temporary file is gone
    again, it2 = ckpt.load_checkpoint(path, device="cpu")
    assert it2 == it and again.sh_degree == state.sh_degree
    assert again.opt_state.count == state.opt_state.count
    a, b = ckpt.state_to_dict(again), ckpt.state_to_dict(state)
    flat = [(a["params"], b["params"]), (a["opt_state"]["mu"], b["opt_state"]["mu"]),
            (a["opt_state"]["nu"], b["opt_state"]["nu"]),
            ({k: a[k] for k in ("active", "max_radii2d", "xyz_grad_accum", "denom")},
             {k: b[k] for k in ("active", "max_radii2d", "xyz_grad_accum", "denom")})]
    for x, y in flat:
        for k in y:
            assert torch.equal(x[k], y[k]) and x[k].dtype == y[k].dtype, k


def test_cli_renders_and_scores(cli_run):
    root, model, _ = cli_run
    _cli(render.main, ["-m", model, "--quiet", "--iteration", "30"])  # cfg_args: cpu
    renders = os.path.join(model, "test", "ours_30", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png"]  # 8 cameras, every 8th a test view
    assert _levels(os.path.join(renders, "00000.png")).shape == (48, 64, 3)
    results = _cli(metrics.main, ["-m", model, "--no_lpips", "--data_device", "cpu"])
    r = results[model]["ours_30"]
    assert 0 <= r["SSIM"] <= 1 and r["PSNR"] > 5
    with open(os.path.join(model, "results.json")) as f:
        assert json.load(f) == results[model]
    with open(os.path.join(model, "per_view.json")) as f:
        assert "00000.png" in json.load(f)["ours_30"]["PSNR"]


def test_track_render_matches_jax(cli_run, tmp_path):
    """track_render's main on the 30-step model (64x48 views, so the last
    tile row is 16 px) with a 128x96 eye image: the gaze within 1 px of
    JAX's ``estimate_gaze`` on the same file, the segmentation written,
    and each render within 1/255 + 1e-3 of JAX's 5-step frame
    (``amr.render_amr``, interpret mode) for that gaze with the rings
    (W/8, W/4, W/2)."""
    root, model, _ = cli_run
    eye_path = str(tmp_path / "eye.png")
    Image.fromarray(cs.make_eye(height=96, width=128)).save(eye_path)
    out_dir = str(tmp_path / "foveated")
    got = _cli(track_render.main, ["-m", model, "--eye_image", eye_path, "--num_views", "2",
                                   "--out_dir", out_dir, "--quiet"])
    juv, _ = jax_track_render.estimate_gaze(eye_path)
    uv = np.asarray(got["gaze_uv"])
    assert np.abs((uv - juv) * np.array([128, 96])).max() <= 1.0
    assert _levels(os.path.join(model, "eye_seg_pred.png")).shape == (96, 128, 3)
    assert got["renders"] == [os.path.join(out_dir, f"foveated_{i:03d}.png") for i in (0, 1)]
    assert got["capacities"] == [1 << 20] * 2 and len(got["view_ms"]) == 2

    scene = Scene(ModelConfig(source_path=root, model_path=model, data_device="cpu",
                              eval=True), load_iteration=-1, shuffle=False, load_images=False)
    p, deg = jply.load_gaussians_ply(os.path.join(model, "point_cloud", "iteration_30",
                                                  "point_cloud.ply"))
    args = (p.xyz, jgm.get_scaling(p), p.rotation, jgm.get_opacity(p), jgm.get_sh(p))
    cams = [cam.params("cpu") for cam in scene.get_train_cameras()[:2]]
    c = cams[0]
    assert {(x.tan_fovx, x.tan_fovy, x.width, x.height) for x in cams} == {
        (c.tan_fovx, c.tan_fovy, c.width, c.height)}
    radii = jnp.asarray(track_render.ring_radii(c.width), jnp.float32)
    assert radii[0] < radii[1] < radii[2]
    gaze = jnp.asarray([uv[0] * c.width, uv[1] * c.height], jnp.float32)

    @jax.jit
    def frame(view, proj, campos):
        jcam = JCameraParams(viewmatrix=view, projmatrix=proj, campos=campos,
                             tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy, width=c.width,
                             height=c.height)
        return jamr.render_amr(*args, deg, jcam, jnp.zeros(3), impl="pallas", interpret=True,
                               max_instances=1 << 14, gaze_xy=gaze, gaze_radii=radii)

    for path, view in zip(got["renders"], cams):
        want, st = frame(*(jnp.asarray(x.numpy()) for x in (view.viewmatrix, view.projmatrix,
                                                            view.campos)))
        assert not bool(st.overflow) and len(set(np.asarray(st.tile_levels).tolist())) >= 2
        rendered = _levels(path)
        assert rendered.shape == (view.height, view.width, 3) == (48, 64, 3)
        diff = np.abs(rendered.transpose(2, 0, 1) / 255.0 - np.clip(np.asarray(want), 0, 1))
        assert diff.max() <= 1 / 255 + 1e-3 and rendered.max() > 0


def test_overflow_redo(tmp_path):
    """A tiny instance capacity: the first step overflows, the capacity
    grows and the step is redone; training ends with finite parameters."""
    root = make_colmap_scene(str(tmp_path / "scene"), n_cams=4, n_pts=150)
    model = str(tmp_path / "model")
    scene, state, log = train.training(
        ModelConfig(source_path=root, model_path=model, data_device="cpu"),
        OptimizationConfig(iterations=6, densify_from_iter=100),
        testing_iterations=[], saving_iterations=[6], checkpoint_iterations=[],
        start_checkpoint=None, quiet=True, instance_capacity=64, capacity_bucket=64)
    assert log["capacity"][0] > 64 and state.opt_state.count == 6
    params, _ = tply.load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_6", "point_cloud.ply"), device="cpu")
    assert torch.isfinite(params.xyz).all() and params.xyz.shape[0] == 150


def test_metrics_without_renders_fails(tmp_path):
    (tmp_path / "test" / "ours_1" / "renders").mkdir(parents=True)
    (tmp_path / "test" / "ours_1" / "gt").mkdir(parents=True)
    with pytest.raises(ValueError, match="no renders"):
        _cli(metrics.main, ["-m", str(tmp_path), "--no_lpips", "--data_device", "cpu"])
    with pytest.raises(FileNotFoundError):
        _cli(metrics.main, ["-m", str(tmp_path / "missing"), "--no_lpips",
                            "--data_device", "cpu"])
    assert not (tmp_path / "results.json").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_clis_need_a_card_unless_told(no_cuda, tmp_path):
    root = make_colmap_scene(str(tmp_path / "scene"), n_cams=2, n_pts=20)
    model = str(tmp_path / "model")
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli(train.main, ["-s", root, "-m", model, "--iterations", "1", "--quiet",
                          "--disable_viewer"])
    with pytest.raises(ValueError, match="data_device 'tpu'"):
        _cli(train.main, ["-s", root, "-m", model, "--iterations", "1", "--quiet",
                          "--disable_viewer", "--data_device", "tpu"])
    os.makedirs(os.path.join(model, "point_cloud", "iteration_1"), exist_ok=True)
    with open(os.path.join(model, "cfg_args"), "w") as f:
        f.write(f"Namespace(source_path={root!r}, model_path={model!r}, sh_degree=3, "
                "images='images', resolution=-1, white_background=False, eval=False)")
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli(render.main, ["-m", model, "--quiet"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli(metrics.main, ["-m", model, "--no_lpips"])
    with pytest.raises(RuntimeError, match="CUDA"):
        _cli(track_render.main, ["-m", model, "--quiet", "--eye_image", "eye.png"])


@pytest.mark.parametrize("cli,flag", [
    (train, ["--debug"]), (train, ["--convert_SHs_python"]), (train, ["--ip", "0.0.0.0"]),
    (render, ["--compute_cov3D_python"])])
def test_clis_reject_flags_nothing_reads(cli, flag, tmp_path, capsys):
    """The reference's pipeline toggles and viewer address have no reader
    in the port: the CLIs refuse them rather than ignore them."""
    with pytest.raises(SystemExit) as exc:
        _cli(cli.main, ["-s", str(tmp_path), "-m", str(tmp_path), "--data_device", "cpu", *flag])
    assert exc.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


def test_lpips_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    chans = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    z = {}
    for i in range(13):
        fan_in = chans[i] * 9
        z[f"conv_{i}_w"] = (rng.normal(size=(chans[i + 1], chans[i], 3, 3))
                            * np.sqrt(2.0 / fan_in)).astype(np.float32)
        z[f"conv_{i}_b"] = rng.normal(scale=0.01, size=chans[i + 1]).astype(np.float32)
    for i, c in enumerate((64, 128, 256, 512, 512)):
        z[f"lin_{i}"] = rng.uniform(size=c).astype(np.float32)
    path = str(tmp_path / "lpips_random.npz")
    np.savez(path, **z)
    x, y = (rng.uniform(size=(2, 3, 32, 40)).astype(np.float32) for _ in range(2))
    want = np.asarray(jmetrics.lpips(jnp.asarray(x), jnp.asarray(y), weights_path=path))
    got = metrics_lib.lpips(torch.from_numpy(x), torch.from_numpy(y), weights_path=path)
    assert want.shape == (2,) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert metrics_lib.lpips_available(path) and not metrics_lib.lpips_available(
        str(tmp_path / "none.npz"))


_jax_densenet = jax.jit(jrit.densenet2d_apply)  # one compile instead of one per operation
EPOCH_LINE = re.compile(r"Epoch 0: loss=([\d.]+) val mIoU=([\d.]+) alpha=1\.00")


def test_train_ritnet_matches_jax(tmp_path, monkeypatch, capsys):
    data, init = str(tmp_path / "data"), str(tmp_path / "init.npz")
    cs.write_eye_dataset(data, 4, 2, height=48, width=64)
    jax_train_ritnet.save_params_npz(init, jax.jit(jrit.init_params)(jax.random.PRNGKey(0)))
    argv = ["--dataset", data, "--bs", "2", "--epochs", "1", "--resume", init, "--seed", "3",
            "--expname", "run"]
    lines = {}
    for name, cli, extra in (("jax", jax_train_ritnet, []),
                             ("port", train_ritnet, ["--data_device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        out = cli.main(argv + extra)
        lines[name] = EPOCH_LINE.search(capsys.readouterr().out)
        assert lines[name], name
    params, log = out
    assert len(log["losses"][0]) == 2 and np.isfinite(log["losses"][0]).all()
    (jloss, jmiou), (tloss, tmiou) = (map(float, lines[n].groups()) for n in ("jax", "port"))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert abs(tmiou - jmiou) <= 2e-3 and tmiou > 0
    x = np.random.default_rng(0).uniform(-1, 1, (1, 1, 48, 64)).astype(np.float32)
    for writer in ("jax", "port"):
        for kind in ("best", "last"):
            path = str(tmp_path / writer / "logs" / "run" / f"{kind}_model.npz")
            jp = jax_train_ritnet.load_params_npz(path)
            tp = train_ritnet.load_params_npz(path, "cpu")
            assert list(tp) == list(jp) and len(tp) == 104
            for k in jp:
                assert tp[k].dtype == torch.float32
                np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            with torch.no_grad():
                got = trit.densenet2d_apply(tp, torch.from_numpy(x)).numpy()
            want = np.asarray(_jax_densenet(jp, jnp.asarray(x)))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    for k, v in params.items():  # the port's last model is what its main returned
        np.testing.assert_array_equal(tp[k].numpy(), v.numpy())


def test_eval_ritnet_matches_jax(tmp_path, capsys):
    data = str(tmp_path / "data")
    cs.write_eye_dataset(data, 0, 2, height=56, width=72, seed=2)  # cropped to 48x64
    images, labels = (os.path.join(data, "validation", d) for d in ("images", "labels"))
    out = {}
    for name, cli, extra in (("jax", jax_eval_ritnet, []),
                             ("port", eval_ritnet, ["--data_device", "cpu"])):
        out[name] = str(tmp_path / name)
        cli.main(["--images", images, "--labels", labels, "--out_dir", out[name]] + extra)
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("mIoU over 2 images: "), lines
        out[name + "_line"] = lines[0]
    assert out["port_line"] == out["jax_line"]
    assert sorted(os.listdir(out["port"])) == sorted(os.listdir(out["jax"])) == [
        "e000_label.npy", "e000_mask.png", "e001_label.npy", "e001_mask.png"]
    for base in ("e000", "e001"):
        got, want = (np.load(os.path.join(out[n], base + "_label.npy")) for n in ("port", "jax"))
        assert got.dtype == want.dtype and got.shape == want.shape == (48, 64)
        assert (got != want).mean() <= 1e-3
        assert np.array_equal(*(_levels(os.path.join(out[n], base + "_mask.png"))
                                for n in ("port", "jax"))) == np.array_equal(got, want)

    # the reference checkpoint's form: a DataParallel state dict
    sd = trit.load_pretrained(device="cpu").state_dict()
    pkl = str(tmp_path / "best_model.pkl")
    torch.save({"module." + k: v for k, v in sd.items()}, pkl)
    want = jrit.import_torch_state_dict(pkl)
    got = trit.import_torch_state_dict(pkl)
    assert list(got) == list(want) and len(got) == 104
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got[k], sd[k].numpy())
    eval_ritnet.main(["--images", images, "--weights", pkl, "--out_dir", str(tmp_path / "pkl"),
                      "--data_device", "cpu"])
    for base in ("e000", "e001"):
        np.testing.assert_array_equal(np.load(tmp_path / "pkl" / f"{base}_label.npy"),
                                      np.load(os.path.join(out["port"], base + "_label.npy")))


def _commands(cli, argv, monkeypatch):
    calls = []
    monkeypatch.setattr(os, "system", lambda cmd: calls.append(cmd) or 0)
    cli.main(argv)
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("argv", [
    ["-m360", "/d/m360", "-tat", "/d/tat", "-db", "/d/db", "--output_path", "/o"],
    ["-tat", "/d/tat", "--skip_training", "--skip_metrics"]])
def test_full_eval_commands_match_jax(argv, monkeypatch):
    want = _commands(jax_full_eval, argv, monkeypatch)
    got = _commands(full_eval, argv, monkeypatch)
    assert len(got) == len(want) == (13 + 26 + 1 if len(argv) > 4 else 4)
    pkg = "gaussian_splatting_with_eye_tracking_tpu_torch"
    seen = {}
    for g, w in zip(got, want):
        py, flag, module, *rest = shlex.split(g)
        name = module.removeprefix(pkg + ".")
        assert (py, flag, module.startswith(pkg + ".")) == (sys.executable, "-m", True)
        assert shlex.split(w) == [py, f"{name}.py", *rest]
        seen[name] = seen.get(name, 0) + 1
        parsed = {}
        monkeypatch.setattr(train, "training", lambda *a, **k: parsed.update(cfg=a))
        monkeypatch.setattr(render, "render_sets", lambda *a, **k: parsed.update(cfg=a))
        monkeypatch.setattr(metrics, "evaluate", lambda *a, **k: parsed.update(cfg=a))
        _cli({"train": train, "render": render, "metrics": metrics}[name].main, rest)
        monkeypatch.undo()
        assert parsed, g
        if name == "train":
            model, opt = parsed["cfg"][:2]
            assert model.eval and model.data_device == "cuda"
            scene = os.path.basename(model.model_path)
            assert model.images == ("images_4" if scene in full_eval.mipnerf360_outdoor_scenes
                                    else "images_2" if scene in full_eval.mipnerf360_indoor_scenes
                                    else "images")
        elif name == "render":
            assert parsed["cfg"][1] in (7000, 30000) and parsed["cfg"][2]  # skip_train
    assert seen == ({"train": 13, "render": 26, "metrics": 1} if len(argv) > 4 else
                    {"render": 4})


def test_full_eval_needs_a_dataset(capsys):
    for cli in (jax_full_eval, full_eval):
        with pytest.raises(SystemExit) as exc:
            cli.main([])
        assert exc.value.code == 2 and "provide at least one" in capsys.readouterr().err


FAKE_COLMAP = """#!{python}
import os, shutil, sys
args = sys.argv[1:]
with open(os.environ["FAKE_COLMAP_LOG"], "a") as f:
    f.write(" ".join(args) + "\\n")
opt = dict(zip(args[1::2], args[2::2]))
if args[0] == "image_undistorter":
    out = opt["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "w") as f:
            f.write(name)
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"))
"""


def test_convert_matches_jax(tmp_path, monkeypatch, capsys):
    empty = tmp_path / "empty_bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    for cli in (jax_convert, convert):
        with pytest.raises(SystemExit) as exc:
            cli.main(["-s", str(tmp_path / "nowhere")])
        assert exc.value.code == 1 and "`colmap` not found" in capsys.readouterr().out

    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "colmap").write_text(FAKE_COLMAP.format(python=sys.executable))
    (bindir / "colmap").chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    rng = np.random.default_rng(0)
    src = {}
    for name, cli in (("jax", jax_convert), ("port", convert)):
        src[name] = tmp_path / name
        (src[name] / "input").mkdir(parents=True)
        for i, (w, h) in enumerate([(64, 48), (50, 37)]):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                src[name] / "input" / f"im{i}.png")
        rng = np.random.default_rng(0)  # the same images for both
        monkeypatch.setenv("FAKE_COLMAP_LOG", str(tmp_path / f"{name}.log"))
        cli.main(["-s", str(src[name]), "--resize"])
        assert capsys.readouterr().out.rstrip().endswith("Done.")
    logs = {n: (tmp_path / f"{n}.log").read_text().replace(str(src[n]), "SRC") for n in src}
    assert logs["port"] == logs["jax"] and len(logs["jax"].splitlines()) == 4
    assert sorted(os.listdir(src["port"] / "sparse" / "0")) == [
        "cameras.bin", "images.bin", "points3D.bin"]
    for sub in ("images", "images_2", "images_4", "images_8"):
        files = sorted(os.listdir(src["jax"] / sub))
        assert sorted(os.listdir(src["port"] / sub)) == files == ["im0.png", "im1.png"]
        for f in files:
            assert np.array_equal(_levels(src["port"] / sub / f), _levels(src["jax"] / sub / f))
    assert Image.open(src["port"] / "images_8" / "im1.png").size == (50 // 8, 37 // 8)


def test_ritnet_clis_need_a_card_unless_told(no_cuda, tmp_path):
    for call in (lambda: train_ritnet.main(["--dataset", str(tmp_path)]),
                 lambda: eval_ritnet.main(["--images", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="data_device 'tpu'"):
        train_ritnet.main(["--dataset", str(tmp_path), "--data_device", "tpu"])
