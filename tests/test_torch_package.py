"""Package rules of the PyTorch port: no JAX anywhere in it or in
chip_smoke.py, entry points that refuse to fall back to the CPU silently,
a rasterizer whose gradients reach every differentiable input, and kernel
wrappers that are bound to their CUDA sources and count only real
launches."""

import ast
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend, bench, fps_foveated, fps_test
from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test_amr, track_render
from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io as tply
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import binning, blend, expand, segsum
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as trast
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import Camera, MiniCam
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import cam_to_torch, to_torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "gaussian_splatting_with_eye_tracking_tpu_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "tests") or root == "gaussian_splatting_with_eye_tracking_tpu"


STUDIES = ("AMR_test", "KDtree_test", "opacity_quant_test", "amr_quality_sweep")
ROOT_SCRIPTS = {p.stem for p in ROOT.glob("*.py")}


@pytest.mark.parametrize("target", ["package", "chip_smoke", "studies"])
def test_no_jax_imports(target):
    """Nor does the package import the smoke script above it; the study
    modules, which keep the root scripts' names, import no root script
    either."""
    files = {"package": sorted(PORT.rglob("*.py")), "chip_smoke": [ROOT / "chip_smoke.py"],
             "studies": [PORT / f"{name}.py" for name in STUDIES]}[target]
    assert files and all(f.exists() for f in files)
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if _forbidden(m) or (target != "chip_smoke" and m.split(".")[0] == "chip_smoke")
           or (target == "studies" and m in ROOT_SCRIPTS)]
    assert not bad, bad


def test_no_pil_at_module_level():
    """Importing the package needs no imaging package: PIL is imported
    only inside the functions that read or write an image file, as in the
    JAX package."""
    bad = []
    for f in sorted(PORT.rglob("*.py")):
        for node in ast.parse(f.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(str(f.relative_to(ROOT)), m) for m in names if m.split(".")[0] == "PIL"]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    cam = MiniCam(32, 32, 1.0, 1.0, 0.01, 100.0, np.eye(4), np.eye(4))
    params = {name: np.zeros((2, 3)) for name in tgm.GaussianParams._fields}
    path = os.path.join(tmp_path, "m.ply")
    tply.save_gaussians_ply(path, tgm.params_from_jax(
        {"xyz": np.zeros((2, 3)), "f_dc": np.zeros((2, 3, 1)), "f_rest": np.zeros((2, 3, 0)),
         "scaling": np.zeros((2, 3)), "rotation": np.ones((2, 4)),
         "opacity": np.zeros((2, 1))}, device="cpu"), np.ones(2, bool))
    calls = [
        lambda: backend.resolve_device(None),
        lambda: backend.resolve_device("cuda"),
        lambda: train_lib.make_eval_render(3, 32, 32),
        lambda: train_lib.make_train_step(tgm.make_optimizer(OptimizationConfig(), 1.0),
                                          OptimizationConfig(), 3, 32, 32),
        lambda: tgm.create_from_points(np.zeros((4, 3)), np.zeros((4, 3)), 0,
                                       OptimizationConfig(), 1.0),
        lambda: cam.params(),
        lambda: tgm.params_from_jax(params),
        lambda: tply.load_gaussians_ply(path),
        lambda: Camera(0, np.eye(3), np.zeros(3), 1.0, 1.0, np.zeros((3, 4, 4)), "c", 0).params(),
        lambda: Camera(0, np.eye(3), np.zeros(3), 1.0, 1.0, np.zeros((3, 4, 4)), "c", 0).gt(),
        lambda: ckpt.load_checkpoint(path),
        lambda: scene_synth.synthesize_dataset(str(tmp_path / "synth")),
        lambda: backend.resolve_data_device("cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert backend.resolve_device("cpu") == torch.device("cpu")
    assert backend.resolve_data_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'tpu'"):
        backend.resolve_data_device("tpu")


def test_foveated_entry_points_raise_without_cuda(no_cuda):
    """RITnet's loader and preprocessing, estimate_gaze, the foveated
    timing, the frame-rate sweeps and the bench run on the card unless told
    otherwise; with device="cpu" they run on the CPU, and the timing says
    that it took the host clock."""
    import chip_smoke as cs

    eye = cs.make_eye(height=64, width=96)
    g, cam, bg = _small_scene()
    params = tgm.params_from_jax(
        {"xyz": g[0], "f_dc": g[4], "f_rest": g[4][:, :, :0], "scaling": g[1].log(),
         "rotation": g[2], "opacity": torch.logit(g[3])[:, None]}, device="cpu")
    state = tgm.state_from_params(params, 0)
    for call in (lambda: ritnet.load_pretrained(),
                 lambda: ritnet.preprocess_eye_image(eye),
                 lambda: track_render.estimate_gaze(eye),
                 lambda: fps_foveated.run_foveated_breakdown(state, cam, bg, max_sh_degree=0),
                 lambda: fps_foveated.main(["--num_gaussians", "8"]),
                 lambda: fps_test.run_sweep(state, 0, state.active),
                 lambda: fps_test.main(["--synthetic", "--num_gaussians", "8"]),
                 lambda: fps_test_amr.main(["--num_gaussians", "8"]),
                 lambda: bench.measure(),
                 lambda: bench.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert ritnet.preprocess_eye_image(eye, device="cpu").device.type == "cpu"
    uv, pred = track_render.estimate_gaze(eye, device="cpu")
    assert pred.shape == (64, 96) and pred.device.type == "cpu" and ((0 <= uv) & (uv <= 1)).all()
    out = fps_foveated.run_foveated_breakdown(
        state, cam, bg, max_sh_degree=0, gaze_xy=torch.tensor([16.0, 16.0]),
        radii=torch.tensor([8.0, 16.0, 24.0]), max_instances=1 << 10, reps=1, device="cpu")
    assert out["device"] == "cpu" and out["timer"] == "host clock"
    assert len(out["steps_protocol"]) == 5 and out["plain_forward_ms"] > 0
    assert sum(out["level_histogram"]) == 1 and "fused_predecimated_ms" in out


@pytest.mark.parametrize("name", STUDIES)
def test_studies_raise_without_cuda(no_cuda, name, tmp_path):
    """Each study's main runs on the card unless told otherwise."""
    import importlib

    module = importlib.import_module(f"gaussian_splatting_with_eye_tracking_tpu_torch.{name}")
    argv = ["--densities", "8"] if name == "amr_quality_sweep" else ["--num_gaussians", "8"]
    argv += ["--out", str(tmp_path / "q.json"), "--png", str(tmp_path / "q.png")] \
        if name == "amr_quality_sweep" else ["--out_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)


def _small_scene():
    cam = make_camera(32, 32)
    g = [to_torch(x) for x in make_random_gaussians(40, seed=1)]
    return g, cam_to_torch(cam), torch.zeros(3)


def test_rasterize_gradients_reach_every_input():
    g, cam, bg = _small_scene()
    inputs = [x.requires_grad_(True) for x in g] + [bg.requires_grad_(True)]
    offset = torch.zeros((g[0].shape[0], 2), requires_grad=True)
    out = trast.rasterize(*inputs[:5], cam, inputs[5], means2d_offset=offset, sh_degree=0,
                          max_instances=1 << 10)
    grads = torch.autograd.grad(out.color.square().mean() + out.final_t.mean(),
                                inputs + [offset])
    for name, grad in zip(("means", "scales", "quats", "opacities", "sh", "bg",
                           "means2d_offset"), grads):
        assert torch.isfinite(grad).all() and grad.abs().max() > 0, name
    with torch.no_grad():  # rendering a trainable tensor without autograd is fine
        out = trast.rasterize(*g, cam, bg, sh_degree=0, max_instances=1 << 10)
    assert out.color.shape == (3, 32, 32) and not out.color.requires_grad


def test_rasterize_debug_snapshot(tmp_path, monkeypatch):
    """debug=True saves the inputs on an exception and re-raises it."""
    g, cam, bg = _small_scene()
    monkeypatch.chdir(tmp_path)
    bad_sh = g[4][:, :, :0]  # no SH coefficients: the colour evaluation fails
    with pytest.raises(IndexError):
        trast.rasterize(*g[:4], bad_sh, cam, bg, sh_degree=0, max_instances=1 << 10,
                        debug=True)
    snap = torch.load(tmp_path / "snapshot_fw.pt")
    assert torch.equal(snap["means3d"], g[0]) and snap["width"] == 32
    assert "means2d_offset" not in snap  # inputs not given are not saved


def test_eval_render_rejects_model_on_other_device():
    g, cam, bg = _small_scene()
    render = train_lib.make_eval_render(0, 32, 32, device="cpu")
    params = tgm.params_from_jax(
        {"xyz": g[0], "f_dc": g[4], "f_rest": g[4][:, :, :0], "scaling": g[1].log(),
         "rotation": g[2], "opacity": torch.logit(g[3])[:, None]}, device="meta")
    state = tgm.state_from_params(params, 0)
    with pytest.raises(ValueError, match="renderer built for"):
        render(state, *train_lib.camera_arrays(cam), bg)


@pytest.mark.parametrize("kernel,source", [
    (expand.EXPAND_SEG, "expand_seg.cu"), (expand.EXPAND_ROWS, "expand_seg.cu"),
    (blend.BLEND_FWD, "blend_fwd.cu"),
    (blend.BLEND_BWD, "blend_bwd.cu"), (segsum.SEGSUM, "segsum.cu"),
    (blend.BLEND_ROUND, "blend_amr.cu"), (blend.BLEND_LEVELS, "blend_amr.cu"),
    (binning.BINNING_SORT, "binning.cu"), (binning.BINNING_LAYOUT, "binning.cu")])
def test_kernel_wrappers_bound_to_sources(kernel, source):
    src = backend.CSRC / source
    assert kernel in backend.kernels() and kernel.stem == src.stem
    text = src.read_text()
    assert f'extern "C" int {kernel.symbol}(' in text
    params = text.split(f'extern "C" int {kernel.symbol}(', 1)[1].split(")", 1)[0]
    assert len(params.split(",")) == len(kernel.argtypes)  # ctypes passes them by position
    assert 'extern "C" const char* error_string(int code)' in text
    assert "cudaGetLastError()" in text


def test_cpu_calls_use_plain_versions_and_count_nothing():
    table = torch.tensor([[0.0, 2.0, float("inf")], [1.0, 2.0, 3.0]])
    feat = torch.zeros((16, 128))
    kernels = (expand.EXPAND_SEG, expand.EXPAND_ROWS, blend.BLEND_FWD, blend.BLEND_BWD,
               segsum.SEGSUM)
    before = [k.launches for k in kernels]
    out = expand.expand_rows_by_segments(table, 0, 5)
    assert out[1].tolist() == [1.0, 1.0, 2.0, 2.0, 2.0]
    ck = torch.tensor([0, 0, 1, 1, 1], dtype=torch.int32)
    assert torch.equal(expand.expand_rows(table, ck), out)
    offsets = torch.tensor([0, 0], dtype=torch.int32)
    fwd = blend.blend_fwd(feat, offsets, 1, 1)
    blend.blend_bwd(feat, offsets, fwd, torch.ones_like(fwd), 1, 1)
    segsum.segment_sum_bounds(table[1:], offsets)
    assert [k.launches for k in kernels] == before


def test_cpu_foveated_calls_use_plain_versions_and_count_nothing():
    feat = torch.zeros((16, 128))
    feat[0:2, :40] = torch.rand((2, 40), generator=torch.Generator().manual_seed(0)) * 32
    feat[2], feat[4], feat[5:8], feat[8] = 0.05, 0.05, 0.7, 0.5
    offsets = torch.tensor([0, 40], dtype=torch.int32)
    counts = torch.tensor([40], dtype=torch.int32)
    levels = torch.tensor([3], dtype=torch.int32)
    kernels = (blend.BLEND_ROUND, blend.BLEND_LEVELS)
    before = [k.launches for k in kernels]
    got = blend.blend_round(feat, offsets, 1, 1, offx=1, offy=0)
    assert torch.equal(got, blend.blend_round_plain(feat, offsets, 1, 1, offx=1, offy=0))
    got = blend.blend_levels(feat, offsets, counts, levels, 1, 1, decimation=(4, 2, 1, 1))
    assert torch.equal(got, blend.blend_levels_plain(feat, offsets, counts, levels, 1, 1,
                                                     decimation=(4, 2, 1, 1)))
    assert got[0, :768, 0:3].any() and not got[0, 768:].any()
    assert [k.launches for k in kernels] == before
