"""The port's ``train_regression`` on a tiny CPU run: it writes the
trained model's bench (``trained_bench_1080p``: live instances, ms of a
forward + backward, Mpix/s) into its JSON record, and the bench's
instance count is the one a render of the saved PLY at that camera keeps.
On the CPU the bench runs at 256x128 and a capacity of 2^17 (at
1920x1088 one forward + backward of the plain versions takes a minute)."""

import functools
import json
import math
import os
import sys

import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth, train_regression
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ply_io
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_tiny_run_writes_the_trained_bench(tmp_path, monkeypatch):
    monkeypatch.setattr(scene_synth, "synthesize_dataset", functools.partial(
        scene_synth.synthesize_dataset, n_cams=8, width=64, height=64))
    monkeypatch.setattr(train_regression, "BENCH_W", 256)
    monkeypatch.setattr(train_regression, "BENCH_H", 128)
    monkeypatch.setattr(train_regression, "BENCH_CAPACITY", 1 << 17)
    monkeypatch.setattr(train_regression, "BENCH_REPS", 1)
    out = str(tmp_path / "TRAIN.json")
    model = str(tmp_path / "model")
    saved = sys.stdout
    try:
        doc = train_regression.main(["--iters", "2", "--root", str(tmp_path / "scene"),
                                     "--model", model, "--out", out, "--data_device", "cpu"])
    finally:
        sys.stdout = saved
    with open(out) as f:
        assert json.load(f)["trained_bench_1080p"] == doc["trained_bench_1080p"]
    bench = doc["trained_bench_1080p"]
    assert sorted(bench) == ["fwd_bwd_ms", "live_instances", "mpix_per_s"]
    assert bench["fwd_bwd_ms"] > 0 and math.isclose(
        bench["mpix_per_s"], 256 * 128 / bench["fwd_bwd_ms"] / 1e3)
    assert doc["card"] == "cpu"

    p, degree = ply_io.load_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_2", "point_cloud.ply"), "cpu")
    with torch.no_grad():
        probe = rast.rasterize(p.xyz, gm.get_scaling(p), p.rotation, gm.get_opacity(p),
                               gm.get_sh(p), make_camera(256, 128, device="cpu"),
                               torch.zeros(3), sh_degree=degree, max_instances=1 << 17)
    assert bench["live_instances"] == int(probe.num_instances) > 0
    assert not bool(probe.overflow)


def test_skip_bench_writes_null(tmp_path, monkeypatch):
    monkeypatch.setattr(scene_synth, "synthesize_dataset", functools.partial(
        scene_synth.synthesize_dataset, n_cams=8, width=32, height=32))
    saved = sys.stdout
    try:
        doc = train_regression.main(["--iters", "1", "--root", str(tmp_path / "scene"),
                                     "--model", str(tmp_path / "model"), "--skip_bench",
                                     "--out", str(tmp_path / "T.json"), "--data_device", "cpu"])
    finally:
        sys.stdout = saved
    assert doc["trained_bench_1080p"] is None
