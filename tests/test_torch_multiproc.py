"""The port's multi-process entry points on the CPU (gloo): the trainer
(``python -m …_torch.train`` in two ranks with torchrun's variables) and
``scaling_bench --emulate_devices``.

The trainer's two ranks train a 6-camera 64x64 scene for 40 iterations
with a checkpoint at 40; each rank is given its own model directory, so
that what rank 1 writes shows (nothing: rank 0 alone writes ``cfg_args``,
the scene's files, TensorBoard and the PLY, and the replicated checkpoint).
The checkpoint directory loads back in this process at iteration 40, its
metadata holds the two ranks' equal state hashes, and the state equals bit
for bit one process's run of the same command (every rank replays the same
seeded loop on the same replicated state).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth
from gaussian_splatting_with_eye_tracking_tpu_torch import train as train_cli
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.train_regression import run_cli
from tests.torch_helpers import free_port, start_ranks, wait_ranks

ITERS = 40


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train_args(scene, model):
    return ["-s", scene, "-m", model, "--iterations", str(ITERS), "--eval",
            "--test_iterations", str(ITERS), "--save_iterations", str(ITERS),
            "--checkpoint_iterations", str(ITERS), "--data_device", "cpu", "--quiet"]


def test_two_process_training(tmp_path, monkeypatch):
    scene = scene_synth.synthesize_dataset(str(tmp_path / "scene"), n_cams=6, width=64,
                                           height=64, device="cpu")
    models = [str(tmp_path / f"model{r}") for r in range(2)]
    port = free_port()
    procs = start_ranks(
        [[sys.executable, "-m", "gaussian_splatting_with_eye_tracking_tpu_torch.train",
          *_train_args(scene, models[r])] for r in range(2)],
        envs=[dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2")
              for r in range(2)],
        cwd=str(tmp_path))
    # the same command in one process, while the ranks run
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.chdir(tmp_path)
    single = str(tmp_path / "single")
    run_cli(train_cli.main, _train_args(scene, single))
    wait_ranks(procs, timeout=120)

    assert not os.path.exists(models[1]), os.listdir(models[1])
    for name in ("cfg_args", "input.ply", "cameras.json",
                 os.path.join("point_cloud", f"iteration_{ITERS}", "point_cloud.ply")):
        assert os.path.exists(os.path.join(models[0], name)), name
    path = ckpt.latest_checkpoint(models[0])
    assert path == os.path.join(models[0], f"chkpnt{ITERS}{ckpt.SHARDS}")
    meta = ckpt.checkpoint_meta(path)
    assert meta["layout"] == "replicated" and meta["world_size"] == 2
    assert len(set(meta["digests"])) == 1  # both ranks' states equal bit for bit
    state, it = ckpt.load_checkpoint_dist(path, device="cpu")
    assert it == ITERS
    assert np.isfinite(state.params.xyz[state.active].numpy()).all()
    want, _ = ckpt.load_checkpoint(os.path.join(single, f"chkpnt{ITERS}.ckpt"), device="cpu")
    a, b = ckpt.state_to_dict(state), ckpt.state_to_dict(want)
    for group in ("params",):
        for k in b[group]:
            assert torch.equal(a[group][k], b[group][k]), k
    for k in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        assert torch.equal(a[k], b[k]), k


def test_scaling_bench_emulated_ranks(tmp_path):
    out = tmp_path / "scaling.json"
    procs = start_ranks([[
        sys.executable, "-m", "gaussian_splatting_with_eye_tracking_tpu_torch.scaling_bench",
        "--emulate_devices", "2", "--devices", "1", "2", "--width", "64", "--height", "64",
        "--num_gaussians", "500", "--out", str(out)]], cwd=str(tmp_path))
    log = wait_ranks(procs, timeout=120)[0]
    res = json.loads(out.read_text())
    assert [r["devices"] for r in res] == [1, 2], log
    for r in res:
        assert r["ms_per_step"] > 0 and r["rays_per_s"] > 0 and r["card"] == "cpu"
        assert not r["overflow"]
    assert res[0]["scaling_efficiency"] is None and res[1]["scaling_efficiency"] > 0
    assert "1 device(s):" in log and "2 device(s):" in log
