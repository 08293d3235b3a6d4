"""The port repeats bit for bit: ``backend`` asks cuDNN for deterministic
algorithms only (RITnet's default weight-gradient algorithms sum with
atomics on the card), and two runs of ``train_ritnet`` on the same data
and seed write equal parameters and log equal losses."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from gaussian_splatting_with_eye_tracking_tpu_torch import backend, train_ritnet


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_backend_sets_deterministic_cudnn():
    assert backend.torch is torch
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_train_ritnet_repeats_bit_for_bit(tmp_path, monkeypatch, capsys):
    data = str(tmp_path / "data")
    cs.write_eye_dataset(data, 4, 2, height=48, width=64, seed=2)
    runs = []
    for name in ("a", "b"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        _, log = train_ritnet.main(["--dataset", data, "--bs", "2", "--epochs", "2",
                                    "--seed", "1", "--expname", "run", "--data_device", "cpu"])
        runs.append(log)
    capsys.readouterr()
    assert runs[0]["losses"] == runs[1]["losses"] and runs[0]["val_miou"] == runs[1]["val_miou"]
    for kind in ("last", "best"):
        a, b = (np.load(os.path.join(tmp_path, n, "logs", "run", f"{kind}_model.npz"))
                for n in ("a", "b"))
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 104
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{kind}: {k}")
