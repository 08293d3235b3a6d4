"""The port's distance-pruning study (``…_torch/KDtree_test.py``) against
the repository's root ``KDtree_test.py`` (JAX, on the CPU), both ``main``s
run once on the same arguments: 2,000 synthetic gaussians at 128x96,
where no tile holds more than the 2,048 instances that JAX's CPU frame
keeps per tile (asserted).

- The count kept equals JAX's exactly: k + 1 of the 2,000, the root
  script's count, which the port keeps.
- The PSNR within 0.05 dB of the one JAX prints to 2 decimals.
- Both PNGs within 1/255 of JAX's on at least 99.9 % of values.

Torch keeps to two threads (the suite runs several workers at once)."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from PIL import Image

import KDtree_test as jax_kdtree_test
from gaussian_splatting_with_eye_tracking_tpu_torch import KDtree_test, study_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr

ARGS = ["--synthetic", "--num_gaussians", "2000", "--width", "128", "--height", "96"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kdtree_test")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_kdtree_test.main(ARGS + ["--out_dir", str(root / "jax")])
    doc = KDtree_test.main(ARGS + ["--out_dir", str(root / "port")], device="cpu")
    return {"jax_out": out.getvalue(), "port": doc, "root": root}


def test_no_tile_past_the_jax_frames_cap():
    model, deg, active, cam, _ = study_lib.study_view(
        study_lib.study_parser("", "").parse_args(ARGS), "cpu")
    st = amr.fovea_step0(*model, deg, cam, active_mask=active)
    assert not bool(st.overflow)
    assert int((st.offsets[1:] - st.offsets[:-1]).max()) <= 2048


def test_kept_count_matches_jax(runs):
    kept, total = map(int, re.search(r"keeping (\d+)/(\d+) gaussians", runs["jax_out"]).groups())
    doc = runs["port"]
    assert (doc["kept"], doc["active_gaussians"]) == (kept, total) == (1001, 2000)


def test_psnr_matches_jax(runs):
    want = float(re.search(r"PSNR\(pruned, full\) = ([0-9.]+) dB", runs["jax_out"]).group(1))
    assert abs(runs["port"]["psnr_db"] - want) <= 0.05


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("name", ["full", "pruned"])
def test_pngs_match_jax(runs, name):
    got = _png(runs["root"] / "port" / f"{name}.png")
    want = _png(runs["root"] / "jax" / f"{name}.png")
    assert got.shape == want.shape == (96, 128, 3)
    assert np.mean(np.abs(got - want) <= 1) >= 0.999


def test_threshold_keeps_k_plus_one_on_the_device():
    """The threshold is the sorted distance at int(fraction x active);
    inactive rows are never kept."""
    means = torch.arange(10, dtype=torch.float32)[:, None] * torch.tensor([[0.0, 0.0, 1.0]])
    active = torch.ones(10, dtype=torch.bool)
    active[3] = False
    keep = KDtree_test.nearest(means, torch.zeros(3), active, 0.5)  # int(0.5 * 9) = 4
    assert keep.tolist() == [True, True, True, False, True, True, False, False, False, False]
