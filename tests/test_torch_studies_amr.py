"""The port's AMR cross-check (``…_torch/AMR_test.py``) against the
repository's root ``AMR_test.py`` (JAX, on the CPU), both ``main``s run
once on the same arguments: 2,000 synthetic gaussians at 128x96, where no
tile holds more than the 1,024 instances that JAX's AMR frame keeps per
tile (its full frame keeps 2,048), which the tests assert.

- The production per-tile counts and levels equal JAX's ``fovea_step0``'s
  exactly, and so do the instances.
- The root script reports both its flags False (it compares the rect
  pairs, counted before binning's ellipse cull, with the kept instances);
  the port's oracle compares like with like, and (a) the rect pairs sum to
  ``num_enumerated``, (b) the kept pairs per tile equal the production
  counts and ``bin_gaussians``' counts, (c) the percentile levels of the
  kept counts equal the production levels. The rect comparison the root
  script makes reads False in the port too.
- The level shares equal the ones JAX prints; the mean |AMR - full| within
  1e-4 of the value JAX prints to 4 decimals.
- The three PNGs within 1/255 of JAX's on at least 99.9 % of values.
- The NumPy ellipse cull equals binning's, bit for bit, on random pairs.

Torch keeps to two threads (the suite runs several workers at once)."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from PIL import Image

import AMR_test as jax_amr_test
from gaussian_splatting_with_eye_tracking_tpu.ops import amr as jamr
from gaussian_splatting_with_eye_tracking_tpu_torch import AMR_test
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, binning

ARGS = ["--synthetic", "--num_gaussians", "2000", "--width", "128", "--height", "96"]
PNGS = ("full", "amr", "levels_overlay")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's result, stdout and first ``fovea_step0`` state; the port's
    document; both output directories)."""
    root = tmp_path_factory.mktemp("amr_test")
    steps = []
    step0 = jamr.fovea_step0

    def recorded(*a, **kw):
        steps.append(step0(*a, **kw))
        return steps[-1]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jamr, "fovea_step0", recorded)
        ok = jax_amr_test.main(ARGS + ["--out_dir", str(root / "jax")])
    doc = AMR_test.main(ARGS + ["--out_dir", str(root / "port")], device="cpu")
    return {"jax_ok": ok, "jax_out": out.getvalue(), "jax_step0": steps[0], "port": doc,
            "root": root}


def test_no_tile_past_the_jax_frames_caps(runs):
    assert max(runs["port"]["tile_counts"]) <= 1024


def test_production_counts_and_levels_match_jax(runs):
    st, doc = runs["jax_step0"], runs["port"]
    want_counts = np.asarray(st.offsets[1:] - st.offsets[:-1]).tolist()
    assert doc["tile_counts"] == want_counts
    assert doc["tile_levels"] == np.asarray(st.tile_levels).tolist()
    assert doc["instances"] == int(st.num_instances)


def test_cross_check_passes_where_jax_reports_false(runs):
    doc = runs["port"]
    assert not runs["jax_ok"]
    assert "intersection counts match: False" in runs["jax_out"]
    assert "AMR levels match: False" in runs["jax_out"]
    assert doc["counts_match"] and doc["rect_pairs"] == doc["enumerated"]  # (a)
    assert doc["kept_match"] and doc["bin_gaussians_match"]  # (b)
    assert doc["levels_match"]  # (c)
    assert doc["rect_pairs"] > doc["instances"]
    assert not doc["rect_counts_match"]  # the root script's comparison


def test_level_shares_and_mean_error_match_jax(runs):
    doc, out = runs["port"], runs["jax_out"]
    shares = [float(s) for s in re.findall(r"level \d: ([0-9.]+)% of tiles", out)]
    assert shares == [round(100 * s, 1) for s in doc["level_shares"]]
    err = float(re.search(r"mean \|AMR - full\| = ([0-9.]+)", out).group(1))
    assert abs(doc["mean_abs_err"] - err) <= 1e-4


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.int16)


@pytest.mark.parametrize("name", PNGS)
def test_pngs_match_jax(runs, name):
    got = _png(runs["root"] / "port" / f"{name}.png")
    want = _png(runs["root"] / "jax" / f"{name}.png")
    assert got.shape == want.shape == (96, 128, 3)
    assert np.mean(np.abs(got - want) <= 1) >= 0.999


def test_numpy_cull_equals_binning_bit_for_bit():
    """Random (gaussian, tile) pairs around the tile edges, conics of every
    shape, thresholds of every size: the same verdict on every pair."""
    rng = np.random.default_rng(3)
    n = 200_000
    tx, ty = rng.integers(0, 8, n), rng.integers(0, 6, n)
    cx = (rng.uniform(-40, 300, n)).astype(np.float32)
    cy = (rng.uniform(-40, 220, n)).astype(np.float32)
    a, c = (10.0 ** rng.uniform(-4, 1, (2, n))).astype(np.float32)
    b = (rng.uniform(-0.99, 0.99, n) * np.sqrt(a * c)).astype(np.float32)
    thr = (10.0 ** rng.uniform(-3, 1, n)).astype(np.float32)
    want = binning._tile_ellipse_kept(*(torch.from_numpy(x) for x in (tx, ty, cx, cy, a, b, c,
                                                                      thr)), 32).numpy()
    got = AMR_test.tile_ellipse_kept_np(tx, ty, cx, cy, a, b, c, thr, 32)
    assert 0.05 < want.mean() < 0.95
    assert np.array_equal(got, want)


def test_percentile_levels_equal_assign_levels_on_the_kept_counts(runs):
    counts = np.asarray(runs["port"]["tile_counts"])
    assert AMR_test.percentile_levels(counts).tolist() == amr.assign_levels(
        torch.from_numpy(counts)).tolist() == runs["port"]["tile_levels"]
