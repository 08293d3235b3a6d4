"""The port's foveated-decimation quality sweep (``…_torch/amr_quality_sweep
.py``) against the repository's root ``amr_quality_sweep.py`` (JAX, its
fused levels kernel in Pallas interpret mode on the CPU), both ``main``s
run once on the same arguments: one density of 2,000 synthetic gaussians
at 128x96, no ``--alpha_modes``.

- For each decimation, in the kernel and at binning time, PSNR within
  0.05 dB and SSIM within 1e-3 of JAX's (which rounds them to 2 and 4
  decimals in its document).
- The side-by-side PNG within 1/255 of JAX's on at least 99.9 % of values.
- The row records the capacity, the instances and no overflow; an
  ``--alpha_modes f32`` row is the baseline frame again (100 dB or more);
  ``--alpha_modes bf16`` is refused.

Torch keeps to two threads (the suite runs several workers at once)."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

import amr_quality_sweep as jax_amr_quality_sweep
from gaussian_splatting_with_eye_tracking_tpu_torch import amr_quality_sweep

ARGS = ["--densities", "2000", "--width", "128", "--height", "96", "--alpha_modes"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("amr_quality_sweep")
    outs = {k: ["--out", str(root / f"{k}.json"), "--png", str(root / f"{k}.png")]
            for k in ("jax", "port")}
    with contextlib.redirect_stdout(io.StringIO()):
        jax_amr_quality_sweep.main(ARGS + outs["jax"])
    doc = amr_quality_sweep.main(ARGS + outs["port"], device="cpu")
    with open(root / "jax.json") as f:
        jax_doc = json.load(f)
    return {"jax": jax_doc, "port": doc, "root": root}


def test_psnr_and_ssim_match_jax(runs):
    (want,), (got,) = runs["jax"]["results"], runs["port"]["results"]
    assert got["workload"] == want["workload"] == "synthetic_2000"
    assert got["gaze_rings_px"] == want["gaze_rings_px"]
    assert len(got["decimation"]) == len(want["decimation"]) == 3
    for g, w in zip(got["decimation"], want["decimation"]):
        assert g["decimation"] == w["decimation"]
        for key in ("psnr_db", "predecimate_psnr_db"):
            assert abs(g[key] - w[key]) <= 0.05, (g, w)
        for key in ("ssim", "predecimate_ssim"):
            assert abs(g[key] - w[key]) <= 1e-3, (g, w)


def test_document_records_capacity_and_no_overflow(runs):
    doc = runs["port"]
    assert doc["resolution"] == runs["jax"]["resolution"] == [128, 96]
    (row,) = doc["results"]
    assert row["overflow"] is False and 0 < row["instances"] <= row["enumerated"]
    assert row["enumerated"] <= row["capacity"] and row["card"] == "cpu"
    assert len(row["frames"]) == 8 and row["alpha_modes"] == []
    with open(runs["root"] / "port.json") as f:
        assert json.load(f) == json.loads(json.dumps(doc))


def test_side_by_side_png_matches_jax(runs):
    with Image.open(runs["root"] / "port.png") as a, Image.open(runs["root"] / "jax.png") as b:
        got = np.asarray(a.convert("RGB")).astype(np.int16)
        want = np.asarray(b.convert("RGB")).astype(np.int16)
    assert got.shape == want.shape == (96, 3 * 128, 3)
    assert np.mean(np.abs(got - want) <= 1) >= 0.999


def test_alpha_modes_f32_only(tmp_path):
    argv = ["--densities", "300", "--width", "64", "--height", "64", "--out",
            str(tmp_path / "q.json"), "--png", str(tmp_path / "q.png")]
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(io.StringIO()) as err:
        amr_quality_sweep.main(argv + ["--alpha_modes", "f32", "bf16"], device="cpu")
    assert exc.value.code == 2 and "pallas_blend.py:291-294" in err.getvalue()
    doc = amr_quality_sweep.main(argv + ["--alpha_modes", "f32"], device="cpu")
    (mode,) = doc["results"][0]["alpha_modes"]
    assert mode["mode"] == "f32" and mode["psnr_db"] >= 100 and mode["ssim"] == 1.0
