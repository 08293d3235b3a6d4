"""The port's opacity quantization study (``…_torch/opacity_quant_test.py``)
against the repository's root ``opacity_quant_test.py`` (JAX, on the CPU),
both ``main``s run once per bit width on the same arguments: 2,000
synthetic gaussians at 128x96, where no tile holds more than the 2,048
instances that JAX's CPU frame keeps per tile (asserted).

- PSNR(quantized, original) within 0.05 dB of the one JAX prints to 2
  decimals; the identity check (quantized + residual) at 100 dB or more
  in both.
- The three PNGs within 1/255 of JAX's on at least 99.9 % of values.

Torch keeps to two threads (the suite runs several workers at once)."""

import contextlib
import io
import re

import numpy as np
import pytest
import torch
from PIL import Image

import opacity_quant_test as jax_opacity_quant_test
from gaussian_splatting_with_eye_tracking_tpu_torch import opacity_quant_test

ARGS = ["--synthetic", "--num_gaussians", "2000", "--width", "128", "--height", "96"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[4, 8])
def runs(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"opacity_quant_{request.param}")
    argv = ARGS + ["--bits", str(request.param)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_opacity_quant_test.main(argv + ["--out_dir", str(root / "jax")])
    doc = opacity_quant_test.main(argv + ["--out_dir", str(root / "port")], device="cpu")
    return {"jax_out": out.getvalue(), "port": doc, "root": root, "bits": request.param}


def _jax_psnrs(out):
    return [float(x) for x in re.findall(r"= ([0-9.]+) dB", out)]


def test_psnrs_match_jax(runs):
    doc = runs["port"]
    quantized, identity = _jax_psnrs(runs["jax_out"])
    assert doc["bits"] == runs["bits"]
    assert abs(doc["psnr_quantized_db"] - quantized) <= 0.05
    assert identity >= 100 and doc["psnr_quantized_residual_db"] >= 100
    assert doc["psnr_quantized_db"] < 100
    frames = doc["frames"]
    assert frames["original"]["instances"] == frames["quantized_residual"]["instances"]
    assert all(f["enumerated"] <= f["capacity"] for f in frames.values())


@pytest.mark.parametrize("name", opacity_quant_test.FRAMES)
def test_pngs_match_jax(runs, name):
    got_path = runs["root"] / "port" / f"{name}.png"
    with Image.open(got_path) as a, Image.open(runs["root"] / "jax" / f"{name}.png") as b:
        got = np.asarray(a.convert("RGB")).astype(np.int16)
        want = np.asarray(b.convert("RGB")).astype(np.int16)
    assert got.shape == want.shape == (96, 128, 3)
    assert np.mean(np.abs(got - want) <= 1) >= 0.999


def test_quantize_rounds_to_the_grid():
    op = torch.tensor([0.0, 0.03, 0.5, 0.97, 1.0])
    q, r = opacity_quant_test.quantize(op, 4)
    assert torch.allclose(q * 15, torch.round(q * 15), atol=1e-5)
    assert torch.allclose(q + r, op, atol=1e-7, rtol=0)
    assert (r.abs() <= 0.5 / 15 + 1e-7).all()
