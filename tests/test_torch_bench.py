"""The port's bench entry (``…_torch/bench.py``) against the JAX
package's root ``bench.py``, on the CPU at test scale: bench's scene
drawn at 2,000 gaussians and seen at 128x96; the loss mean(color^2) and
its gradient with respect to the means against ``jax.grad`` of the same
loss through JAX's ``rasterize`` (``impl="pallas"``, interpret mode):
the loss to rtol 1e-5, the gradient to atol 1e-4 of its largest
magnitude and rtol 5e-3 (tests/test_torch_train.py's gradient tolerance,
scaled to this loss, whose gradients are far below 1). The printed line
has the root script's four keys and value = W*H/t."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu.ops import rasterize as jrast
from gaussian_splatting_with_eye_tracking_tpu_torch import bench
from tests.helpers import make_camera, make_random_gaussians
from tests.torch_helpers import assert_close

N, W, H = 2000, 128, 96
CAPS = dict(max_instances=1 << 15, max_live=1 << 15)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_measure_matches_jax_grad():
    got = bench.measure(N, W, H, reps=1, device="cpu", **CAPS)
    g = make_random_gaussians(N, seed=0, sh_degree=3, spread=2.5, scale_range=(-4.6, -3.0))
    cam = make_camera(W, H, cam_z=-5.0)

    def loss(m):
        out = jrast.rasterize(m, *g[1:], cam, jnp.zeros(3), sh_degree=3, impl="pallas", **CAPS)
        return jnp.mean(out.color ** 2)

    want_loss, want_grad = jax.jit(jax.value_and_grad(loss))(g[0])
    scale = float(np.abs(np.asarray(want_grad)).max())
    assert scale > 0 and got["instances"] > 0 and got["enumerated"] <= CAPS["max_instances"]
    assert_close(got["loss"], want_loss, atol=0, rtol=1e-5)
    assert_close(got["grad"], want_grad, atol=1e-4 * scale, rtol=5e-3)
    assert got["ms"] > 0 and got["iterations"] == 2
    assert not any(got["launches"].values())  # the plain versions count nothing


def test_main_prints_the_root_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "measure", functools.partial(bench.measure, N, W, H, reps=1,
                                                            **CAPS))
    result = bench.main(["--data_device", "cpu"])
    card, line = capsys.readouterr().out.strip().splitlines()
    assert card == "cpu"
    doc = json.loads(line)
    assert doc == result["line"]
    assert list(doc) == ["metric", "value", "unit", "vs_baseline"]
    assert doc["metric"] == "1080p_fwd_bwd_rasterize_throughput" and doc["unit"] == "pixels/s"
    assert doc["value"] == round(W * H / (result["ms"] * 1e-3), 1) > 0
    assert doc["vs_baseline"] == pytest.approx(doc["value"] / (30 * 1920 * 1080), abs=1e-4)


def test_measure_raises_on_overflow():
    with pytest.raises(RuntimeError, match="overflow"):
        bench.measure(N, W, H, max_instances=256, max_live=256, reps=1, device="cpu")
