"""The model's two input forms on the CPU: a ``gaussian_model.RawGaussians``
(the raw parameters and the active SH degree, which the preprocess kernel
K7 activates as it loads a row on the card) in place of the five
activated tensors of ``renderer.activated``.

- ``preprocess`` given the raw form equals ``preprocess`` given
  ``renderer.activated``'s tensors bit for bit in every field, at SH
  degrees 0-3 of a degree-3 model (the band cut), with padded inactive
  slots and ``scale_modifier`` 0.7;
- ``rasterize``, ``amr.fovea_step0`` and ``amr.render_amr_fused`` given
  the raw form equal the same calls given the activated form;
- ``renderer.model_inputs`` gives the raw form only where
  ``projection.takes_kernel`` says K7 runs: on the CPU (and under a
  gradient) ``renderer.activated``'s tensors; with K7's route forced and
  K7's wrapper swapped for the plain version, ``renderer.render`` hands
  the raw form down and draws the same image;
- ``renderer.render`` under a gradient still differentiates through
  ``renderer.activated``: its gradients equal those of the activated
  tensors passed by hand, bit for bit;
- ``gs.preprocess.raw`` is never counted on the CPU, and the benchmark's
  ``preprocess_raw.*`` readers leave the metric out (None) on such a run
  and read 100 where every row was counted; both are in
  ``BENCHMARK.json`` in the preprocess layer.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene, renderer, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import amr, projection
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import rasterize as rast
from gsbench import harness, spans

N, SLOTS, W, H = 1500, 2048, 112, 80
CAPACITY = 1 << 14
LAYER = "preprocess (renderer.activated, ops/projection.preprocess)"


@pytest.fixture(autouse=True)
def few_threads():
    tracing._records.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tracing._records.clear()
    torch.set_num_threads(threads)


def model_state(sh_degree):
    """A degree-3 model of ``N`` gaussians in ``SLOTS`` slots (the rest
    ``_pad_params``' inert fills, inactive) at active degree ``sh_degree``."""
    raw = bench_scene.raw_params(*bench_scene.make_random_gaussians(
        N, seed=5, sh_degree=3, spread=1.2))
    p = gm._pad_params(gm.GaussianParams(**{k: torch.from_numpy(np.ascontiguousarray(v))
                                            for k, v in raw.items()}), SLOTS)
    return gm.GaussianModelState(params=p, active=torch.arange(SLOTS) < N, sh_degree=sh_degree)


def camera():
    return bench_scene.view_request(4.0, -3.0, W, H).params(device="cpu")


def raw_inputs(state):
    return gm.RawGaussians(*state.params, state.sh_degree), None, None, None, None


def assert_same(got, want):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_preprocess_raw_form_equals_the_activated_form(sh_degree):
    state = model_state(sh_degree)
    kw = dict(tile=32, active_mask=state.active, scale_modifier=0.7)
    want = projection.preprocess(*renderer.activated(state, 3), 3, camera(), **kw)
    got = projection.preprocess(*raw_inputs(state), 3, camera(), **kw)
    assert_same(got, want)
    assert (want.radii > 0).sum() > 100


def _rasterize(inputs, state):
    return rast.rasterize(*inputs, camera(), torch.tensor([0.1, 0.2, 0.3]), sh_degree=3,
                          max_instances=CAPACITY, active_mask=state.active)


def _step0(inputs, state):
    return amr.fovea_step0(*inputs, 3, camera(), max_instances=CAPACITY,
                           active_mask=state.active, gaze_xy=(50.0, 40.0),
                           gaze_radii=(14.0, 28.0, 56.0))


def _fused(inputs, state):
    color, st = amr.render_amr_fused(*inputs, 3, camera(), torch.tensor([0.1, 0.2, 0.3]),
                                     max_instances=CAPACITY, active_mask=state.active,
                                     gaze_xy=(50.0, 40.0), gaze_radii=(14.0, 28.0, 56.0))
    return st._replace(color=color)


@pytest.mark.parametrize("call", [_rasterize, _step0, _fused],
                         ids=["rasterize", "fovea_step0", "render_amr_fused"])
def test_entry_points_take_the_raw_form(call):
    state = model_state(2)
    with torch.no_grad():
        want = call(renderer.activated(state, 3), state)
        got = call(raw_inputs(state), state)
    assert_same(got, want)
    assert int(want.num_instances) > 0


def test_model_inputs_on_the_cpu_are_the_activated_tensors():
    state = model_state(1)
    with torch.no_grad():
        got = renderer.model_inputs(state, 3)
    assert len(got) == 5 and all(isinstance(t, torch.Tensor) for t in got)
    for a, b in zip(got, renderer.activated(state, 3)):
        assert torch.equal(a, b)


def test_render_hands_the_raw_form_down_on_the_kernel_route(monkeypatch):
    """K7's route forced on the CPU, with K7's wrapper the plain version
    (as ``chip_smoke.plain_route`` swaps it): ``renderer.render`` passes
    one ``RawGaussians`` to the rasterizer, preprocess counts it as K7's
    raw rows, and the image is the activated route's."""
    state = model_state(2)
    cam, bg = camera(), torch.tensor([0.1, 0.2, 0.3])
    with torch.no_grad():
        want = renderer.render(cam, state, bg, max_instances=CAPACITY)
    seen = []
    monkeypatch.setattr(projection, "takes_kernel", lambda *t: not torch.is_grad_enabled())

    def plain(*args, **kw):
        seen.append(type(args[0]))
        return projection.preprocess_plain(*args, **kw)

    monkeypatch.setattr(projection, "preprocess_kernel", plain)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            got = renderer.render(cam, state, bg, max_instances=CAPACITY)
    counts = {c.name: int(c.value) for c in tracing.counters()}
    assert seen == [gm.RawGaussians]
    assert counts["gs.preprocess.raw"] == counts["gs.preprocess.rows"] == SLOTS
    assert_same(got, want)


def test_render_under_a_gradient_differentiates_through_activated(monkeypatch):
    state = model_state(3)
    params = gm.GaussianParams(*(p.clone().requires_grad_(True) for p in state.params))
    state = state._replace(params=params)
    cam, bg = camera(), torch.tensor([0.1, 0.2, 0.3])
    calls = []
    activated = renderer.activated
    monkeypatch.setattr(renderer, "activated", lambda *a: calls.append(a) or activated(*a))
    out = renderer.render(cam, state, bg, max_instances=CAPACITY)
    got = torch.autograd.grad((out.color * out.color).sum(), params)
    assert len(calls) == 1
    want_out = rast.rasterize(*gm.activate(params, 3, 3), cam, bg, sh_degree=3,
                              max_instances=CAPACITY, active_mask=state.active)
    want = torch.autograd.grad((want_out.color * want_out.color).sum(), params)
    for name, a, b in zip(gm.GaussianParams._fields, got, want):
        assert torch.equal(a, b), name
    assert float(got[0].abs().sum()) > 0


def cpu_render_counts():
    state = model_state(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            renderer.render(camera(), state, torch.zeros(3), max_instances=CAPACITY)
    return tracing.counters()


def test_the_cpu_counts_no_raw_rows():
    names = [c.name for c in cpu_render_counts()]
    assert "gs.preprocess.rows" in names
    assert "gs.preprocess.raw" not in names and "gs.preprocess.kernel" not in names
    assert "``gs.preprocess.raw``" in tracing.__doc__
    assert "gs.preprocess.raw" in projection.preprocess.__doc__


@pytest.mark.parametrize("name", ["preprocess_raw.serve", "preprocess_raw.binocular"])
def test_raw_metrics_read_none_on_a_cpu_run_and_100_through_k7(monkeypatch, name):
    counts = cpu_render_counts()
    monkeypatch.setattr(spans, "program_counts", lambda run: counts)
    assert harness.load_metric(name)(None) is None
    rows = [tracing.Count("gs.preprocess.rows", 4096, 0.1),
            tracing.Count("gs.preprocess.rows", 4096, 1.1)]
    raw = [tracing.Count("gs.preprocess.raw", 4096, 0.1),
           tracing.Count("gs.preprocess.raw", 4096, 1.1)]
    monkeypatch.setattr(spans, "program_counts", lambda run: rows + raw)
    assert harness.load_metric(name)(None) == pytest.approx(100.0)
    bench = json.loads((Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["layer"] == LAYER and entry["source"] == "program_counter"
    assert entry["moves"] == "frames_per_s"
