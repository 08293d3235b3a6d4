"""The port's spans and counters (``tracing.py``) on the CPU: off, they
are the shared no-op and record nothing; under ``torch.profiler`` the
served view, the foveated view, the gaze and a train step leave their
spans in the exported trace, each inside its parent; preprocess counts
its rows and active rows; nothing computed changes with tracing on; and
``device_ops`` sums the same device time with the spans' device-side
ranges as without them. Tiny sizes: 200 gaussians in 256 slots at 64x64,
a 64x96 eye."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

import chip_smoke as cs
from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene, renderer, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch import track_render, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet

N, SLOTS, W, H = 200, 256, 64, 64
CAPACITY = 1 << 12
VIEW = ("gs.activate", "gs.preprocess", "gs.binning", "gs.composite", "gs.assemble")
# each path's spans: child -> parent
NESTING = {
    "serve": {**{s: "gs.render" for s in VIEW}, "gs.render": None},
    "fovea": {**{s: "gs.fovea" for s in VIEW}, "gs.levels": "gs.fovea", "gs.fovea": None},
    "gaze": {"gs.gaze.prep": "gs.gaze", "gs.gaze.net": "gs.gaze",
             "gs.gaze.centroid": "gs.gaze", "gs.gaze": None},
    "train": {**{s: "gs.render" for s in VIEW}, "gs.render": None, "gs.loss": None,
              "gs.backward": None, "gs.optimizer": None},
}


@pytest.fixture(autouse=True)
def tracing_restored():
    """Each test starts with nothing kept, and leaves the module so (xdist
    workers run other files in the same process)."""
    tracing._records.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tracing._records.clear()
    torch.set_num_threads(threads)


def profiled(fn):
    """``fn()`` under a CPU profiler, which turns tracing on."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracing.is_on()
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def world():
    scene = bench_scene.make_random_gaussians(N, seed=3, sh_degree=3)
    raw = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
           for k, v in bench_scene.raw_params(*scene).items()}
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, 1.0)
    state = gm.init_training(gm.GaussianParams(**raw), 3, tx, capacity=SLOTS)
    cam = bench_scene.make_camera(W, H, device="cpu")
    step = train_lib.make_train_step(tx, opt, 3, W, H, CAPACITY, device="cpu")
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(1))
    return dict(state=state, cam=cam, step=step, gt=gt, bg=torch.zeros(3),
                model=ritnet.load_pretrained(device="cpu"),
                eye=cs.make_eye(seed=2, height=64, width=96))


def run_path(world, path):
    """The path's outputs, as tensors and arrays."""
    state, cam, bg = world["state"], world["cam"], world["bg"]
    if path == "serve":
        with torch.no_grad():
            out = renderer.render(cam, state, bg, max_instances=CAPACITY)
        return [out.color, out.final_t, out.radii, out.num_instances]
    if path == "fovea":
        color, st = track_render.foveated_view(state, cam, bg, (0.4, 0.6), 3,
                                               radii=(8.0, 16.0, 32.0), max_instances=CAPACITY)
        return [color, st.tile_levels, st.offsets, st.gauss_id]
    if path == "gaze":
        uv, cls = track_render.estimate_gaze(world["eye"], world["model"], device="cpu")
        return [torch.from_numpy(np.asarray(uv)), cls]
    new, aux = world["step"](state, *train_lib.camera_arrays(cam), world["gt"], bg, True)
    return [*new.params, *new.opt_state.mu, *new.opt_state.nu, new.xyz_grad_accum,
            new.denom, new.max_radii2d, aux.loss, aux.image]


def traced_spans(world, path, tmp_path) -> list:
    """(name, start, end) of the program's spans in the chrome trace of
    one call of ``path`` under a CPU profiler."""
    _, prof = profiled(lambda: run_path(world, path))
    trace = tmp_path / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith("gs.")]


def test_off_is_the_shared_no_op(world):
    assert not tracing.is_on()
    assert tracing.span("gs.render") is tracing.NO_SPAN
    assert tracing.span("anything") is tracing.NO_SPAN
    tracing.count("gs.preprocess.rows", 1)
    run_path(world, "serve")
    assert tracing.counters() == []


@pytest.mark.parametrize("path", list(NESTING))
def test_spans_nest_under_the_profiler(world, path, tmp_path):
    spans = traced_spans(world, path, tmp_path)
    assert not tracing.is_on()  # the profiler has stopped
    assert {n for n, _, _ in spans} == set(NESTING[path])
    for name, s, e in spans:
        parent = NESTING[path][name]
        inside = [(ps, pe) for n, ps, pe in spans if n == parent and ps <= s and e <= pe]
        assert parent is None or inside, f"{name} outside {parent}"
        if parent is None:  # a top-level span lies inside no other
            assert not [n for n, ps, pe in spans if n != name and ps <= s and e <= pe
                        and NESTING[path][n] is None]
    if path == "train":
        starts = {n: s for n, s, _ in reversed(spans)}
        order = sorted(("gs.render", "gs.loss", "gs.backward", "gs.optimizer"), key=starts.get)
        assert order == ["gs.render", "gs.loss", "gs.backward", "gs.optimizer"]


def test_preprocess_counts_rows_and_active_rows(world):
    profiled(lambda: run_path(world, "serve"))
    counts = {c.name: c.value for c in tracing.counters()}
    assert counts == {"gs.preprocess.rows": SLOTS, "gs.preprocess.active": N}
    assert [c.value for c in tracing.counters()] == [SLOTS, N]


@pytest.mark.parametrize("path", list(NESTING))
def test_outputs_equal_with_tracing_on_and_off(world, path):
    off = run_path(world, path)
    on, _ = profiled(lambda: run_path(world, path))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_spans_are_user_annotations(world):
    """Each span's events carry the profiler's user-annotation flag, which
    is what ``device_ops`` leaves out of the device's events."""
    _, prof = profiled(lambda: run_path(world, "serve"))
    spans = [e for e in prof.events() if e.name.startswith("gs.")]
    assert {e.name for e in spans} == set(NESTING["serve"])
    assert all(e.is_user_annotation for e in spans)
    assert not any(e.is_user_annotation for e in prof.events() if e.name.startswith("aten::"))
    assert tracing.device_ops(prof.events()) == []  # no device on the CPU


def test_device_ops_sum_is_the_same_with_the_spans():
    """The events of two requests on the card, as the profiler gives them:
    kernels and a copy, their launch calls on the host, and, with tracing
    on, the spans on the host and their device-side ranges over the
    kernels launched inside them."""
    def event(i, name, start, end, device=DeviceType.CUDA, note=False):
        return FunctionEvent(i, name, 0, start, end, device_type=device,
                             is_user_annotation=note)

    device = [event(1, "k_preprocess", 10.0, 14.0), event(2, "k_binning", 15.0, 22.0),
              event(3, "Memcpy DtoH", 22.0, 23.0), event(4, "k_blend", 30.0, 41.0)]
    host = [event(5, "cudaLaunchKernel", 2.0, 3.0, DeviceType.CPU),
            event(6, "aten::mul", 1.0, 4.0, DeviceType.CPU)]
    spans = [event(7, "gs.render", 0.0, 45.0, DeviceType.CPU, True),
             event(8, "gs.render", 10.0, 41.0, note=True),
             event(9, "gs.preprocess", 10.0, 14.0, note=True),
             event(10, "gs.binning", 15.0, 23.0, note=True)]

    def device_us(events):
        return sum(e.time_range.elapsed_us() for e in tracing.device_ops(events))

    assert device_us(device + host) == 4.0 + 7.0 + 1.0 + 11.0
    assert device_us(device + host + spans) == device_us(device + host)
    assert tracing.device_ops(spans + device) == device
