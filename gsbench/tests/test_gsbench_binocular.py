"""The cell ``hmd1m.binocular`` at a tiny size on the CPU (its small
sizes are carried here): the run is correct and loads no JAX, the
lower-precision control fails, a frame rendered with the two eyes' gazes
swapped fails ``frame_max_abs`` and ``levels_off``, and its per-layer
readers read a hand-made trace."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from gaussian_splatting_with_eye_tracking_tpu_torch import track_render, tracing
from gsbench import harness, spans, work

WEIGHTS = "gaussian_splatting_with_eye_tracking_tpu_torch/models/weights/ritnet_best.npz"
# per-eye 112x96 views (the last tile column and row cropped), the rings
# scaled with the views' height as the configuration's are; 200x320 eyes,
# the smallest at which the vendored RITnet finds the pupil (at 96x160
# every gaze reads the image centre)
TINY = {
    "hmd1m.binocular": {
        "config": {"scene": {"kind": "point_cloud", "n": 2000, "sh_degree": 3, "extent": 2.5},
                   "width": 112, "height": 96, "max_instances": 1 << 15, "slots": 4096,
                   "foveation": {"rings": [12.0, 24.0, 48.0], "decimation": [1, 1, 1, 1]},
                   "eye": {"height": 200, "width": 320, "weights": WEIGHTS}},
        "mix": {"path_len": 4, "check_below": 1, "trace_requests": 2}},
}
CELL = "hmd1m.binocular"


def cpu_run(bench, seed, trace=False, control=False, overrides=None):
    return harness.run_cell(bench, CELL, seed, 1.0, trace, device="cpu", control=control,
                            overrides=overrides or TINY[CELL])


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(bench, trace):
    run = cpu_run(bench, 2 ** 31 + 17, trace=trace)
    line = harness.result_line(run)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"] for m in harness.cell_metrics(bench, CELL, kind)}
    if not trace:
        assert {"setup_s", "frames_per_s", "frame_p95_ms"} <= set(line["metrics"])
    else:
        # on the CPU no device time is read; the program's counter is
        assert line["metrics"]["gaze_batch.binocular"]["value"] == 2.0
        assert "eye_prep_ms.binocular" in line["metrics"]


def test_the_control_fails(bench):
    run = cpu_run(bench, 21, control=True)
    assert harness.result_line(run)["correct"] is False


def test_swapped_gazes_fail_the_frame(bench, monkeypatch):
    """Each eye rendered with the other's gaze: the gazes read right, the
    frames and the tiles' levels do not."""
    frame = track_render.binocular_frame

    def swapped(state, cams, bg, gaze_uvs, *a, **k):
        return frame(state, cams, bg, gaze_uvs[::-1], *a, **k)

    monkeypatch.setattr(track_render, "binocular_frame", swapped)
    run = cpu_run(bench, 23)
    value, limit = run.checks["frame_max_abs"]
    assert value > limit and harness.result_line(run)["correct"] is False
    value, limit = run.checks["levels_off"]
    assert value > limit
    assert run.checks["gaze_px"][0] <= run.checks["gaze_px"][1]


def test_the_cell_loads_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
from gsbench import harness
from gsbench.tests import test_gsbench_binocular as t
bench = json.load(open({str(harness.ROOT / "BENCHMARK.json")!r}))
harness.result_line(t.cpu_run(bench, 3))
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# two headset frames; each: the prep and the net inside gs.gaze, the
# shared activation, then two gs.fovea, each with a preprocess launch, a
# binning launch and a K5 launch
HOST = []
OPS = []
for r, t0 in enumerate((0.0, 1.0)):
    HOST += [
        (f"gsbench.request#{r}", t0, t0 + 1.0), ("gs.binocular", t0 + 0.05, t0 + 0.95),
        ("gs.gaze", t0 + 0.05, t0 + 0.35), ("gs.gaze.prep", t0 + 0.05, t0 + 0.25),
        ("gs.gaze.net", t0 + 0.25, t0 + 0.3),
        ("cudaLaunchKernel", t0 + 0.26, t0 + 0.261),
        ("gs.activate", t0 + 0.4, t0 + 0.45), ("cudaLaunchKernel", t0 + 0.41, t0 + 0.411),
    ]
    for f0 in (t0 + 0.5, t0 + 0.7):
        HOST += [("gs.fovea", f0, f0 + 0.2),
                 ("gs.preprocess", f0 + 0.01, f0 + 0.02),
                 ("cudaLaunchKernel", f0 + 0.011, f0 + 0.012),
                 ("gs.binning", f0 + 0.02, f0 + 0.04),
                 ("cudaLaunchKernel", f0 + 0.021, f0 + 0.022),
                 ("cudaLaunchKernel", f0 + 0.05, f0 + 0.051)]
    OPS += [("conv", t0 + 0.27, t0 + 0.29), ("cat", t0 + 0.42, t0 + 0.43)]
    for f0, k5 in ((t0 + 0.5, 0.04), (t0 + 0.7, 0.02)):
        OPS += [("preprocess_kernel", f0 + 0.012, f0 + 0.013),
                ("sort", f0 + 0.022, f0 + 0.027),
                ("blend_levels_kernel", f0 + 0.06, f0 + 0.06 + k5)]
K5 = dict(sfu=0.0, flops=0.0, nbytes=3.35e12 * 0.01)  # 10 ms at the HBM peak


def fake_run(ops=OPS, work_=None):
    trace = harness.Trace(ops=list(ops), host=list(HOST), requests={0: (0.0, 1.0),
                                                                    1: (1.0, 2.0)},
                          spans=[(0.0, 2.0)])
    return SimpleNamespace(trace=trace, traced=2, requests=[], window_start=0.0,
                           work=work_ if work_ is not None else {1: {"k5_eyes": [K5, K5]}})


def test_binocular_readers_on_a_hand_made_trace(monkeypatch):
    run = fake_run()
    read = {m: harness.load_metric(m) for m in (
        "eye_prep_ms.binocular", "ritnet_ms.binocular", "fovea_ms.binocular",
        "k5_roofline.binocular", "gaze_batch.binocular", "binning_ms.binocular",
        "preprocess_ms.binocular", "preprocess_kernel.binocular", "active_rows.binocular")}
    assert read["eye_prep_ms.binocular"](run) == pytest.approx(200.0)
    assert read["ritnet_ms.binocular"](run) == pytest.approx(20.0)
    # both eyes' preprocess, binning and K5, not the shared activation's copy
    assert read["fovea_ms.binocular"](run) == pytest.approx(2 + 10 + 60.0)
    assert read["binning_ms.binocular"](run) == pytest.approx(10.0)
    # the shared activation once, and each eye's preprocess
    assert read["preprocess_ms.binocular"](run) == pytest.approx(10.0 + 2.0)
    # request 1's two launches: 40 + 20 ms against 2 x 10 ms of least time
    assert read["k5_roofline.binocular"](run) == pytest.approx(100.0 * 0.02 / 0.06)
    # one K5 launch missing: not matched, left out
    assert read["k5_roofline.binocular"](fake_run(ops=OPS[:-1])) is None
    assert read["binning_ms.binocular"](fake_run(ops=OPS[:-1])) is None
    counts = [tracing.Count("gs.gaze.eyes", 2, 0.1), tracing.Count("gs.fovea.instances", 9, 0.6)]
    for t in (0.51, 0.71):  # each eye: 8 rows, 2 active, 6 through K7
        counts += [tracing.Count("gs.preprocess.rows", 8, t),
                   tracing.Count("gs.preprocess.active", 2, t),
                   tracing.Count("gs.preprocess.kernel", 6, t)]
    counts += [tracing.Count("gs.gaze.eyes", 2, 1.1)]
    monkeypatch.setattr(spans, "program_counts", lambda run: counts)
    assert read["gaze_batch.binocular"](run) == 2.0
    assert read["active_rows.binocular"](run) == pytest.approx(25.0)
    assert read["preprocess_kernel.binocular"](run) == pytest.approx(75.0)
    monkeypatch.setattr(spans, "program_counts", lambda run: [c for c in counts
                                                              if c.name != "gs.preprocess.kernel"])
    assert read["preprocess_kernel.binocular"](run) is None
    monkeypatch.setattr(spans, "program_counts", lambda run: [])
    assert read["gaze_batch.binocular"](run) is None
    assert read["active_rows.binocular"](run) is None
    assert work.least_seconds(**K5) == pytest.approx(0.01)
