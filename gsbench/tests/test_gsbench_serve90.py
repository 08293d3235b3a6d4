"""The cell ``bench300k.serve90`` (``bench300k.serve``'s views due at 90 Hz)
at ``bench300k.serve``'s tiny size on the CPU: the run is correct and
reports its metrics, and the share of frames on time reads the
requests' due and done times; a run loads no JAX."""

import subprocess
import sys
from types import SimpleNamespace

import pytest

from gsbench import harness
from gsbench.tests.helpers import tiny

CELL = "bench300k.serve90"


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(bench, trace):
    run = harness.run_cell(bench, CELL, 2 ** 31 + 90, 1.0, trace, device="cpu",
                           overrides=tiny("bench300k.serve"))
    line = harness.result_line(run)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == 90
    kind = "per_layer" if trace else "end_to_end"
    assert set(line["metrics"]) <= {m["name"] for m in harness.cell_metrics(bench, CELL, kind)}
    on_time = harness.load_metric("frames_on_time.serve90")(run)
    if trace:
        # left out where the loop never caught up after the traced requests
        # (a CPU view takes longer than a period)
        assert on_time is None or 0.0 <= on_time <= 100.0
        assert (on_time is None) == ("frames_on_time.serve90" not in line["metrics"])
    else:
        assert {"setup_s", "frames_per_s"} <= set(line["metrics"])
        assert 0.0 <= on_time <= 100.0


def test_frames_on_time_reads_due_and_done():
    read = harness.load_metric("frames_on_time.serve90")
    period = 1.0 / 90
    fixed = {"arrival": "fixed", "rate_hz": 90}
    requests = [dict(due=i * period, done=i * period + lat, ok=ok) for i, (lat, ok) in
                enumerate([(0.005, True), (period, True), (0.012, True), (0.004, False)])]
    # on time and answered: the first two (one right at the period)
    assert read(SimpleNamespace(mix=fixed, requests=requests, traced=0)) == pytest.approx(50.0)
    assert read(SimpleNamespace(mix={"arrival": "closed"}, requests=requests, traced=0)) is None
    assert read(SimpleNamespace(mix=fixed, requests=[], traced=0)) is None


def test_frames_on_time_skips_the_profilers_backlog():
    """Traced: the first request traced, then a stop that held the loop
    up for four periods; the count starts at the first request due after
    the one before it had finished."""
    read = harness.load_metric("frames_on_time.serve90")
    period = 1.0 / 90
    done = [0.005, 5 * period, 5 * period + 0.003, 5 * period + 0.006, 5 * period + 0.009,
            5 * period + 0.0105, 6 * period + 0.005, 7 * period + 0.02, 8 * period + 0.005]
    requests = [dict(due=i * period, done=d, ok=True) for i, d in enumerate(done)]
    run = SimpleNamespace(mix={"arrival": "fixed", "rate_hz": 90}, requests=requests, traced=1)
    # requests 6-8 count: 6 and 8 on time, 7 late
    assert read(run) == pytest.approx(100.0 * 2 / 3)
    # untraced, every request counts: 0, 5, 6 and 8 on time
    run.traced = 0
    assert read(run) == pytest.approx(100.0 * 4 / 9)


def test_the_cell_loads_no_jax():
    code = f"""
import json, sys
sys.path.insert(0, {str(harness.ROOT)!r})
from gsbench import harness
from gsbench.tests.helpers import tiny
bench = json.load(open({str(harness.ROOT / "BENCHMARK.json")!r}))
harness.result_line(harness.run_cell(bench, {CELL!r}, 5, 0.5, True, device="cpu",
                                     overrides=tiny("bench300k.serve")))
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
