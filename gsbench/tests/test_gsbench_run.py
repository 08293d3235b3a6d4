"""Whole runs of every cell at a tiny size on the CPU: the result line,
the traced line, and the checks passing for the program's plain path."""

import json
import subprocess
import sys

import pytest

from gsbench import harness
from gsbench.tests.helpers import cpu_run, tiny

CELLS = ["bench300k.serve", "scene1m.eyetrack", "bench300k.train", "scene1m.serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_prints_the_line(bench, cell, capsys):
    run = cpu_run(bench, cell, 2 ** 31 + 5)
    harness.emit(harness.result_line(run))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "checks"}
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("cell", ["bench300k.serve", "bench300k.train"])
def test_traced_cpu_run(bench, cell):
    line = harness.result_line(cpu_run(bench, cell, 9, trace=True))
    assert line["correct"] is True
    assert "breakdown" in line and line["device"]["window_s"] > 0
    assert set(line["metrics"]) <= {m["name"] for m in bench["per_layer"]}


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload", "bench300k.serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_overflowed_view_counts_as_failed(bench):
    """A served view whose instances overflow the capacity is counted in
    ``failed`` and not in ``frames_per_s``."""
    small = tiny("bench300k.serve")
    small["config"].update(max_instances=64, max_live=64)
    run = harness.run_cell(bench, "bench300k.serve", 6, 1.0, False, device="cpu",
                           overrides=small)
    line = harness.result_line(run)
    assert line["failed"] == line["attempted"] > 0
    assert "frames_per_s" not in line["metrics"] or line["metrics"]["frames_per_s"]["value"] == 0
