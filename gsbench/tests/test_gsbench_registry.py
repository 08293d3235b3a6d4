"""BENCHMARK.json and the files it names: every configuration, mix, cell
and metric is found by name."""

import json
import re

from gsbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell, config, mix, limits = harness.resolve(bench, w["name"])
        assert config["name"] == w["config"]
        assert mix["entry"] in ("serve", "eyetrack", "train")
        assert limits and all(isinstance(v, (int, float)) for v in limits.values())
        if mix["arrival"] == "fixed":
            assert mix["rate_hz"] > 0


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"]))


def test_names_and_shapes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for cell in cells:
        reported = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert len(json.dumps(bench)) < 64 * 1024
