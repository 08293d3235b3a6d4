"""No run loads JAX or the JAX package, compared by whole top-level
module name; the reference imports nothing of the program."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import torch

from gsbench import harness
from gsbench import run as run_module
from gsbench.tests.helpers import cpu_run, tiny

GSBENCH = Path(harness.__file__).resolve().parent
PORT = "gaussian_splatting_with_eye_tracking_tpu_torch"

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
from gsbench import harness
from gsbench.tests.helpers import cpu_run, tiny
bench = json.load(open({bench!r}))
for cell in [w["name"] for w in bench["workloads"]]:
    run = cpu_run(bench, cell, 3)
    harness.result_line(run)  # the metric readers, as run.main calls them
    assert run.checks
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    code = PROBE.format(root=str(harness.ROOT), bench=str(harness.ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_and_the_reference_none_of_the_program():
    for path in GSBENCH.rglob("*.py"):
        assert not _imports(path) & set(harness.FORBIDDEN), path
    for path in (GSBENCH / "reference").glob("*.py"):
        assert PORT not in path.read_text(), path


def test_forbidden_names_compare_whole():
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert "gaussian_splatting_with_eye_tracking_tpu" in harness.FORBIDDEN


def test_a_module_loaded_after_the_window_stops_the_line(bench, monkeypatch, capsys):
    """JAX loaded by the check or a metric reader, after the window has
    closed, still leaves the run without a result line."""
    card = {"seen": True}  # a card for run.main's look, none for the run itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card["seen"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real = harness.run_cell

    def cpu_cell(bench, cell, seed, seconds, trace, **k):
        card["seen"] = False
        return real(bench, cell, seed, seconds, trace, device="cpu", overrides=tiny(cell))

    monkeypatch.setattr(harness, "run_cell", cpu_cell)
    line = harness.result_line

    def loads_flax(run):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return line(run)

    monkeypatch.setattr(harness, "result_line", loads_flax)
    rc = run_module.main(["--workload", "bench300k.serve", "--seed", "4", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 4 and out.strip() == "" and "flax" in err
