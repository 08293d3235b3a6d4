"""Small sizes for the benchmark's CPU tests."""

import copy
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def tiny(cell: str) -> dict:
    """The overrides that shrink a cell to a CPU test's size."""
    with open(HERE / "tiny_cells.json") as f:
        out = copy.deepcopy(json.load(f)[cell])
    cfg_file = {"bench300k": "bench300k.json", "scene1m": "scene1m.json"}[cell.split(".")[0]]
    with open(HERE.parent / "configs" / cfg_file) as f:
        full = json.load(f)
    if "train_slots" in out["config"]:
        out["config"]["train"] = dict(full["train"], slots=out["config"].pop("train_slots"))
    return out


def cpu_run(bench, cell, seed, seconds=1.0, trace=False, control=False):
    from gsbench import harness

    return harness.run_cell(bench, cell, seed, seconds, trace, device="cpu", control=control,
                            overrides=tiny(cell))
