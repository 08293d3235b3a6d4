"""A short run of every cell on the card, as the benchmark's command runs
it (skips without a card)."""

import json
import subprocess
import sys

import pytest

from gsbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["bench300k.serve", "scene1m.eyetrack", "bench300k.train",
                                  "scene1m.serve"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "gsbench.run", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line["checks"]
