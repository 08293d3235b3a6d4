"""The benchmark's own tests: CPU runs of every cell at a tiny size, the
reference against the program's plain path, the work counter, the
control and the planted faults, and the no-JAX rule. Tests marked
``cuda`` run a cell on the card and skip without one.

    python -m pytest gsbench/tests -q -p no:cacheprovider
"""

import json
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)
