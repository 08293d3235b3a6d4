"""The readers ``binning_kernel.serve`` and ``binning_kernel.binocular``
on hand-made counters: 100 x the pairs counted through the hand-written
binning pipeline (K8) over the pairs counted, and None where no pair went
through it."""

import pytest

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gsbench import harness, spans

READERS = ("binning_kernel.serve", "binning_kernel.binocular")
PAIRS = [tracing.Count("gs.binning.pairs", 5000, 0.1),
         tracing.Count("gs.binning.pairs", 3000, 1.1)]
KERNEL = [tracing.Count("gs.binning.kernel", 5000, 0.1),
          tracing.Count("gs.binning.kernel", 3000, 1.1)]


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("counts, expected", [
    (PAIRS + KERNEL, pytest.approx(100.0)),
    # the CPU's plain route, or a program without the kernel's counter
    (PAIRS, None),
    ([], None),
], ids=["through_k8", "no_kernel_counter", "no_counter"])
def test_binning_kernel_reader(monkeypatch, name, counts, expected):
    monkeypatch.setattr(spans, "program_counts", lambda run: counts)
    assert harness.load_metric(name)(None) == expected
