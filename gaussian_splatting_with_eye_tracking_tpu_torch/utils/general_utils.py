"""Seeding and timestamped output.

Port of ``safe_state`` from
``gaussian_splatting_with_eye_tracking_tpu/utils/general_utils.py`` (the
reference's ``utils/general_utils.py``): seed Python's, numpy's and
PyTorch's generators and timestamp every line written to stdout.
"""

from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStdout:
    def __init__(self, old, silent: bool):
        self.old = old
        self.silent = silent

    def write(self, x):
        if self.silent:
            return
        if x.endswith("\n"):
            ts = datetime.now().strftime("%d/%m %H:%M:%S")
            self.old.write(x.replace("\n", f" [{ts}]\n"))
        else:
            self.old.write(x)

    def flush(self):
        self.old.flush()


def safe_state(silent: bool = False, seed: int = 0):
    """Seed the host generators and ``torch.manual_seed`` (every device),
    and timestamp stdout lines (all of them dropped when ``silent``).
    Replaces ``sys.stdout`` for the rest of the process, as the reference
    does."""
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
