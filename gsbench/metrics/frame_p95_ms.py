"""95th percentile of request latency over every request of the window:
from its start (a closed loop) or from when it was due (an open loop, so
a request that waits for the one before counts the wait) to its image
synchronised on the device."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return 1e3 * float(np.percentile([r["done"] - r["due"] for r in run.requests], 95))
