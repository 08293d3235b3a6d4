"""What the per-layer metric readers share (``gsbench/metrics/<name>.py``
each call one of these with its own arguments). A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import numpy as np

from gsbench import work


def mean_span_ms(run, name: str):
    """Mean duration of the window's host-clock spans called ``name``."""
    d = [e - s for n, _, s, e in run.spans if n == name]
    return 1e3 * float(np.mean(d)) if d else None


def mean_event_ms(run, start: str, end: str):
    """Mean time between two of the program's CUDA events over the traced
    steps."""
    d = [ev[end] - ev[start] for ev in run.events if start in ev and end in ev]
    return float(np.mean(d)) if d else None


def kernel_share(run, kernel: str, key: str):
    """Per cent of a kernel's device time that the least time of the
    counted work of the sampled requests takes: the kernel's launches in
    the trace, one per traced request in order, matched to the sampled
    requests. None unless the trace holds exactly one launch per traced
    request."""
    if run.trace is None or not run.work:
        return None
    ops = run.trace.device_ops(kernel)
    if len(ops) != run.traced:
        return None
    bound = sum(work.least_seconds(**run.work[i][key]) for i in run.work)
    spent = sum(ops[i][2] - ops[i][1] for i in run.work)
    return 100.0 * bound / spent if spent > 0 else None


def request_share(run, key: str = "request"):
    """Per cent of the mean time of the requests that ran after the traced
    ones (no profiler on them) that the least time of a sampled request's
    counted work takes. A closed loop's requests are timed together: the
    window past the traced ones over their count."""
    if not run.work or run.traced >= len(run.requests):
        return None
    bound = np.mean([work.least_seconds(**run.work[i][key]) for i in run.work])
    rest = run.requests[run.traced:]
    if run.mix["arrival"] == "closed":
        each = (run.window_s - rest[0]["start"]) / len(rest)
    else:
        each = float(np.mean([r["done"] - r["start"] for r in rest]))
    return 100.0 * bound / each if each > 0 else None


def device_idle(run):
    """Per cent of the traced requests' time in which no device operation
    ran (an open loop's waits between requests are not counted)."""
    if run.trace is None or run.trace.length() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy() / run.trace.length())
