"""Readers of the program's own spans and counters in a traced run.

The port's ``tracing`` module turns its spans on while a profiler
records, so a ``--trace 1`` run's trace holds them among its host
annotations (``gs.render``, ``gs.preprocess``, ...; the port's
``tracing.py`` lists them), and its counters are kept in the program with
the host clock of their count. Every reader returns None where the
program has no such span or counter (a program without tracing), and the
metric is then left out of the line.

A device operation belongs to the span that was open when its launch
call ran. The trace's runtime calls and device operations are paired in
launch order, kind by kind (kernels with the launch calls, copies with
the copy calls, fills with the memset calls): one stream runs its work
in the order it was launched. Where a kind's counts differ (the profiler
lost or added an event), no operation of that kind is paired, since one
missing launch would shift every later operation onto the wrong span,
and the device-time readers return None. Spans are compared by time,
never by thread: the autograd engine launches the backward from a thread
of its own while the caller waits inside ``gs.backward``.
"""

from __future__ import annotations

import numpy as np

from gsbench.harness import _union

KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                   "cuLaunchKernelEx")


def _op_kind(name: str) -> str:
    return "memcpy" if name.startswith("Memcpy") else \
        "memset" if name.startswith("Memset") else "kernel"


def _call_kind(name: str):
    if name in KERNEL_LAUNCHES:
        return "kernel"
    low = name.lower()
    return "memcpy" if "memcpy" in low else "memset" if "memset" in low else None


def launch_starts(trace) -> list:
    """Parallel to ``trace.ops``: the host start of the CUDA call that
    launched each operation, or None where its kind's counts of calls and
    operations differ. The pairs are not held to start after their call:
    the profiler maps the device's clock onto the host's only to a few
    microseconds, and where the card waits on the host, an operation
    starts within that of its launch."""
    out = [None] * len(trace.ops)
    for kind in ("kernel", "memcpy", "memset"):
        ops = sorted((o[1], i) for i, o in enumerate(trace.ops) if _op_kind(o[0]) == kind)
        calls = sorted(h[1] for h in trace.host if _call_kind(h[0]) == kind)
        if len(ops) == len(calls):
            for call, (_, i) in zip(calls, ops):
                out[i] = call
    return out


class Intervals:
    """The union of some spans' (start, end), for membership tests."""

    def __init__(self, spans):
        merged = _union(spans)
        self.starts = np.array([m[0] for m in merged])
        self.ends = np.array([m[1] for m in merged])

    def __len__(self):
        return len(self.starts)

    def holds(self, t) -> np.ndarray:
        t = np.asarray(t, dtype=float)
        if not len(self.starts):
            return np.zeros(t.shape, dtype=bool)
        k = np.searchsorted(self.starts, t, side="right") - 1
        return (k >= 0) & (t <= self.ends[np.maximum(k, 0)])


def named(trace, names) -> Intervals:
    names = {names} if isinstance(names, str) else set(names)
    return Intervals([(s, e) for n, s, e in trace.host if n in names])


def _requests(trace) -> list:
    return [trace.requests[i] for i in sorted(trace.requests)]


def _per_request(trace, times, weights=None):
    """Mean over the traced requests of the weights (1 each by default)
    of the times that fall in each request's annotation."""
    reqs = _requests(trace)
    if not reqs:
        return None
    times = np.asarray(times, dtype=float)
    weights = np.ones(len(times)) if weights is None else np.asarray(weights, dtype=float)
    total = sum(float(weights[(times >= s) & (times <= e)].sum()) for s, e in reqs)
    return total / len(reqs)


def span_device_ms(run, names, within=None):
    """Device ms per traced request of the operations launched inside a
    span of ``names`` (and, if given, inside one of ``within``); None
    where some operation's launch is not known."""
    trace = run.trace
    if trace is None or not trace.ops:
        return None
    spans = named(trace, names)
    if not len(spans):
        return None
    starts = launch_starts(trace)
    if None in starts:
        return None
    t = np.array(starts)
    inside = spans.holds(t)
    if within is not None:
        inside &= named(trace, within).holds(t)
    dur = np.array([o[2] - o[1] for o in trace.ops]) * inside
    return 1e3 * _per_request(trace, t, dur)


def span_host_ms(run, name: str):
    """Host ms per traced request of the spans called ``name``."""
    trace = run.trace
    if trace is None:
        return None
    spans = [(s, e) for n, s, e in trace.host if n == name]
    if not spans:
        return None
    return 1e3 * _per_request(trace, [s for s, _ in spans], [e - s for s, e in spans])


def span_launches(run, name: str):
    """Kernel launch calls per traced request inside spans called
    ``name`` (on any thread)."""
    trace = run.trace
    if trace is None:
        return None
    spans = named(trace, name)
    if not len(spans):
        return None
    t = np.array([s for n, s, _ in trace.host if n in KERNEL_LAUNCHES])
    return _per_request(trace, t[spans.holds(t)]) if len(t) else 0.0


def program_counts(run) -> list:
    """The program's ``tracing.counters()`` counted during the traced
    requests (host clock), or [] without them."""
    try:
        from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
    except ImportError:
        return []
    if not run.traced or not run.requests:
        return []
    lo = run.window_start + run.requests[0]["start"]
    hi = run.window_start + run.requests[run.traced - 1]["done"]
    return [c for c in tracing.counters() if lo <= c.t <= hi]


def counter_percent(run, num: str, den: str):
    """100 x the sum of counter ``num`` over the sum of counter ``den``
    during the traced requests."""
    counts = program_counts(run)
    top = sum(c.value for c in counts if c.name == num)
    bottom = sum(c.value for c in counts if c.name == den)
    return 100.0 * top / bottom if bottom else None
