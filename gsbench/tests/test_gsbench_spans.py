"""The readers of the program's spans and counters (``gsbench/spans.py``)
on a hand-made trace, and on tiny traced CPU runs of every cell."""

import time
from types import SimpleNamespace

import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing
from gsbench import harness, spans
from gsbench.tests.helpers import cpu_run

# two requests; the device runs each operation a little after its launch
HOST = [
    ("gsbench.request#0", 0.0, 1.0), ("gsbench.request#1", 1.0, 2.0),
    ("gs.render", 0.1, 0.6), ("gs.preprocess", 0.1, 0.3), ("gs.binning", 0.3, 0.5),
    ("cudaLaunchKernel", 0.15, 0.151), ("cudaLaunchKernel", 0.2, 0.201),
    ("cudaLaunchKernel", 0.35, 0.351), ("cudaMemcpyAsync", 0.4, 0.401),
    ("cudaMemsetAsync", 0.42, 0.421),
    ("cudaLaunchKernel", 0.55, 0.551), ("cudaLaunchKernel", 0.7, 0.701),
    ("cudaStreamSynchronize", 0.71, 0.95),
    ("gs.render", 1.1, 1.5), ("gs.preprocess", 1.1, 1.2),
    ("cudaLaunchKernelExC", 1.15, 1.151), ("cuLaunchKernel", 1.3, 1.301),
    # the autograd engine's launch, from its own thread, inside the
    # caller's span
    ("gs.backward", 1.6, 1.9), ("cudaLaunchKernel", 1.7, 1.701),
]
OPS = [
    ("k0", 0.20, 0.21), ("k1", 0.25, 0.27), ("k2", 0.40, 0.43),
    ("Memcpy DtoH (Device -> Pageable)", 0.45, 0.46),
    ("Memset (Device)", 0.50, 0.51),
    ("k3", 0.60, 0.65), ("k4", 0.80, 0.90), ("k5", 1.20, 1.22), ("k6", 1.35, 1.40),
    ("k7", 1.75, 1.80),
]


def coverage(trace, prefix: str = "gs.") -> dict:
    """Shares of the device time of every operation in the trace: those
    launched inside some span whose name starts with ``prefix``, and those
    whose launch was not matched."""
    starts = spans.launch_starts(trace)
    total = sum(o[2] - o[1] for o in trace.ops)
    inside = spans.Intervals([(s, e) for n, s, e in trace.host if n.startswith(prefix)])
    matched = [(t, o[2] - o[1]) for t, o in zip(starts, trace.ops) if t is not None]
    held = inside.holds([t for t, _ in matched]) if matched else []
    return {"ops": len(trace.ops), "unmatched_ops": starts.count(None),
            "in_spans": sum(d for (_, d), ok in zip(matched, held) if ok) / total,
            "unmatched": (total - sum(d for _, d in matched)) / total}


def fake_run(host=HOST, ops=OPS):
    reqs = {0: (0.0, 1.0), 1: (1.0, 2.0)}
    trace = harness.Trace(ops=list(ops), host=list(host), requests=reqs,
                          spans=[(0.0, 2.0)])
    return SimpleNamespace(trace=trace, traced=2, requests=[], window_start=0.0)


def test_launches_are_paired_kind_by_kind():
    starts = spans.launch_starts(fake_run().trace)
    assert starts == [0.15, 0.2, 0.35, 0.4, 0.42, 0.55, 0.7, 1.15, 1.3, 1.7]


def test_launches_pair_across_a_clock_offset():
    # the device's clock mapped 60 ms early onto the host's: an operation
    # seems to start before its launch, and keeps its launch all the same
    ops = [(n, s - 0.06, e - 0.06) for n, s, e in OPS]
    run = fake_run(ops=ops)
    assert spans.launch_starts(run.trace) == spans.launch_starts(fake_run().trace)
    assert spans.span_device_ms(run, "gs.binning") == pytest.approx(1e3 * 0.05 / 2)


def test_span_readers_on_a_hand_made_trace():
    run = fake_run()
    # request 0: k0 + k1; request 1: k5
    assert spans.span_device_ms(run, "gs.preprocess") == pytest.approx(1e3 * 0.05 / 2)
    assert spans.span_device_ms(run, "gs.preprocess", within="gs.render") == \
        pytest.approx(1e3 * 0.05 / 2)
    assert spans.span_device_ms(run, "gs.preprocess", within="gs.fovea") == 0.0
    # k2, the copy and the fill
    assert spans.span_device_ms(run, "gs.binning") == pytest.approx(1e3 * 0.05 / 2)
    assert spans.span_device_ms(run, ("gs.preprocess", "gs.binning")) == \
        pytest.approx(1e3 * 0.10 / 2)
    assert spans.span_host_ms(run, "gs.preprocess") == pytest.approx(1e3 * 0.3 / 2)
    # four kernel launches in request 0's view, two in request 1's; copies
    # are not kernel launches
    assert spans.span_launches(run, "gs.render") == pytest.approx(3.0)
    assert spans.span_launches(run, "gs.backward") == pytest.approx(0.5)


def test_unmatched_operations_are_counted():
    # the fill's call is gone: the fill is not paired, and the copy and the
    # kernels still are
    run = fake_run(host=[h for h in HOST if h[0] != "cudaMemsetAsync"])
    cov = coverage(run.trace)
    total = sum(e - s for _, s, e in OPS)
    assert cov["ops"] == len(OPS) and cov["unmatched_ops"] == 1
    assert spans.launch_starts(run.trace)[4] is None
    assert cov["unmatched"] == pytest.approx(0.01 / total)
    # everything but k4 (launched outside every span) and the fill
    assert cov["in_spans"] == pytest.approx((total - 0.10 - 0.01) / total)
    # a device reader does not guess what it cannot place
    assert spans.span_device_ms(run, "gs.binning") is None


def test_a_missing_launch_leaves_its_operation_out():
    # k2's launch, mid-trace, is gone: paired in order, every later kernel
    # would land on the span of the launch before it, so no kernel is paired
    host = [h for h in HOST if h[1] != 0.35]
    run = fake_run(host=host)
    starts = spans.launch_starts(run.trace)
    kernels = [i for i, o in enumerate(OPS) if o[0].startswith("k")]
    assert all(starts[i] is None for i in kernels)
    assert [starts[3], starts[4]] == [0.4, 0.42]  # the copy and the fill
    assert coverage(run.trace)["unmatched_ops"] == len(kernels)
    for names in ("gs.preprocess", "gs.binning", "gs.render"):
        assert spans.span_device_ms(run, names) is None
    # launch counts need no pairing
    assert spans.span_launches(run, "gs.render") == pytest.approx(2.5)


def test_readers_find_nothing_without_the_programs_spans():
    host = [h for h in HOST if not h[0].startswith("gs.")]
    run = fake_run(host=host)
    assert spans.span_device_ms(run, "gs.preprocess") is None
    assert spans.span_host_ms(run, "gs.gaze.prep") is None
    assert spans.span_launches(run, "gs.render") is None
    assert spans.counter_percent(run, "gs.preprocess.active", "gs.preprocess.rows") is None
    assert spans.span_device_ms(SimpleNamespace(trace=None), "gs.preprocess") is None


def test_counter_percent_keeps_the_traced_requests_counts():
    tracing._records.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        tracing.count("gs.preprocess.rows", 4)
        tracing.count("gs.preprocess.active", 3)
        done = time.perf_counter() - t0
        tracing.count("gs.preprocess.rows", 10)  # after the traced requests
    run = SimpleNamespace(traced=1, window_start=t0,
                          requests=[dict(start=0.0, done=done), dict(start=done, done=1e9)])
    assert spans.counter_percent(run, "gs.preprocess.active", "gs.preprocess.rows") == 75.0
    tracing._records.clear()


# the metrics a tiny traced CPU run reports (no device operations there,
# so no device milliseconds) and, where known, their values
CPU_METRICS = {
    "bench300k.serve": {"render_launches.serve": 0.0, "active_rows.serve": 100.0},
    "scene1m.serve": {"render_launches.serve": 0.0, "active_rows.serve": 100.0 * 2000 / 4096},
    "scene1m.eyetrack": {"eye_prep_ms.eyetrack": None},
    "bench300k.train": {"backward_launches.train": 0.0},
}


@pytest.mark.parametrize("cell", list(CPU_METRICS))
def test_traced_cpu_run_reports_the_programs_metrics(bench, cell):
    line = harness.result_line(cpu_run(bench, cell, 2 ** 31 + 17, trace=True))
    assert line["correct"] is True
    new = {m["name"] for m in bench["per_layer"] if m["source"] in
           ("program_span", "program_counter") and cell in m["workloads"]
           and m["name"] not in ("loss_ms.train", "backward_ms.train")}
    got = {k: v["value"] for k, v in line["metrics"].items() if k in new}
    assert set(got) == set(CPU_METRICS[cell])
    for name, want in CPU_METRICS[cell].items():
        if want is None:
            assert got[name] > 0
        else:
            assert got[name] == pytest.approx(want)


def test_an_untraced_run_records_nothing(bench):
    tracing._records.clear()
    line = harness.result_line(cpu_run(bench, "bench300k.serve", 5))
    assert not tracing.is_on() and tracing.counters() == []
    assert not set(line["metrics"]) & {m["name"] for m in bench["per_layer"]}
