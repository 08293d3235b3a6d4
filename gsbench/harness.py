"""One run of one cell: set-up, the measured window, the trace, the check
and the result line.

Everything that belongs to one configuration, traffic mix, entry path or
metric sits in a file of its own that this module finds by name:
``configs/<config>.json``, ``mixes/<traffic>.json``, ``entries/<entry>.py``
(named by the mix), ``metrics/<metric>.py`` and ``cells/<cell>.json`` (the
cell's own calibration: an open loop's rate, the check's limits).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from gsbench import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no run may load: JAX, its libraries and
# the JAX package (the port's own name begins with it, so compare whole names)
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "gaussian_splatting_with_eye_tracking_tpu")


def clock() -> float:
    return time.perf_counter()


@dataclass
class Trace:
    """A profiler trace of the window's first requests, in seconds. Its
    window is the union of those requests' intervals (an open loop's waits
    between requests are not in it; a closed loop's last step lasts until
    the device has finished it)."""

    ops: list  # (name, start, end) of every device operation
    host: list  # (name, start, end) of every host op and annotation
    requests: dict  # request index -> (start, end) of its annotation
    spans: list  # the window: disjoint (start, end), in order

    def length(self) -> float:
        return sum(e - s for s, e in self.spans)

    def device_ops(self, substring: str) -> list:
        return sorted((o for o in self.ops if substring in o[0]), key=lambda o: o[1])

    def _busy_intervals(self) -> list:
        out = []
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals, within the window)."""
        return sum(max(0.0, min(e, we) - max(s, ws))
                   for s, e in self._busy_intervals() for ws, we in self.spans
                   if s < we and e > ws)

    def gaps(self) -> list:
        """(start, end) of the window's intervals with no device operation."""
        busy = self._busy_intervals()
        out = []
        for ws, we in self.spans:
            t = ws
            for s, e in busy:
                if e <= t or s >= we:
                    continue
                if s > t:
                    out.append((t, s))
                t = max(t, e)
            if t < we:
                out.append((t, we))
        return out


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(v) for v in out]


@dataclass
class Run:
    bench: dict
    cell: dict
    config: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace_on: bool
    device: object
    t0: float
    control: bool = False
    n_requests: int = 0
    sample: list = field(default_factory=list)
    traced: int = 0  # requests [0, traced) ran under the profiler
    traced_limit: int = 0  # how many the profiler is to cover
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    requests: list = field(default_factory=list)  # dict(due, start, done, ok)
    spans: list = field(default_factory=list)  # (name, request, start, end), window clock
    events: list = field(default_factory=list)  # per traced step: {phase: ms}
    trace: Optional[Trace] = None
    work: dict = field(default_factory=dict)  # sampled request -> {name: work dict}
    checks: dict = field(default_factory=dict)  # name -> (value, limit)
    memory_peak: int = 0
    power_limit: Optional[str] = None
    window_start: float = 0.0

    @property
    def cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)) == "cuda"

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def span(self, name: str, i: int, start: float, end: float):
        self.spans.append((name, i, start - self.window_start, end - self.window_start))


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str, root: Path = ROOT) -> tuple:
    """(cell, config, mix, limits) of a workload of ``bench``, each read
    from its file by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[cell["config"]]["file"])
    mix = read_json(HERE / "mixes" / f"{cell['traffic']}.json")
    own = read_json(HERE / "cells" / f"{workload}.json")
    if "rate_hz" in own:
        mix["rate_hz"] = own["rate_hz"]
    return cell, config, mix, own["limits"]


def load_metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or where that
    is missing the one shared by every metric of its stem (the part before
    the first dot: ``device_idle.serve`` -> ``metrics/device_idle.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"gsbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell_name: str, kind: str) -> list:
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def card_line() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   if torch.cuda.is_available() else [ProfilerActivity.CPU])
    prof.start()
    return prof


def _read_profile(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    ops, host, reqs = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((e["name"], s, s + d))
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append((e["name"], s, s + d))
            if cat == "user_annotation" and e["name"].startswith("gsbench.request#"):
                reqs[int(e["name"].split("#")[1])] = (s, s + d)
    spans = [list(v) for _, v in sorted(reqs.items())]
    if spans:
        # the last request lasts until the device has finished its work
        spans[-1][1] = max([spans[-1][1]] + [o[2] for o in ops if o[1] >= spans[-1][0]])
    return Trace(ops=ops, host=host, requests=reqs, spans=_union(spans))


def _window(run: Run, system) -> None:
    """The measured window: an open loop (requests due at i / rate) or a
    closed one (back to back until the window ends; a control run, which
    answers only the sampled requests, ends after the last of them). The
    first ``trace_requests`` requests run under the profiler when
    tracing."""
    import torch

    n_trace = run.traced_limit = int(run.mix.get("trace_requests", 0)) if run.trace_on else 0
    prof = _start_profiler() if n_trace else None
    run.sync()
    t0 = run.window_start = clock()
    closed = run.mix["arrival"] == "closed"
    i = 0
    while True:
        if closed:
            if run.control and run.sample:
                ended = i > run.sample[-1]
            else:
                ended = clock() - t0 >= run.seconds
            if ended:
                break
            due = clock() - t0
        else:
            if i >= run.n_requests:
                break
            due = i / run.mix["rate_hz"]
            wait = due - (clock() - t0)
            if wait > 0:
                time.sleep(wait)
        start = clock() - t0
        try:
            if prof is not None and i < n_trace:
                with torch.profiler.record_function(f"gsbench.request#{i}"):
                    ok = system.request(i)
            else:
                ok = system.request(i)
        except (RuntimeError, ValueError) as err:
            print(f"request {i} failed: {err!r}", file=sys.stderr)
            ok = False
        run.requests.append(dict(due=due, start=start, done=clock() - t0, ok=bool(ok)))
        i += 1
        if prof is not None and i == n_trace:
            run.sync()
            prof.stop()
            run.traced = n_trace
    system.finish()
    run.sync()
    done = clock() - t0
    if closed:
        run.requests[-1]["done"] = done
    run.window_s = done
    if prof is not None:
        if run.traced == 0:  # the window ended inside the traced requests
            prof.stop()
            run.traced = i
        run.trace = _read_profile(prof)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, control: bool = False,
             overrides: Optional[dict] = None) -> Run:
    """Set up, measure and check one run. ``overrides`` replaces parts of
    the cell's config, mix or limits (the CPU tests' small sizes)."""
    import torch

    cell, config, mix, limits = resolve(bench, workload)
    for key, val in (overrides or {}).items():
        {"config": config, "mix": mix, "limits": limits}[key].update(val)
    run = Run(bench=bench, cell=cell, config=config, mix=mix, limits=limits, seed=seed,
              seconds=seconds, trace_on=trace, device=torch.device(device),
              t0=clock() if t0 is None else t0, control=control)
    run.n_requests = traffic.request_count(mix, seconds)
    rng = np.random.default_rng([seed, 7])
    # the requests checked: drawn among those due (an open loop), or among the
    # first ``check_below`` (a closed loop; its entry also keeps the last);
    # among the traced ones in a traced run. A mix with neither checks
    # its set-up's steps (training).
    hi = run.n_requests if mix["arrival"] == "fixed" else int(mix.get("check_below", 0))
    if hi:
        hi = min(int(mix.get("trace_requests", 0)), hi) if trace else hi
        run.sample = traffic.sample(rng, 0, max(hi, 1), int(mix["check_requests"]))
    entry = importlib.import_module(f"gsbench.entries.{mix['entry']}")
    system = entry.prepare(run)
    # what set-up made lives to the end: keep it out of the collector's
    # full passes inside the window
    gc.collect()
    gc.freeze()
    run.sync()
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = clock() - run.t0
    _window(run, system)
    if run.cuda:
        run.memory_peak = int(torch.cuda.max_memory_allocated())
        run.power_limit = card_line()
    gc.unfreeze()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {', '.join(bad)}")
    system.check(run)
    return run


def evaluate(run: Run) -> dict:
    """The cell's end-to-end metrics (untraced) or per-layer ones (traced),
    each from its reader; a reader that finds nothing returns None and the
    metric is left out."""
    kind = "per_layer" if run.trace_on else "end_to_end"
    out = {}
    for m in cell_metrics(run.bench, run.cell["name"], kind):
        value = load_metric(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing (the innermost host op or annotation over
    each gap's middle)."""
    by_op = {}
    for name, s, e in trace.ops:
        key = name.replace("(anonymous namespace)", "anon").split("(")[0][:120] or "(unnamed)"
        by_op[key] = by_op.get(key, 0.0) + (e - s)
    host = sorted(trace.host, key=lambda h: h[1])
    starts = np.array([h[1] for h in host]) if host else np.zeros(0)
    by_gap = {}
    for gs, ge in trace.gaps():
        mid = 0.5 * (gs + ge)
        best = None
        for j in range(int(np.searchsorted(starts, mid, side="right")) - 1, -1, -1):
            name, s, e = host[j]
            if e >= mid and (best is None or s > best[1]):
                best = host[j]
            if mid - s > 5.0:
                break
        key = best[0].split("#")[0][:120] if best else "no host op"
        by_gap[key] = by_gap.get(key, 0.0) + (ge - gs)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def result_line(run: Run) -> dict:
    import torch

    ok = [r for r in run.requests if r["ok"]]
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
              "count": 1, "memory_peak_bytes": run.memory_peak,
              "card": run.power_limit}
    correct = bool(run.checks) and all(v <= lim for v, lim in run.checks.values()
                                       if not math.isnan(v)) and not any(
        math.isnan(v) for v, _ in run.checks.values())
    out = {"correct": correct, "attempted": len(run.requests),
           "failed": len(run.requests) - len(ok), "metrics": evaluate(run), "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy()
        device["window_s"] = run.trace.length()
        out["breakdown"] = breakdown(run.trace)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def emit(line: dict) -> None:
    """Each number compared beside its limit, as the last lines on standard
    error; the result as the last line of standard output."""
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
