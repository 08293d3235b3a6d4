"""The port's spans on a CUDA card (marked ``cuda``; they skip where there
is no card): under ``torch.profiler`` each span also leaves a device-side
range over the work launched inside it, and ``tracing.device_ops`` leaves
those ranges out, so its operations are exactly the kernels, copies and
fills of the exported trace; binning (K8) asks the runtime for no
synchronisation, allocation or copy. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing_cuda.py -q
"""

import json

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import bench_scene, renderer, tracing
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_device_ops_are_the_traces_device_operations(dev, tmp_path):
    scene = bench_scene.make_random_gaussians(20000, seed=1, sh_degree=3)
    raw = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dev)
           for k, v in bench_scene.raw_params(*scene).items()}
    state = gm.state_from_params(gm.GaussianParams(**raw), 3)
    cam = bench_scene.make_camera(256, 256, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        renderer.render(cam, state, bg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        for _ in range(2):
            renderer.render(cam, state, bg)
        torch.cuda.synchronize()
    events = prof.events()
    # the spans' device-side ranges (the profiler leaves one for the spans
    # that launched work directly, not for every span)
    ranges = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith("gs.")]
    assert ranges and all(e.is_user_annotation for e in ranges)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    ops = tracing.device_ops(events)
    assert not any(e.name.startswith("gs.") for e in ops)
    assert len(ops) == len(trace)
    assert sum(e.time_range.elapsed_us() for e in ops) == pytest.approx(
        sum(float(e["dur"]) for e in trace), rel=1e-3)


def test_binning_neither_synchronises_nor_allocates(dev, tmp_path):
    """Inside ``gs.binning`` (K8, after a warm-up view) the CUDA runtime is
    asked for kernel launches and fills only: no synchronisation, no
    cudaMalloc or cudaFree, no copy (the caching allocator serves the
    workspace; the counts stay on the card)."""
    scene = bench_scene.make_random_gaussians(20000, seed=1, sh_degree=3)
    raw = {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)).to(dev)
           for k, v in bench_scene.raw_params(*scene).items()}
    state = gm.state_from_params(gm.GaussianParams(**raw), 3)
    cam = bench_scene.make_camera(256, 256, device=dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        renderer.render(cam, state, bg)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        for _ in range(2):
            renderer.render(cam, state, bg)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "gs.binning"]
    calls = [e["name"] for e in events if e.get("cat") == "cuda_runtime"
             and any(s <= float(e["ts"]) <= t for s, t in spans)]
    assert len(spans) == 2 and calls.count("cudaLaunchKernel") >= 2 * 10
    assert not [c for c in calls if any(w in c for w in ("Synchronize", "Malloc", "Free",
                                                         "Memcpy"))], sorted(set(calls))
