"""Shared helpers for the PyTorch port's tests: numpy bridges from the JAX
package's fixtures to CPU tensors of the port. It imports no JAX, so the
tests that run on a CUDA machine (which has no JAX) can use it too."""

from __future__ import annotations

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams


def to_torch(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor (copied, so it is writable)."""
    return torch.from_numpy(np.array(x))


def cam_to_torch(cam) -> CameraParams:
    """The JAX package's CameraParams as the port's, on the CPU."""
    return CameraParams(
        viewmatrix=to_torch(cam.viewmatrix), projmatrix=to_torch(cam.projmatrix),
        campos=to_torch(cam.campos), tan_fovx=float(cam.tan_fovx),
        tan_fovy=float(cam.tan_fovy), width=cam.width, height=cam.height,
    )


def assert_close(got: torch.Tensor, want, atol: float, rtol: float = 0.0, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=msg)


def assert_equal(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=msg)



def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(argvs, envs=None, cwd=None):
    """One subprocess per argument list, the repository on the path and
    torch on 2 threads each; output captured."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i, argv in enumerate(argvs):
        env = dict(os.environ, OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
        env.update((envs or [{}] * len(argvs))[i])
        procs.append(subprocess.Popen(argv, env=env, cwd=cwd or repo,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs, timeout: float = 120.0) -> list:
    """Wait for every rank, at most ``timeout`` seconds in all; kill them
    all and fail if one runs into it or exits non-zero. Returns their
    output."""
    import subprocess
    import time

    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"ranks ran past {timeout} s and were killed")
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError(f"ranks exited with {codes}:\n" + "\n".join(
            f"--- rank {i} ---\n{log[-4000:]}" for i, log in enumerate(logs)))
    return logs
