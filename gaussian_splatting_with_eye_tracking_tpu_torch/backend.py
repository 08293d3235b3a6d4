"""Device choice and the hand-written kernels' build and loader.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds. All sources build together,
one ``nvcc`` process each, at the first launch of any kernel (or an explicit
``build_kernels()``), into ``build/kernels/`` at the repository root.
Code shared between sources lives in ``csrc/*.cuh`` headers. A library's
file name carries a digest of its source, the headers and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.

Every C entry point takes raw device pointers and the CUDA stream as
``void*``, launches on that stream and returns ``cudaGetLastError()``;
``CudaKernel.__call__`` raises when that is not 0 and otherwise adds one to
the kernel's ``launches`` counter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

# fp32 means fp32 on the card as well (TF32 keeps ~3 decimal digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# and a run repeats bit for bit: cuDNN picks only deterministic algorithms
# (its default choices for RITnet's weight gradients sum with atomics), and
# none by timing them first
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, Path] = {}
_KERNELS: list["CudaKernel"] = []


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. With no CUDA and no explicit request this raises instead of
    quietly running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def resolve_data_device(data_device: str) -> torch.device:
    """The device of a ``ModelConfig.data_device``: "cuda" (or "cuda:N"),
    which raises without a card, or "cpu". Any other value raises,
    including the JAX package's "tpu" read back from its ``cfg_args``."""
    if str(data_device).split(":")[0] not in ("cuda", "cpu"):
        raise ValueError(f"data_device {data_device!r}: the port runs on 'cuda' or 'cpu'")
    return resolve_device(data_device)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's install prefix
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_kernels() -> dict[str, float]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet, one
    ``nvcc`` per source, all started together. Returns {stem: seconds} for
    the sources built by this call; raises with the compiler's output on a
    failed build. ptxas' register/spill report goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if out.exists():
            _LIBS[src.stem] = out
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds = {}
    failures = []
    for stem, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds[stem] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"--- {stem} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        _LIBS[stem] = out
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def build_log(stem: str) -> str:
    """ptxas' report for a built library (registers, shared memory, spills)."""
    path = _LIBS.get(stem)
    if path is None or not path.with_suffix(".log").exists():
        return ""
    return path.with_suffix(".log").read_text()


class CudaKernel:
    """One C entry point of the library built from ``csrc/<stem>.cu``.

    ``launches`` counts the launches made through this wrapper; callers may
    reset it to 0."""

    def __init__(self, name: str, stem: str, symbol: str, argtypes: list):
        self.name = name
        self.stem = stem
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._errstr = None
        _KERNELS.append(self)

    def _load(self):
        if self._fn is None:
            if self.stem not in _LIBS:
                build_kernels()
            lib = ctypes.CDLL(str(_LIBS[self.stem]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._errstr = fn, err
        return self._fn

    def __call__(self, *args):
        fn = self._load()
        code = fn(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.name}: launch failed with CUDA error {code} "
                f"({self._errstr(code).decode()})")
        self.launches += 1


def kernels() -> list[CudaKernel]:
    """Every kernel wrapper defined by the modules imported so far."""
    return list(_KERNELS)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16):
    """Kernels that read ``t`` in 16-byte vectors (cp.async, float4) need
    its data to start on such a boundary, as fresh allocations do."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data is not {nbytes}-byte aligned")


def blocks_per_sm(stem: str) -> int:
    """CTAs of the kernel in ``csrc/<stem>.cu`` resident per SM, from its
    ``<stem>_blocks_per_sm`` entry (the CUDA runtime's occupancy query)."""
    if stem not in _LIBS:
        build_kernels()
    fn = getattr(ctypes.CDLL(str(_LIBS[stem])), f"{stem}_blocks_per_sm")
    fn.argtypes = []
    fn.restype = ctypes.c_int
    blocks = fn()
    if blocks < 0:
        raise RuntimeError(f"{stem}: occupancy query failed with CUDA error {-blocks}")
    return blocks
