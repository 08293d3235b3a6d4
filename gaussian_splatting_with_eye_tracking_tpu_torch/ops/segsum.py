"""Contiguous-segment row sums (kernel K4), over a table or gathered.

Port of ``segment_sum_bounds`` in
``gaussian_splatting_with_eye_tracking_tpu/ops/segsum.py`` (the TPU kernel
``_segsum_kernel``): ``out[:, g]`` is the sum of the table's columns
``[bounds[g], bounds[g+1])``. ``segment_sum_gather`` sums the same
segments of a slot axis whose slot j reads column ``src[j]`` of the
values (nothing where ``src[j] < 0``): the per-gaussian reduction of the
backward compositor's per-instance gradients (``ops/blend.py``), read
where the backward wrote them, with no table in gaussian-id order built
first. On a CUDA tensor both launch the hand-written kernel
``csrc/segsum.cu`` (deterministic: every sum in a fixed order); on a CPU
tensor they run their ``*_plain`` versions.

The gather reads values in the record layout: column c is the 48-byte
record ``storage[c, 0:12]``, row r its float r, as ``records`` allocates
and ``record_rows`` views it.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend

MAX_ROWS = 16  # rows a table may have (the kernel sums up to REC per launch)
REC = 12  # floats per record of the gather's values

SEGSUM = backend.CudaKernel(
    "segsum", "segsum", "segsum_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)


def records(columns: int, device) -> torch.Tensor:
    """Uninitialised (columns, REC) float32 storage of the record layout."""
    return torch.empty((columns, REC), dtype=torch.float32, device=device)


def record_rows(storage: torch.Tensor, rows: int) -> torch.Tensor:
    """The (rows, columns) view of a record storage: row r is float r of
    every record."""
    return storage[:, :rows].T


def _is_record_view(values: torch.Tensor) -> bool:
    return (values.dim() == 2 and values.shape[0] <= REC
            and values.stride() == (1, REC) and values.data_ptr() % 16 == 0)


def segment_sum_bounds_plain(table: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """(R, S) table, (N+1,) nondecreasing bounds -> (R, N) in the table's
    dtype: float64 prefix sums and their differences at the bounds
    (clamped to [0, S]), as the JAX function's CPU branch computes them.
    An empty segment gives 0."""
    rows, s = table.shape
    csum = torch.cat([torch.zeros((rows, 1), dtype=torch.float64, device=table.device),
                      torch.cumsum(table.to(torch.float64), dim=1)], dim=1)
    at_b = csum[:, bounds.to(torch.int64).clamp(0, s)]
    return (at_b[:, 1:] - at_b[:, :-1]).to(table.dtype)


def _check_bounds(bounds: torch.Tensor):
    backend.check_cuda_tensor("bounds", bounds, torch.int32)
    if bounds.dim() != 1 or bounds.shape[0] < 1:
        raise ValueError(f"segsum: bad bounds shape {tuple(bounds.shape)}")


def segment_sum_bounds(table: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """See ``segment_sum_bounds_plain``; table (R, S) float32 with R <= 16,
    bounds (N+1,) int32."""
    if table.device.type == "cpu":
        return segment_sum_bounds_plain(table, bounds)
    backend.check_cuda_tensor("table", table, torch.float32)
    _check_bounds(bounds)
    rows, s = table.shape
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"segsum: table has {rows} rows, not 1..{MAX_ROWS}")
    n = bounds.shape[0] - 1
    out = torch.empty((rows, n), dtype=torch.float32, device=table.device)
    if n > 0:
        for r0 in range(0, rows, REC):  # a launch per REC rows (contiguous slices)
            part = table[r0:r0 + REC]
            SEGSUM(part.data_ptr(), part.shape[0], s, None, s, bounds.data_ptr(), n,
                   out[r0:r0 + REC].data_ptr(), backend.stream_ptr(table))
    return out


def segment_sum_gather_plain(values: torch.Tensor, src: torch.Tensor,
                             bounds: torch.Tensor) -> torch.Tensor:
    """(R, K) values, (S,) int src (column per slot, < 0 for none), (N+1,)
    nondecreasing bounds over the slots -> (R, N): ``segment_sum_bounds_plain``
    of the table whose slot j is column ``src[j]`` (zero where < 0)."""
    src = src.to(torch.int64)
    table = values[:, src.clamp_min(0)] * (src >= 0).to(values.dtype)
    return segment_sum_bounds_plain(table, bounds)


def segment_sum_gather(values: torch.Tensor, src: torch.Tensor,
                       bounds: torch.Tensor) -> torch.Tensor:
    """See ``segment_sum_gather_plain``; values (R, K) float32 with R <=
    REC (on CUDA read in place when it is a ``record_rows`` view, else
    copied into records first), src (S,) int32, bounds (N+1,) int32."""
    if values.device.type == "cpu":
        return segment_sum_gather_plain(values, src, bounds)
    if values.dtype != torch.float32:
        raise ValueError(f"values: expected torch.float32, got {values.dtype}")
    backend.check_cuda_tensor("src", src, torch.int32)
    _check_bounds(bounds)
    rows, k = values.shape
    if not 1 <= rows <= REC or src.dim() != 1:
        raise ValueError(f"segsum: bad shapes values {tuple(values.shape)}, "
                         f"src {tuple(src.shape)}")
    if not _is_record_view(values):
        storage = records(k, values.device)
        storage[:, :rows] = values.T
        values = record_rows(storage, rows)
    n = bounds.shape[0] - 1
    out = torch.empty((rows, n), dtype=torch.float32, device=values.device)
    if n > 0:
        SEGSUM(values.data_ptr(), rows, k, src.data_ptr(), src.shape[0], bounds.data_ptr(),
               n, out.data_ptr(), backend.stream_ptr(values))
    return out
