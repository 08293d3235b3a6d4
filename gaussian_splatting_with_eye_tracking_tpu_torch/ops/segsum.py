"""Contiguous-segment row sums (kernel K4).

Port of ``segment_sum_bounds`` in
``gaussian_splatting_with_eye_tracking_tpu/ops/segsum.py`` (the TPU kernel
``_segsum_kernel``): ``out[:, g]`` is the sum of the table's columns
``[bounds[g], bounds[g+1])``. In the port it is the per-gaussian reduction
of the backward compositor's per-instance gradients once they stand in
gaussian-id order (``ops/blend.py``). On a CUDA tensor it launches the
hand-written kernel ``csrc/segsum.cu`` (deterministic: every sum in a fixed
order); on a CPU tensor it runs ``segment_sum_bounds_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend

MAX_ROWS = 16  # the CUDA kernel's row limit

SEGSUM = backend.CudaKernel(
    "segsum", "segsum", "segsum_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)


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


def segment_sum_bounds(table: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """See ``segment_sum_bounds_plain``; table (R, S) float32 with R <= 16,
    bounds (N+1,) int32."""
    if table.device.type == "cpu":
        return segment_sum_bounds_plain(table, bounds)
    backend.check_cuda_tensor("table", table, torch.float32)
    backend.check_cuda_tensor("bounds", bounds, torch.int32)
    rows, s = table.shape
    if not 1 <= rows <= MAX_ROWS or bounds.dim() != 1 or bounds.shape[0] < 1:
        raise ValueError(f"segsum: bad shapes table {tuple(table.shape)}, "
                         f"bounds {tuple(bounds.shape)}")
    n = bounds.shape[0] - 1
    out = torch.empty((rows, n), dtype=torch.float32, device=table.device)
    if n > 0:
        SEGSUM(table.data_ptr(), rows, s, bounds.data_ptr(), n, out.data_ptr(),
               backend.stream_ptr(table))
    return out
