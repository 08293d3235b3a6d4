"""Column expands of a compact table: by segment starts (K1) and along an
index vector (K6).

Port of ``expand_rows_by_segments`` and ``expand_rows`` in
``gaussian_splatting_with_eye_tracking_tpu/ops/expand.py`` (the TPU kernels
``_expand_seg_kernel`` and ``_expand_kernel``). On a CUDA tensor each
launches its hand-written kernel in ``csrc/expand_seg.cu``; on a CPU
tensor it runs its ``*_plain`` version. All are bit-exact copies.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend

EXPAND_SEG = backend.CudaKernel(
    "expand_seg", "expand_seg", "expand_seg_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)
EXPAND_ROWS = backend.CudaKernel(
    "expand_rows", "expand_seg", "expand_rows_launch",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def expand_rows_by_segments_plain(table: torch.Tensor, seg_row: int, k: int) -> torch.Tensor:
    """out (C, k) with out[:, j] = table[:, c] for c = clamp(upper_bound(
    seg, j) - 1, 0, Nc - 1), seg = table[seg_row] (nondecreasing exact-int
    f32 segment starts, +inf on columns that own no slots). Slots past the
    last segment resolve to the last live column; with no live column at
    all every slot copies column 0."""
    nc = table.shape[1]
    seg = table[seg_row].contiguous()
    slots = torch.arange(k, dtype=torch.float32, device=table.device)
    ck = (torch.searchsorted(seg, slots, right=True) - 1).clamp(0, nc - 1)
    return table[:, ck]


def expand_rows_by_segments(table: torch.Tensor, seg_row: int, k: int) -> torch.Tensor:
    """See ``expand_rows_by_segments_plain``; table (C, Nc) float32."""
    if table.device.type == "cpu":
        return expand_rows_by_segments_plain(table, seg_row, k)
    backend.check_cuda_tensor("table", table, torch.float32)
    c, nc = table.shape
    if nc == 0 or not 0 <= seg_row < c:
        raise ValueError(f"expand: bad table shape {tuple(table.shape)} / seg_row {seg_row}")
    if k >= 1 << 24:
        raise ValueError(f"expand: k={k} slots exceed exact float32 slot ids")
    out = torch.empty((c, k), dtype=torch.float32, device=table.device)
    if k > 0:
        EXPAND_SEG(table.data_ptr(), c, nc, seg_row, out.data_ptr(), k,
                   backend.stream_ptr(table))
    return out


def expand_rows_plain(table: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    """out (C, K) with out[:, k] = table[:, clamp(ck[k], 0, Nc - 1)]; ck
    (K,) int32, nondecreasing in every caller (the kernel is correct for
    any order, only slower)."""
    return table[:, ck.long().clamp(0, table.shape[1] - 1)]


def expand_rows(table: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    """See ``expand_rows_plain``; table (C, Nc) float32, ck (K,) int32.
    Nothing on the package's paths calls it, as in the JAX package."""
    if table.device.type == "cpu":
        return expand_rows_plain(table, ck)
    backend.check_cuda_tensor("table", table, torch.float32)
    backend.check_cuda_tensor("ck", ck, torch.int32)
    if table.dim() != 2 or table.shape[1] == 0 or ck.dim() != 1:
        raise ValueError(f"expand_rows: bad shapes table {tuple(table.shape)}, "
                         f"ck {tuple(ck.shape)}")
    if ck.device != table.device:
        raise ValueError(f"expand_rows: table on {table.device}, ck on {ck.device}")
    c, nc = table.shape
    k = ck.shape[0]
    out = torch.empty((c, k), dtype=torch.float32, device=table.device)
    if k > 0:
        EXPAND_ROWS(table.data_ptr(), c, nc, ck.data_ptr(), out.data_ptr(), k,
                    backend.stream_ptr(table))
    return out
