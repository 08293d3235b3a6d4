"""Multi-process runs: process-group wiring and moving state onto a mesh.

Port of ``gaussian_splatting_with_eye_tracking_tpu/parallel/multihost.py``.
A rank is one process on one device; the global mesh is one axis over
every rank (``collectives.Mesh``).

- ``maybe_initialize_distributed``: one call at program start, before the
  first device use. Explicit arguments first, then torchrun's variables
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` /
  ``LOCAL_RANK``); with neither it does nothing and returns False.
- ``make_global_mesh``: the mesh over every rank.
- ``replicate_to_mesh`` / ``shard_to_mesh``: a tree of tensors (a
  ``GaussianModelState``, a camera's arrays) as every rank's copy,
  broadcast from the first rank, or as this rank's rows of every
  leading-``cap`` leaf.
- ``process_local_value``: a value on the host, the rows of every rank
  gathered where a mesh is given.

The backend is NCCL for a CUDA device and gloo for ``device="cpu"``. NCCL
cannot place two ranks on one device, so where the ranks on a host
outnumber its cards (``LOCAL_WORLD_SIZE`` above the device count), the
ranks share the cards through gloo (see ``collectives`` for what gloo
stages through host memory). Every group has a finite timeout, so that a
rank that hangs fails the run instead of stalling it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gaussian_splatting_with_eye_tracking_tpu_torch.backend import resolve_device
from gaussian_splatting_with_eye_tracking_tpu_torch.parallel.collectives import (
    Mesh,
    broadcast_,
    gather_stacked,
)

TIMEOUT_S = 300.0  # init and every collective

_DEVICE: Optional[torch.device] = None  # this rank's device, set at init
_HOST_GROUP = None  # agree_max's gloo group


def maybe_initialize_distributed(init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 local_rank: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group when a multi-process run is configured.

    ``init_method`` is a ``tcp://host:port`` address; ``device`` is
    "cpu" (gloo) or CUDA (the default; NCCL, or gloo where ranks share a
    card); ``backend`` overrides the backend. Sets this rank's CUDA
    device to ``local_rank % device_count``. Returns True when the group
    is (or already was) initialized."""
    global _DEVICE
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if init_method is None or world_size is None:
        return False
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = local_rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
        local_ranks = int(env.get("LOCAL_WORLD_SIZE", world_size))
        default = "gloo" if local_ranks > torch.cuda.device_count() else "nccl"
    else:
        default = "gloo"
    dist.init_process_group(backend or default, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE = dev
    return True


def is_distributed() -> bool:
    """Whether this process is one of several ranks."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device=None) -> torch.device:
    """This rank's device: the one chosen at init, else ``device``
    (CUDA unless told otherwise)."""
    if device is None and _DEVICE is not None:
        return _DEVICE
    return resolve_device(device)


def make_global_mesh(axis: str = "tiles", device=None) -> Mesh:
    """The mesh over every rank, in rank order (adjacent bands on adjacent
    ranks: the SSIM halo goes to the neighbouring rank). Without a process
    group, a one-rank mesh on ``device``."""
    dev = local_device(device)
    if not dist.is_initialized():
        return Mesh(None, axis, 1, 0, dev)
    return Mesh(dist.group.WORLD, axis, dist.get_world_size(), dist.get_rank(), dev)


def tree_map(fn, tree):
    """``fn`` on every tensor of a tree of NamedTuples, tuples, lists and
    dicts; other leaves (ints, None) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def replicate_to_mesh(tree, mesh: Mesh):
    """Every tensor of ``tree`` on this rank's device, broadcast from the
    mesh's first rank, so that every rank holds the same state."""
    def put(x):
        x = x.to(mesh.device)
        if x.dtype == torch.bool:  # broadcast as bytes: not every backend has bool
            return broadcast_(x.to(torch.uint8), mesh).to(torch.bool)
        return broadcast_(x.contiguous().clone(), mesh)

    return tree_map(put, tree)


def shard_to_mesh(tree, mesh: Mesh, cap: int):
    """This rank's rows of every tensor whose leading dimension is ``cap``
    (rank r holds rows [r cap/n, (r+1) cap/n)), on its device; the other
    tensors whole. Every rank holds the same ``tree``; ``cap`` must divide
    by the mesh size."""
    if cap % mesh.size:
        raise ValueError(f"capacity {cap} not divisible by mesh size {mesh.size}")
    rows = cap // mesh.size

    def put(x):
        if x.dim() >= 1 and x.shape[0] == cap:
            x = x[mesh.rank * rows:(mesh.rank + 1) * rows]
        return x.to(mesh.device).contiguous().clone()

    return tree_map(put, tree)


def process_local_value(x: torch.Tensor, mesh: Optional[Mesh] = None) -> np.ndarray:
    """``x`` on the host. With ``mesh``, ``x`` is this rank's rows of a
    sharded tensor and the result every rank's rows in rank order (a
    collective: every rank calls it)."""
    if mesh is not None:
        parts = gather_stacked(x.detach(), mesh)
        x = parts.reshape((-1,) + tuple(x.shape[1:]))
    return x.detach().cpu().numpy()


def agree_max(values) -> list:
    """Host numbers made the same on every rank: their elementwise maximum
    over the ranks, as float64 (the values themselves outside a
    multi-process run). A host decision taken from what a step read back
    (a capacity, an overflow, a non-finite loss) then comes out the same
    everywhere, and no rank leaves the others waiting at a collective. The
    sum runs on the host, over a gloo group, so that it waits for no work
    queued on a card."""
    global _HOST_GROUP
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    if is_distributed():
        if _HOST_GROUP is None:  # created on every rank at its first call
            _HOST_GROUP = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return t.tolist()
