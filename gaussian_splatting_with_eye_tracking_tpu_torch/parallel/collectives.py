"""The collectives of the multi-device steps, over one mesh axis.

JAX takes these from ``lax`` inside ``shard_map``: ``psum``, ``ppermute``,
``all_to_all``, ``all_gather`` and ``pmax``, and differentiates them by
their transposes. Here a mesh axis of n devices is a process group of n
ranks (``Mesh``), one process per device, and each differentiable
collective is a ``torch.autograd.Function`` whose backward is written out:

- ``psum`` of a per-rank partial: the forward sums over the ranks and the
  backward is the identity. Every rank backpropagates its own copy of the
  global loss, which reaches only its own partial, and the steps sum the
  parameter gradients once, after the backward. (``torch.distributed.nn``'s
  ``all_reduce`` sums again in its backward, which would multiply every
  gradient by the number of ranks.)
- ``ppermute_halo``: rows to both neighbours on the axis, zeros at the
  unpaired edges; the backward sends each halo's gradient back to the rank
  it came from.
- ``all_to_all`` of fixed blocks: its own reverse, in the backward too.
- ``all_gather`` along a dimension: every rank computes the same function
  of the gathered tensor, so its share of that loss is 1/n of it; the
  backward gives each rank its slice of the gradient summed over the ranks
  and divided by n (JAX's psum_scatter of a replicated output's cotangent).
- ``pmax`` and ``pany`` for flags, without gradient.

Every rank issues the same collectives in the same order, the backwards
included. The halo moves both directions in one batch of point-to-point
ops, so two neighbours never wait on each other's later batch.

A mesh with no process group is one rank alone: every collective is then
the identity. A one-rank group still runs its collectives (a one-rank NCCL
group exercises the NCCL path).

gloo implements only ``broadcast`` and ``all_reduce`` for CUDA tensors. On
a gloo group (``torch.distributed.get_backend`` says "gloo") a CUDA
tensor's ``all_gather``, ``all_to_all`` and point-to-point ops therefore
go through host memory: a copy to the host, the op, a copy back. The
compute stays on the card. The choice is made by the backend's name, never
by catching an error.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One axis of ``size`` ranks: the port's ``jax.sharding.Mesh``.

    ``group`` is the process group (None for a one-rank mesh with no
    process group), ``rank`` this process's place on the axis (-1 when it
    is not on the mesh) and ``device`` where its tensors live."""

    group: Optional[dist.ProcessGroup]
    axis: str
    size: int
    rank: int
    device: torch.device

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _staged(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory for an op that gloo has no
    CUDA implementation of (all_gather, all_to_all, send, recv)."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _global_rank(mesh: Mesh, rank: int) -> int:
    return dist.get_global_rank(mesh.group, rank)


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh (no gradient)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """In-place broadcast of the mesh's first rank's ``t`` (no gradient)."""
    if mesh.group is not None:
        dist.broadcast(t, src=_global_rank(mesh, 0), group=mesh.group)
    return t


def gather_stacked(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(size, *t.shape): every rank's ``t``, in rank order (no gradient)."""
    if mesh.group is None:
        return t[None]
    src = t.contiguous()
    if _staged(mesh, src):
        src = src.cpu()
    out = src.new_empty((mesh.size,) + tuple(src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(t.device)


def _all_to_all(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Block j of ``t`` (split on dim 0) goes to rank j; block i of the
    result came from rank i."""
    if mesh.group is None:
        return t.clone()
    src = t.contiguous()
    if _staged(mesh, src):
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.to(t.device)


def _neighbour_exchange(to_prev: torch.Tensor, to_next: torch.Tensor, mesh: Mesh):
    """Send ``to_prev`` to rank - 1 and ``to_next`` to rank + 1; return
    (what rank - 1 sent forward, what rank + 1 sent back), zeros at the
    axis' ends. One batch of point-to-point ops."""
    from_prev = torch.zeros_like(to_next)
    from_next = torch.zeros_like(to_prev)
    if mesh.group is None or mesh.size == 1:
        return from_prev, from_next
    staged = _staged(mesh, to_prev)
    bufs = [x.contiguous().cpu() if staged else x.contiguous()
            for x in (to_prev, to_next, from_prev, from_next)]
    ops = []
    if mesh.rank > 0:
        peer = _global_rank(mesh, mesh.rank - 1)
        ops += [dist.P2POp(dist.isend, bufs[0], peer, mesh.group),
                dist.P2POp(dist.irecv, bufs[2], peer, mesh.group)]
    if mesh.rank < mesh.size - 1:
        peer = _global_rank(mesh, mesh.rank + 1)
        ops += [dist.P2POp(dist.isend, bufs[1], peer, mesh.group),
                dist.P2POp(dist.irecv, bufs[3], peer, mesh.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return bufs[2].to(to_prev.device), bufs[3].to(to_prev.device)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, top, bottom, mesh):
        ctx.mesh = mesh
        return _neighbour_exchange(top, bottom, mesh)

    @staticmethod
    def backward(ctx, g_above, g_below):
        # the halo from above was rank - 1's bottom rows: its gradient goes
        # back there, and the one from below to rank + 1's top rows
        g_top_from_prev, g_bottom_from_next = _neighbour_exchange(
            g_above.contiguous(), g_below.contiguous(), ctx.mesh)
        return g_top_from_prev, g_bottom_from_next, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        parts = gather_stacked(x, mesh)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = all_reduce_(g.contiguous().clone(), mesh) / mesh.size
        return g.chunk(mesh.size, dim=ctx.dim)[mesh.rank].contiguous(), None, None


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the ranks; its gradient passes through unchanged."""
    return _PSum.apply(x, mesh)


def ppermute_halo(top: torch.Tensor, bottom: torch.Tensor, mesh: Mesh):
    """(rows from above, rows from below): rank - 1's ``bottom`` and rank +
    1's ``top``, zeros where there is no such rank (the image's zero
    padding). JAX's two ``ppermute`` calls of ``_band_local_loss``."""
    return _Halo.apply(top, bottom, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` (size, ...) split on dim 0: block j to rank j; returns the
    blocks received, block i from rank i. Differentiable."""
    return _AllToAll.apply(x, mesh)


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (JAX's
    ``all_gather(..., tiled=True)``). Differentiable."""
    return _AllGather.apply(x, mesh, dim)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Elementwise maximum over the ranks (no gradient)."""
    return all_reduce_(x.detach().clone(), mesh, dist.ReduceOp.MAX)


def pany(flag: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Whether ``flag`` (bool) is set on any rank, on every rank."""
    return pmax(flag.to(torch.int32), mesh) > 0
