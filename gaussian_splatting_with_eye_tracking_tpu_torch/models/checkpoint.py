"""Training checkpoints: one file, or one directory that every rank writes.

Port of ``save_checkpoint``, ``load_checkpoint`` and ``latest_checkpoint``
from ``gaussian_splatting_with_eye_tracking_tpu/models/checkpoint.py`` (the
reference's ``torch.save((capture(), iteration))``), and of its
multi-process checkpoints (``save_checkpoint_orbax`` /
``load_checkpoint_orbax``, which are orbax directories there):

- ``save_checkpoint`` / ``load_checkpoint``: a ``torch.save`` of plain
  containers of CPU tensors and ints (the parameters, the Adam state, the
  densification statistics, ``active``, the active SH degree, the
  iteration and a format version), written through a temporary file and
  ``os.replace``, so a crash never leaves half a checkpoint.
- ``save_checkpoint_dist`` / ``load_checkpoint_dist``: a directory
  ``<prefix><N>.shards`` written by every rank of a run together. A
  replicated state is written by the first rank alone; a gaussian-sharded
  one by every rank, its own rows. The first rank writes the metadata
  (layout, each shard's rows, the iteration, the version, and every
  rank's SHA-256 of its state: in the replicated layout they are equal
  when the replicas agree). The ranks write into ``<dir>.tmp``, meet, and
  the first rank renames it into place. Loading reassembles the whole
  state in one process, whatever the number of ranks that wrote it.
  With ``async_save=True`` (the JAX package's orbax saves) the call
  returns once the state is copied off the device, and a background
  thread writes the files; ``wait_for_async_saves`` joins it.

Every file is read with ``weights_only=True``, which unpickles no code.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
from typing import Optional, Tuple

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.models.gaussian_model import (
    AdamState,
    GaussianModelState,
    GaussianParams,
)

VERSION = 1
SHARDS = ".shards"  # the directory suffix of save_checkpoint_dist
_STATS = ("max_radii2d", "xyz_grad_accum", "denom")


def _fields(p: GaussianParams, fn) -> dict:
    return {name: fn(v) for name, v in zip(GaussianParams._fields, p)}


def state_to_dict(state: GaussianModelState, copy=None) -> dict:
    """The state as plain containers of CPU tensors and ints, each tensor
    through ``copy`` (by default ``Tensor.cpu``)."""
    def cpu(t):
        if t is None:
            return None
        return t.detach().cpu() if copy is None else copy(t.detach())

    opt = state.opt_state
    return {
        "params": _fields(state.params, cpu),
        "active": cpu(state.active),
        "sh_degree": int(state.sh_degree),
        **{k: cpu(getattr(state, k)) for k in _STATS},
        "opt_state": None if opt is None else {
            "count": int(opt.count), "mu": _fields(opt.mu, cpu), "nu": _fields(opt.nu, cpu)},
    }


def state_from_dict(d: dict, device: torch.device) -> GaussianModelState:
    def to(t):
        return None if t is None else t.to(device)

    def params(p):
        return GaussianParams(**{k: to(p[k]) for k in GaussianParams._fields})

    opt = d["opt_state"]
    return GaussianModelState(
        params=params(d["params"]), active=to(d["active"]), sh_degree=int(d["sh_degree"]),
        **{k: to(d[k]) for k in _STATS},
        opt_state=None if opt is None else AdamState(
            count=int(opt["count"]), mu=params(opt["mu"]), nu=params(opt["nu"])))


def save_checkpoint(path: str, state: GaussianModelState, iteration: int) -> None:
    payload = {"state": state_to_dict(state), "iteration": int(iteration), "version": VERSION}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, device=None) -> Tuple[GaussianModelState, int]:
    """(state, iteration) on ``device``: CUDA unless told otherwise."""
    dev = backend.resolve_device(device)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("version") != VERSION:
        raise ValueError(f"{path}: checkpoint version {payload.get('version')}, "
                         f"expected {VERSION}")
    return state_from_dict(payload["state"], dev), int(payload["iteration"])


def _digest(d: dict) -> str:
    """SHA-256 of every tensor's bytes and every number of a
    ``state_to_dict`` dict."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(k.encode())
                add(x[k])
        elif isinstance(x, torch.Tensor):
            h.update(str((x.dtype, tuple(x.shape))).encode())
            h.update(x.contiguous().view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(x).encode())

    add(d)
    return h.hexdigest()


def _host_copy(state: GaussianModelState) -> dict:
    """``state_to_dict`` of a snapshot of the state: a device tensor is
    copied into pinned host memory on the current stream, which is then
    synchronized, so later steps may change the state (in place too)."""
    cuda = state.params.xyz.device.type == "cuda"

    def copy(t):
        if t.device.type != "cuda":
            return t.clone()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    d = state_to_dict(state, copy)
    if cuda:
        torch.cuda.current_stream(state.params.xyz.device).synchronize()
    return d


class _Writer:
    """The checkpoint writes in flight: at most one background thread,
    whose exception is raised by the next ``wait``."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.error: Optional[Exception] = None

    def wait(self) -> None:
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        error, self.error = self.error, None
        if error is not None:
            raise RuntimeError("an overlapped checkpoint save failed") from error

    def start(self, fn) -> None:
        self.wait()

        def run():
            try:
                fn()
            except Exception as exc:  # raised again by wait()
                self.error = exc

        self.thread = threading.Thread(target=run, name="checkpoint-save")
        self.thread.start()


_WRITER = _Writer()


def wait_for_async_saves() -> None:
    """Block until the overlapped ``save_checkpoint_dist`` of this process
    has written its files (on the first rank: until the directory is in
    place), and raise if it failed. Returns at once when none is
    pending."""
    _WRITER.wait()


_CKPT_GROUPS: dict = {}  # ranks -> the gloo group the writer threads meet on


def _writer_group(group):
    """A gloo process group over ``group``'s ranks for the writer threads
    (None outside a process group). Collectives of the training run's own
    group stay on the caller's thread; the writers meet on this one. Made
    on first use, by every rank together (each save is called by all)."""
    import torch.distributed as dist

    if group is None:
        return None
    ranks = tuple(dist.get_process_group_ranks(group))
    if ranks not in _CKPT_GROUPS:
        _CKPT_GROUPS[ranks] = dist.new_group(list(ranks), backend="gloo")
    return _CKPT_GROUPS[ranks]


def _write_shards(path: str, host: dict, iteration: int, rank: int, size: int,
                  rows: int, sharded: bool, group) -> None:
    """Write a ``save_checkpoint_dist`` directory, every rank together
    (``group`` a gloo group over the ranks, or None for one process): the
    ranks exchange their state's SHA-256, write into ``<path>.tmp`` (every
    rank its shard when ``sharded``, else the first rank alone), the first
    rank writes the metadata and renames the directory into place, and
    every rank returns once it is there."""
    import torch.distributed as dist

    def barrier():
        if group is not None:
            dist.barrier(group=group)

    digests = [_digest(host)]
    if group is not None:
        digests = [None] * size
        dist.all_gather_object(digests, _digest(host), group=group)
    tmp = path + ".tmp"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier()
    if sharded or rank == 0:
        torch.save(host, os.path.join(tmp, f"shard{rank}.pt"))
    if rank == 0:
        torch.save({
            "version": VERSION, "iteration": int(iteration),
            "layout": "sharded" if sharded else "replicated", "world_size": size,
            "rows": [[r * rows, (r + 1) * rows] for r in range(size if sharded else 1)],
            "digests": digests,
        }, os.path.join(tmp, "meta.pt"))
    barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    barrier()


def save_checkpoint_dist(path: str, state: GaussianModelState, iteration: int,
                         mesh=None, async_save: bool = False) -> None:
    """Write ``state`` and ``iteration`` as the directory ``path``, every
    rank of the run calling together. ``mesh`` is the gaussian-sharded
    step's mesh when ``state`` is this rank's rows
    (``parallel.sharded.shard_model_state``), None when every rank holds
    the whole state. Outside a multi-process run, one process writes it
    all.

    The state is copied to host memory first (``_host_copy``); a
    background thread then writes the files (``_write_shards``). With
    ``async_save`` the call returns as soon as the copy is made and
    ``wait_for_async_saves`` joins the thread; without it the call joins
    it, and returns on every rank once the directory is in place. The
    thread starts once this process's previous save has finished."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost

    group = mesh or multihost.make_global_mesh(device=state.params.xyz.device)
    writers = _writer_group(group.group)
    host = _host_copy(state)
    rows = state.params.xyz.shape[0]
    _WRITER.start(lambda: _write_shards(path, host, iteration, group.rank, group.size, rows,
                                        mesh is not None, writers))
    if not async_save:
        _WRITER.wait()


def _concat_rows(parts: list):
    """The shards' dicts as one: tensors concatenated on their rows, in
    shard order; other values from the first shard."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, 0)
    return first


def checkpoint_meta(path: str) -> dict:
    """The metadata of a ``save_checkpoint_dist`` directory."""
    meta = torch.load(os.path.join(path, "meta.pt"), map_location="cpu", weights_only=True)
    if meta.get("version") != VERSION:
        raise ValueError(f"{path}: checkpoint version {meta.get('version')}, "
                         f"expected {VERSION}")
    return meta


def load_checkpoint_dist(path: str, device=None) -> Tuple[GaussianModelState, int]:
    """(state, iteration) of a ``save_checkpoint_dist`` directory, the whole
    state in this process on ``device`` (CUDA unless told otherwise)."""
    dev = backend.resolve_device(device)
    meta = checkpoint_meta(path)
    parts = [torch.load(os.path.join(path, f"shard{r}.pt"), map_location="cpu",
                        weights_only=True) for r in range(len(meta["rows"]))]
    return state_from_dict(_concat_rows(parts), dev), int(meta["iteration"])


def latest_checkpoint(model_dir: str, prefix: str = "chkpnt") -> Optional[str]:
    """The newest ``<prefix><iteration>`` checkpoint under ``model_dir``:
    a ``.ckpt`` file, a ``.shards`` directory, or a bare ``<prefix><N>``;
    on a tie the single file first. Anything else that starts with the
    prefix (a ``.tmp`` directory, a sidecar) is skipped. None if there is
    none."""
    if not os.path.isdir(model_dir):
        return None
    best, best_key = None, (-1, -1)
    for name in os.listdir(model_dir):
        if not name.startswith(prefix):
            continue
        it_str, _, ext = name[len(prefix):].partition(".")
        if not it_str.isdigit() or ext not in ("", "ckpt", SHARDS[1:]):
            continue
        key = (int(it_str), {"ckpt": 2, "": 1, SHARDS[1:]: 0}[ext])
        if key > best_key:
            best, best_key = os.path.join(model_dir, name), key
    return best
