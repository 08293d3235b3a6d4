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

Every file is read with ``weights_only=True``, which unpickles no code.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
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


def state_to_dict(state: GaussianModelState) -> dict:
    """The state as plain containers of CPU tensors and ints."""
    def cpu(t):
        return None if t is None else t.detach().cpu()

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


def _state_digest(state: GaussianModelState) -> str:
    """SHA-256 of every tensor's bytes and every number of the state."""
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

    add(state_to_dict(state))
    return h.hexdigest()


def save_checkpoint_dist(path: str, state: GaussianModelState, iteration: int,
                         mesh=None) -> None:
    """Write ``state`` and ``iteration`` as the directory ``path``, every
    rank of the run calling together. ``mesh`` is the gaussian-sharded
    step's mesh when ``state`` is this rank's rows
    (``parallel.sharded.shard_model_state``), None when every rank holds
    the whole state. Outside a multi-process run, one process writes it
    all."""
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import collectives as cc
    from gaussian_splatting_with_eye_tracking_tpu_torch.parallel import multihost

    group = mesh or multihost.make_global_mesh(device=state.params.xyz.device)
    rank, size = group.rank, group.size

    def barrier():
        cc.all_reduce_(torch.zeros(1, device=group.device), group)

    digest = torch.tensor(list(bytes.fromhex(_state_digest(state))), dtype=torch.uint8)
    digests = cc.gather_stacked(digest.to(torch.int32).to(group.device), group).cpu()
    tmp = path + ".tmp"
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier()
    rows = state.params.xyz.shape[0]
    if mesh is not None or rank == 0:
        torch.save(state_to_dict(state), os.path.join(tmp, f"shard{rank}.pt"))
    if rank == 0:
        sharded = mesh is not None
        torch.save({
            "version": VERSION, "iteration": int(iteration),
            "layout": "sharded" if sharded else "replicated", "world_size": size,
            "rows": [[r * rows, (r + 1) * rows] for r in range(size if sharded else 1)],
            "digests": [bytes(d.to(torch.uint8).tolist()).hex() for d in digests],
        }, os.path.join(tmp, "meta.pt"))
    barrier()
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    barrier()


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
