"""Training checkpoints: the whole training state in one file.

Port of ``save_checkpoint``, ``load_checkpoint`` and ``latest_checkpoint``
from ``gaussian_splatting_with_eye_tracking_tpu/models/checkpoint.py`` (the
reference's ``torch.save((capture(), iteration))``). The file is a
``torch.save`` of plain containers of CPU tensors and ints: the
parameters, the Adam state, the densification statistics, ``active``,
the active SH degree, the iteration and a format version. It is written
through a temporary file and ``os.replace``, so a crash never leaves half
a checkpoint, and read with ``weights_only=True``, which unpickles no
code. Single process only; the JAX package's multi-host (orbax)
checkpoints have no counterpart yet.
"""

from __future__ import annotations

import os
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


def latest_checkpoint(model_dir: str, prefix: str = "chkpnt") -> Optional[str]:
    """The ``<prefix><iteration>.ckpt`` file under ``model_dir`` with the
    highest iteration, or None."""
    if not os.path.isdir(model_dir):
        return None
    best, best_it = None, -1
    for name in os.listdir(model_dir):
        it_str = name[len(prefix):-len(".ckpt")]
        if name.startswith(prefix) and name.endswith(".ckpt") and it_str.isdigit():
            if int(it_str) > best_it:
                best, best_it = os.path.join(model_dir, name), int(it_str)
    return best
