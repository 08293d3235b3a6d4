"""RITnet training CLI: ``python -m gaussian_splatting_with_eye_tracking_tpu_torch.train_ritnet``.

Port of the root ``train_ritnet.py`` (the reference's RITnet/train.py:94-193):
trains DenseNet2D on an OpenEDS-style dataset (``--dataset`` holding
``train/`` and ``validation/``) with the boundary-weighted CE + annealed
generalized Dice + surface loss and Adam, reports each epoch's mean loss and
validation mIoU, and writes ``logs/<expname>/last_model.npz`` and
``best_model.npz`` under the working directory. Runs on CUDA unless
``--data_device cpu``. ``--workers`` is parsed and unused, as in JAX.

The ``.npz`` files hold one float32 array per checkpoint name, the JAX
package's format: a file written by either package loads in the other.
"""

from __future__ import annotations

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.models import (
    ritnet,
    ritnet_data,
    ritnet_train,
)


def save_params_npz(path: str, params) -> None:
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_params_npz(path: str, device) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files}


def to_device(batch, device):
    """A ``ritnet_data.batches`` tuple of numpy arrays as tensors on
    ``device``."""
    return tuple(torch.from_numpy(b).to(device) for b in batch)


def main(argv=None):
    """Parse ``argv`` and train. Returns (final params, log): the log holds
    each epoch's step losses, validation mIoU, alpha and seconds."""
    parser = ArgumentParser()
    parser.add_argument("--dataset", required=True, type=str,
                        help="OpenEDS-style root with train/ and validation/")
    parser.add_argument("--bs", type=int, default=8)
    parser.add_argument("--epochs", type=int, default=250)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--workers", type=int, default=0)
    parser.add_argument("--expname", type=str, default="densenet")
    parser.add_argument("--resume", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = backend.resolve_data_device(args.data_device)

    out_dir = os.path.join("logs", args.expname)
    os.makedirs(out_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    if args.resume:
        params = load_params_npz(args.resume, dev)
    else:
        gen = torch.Generator().manual_seed(args.seed)
        params = {k: v.to(dev) for k, v in ritnet.init_params(gen).items()}
    tx, step = ritnet_train.make_train_step(args.lr)
    opt_state = tx.init(params)

    log = {"losses": [], "val_miou": [], "alpha": [], "seconds": []}
    best_miou = 0.0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        alpha = ritnet_train.alpha_schedule(epoch)
        losses = []
        for batch in ritnet_data.batches(args.dataset, "train", args.bs, rng):
            params, opt_state, loss = step(params, opt_state, to_device(batch, dev), alpha)
            losses.append(float(loss))

        mious = []
        with torch.no_grad():
            for batch in ritnet_data.batches(args.dataset, "validation", args.bs,
                                             rng, train=False):
                imgs, labels = to_device(batch[:2], dev)
                pred = ritnet.get_predictions(ritnet.densenet2d_apply(params, imgs))
                mious.append(float(ritnet_train.miou(pred, labels)))
        val_miou = float(np.mean(mious)) if mious else 0.0
        print(f"Epoch {epoch}: loss={np.mean(losses):.4f} val mIoU={val_miou:.4f} "
              f"alpha={alpha:.2f}")
        save_params_npz(os.path.join(out_dir, "last_model.npz"), params)
        if val_miou >= best_miou:
            best_miou = val_miou
            save_params_npz(os.path.join(out_dir, "best_model.npz"), params)
        for key, value in (("losses", losses), ("val_miou", val_miou), ("alpha", alpha),
                           ("seconds", time.perf_counter() - t0)):
            log[key].append(value)
    print(f"Done. Best val mIoU: {best_miou:.4f}")
    return params, log


if __name__ == "__main__":
    main()
