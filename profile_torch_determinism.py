#!/usr/bin/env python3
"""What the port's deterministic cuDNN setting costs, and whether a step
repeats bit for bit under it.

Run from the repository root on a machine with a CUDA card:

    python3 profile_torch_determinism.py [--cudnn port|default]

``--cudnn port`` (the default) keeps ``backend.py``'s setting
(``cudnn.deterministic = True``, ``cudnn.benchmark = False``); ``--cudnn
default`` puts PyTorch's defaults back (``deterministic = False``), the
setting before the port fixed it. Prints the card's name and power limit,
then one JSON line:

- ``ritnet``: the RITnet train step at 8x1x400x640 (full width, JAX-scheme
  parameters from seed 0, one batch of chip_smoke.py's synthetic eyes),
  CUDA events, a warm-up then the median of ``chip_smoke.REPS``; and
  whether three steps run twice from the same start give bit-equal
  parameters and losses;
- ``gaussians``: the 1920x1088 train step of bench.py's 300k model (the
  front view, 524,288 slots, as chip_smoke.py's training phase), the same
  timing, and whether two steps from the same state give bit-equal
  parameters.

Run both settings in turns in one call to compare them.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from argparse import ArgumentParser

import numpy as np
import torch

import chip_smoke as cs


def ritnet_step(root):
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_ritnet
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet, ritnet_data
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train

    dev = torch.device("cuda")
    init = {k: v.to(dev) for k, v in ritnet.init_params(
        torch.Generator().manual_seed(0)).items()}
    batch = train_ritnet.to_device(
        next(ritnet_data.batches(root, "train", 8, np.random.default_rng(2))), dev)
    tx, step = ritnet_train.make_train_step(1e-3)
    state = tx.init(init)
    ms = cs.cuda_ms(lambda: step(init, state, batch, 1.0))

    def three_steps():
        p, s, losses = dict(init), tx.init(init), []
        for _ in range(3):
            p, s, loss = step(p, s, batch, 1.0)
            losses.append(float(loss))
        return p, losses

    (pa, la), (pb, lb) = three_steps(), three_steps()
    differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
    return {"step_ms": ms, "batch": list(batch[0].shape), "losses": [la, lb],
            "params_differ": len(differ), "first_differing": differ[:5],
            "repeats": not differ and la == lb}


def gaussian_step():
    from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
    from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
    from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

    dev = torch.device("cuda")
    params = gm.params_from_jax(cs.raw_params(*cs.make_scene(cs.N)))
    bg = torch.zeros(3, device=dev)
    cam = cs.view_request(0.0, 0.0).params()
    render = train_lib.make_eval_render(3, cs.W, cs.H, max_instances=cs.MAX_INSTANCES,
                                        max_live=cs.MAX_LIVE)
    target = render(gm.state_from_params(params, 3), *train_lib.camera_arrays(cam), bg)
    opt = OptimizationConfig()
    tx = gm.make_optimizer(opt, cs.EXTENT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randn(params.f_dc.shape, generator=gen, device="cuda")
    state = gm.init_training(params._replace(f_dc=params.f_dc + 0.1 * noise), 3, tx,
                             capacity=gm.next_pow2(cs.N))
    step = train_lib.make_train_step(tx, opt, 3, cs.W, cs.H, cs.MAX_INSTANCES, cs.MAX_LIVE)
    args = (*train_lib.camera_arrays(cam), target, bg, True)
    ms = cs.cuda_ms(lambda: step(state, *args))
    (a, aux_a), (b, aux_b) = step(state, *args), step(state, *args)
    differ = [k for k, x, y in zip(a.params._fields, a.params, b.params) if not torch.equal(x, y)]
    return {"step_ms": ms, "loss": [float(aux_a.loss), float(aux_b.loss)],
            "params_differ": differ, "repeats": not differ}


def main(argv=None):
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cudnn", choices=("port", "default"), default="port")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_determinism: no CUDA device", file=sys.stderr)
        return 1
    from gaussian_splatting_with_eye_tracking_tpu_torch import backend, fps_test

    if args.cudnn == "default":
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = False
    backend.build_kernels()
    card = fps_test.card(torch.device("cuda"))
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "eyes")
        cs.write_eye_dataset(root, 8, 1, seed=1)
        rit = ritnet_step(root)
    out = {"cudnn": args.cudnn, "deterministic": torch.backends.cudnn.deterministic,
           "benchmark": torch.backends.cudnn.benchmark, "card": card,
           "ritnet": rit, "gaussians": gaussian_step()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
