"""The trainer's step: ``train_lib.make_train_step`` at 1920x1088 on the
configuration's scene, its f_dc perturbed by N(0, f_dc_noise), in
``train.slots`` slots, fitted in a closed loop to ``train.views`` target
views of the head path in a seeded order (the targets rendered by the
reference from the unperturbed scene at set-up), densification
statistics accumulated, no densify or opacity reset.

Set-up builds the one state and step and drives them through the first
``check_requests`` steps with the window's own call and feed (three
different views); the window goes on from there. The check follows
those steps with the reference from the same start and compares each
step's loss, the first gradient as Adam's first moment holds it after
one step, and each leaf's change over the steps.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import scenes, traffic, work
from gsbench.entries.common import Views, free_cuda
from gsbench.reference import render as ref
from gsbench.reference import train as ref_train

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone and is left out of the comparison
QUIET_LEAF = 1e-3


class Train:
    def __init__(self, run):
        cfg, mix = run.config, run.mix
        dev = run.device
        self.run = run
        self.tcfg = tc = cfg["train"]
        raw = scenes.make_scene(cfg["scene"], run.seed, dev)
        rng = np.random.default_rng([run.seed, 4])
        self.views = Views(traffic.head_path(rng, int(tc["views"]), **mix["head"]),
                           cfg["width"], cfg["height"], dev)
        self.order = rng.permutation(int(tc["views"]))
        self.bg = torch.zeros(3, device=dev)
        with torch.no_grad():
            self.targets = [ref.render(ref.preprocess(*ref.activate(raw), self.views.reference(v)),
                                       self.views.reference(v), self.bg).color
                            for v in range(len(self.views))]
        gen = torch.Generator(device=dev).manual_seed(run.seed + 1)
        raw["f_dc"] = raw["f_dc"] + float(tc["f_dc_noise"]) * torch.randn(
            raw["f_dc"].shape, generator=gen, device=dev)
        self.start = raw
        self.n_check = int(mix["check_requests"])
        self.steps = 0
        self.overflow = []
        self.traced_events = []
        if run.control:
            self.record = self._control()
            return
        from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
        from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
        from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

        opt = OptimizationConfig()
        self.tx = gm.make_optimizer(opt, float(tc["extent"]))
        params = gm.GaussianParams(**{k: v.clone() for k, v in raw.items()})
        self.state = gm.init_training(params, int(cfg["scene"]["sh_degree"]), self.tx,
                                      capacity=int(tc["slots"]))
        self.step = train_lib.make_train_step(
            self.tx, opt, int(cfg["scene"]["sh_degree"]), cfg["width"], cfg["height"],
            int(cfg["max_instances"]), int(cfg["max_live"]), device=dev)
        n = raw["xyz"].shape[0]
        losses = []
        for k in range(self.n_check):
            aux = self._step(None)
            losses.append(float(aux.loss))
            if k == 0:  # the first gradient, as Adam's first moment holds it
                b1 = self.tx.b1
                mu1 = {name: (getattr(self.state.opt_state.mu, name)[:n] / (1.0 - b1)).cpu()
                       for name in ref_train.LEAVES}
        params = {name: getattr(self.state.params, name)[:n].cpu() for name in ref_train.LEAVES}
        self.record = (losses, mu1, params)

    def _step(self, events):
        v = self._view_at(self.steps)
        self.state, aux = self.step(self.state, *self.views.arrays(v), self.targets[v], self.bg,
                                    True, events=events)
        self.steps += 1
        self.overflow.append(aux.overflow)
        return aux

    def _control(self):
        """The reference in bfloat16 in the program's place, over the same
        steps."""
        views = [self._view_at(k) for k in range(self.n_check)]
        losses, first, params = ref_train.follow(
            self.start, [self.views.reference(v) for v in views],
            [self.targets[v] for v in views], self.bg, self.tcfg, torch.bfloat16)
        n = self.start["xyz"].shape[0]
        return losses, {k: v[:n].cpu() for k, v in first.items()}, \
            {k: v[:n].cpu() for k, v in params.items()}

    def _view_at(self, k):
        return int(self.order[k % len(self.order)])

    def request(self, i: int) -> bool:
        if self.run.control:
            return True
        events = [] if i < self.run.traced_limit and self.run.cuda else None
        self._step(events)
        if events is not None:
            self.traced_events.append(events)
        return True

    def finish(self):
        self.run.sync()
        for events in self.traced_events:
            t0 = events[0][1]
            self.run.events.append({name: t0.elapsed_time(ev) for name, ev in events})

    def check(self, run):
        bad = bool(torch.stack(self.overflow).any()) if self.overflow else False
        self.state = self.step = None
        free_cuda()
        losses, grads, params = self.record
        views = [self._view_at(k) for k in range(self.n_check)]
        r_losses, r_first, r_params = ref_train.follow(
            self.start, [self.views.reference(v) for v in views],
            [self.targets[v] for v in views], self.bg, self.tcfg)
        start = {k: self.start[k].float() for k in ref_train.LEAVES}
        g_ref = {k: float(r_first[k].norm()) for k in ref_train.LEAVES}
        med = float(np.median(list(g_ref.values())))
        loud = [k for k in ref_train.LEAVES if g_ref[k] >= QUIET_LEAF * med]
        d_ref = {k: float((r_params[k] - start[k]).norm()) for k in loud}
        d_med = float(np.median(list(d_ref.values())))
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses))
        grad_gap = max(abs(float(grads[k].norm()) - g_ref[k]) / max(g_ref[k], med) for k in loud)
        change_gap = max(abs(float((params[k].to(start[k].device) - start[k]).norm()) - d_ref[k])
                         / max(d_ref[k], d_med) for k in loud)
        if bad:
            loss_gap = float("nan")  # an overflowed capacity drops instances
        run.checks["loss_rel"] = (loss_gap, float(run.limits["loss_rel"]))
        run.checks["grad_norm_gap"] = (grad_gap, float(run.limits["grad_norm_gap"]))
        run.checks["change_norm_gap"] = (change_gap, float(run.limits["change_norm_gap"]))
        if run.trace_on and run.traced:
            self._count_work(run)

    def _count_work(self, run):
        """The least work of the first traced steps, counted on the start
        parameters at each step's view."""
        cfg = run.config
        w, h = cfg["width"], cfg["height"]
        slots = int(self.tcfg["slots"])
        for i in range(min(2, run.traced)):
            v = self._view_at(self.n_check + i)
            cam = self.views.reference(v)
            frame = ref.render(ref.preprocess(*ref.activate(self.start), cam), cam, self.bg,
                               count_work=True)
            k3 = work.backward_composite(frame.kept, frame.contributing, w * h)
            fwd = work.forward_composite(frame.kept, frame.contributing, w * h)
            run.work[i] = {"k3": k3, "request": dict(
                sfu=fwd["sfu"] + k3["sfu"], flops=fwd["flops"] + k3["flops"],
                nbytes=4 * (8 * work.PARAM_FLOATS * slots + 2 * 3 * w * h))}


def prepare(run):
    return Train(run)
