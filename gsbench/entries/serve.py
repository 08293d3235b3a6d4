"""The served view: one viewer's head path of 1920x1088 cameras, each
request through the program's ``renderer.render`` without autograd, as
``train_lib.make_eval_render`` calls it (preprocess, binning with K1, the
compositor K2, assembly), the image synchronised on the device. A view
whose instances overflow the capacities counts as failed. The path has
``path_len`` poses; a closed loop that outruns it starts it again.
Checked against the reference's image of the same camera.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import scenes, traffic, work
from gsbench.entries.common import Views, free_cuda, max_abs, program_state
from gsbench.reference import render as ref


class Serve:
    def __init__(self, run):
        cfg, mix = run.config, run.mix
        dev = run.device
        self.run = run
        self.raw = scenes.make_scene(cfg["scene"], run.seed, dev)
        rng = np.random.default_rng([run.seed, 2])
        n = run.n_requests or int(mix["path_len"])
        poses = traffic.head_path(rng, max(n, 1), **mix["head"])
        self.views = Views(poses, cfg["width"], cfg["height"], dev)
        self.bg = torch.zeros(3, device=dev)
        self.sample = set(run.sample)
        self.outputs = {}
        self.last = None
        self.overflow = []  # each request's flag, read once the window has closed
        self.state = None
        if run.control:
            return
        self.state, _ = program_state(self.raw, cfg)
        self.kwargs = dict(max_sh_degree=int(cfg["scene"]["sh_degree"]),
                           max_instances=int(cfg["max_instances"]),
                           max_live=int(cfg["max_live"]))
        # builds the kernels on a fresh checkout, and lets the allocator cache
        # blocks for the path's spread of instance counts before the window
        warm = int(mix.get("warm_requests", 2))
        for i in np.linspace(0, len(self.views) - 1, warm).astype(int):
            self._render(int(i))

    def _render(self, i):
        from gaussian_splatting_with_eye_tracking_tpu_torch import renderer

        with torch.no_grad():
            return renderer.render(self.views.params(i % len(self.views)), self.state, self.bg,
                                   **self.kwargs)

    def _reference(self, i, dtype=torch.float32, count_work=False):
        cam = self.views.reference(i % len(self.views))
        prep = ref.preprocess(*ref.activate(self.raw, dtype), cam)
        return ref.render(prep, cam, self.bg, count_work=count_work)

    def request(self, i: int) -> bool:
        if self.run.control:  # the reference in bfloat16 in the program's place
            if i in self.sample:
                self.outputs[i] = self._reference(i, torch.bfloat16).color.float()
            return True
        out = self._render(i)
        self.run.sync()
        self.overflow.append(out.overflow)
        if i in self.sample:
            self.outputs[i] = out.color
        self.last = (i, out.color)
        return True

    def finish(self):
        pass

    def check(self, run):
        for i, flag in enumerate(self.overflow):
            if bool(flag):
                run.requests[i]["ok"] = False
        if self.last is not None:
            self.outputs.setdefault(*self.last)
        self.state = self.last = None
        free_cuda()
        worst = 0.0
        n = self.raw["xyz"].shape[0]
        w, h = run.config["width"], run.config["height"]
        for i in sorted(self.outputs):
            frame = self._reference(i, count_work=run.trace_on and i < run.traced)
            worst = max(worst, max_abs(self.outputs[i], frame.color))
            if run.trace_on and i < run.traced:
                k2 = work.forward_composite(frame.kept, frame.contributing, w * h)
                run.work[i] = {"k2": k2, "request": dict(
                    sfu=k2["sfu"], flops=k2["flops"],
                    nbytes=4 * (work.PARAM_FLOATS * n + 3 * w * h))}
        if len(self.outputs) < len(self.sample):
            worst = float("nan")  # a sampled request never answered
        run.checks["image_max_abs"] = (worst, float(run.limits["image_max_abs"]))


def prepare(run):
    return Serve(run)
