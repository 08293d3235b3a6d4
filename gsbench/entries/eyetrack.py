"""The eye-tracked foveated frame: each request is a 640x400 eye image on
a fixation-and-saccade gaze path and a camera on the head path, through
the program's ``track_render.estimate_gaze`` (gamma and CLAHE on the
host, RITnet's DenseNet2D with the vendored weights loaded at set-up,
the pupil centroid) and ``track_render.foveated_view(fused=True)``
(step 0's preprocess and binning, the tile levels from the gaze rings,
K5 with the configuration's decimation, interpolation), the frame
synchronised on the device. A frame whose instances overflow the
capacity counts as failed. The paths have ``path_len`` requests; a closed
loop that outruns them starts them again. Checked against the
reference's class map, gaze and frame.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import eyes, scenes, traffic, work
from gsbench.entries.common import Views, free_cuda, max_abs, program_state
from gsbench.harness import ROOT, clock
from gsbench.reference import render as ref
from gsbench.reference import ritnet as ref_ritnet


class Eyetrack:
    def __init__(self, run):
        cfg, mix = run.config, run.mix
        dev = run.device
        self.run = run
        self.raw = scenes.make_scene(cfg["scene"], run.seed, dev)
        rng = np.random.default_rng([run.seed, 3])
        n = max(run.n_requests or int(mix["path_len"]), 1)
        self.views = Views(traffic.head_path(rng, n, **mix["head"]), cfg["width"],
                           cfg["height"], dev)
        gaze = traffic.gaze_path(rng, n, **mix["gaze"])
        self.eyes = eyes.eye_images(rng, gaze, cfg["eye"]["height"], cfg["eye"]["width"],
                                    int(mix["noise_pool"]))
        fov = cfg["foveation"]
        self.rings = tuple(float(r) for r in fov["rings"])
        self.decimation = tuple(int(d) for d in fov["decimation"])
        self.weights = ROOT / cfg["eye"]["weights"]
        self.bg = torch.zeros(3, device=dev)
        self.sample = set(run.sample)
        self.outputs = {}
        self.last = None
        self.state = self.model = None
        if run.control:
            self.ref_weights = ref_ritnet.load_weights(self.weights, dev, torch.bfloat16)
            return
        from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet

        self.model = ritnet.load_pretrained(self.weights, device=dev)
        self.state, _ = program_state(self.raw, cfg)
        for i in range(min(2, n)):  # builds the kernels on a fresh checkout
            self._frame(i)

    def _frame(self, i):
        from gaussian_splatting_with_eye_tracking_tpu_torch import track_render

        j = i % len(self.eyes)
        t0 = clock()
        with torch.profiler.record_function("gsbench.gaze"):
            uv, cls = track_render.estimate_gaze(self.eyes[j], self.model, device=self.run.device)
        t1 = clock()
        with torch.profiler.record_function("gsbench.fovea"):
            color, st = track_render.foveated_view(
                self.state, self.views.params(j), self.bg, uv,
                int(self.run.config["scene"]["sh_degree"]), radii=self.rings,
                decimation=self.decimation, fused=True,
                max_instances=int(self.run.config["max_instances"]))
            self.run.sync()
        return uv, cls, color, st, (t0, t1, clock())

    def _reference(self, i, dtype, weights, count_work=False):
        j = i % len(self.eyes)
        uv, cls = ref_ritnet.gaze(self.eyes[j], weights, self.run.device, dtype)
        cam = self.views.reference(j)
        gaze_xy = torch.tensor([uv[0] * cam.width, uv[1] * cam.height], dtype=torch.float32)
        prep = ref.preprocess(*ref.activate(self.raw, dtype), cam)
        frame = ref.render_foveated(prep, cam, self.bg, gaze_xy, self.rings, self.decimation,
                                    count_work=count_work)
        return uv, cls, frame

    def request(self, i: int) -> bool:
        if self.run.control:  # the reference in bfloat16 in the program's place
            if i in self.sample:
                uv, cls, frame = self._reference(i, torch.bfloat16, self.ref_weights)
                self.outputs[i] = (uv, cls, frame.color.float())
            return True
        uv, cls, color, st, (t0, t1, t2) = self._frame(i)
        self.run.span("gaze", i, t0, t1)
        self.run.span("fovea", i, t1, t2)
        if i in self.sample:
            self.outputs[i] = (uv, cls, color)
        self.last = (i, (uv, cls, color))
        return not bool(st.overflow)

    def finish(self):
        pass

    def check(self, run):
        if self.last is not None:
            self.outputs.setdefault(*self.last)
        self.state = self.model = self.last = None
        free_cuda()
        weights = ref_ritnet.load_weights(self.weights, run.device)
        cfg = run.config
        eh, ew = cfg["eye"]["height"] // 16 * 16, cfg["eye"]["width"] // 16 * 16
        n = self.raw["xyz"].shape[0]
        worst = {"class_map_mismatch": 0.0, "gaze_px": 0.0, "frame_max_abs": 0.0}
        for i in sorted(self.outputs):
            uv, cls, color = self.outputs[i]
            traced = run.trace_on and i < run.traced
            r_uv, r_cls, frame = self._reference(i, torch.float32, weights, traced)
            worst["class_map_mismatch"] = max(worst["class_map_mismatch"],
                                              float((cls.to(r_cls.device) != r_cls).float().mean()))
            worst["gaze_px"] = max(worst["gaze_px"], float(np.hypot(*((np.asarray(uv) - r_uv)
                                                                    * np.array([ew, eh])))))
            worst["frame_max_abs"] = max(worst["frame_max_abs"], max_abs(color, frame.color))
            if traced:
                k5 = work.forward_composite(frame.kept, frame.contributing, frame.pixels)
                w, h = cfg["width"], cfg["height"]
                run.work[i] = {"k5": k5, "request": dict(
                    sfu=k5["sfu"], flops=k5["flops"] + work.densenet2d_flops(eh, ew),
                    nbytes=4 * (work.PARAM_FLOATS * n + 3 * w * h) + eh * ew)}
        if len(self.outputs) < len(self.sample):
            worst = {k: float("nan") for k in worst}
        for k, v in worst.items():
            run.checks[k] = (v, float(run.limits[k]))


def prepare(run):
    return Eyetrack(run)
