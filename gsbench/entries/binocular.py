"""The binocular headset frame: each request is one frame of a
head-mounted display. Two 640x400 eye images, one per eye: the left
pupil on the eyetrack mix's fixation-and-saccade path, the right the
left's plus a horizontal vergence offset drawn once per fixation, each
eye with its own noise. A head pose on the head path, and from it one
camera per eye, -IPD/2 and +IPD/2 along the head camera's x axis, each
a symmetric frustum of the configuration's field of view. Both go
through the program's ``track_render.headset_frame``: one RITnet forward
at batch 2, one activation of the model, then each eye's fused foveated
view from its own camera and gaze; the frame synchronised on the device.
A frame in which either eye's instances overflow the capacity counts as
failed. The paths have ``path_len`` requests; a closed loop that outruns
them starts them again. Checked per eye against ``reference/binocular``
(class map, gaze, frame, and each tile's level: a view rendered at
another gaze moves its rings), the worst of both eyes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsbench import eyes, scenes, traffic, work
from gsbench.entries.common import free_cuda, max_abs, program_state
from gsbench.harness import ROOT
from gsbench.reference import binocular as ref_binocular
from gsbench.reference import render as ref
from gsbench.reference import ritnet as ref_ritnet


def vergence(rng: np.random.Generator, left: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The right eye's pupil path: ``left`` (n, 2) plus a horizontal offset
    drawn from U[lo, hi] once per fixation (a run of equal rows)."""
    starts = np.flatnonzero(np.r_[True, np.any(left[1:] != left[:-1], axis=1)])
    offset = np.repeat(rng.uniform(lo, hi, len(starts)), np.diff(np.r_[starts, len(left)]))
    return left + np.stack([offset, np.zeros_like(offset)], axis=1)


class EyeViews:
    """Each request's two eye cameras, on the device: the head path's
    camera (``traffic.camera``) moved -IPD/2 and +IPD/2 along its own x
    axis, each with a symmetric frustum of the configuration's field of
    view; numpy matrices made once at set-up."""

    def __init__(self, poses: np.ndarray, config: dict, device):
        self.width, self.height = int(config["width"]), int(config["height"])
        self.tan_y = math.tan(math.radians(float(config["fov_y_deg"])) / 2.0)
        self.tan_x = self.tan_y * self.width / self.height
        proj = traffic.projection_matrix(traffic.ZNEAR, traffic.ZFAR, 2.0 * math.atan(self.tan_x),
                                         2.0 * math.atan(self.tan_y))
        half = 0.5 * float(config["ipd"])
        mats = []
        for yaw, pitch in poses:
            head = traffic.camera(float(yaw), float(pitch))[0].astype(np.float64)
            for side in (-1.0, 1.0):  # left, right
                shift = np.eye(4)
                shift[0, 3] = -side * half
                view = shift @ head
                mats.append((view.astype(np.float32), (proj @ view).astype(np.float32),
                             np.linalg.inv(view)[:3, 3].astype(np.float32)))
        views, fulls, centres = (torch.as_tensor(np.stack(m), device=device) for m in zip(*mats))
        self.mats = list(zip(views, fulls, centres))

    def params(self, i) -> list:
        from gaussian_splatting_with_eye_tracking_tpu_torch.ops.projection import CameraParams

        return [CameraParams(viewmatrix=v, projmatrix=f, campos=c, tan_fovx=self.tan_x,
                             tan_fovy=self.tan_y, width=self.width, height=self.height)
                for v, f, c in self.mats[2 * i:2 * i + 2]]

    def reference(self, i) -> list:
        return [ref.Camera(view=v, full=f, campos=c, tan_fovx=self.tan_x, tan_fovy=self.tan_y,
                           width=self.width, height=self.height)
                for v, f, c in self.mats[2 * i:2 * i + 2]]


class Binocular:
    def __init__(self, run):
        cfg, mix = run.config, run.mix
        dev = run.device
        self.run = run
        self.raw = scenes.make_scene(cfg["scene"], run.seed, dev)
        rng = np.random.default_rng([run.seed, 3])
        n = max(run.n_requests or int(mix["path_len"]), 1)
        self.views = EyeViews(traffic.head_path(rng, n, **mix["head"]), cfg, dev)
        left = traffic.gaze_path(rng, n, **mix["gaze"])
        right = vergence(rng, left, **mix["vergence"])
        eh, ew, pool = cfg["eye"]["height"], cfg["eye"]["width"], int(mix["noise_pool"])
        self.eyes = list(zip(eyes.eye_images(rng, left, eh, ew, pool),
                             eyes.eye_images(rng, right, eh, ew, pool)))
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
        uvs, cls, colors, states = track_render.headset_frame(
            self.state, self.views.params(j), self.bg, list(self.eyes[j]), self.model,
            int(self.run.config["scene"]["sh_degree"]), radii=self.rings,
            decimation=self.decimation, max_instances=int(self.run.config["max_instances"]),
            device=self.run.device)
        self.run.sync()
        return uvs, cls, colors, states

    def _reference(self, i, dtype, weights, count_work=False):
        j = i % len(self.eyes)
        return ref_binocular.frame(self.raw, self.views.reference(j), self.eyes[j], weights,
                                   self.bg, self.rings, self.decimation, self.run.device, dtype,
                                   count_work)

    def request(self, i: int) -> bool:
        if self.run.control:  # the reference in bfloat16 in the program's place
            if i in self.sample:
                cams = self.views.reference(i % len(self.eyes))
                self.outputs[i] = [
                    (uv, cls, frame.color.float(),
                     ref_binocular.levels(frame, cam, uv, self.rings))
                    for (uv, cls, frame), cam in zip(
                        self._reference(i, torch.bfloat16, self.ref_weights), cams)]
            return True
        uvs, cls, colors, states = self._frame(i)
        eyes_out = [(uvs[e], cls[e], colors[e], states[e].tile_levels)
                    for e in range(len(colors))]
        if i in self.sample:
            self.outputs[i] = eyes_out
        self.last = (i, eyes_out)
        return not any(bool(st.overflow) for st in states)

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
        worst = {"class_map_mismatch": 0.0, "gaze_px": 0.0, "frame_max_abs": 0.0,
                 "levels_off": 0.0}
        for i in sorted(self.outputs):
            traced = run.trace_on and i < run.traced
            refs = self._reference(i, torch.float32, weights, traced)
            cams = self.views.reference(i % len(self.eyes))
            for (uv, cls, color, lv), (r_uv, r_cls, frame), cam in zip(self.outputs[i], refs,
                                                                      cams):
                r_lv = ref_binocular.levels(frame, cam, r_uv, self.rings)
                worst["levels_off"] = max(worst["levels_off"], float(
                    (lv.to(r_lv.device).long() != r_lv).sum()))
                worst["class_map_mismatch"] = max(
                    worst["class_map_mismatch"],
                    float((cls.to(r_cls.device) != r_cls).float().mean()))
                worst["gaze_px"] = max(worst["gaze_px"], float(np.hypot(
                    *((np.asarray(uv) - r_uv) * np.array([ew, eh])))))
                worst["frame_max_abs"] = max(worst["frame_max_abs"], max_abs(color, frame.color))
            if traced:
                k5 = [work.forward_composite(f.kept, f.contributing, f.pixels) for _, _, f in refs]
                w, h = cfg["width"], cfg["height"]
                run.work[i] = {"k5_eyes": k5, "request": dict(
                    sfu=sum(k["sfu"] for k in k5),
                    flops=sum(k["flops"] for k in k5) + len(k5) * work.densenet2d_flops(eh, ew),
                    nbytes=4 * (work.PARAM_FLOATS * n + len(k5) * 3 * w * h)
                    + len(k5) * eh * ew)}
        if len(self.outputs) < len(self.sample):
            worst = {k: float("nan") for k in worst}
        for k, v in worst.items():
            run.checks[k] = (v, float(run.limits[k]))


def prepare(run):
    return Binocular(run)
