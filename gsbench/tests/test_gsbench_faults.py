"""The check fails where it should: the lower-precision control (the
reference in bfloat16 in the program's place) and faults planted in the
program's timed path, each at a tiny size on the CPU."""

import pytest

from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import blend
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as ssim_ops
from gsbench import harness
from gsbench.tests.helpers import cpu_run

CELLS = ["bench300k.serve", "scene1m.eyetrack", "bench300k.train", "scene1m.serve"]


def _correct(run):
    return harness.result_line(run)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(bench, cell):
    assert _correct(cpu_run(bench, cell, 21, control=True)) is False


@pytest.mark.parametrize("cell", ["bench300k.serve", "scene1m.serve"])
def test_an_image_altered_where_it_is_made_fails(bench, cell, monkeypatch):
    assemble = blend.assemble_tiles

    def brighter(*a, **k):
        color, final_t = assemble(*a, **k)
        return color + 0.05, final_t

    monkeypatch.setattr(blend, "assemble_tiles", brighter)
    assert _correct(cpu_run(bench, cell, 22)) is False


def test_a_gaze_altered_where_it_is_made_fails(bench, monkeypatch):
    centroid = ritnet.pupil_centroid
    monkeypatch.setattr(ritnet, "pupil_centroid", lambda pred: centroid(pred) + [8.0, 0.0])
    run = cpu_run(bench, "scene1m.eyetrack", 23)
    assert _correct(run) is False and run.checks["gaze_px"][0] > run.checks["gaze_px"][1]


def test_a_step_that_keeps_its_state_fails(bench, monkeypatch):
    make = train_lib.make_train_step

    def frozen(*a, **k):
        step = make(*a, **k)
        return lambda state, *args, **kw: (state, step(state, *args, **kw)[1])

    monkeypatch.setattr(train_lib, "make_train_step", frozen)
    run = cpu_run(bench, "bench300k.train", 24)
    assert _correct(run) is False


def test_a_loss_over_half_the_image_fails(bench, monkeypatch):
    l1, ssim = ssim_ops.l1_loss, ssim_ops.ssim

    def top(f):
        return lambda a, b, *r: f(a[:, :a.shape[1] // 2], b[:, :b.shape[1] // 2], *r)

    monkeypatch.setattr(ssim_ops, "l1_loss", top(l1))
    monkeypatch.setattr(ssim_ops, "ssim", top(ssim))
    assert _correct(cpu_run(bench, "bench300k.train", 25)) is False
