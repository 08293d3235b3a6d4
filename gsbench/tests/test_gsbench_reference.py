"""The reference agrees with the program's plain PyTorch path (its CPU
route) at a tiny size. The test imports both; the reference itself
imports nothing of the program."""

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import renderer, track_render
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gsbench import eyes, scenes
from gsbench.entries.common import Views, program_state
from gsbench.harness import ROOT
from gsbench.reference import render as ref
from gsbench.reference import ritnet as ref_ritnet

SPEC = {"kind": "point_cloud", "n": 3000, "sh_degree": 3, "extent": 2.5}
CFG = {"scene": SPEC, "slots": 4096}
WEIGHTS = ROOT / "gaussian_splatting_with_eye_tracking_tpu_torch" / "models" / "weights" \
    / "ritnet_best.npz"


@pytest.fixture(scope="module")
def scene():
    raw = scenes.make_scene(SPEC, 11, "cpu")
    state, _ = program_state(raw, CFG)
    views = Views(np.array([[2.0, -1.0]]), 160, 96, "cpu")
    return raw, state, views


def test_served_image(scene):
    raw, state, views = scene
    bg = torch.zeros(3)
    with torch.no_grad():
        out = renderer.render(views.params(0), state, bg, max_sh_degree=3, max_instances=1 << 17)
    cam = views.reference(0)
    frame = ref.render(ref.preprocess(*ref.activate(raw), cam), cam, bg)
    assert torch.equal(out.num_instances.long(), frame.lists.counts.sum())
    assert float((out.color - frame.color).abs().max()) < 1e-4


@pytest.mark.parametrize("decimation", [(1, 1, 1, 1), (4, 2, 1, 1)])
def test_foveated_frame(scene, decimation):
    raw, state, views = scene
    bg = torch.zeros(3)
    uv = (0.4, 0.55)
    rings = (20.0, 40.0, 80.0)
    color, st = track_render.foveated_view(state, views.params(0), bg, uv, 3, radii=rings,
                                           decimation=decimation, fused=True,
                                           max_instances=1 << 17)
    cam = views.reference(0)
    gaze = torch.tensor([uv[0] * cam.width, uv[1] * cam.height], dtype=torch.float32)
    frame = ref.render_foveated(ref.preprocess(*ref.activate(raw), cam), cam, bg, gaze, rings,
                                decimation)
    counts = (st.offsets[1:] - st.offsets[:-1]).long()
    assert torch.equal(counts, frame.lists.counts)
    assert float((color - frame.color).abs().max()) < 1e-4


def test_clahe_matches():
    rng = np.random.default_rng(3)
    for h, w in ((96, 160), (400, 640)):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        assert np.array_equal(ref_ritnet.clahe(img), ritnet.clahe(img))


def test_gaze_and_class_map():
    rng = np.random.default_rng(5)
    eye = eyes.eye_images(rng, np.array([[0.42, 0.58]]), 400, 640, 1)[0]
    uv, cls = track_render.estimate_gaze(eye, ritnet.load_pretrained(WEIGHTS, device="cpu"),
                                         device="cpu")
    r_uv, r_cls = ref_ritnet.gaze(eye, ref_ritnet.load_weights(WEIGHTS, "cpu"), "cpu")
    assert torch.equal(cls, r_cls) and np.allclose(uv, r_uv, atol=1e-9)
    assert (r_cls == ref_ritnet.PUPIL).any()
