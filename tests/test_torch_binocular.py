"""A head-mounted display's binocular frame in the port: ``estimate_gaze``
on a pair of eye images (one RITnet forward at batch 2),
``binocular_frame`` (one activation, each eye's fused foveated view),
``headset_frame`` (both, under the ``gs.binocular`` span) and
``eye_camera``. On the CPU, at a tiny size (a 2,000-point cloud in 4,096
slots, per-eye 112x96 views, so the last tile column and row are cropped,
64x96 eye images, RITnet weights from a seeded ``ritnet.init_params``):

- the frame and the gazes against the benchmark's plain reference
  (``gsbench/reference/binocular.py``): class maps equal, gazes within
  1e-9 of an eye image's size, per-tile counts equal and frames within
  1e-4, the tolerances of the single-eye reference tests
  (``gsbench/tests/test_gsbench_reference.py``);
- the batch-2 forward equals two batch-1 forwards (class maps equal,
  logits within 1e-5 of the largest), the pair's preprocessing (gamma,
  CLAHE and normalisation in tensor operations, the one route) the host
  NumPy reference's of each eye exactly, at the eye cameras' 400x640, at
  64x96 and at a shape the CLAHE grid pads;
- each eye's frame equals a single-eye ``foveated_view`` bit for bit;
- under ``torch.profiler``: one ``gs.gaze`` and one ``gs.activate``
  (outside every ``gs.fovea``) and two ``gs.fovea`` per ``gs.binocular``,
  ``gs.gaze.eyes`` 2, ``gs.fovea.instances`` each eye's
  ``num_instances``;
- the single-image ``estimate_gaze`` returns what the host reference's
  input gives through RITnet, and a centroid patched at
  ``ritnet.pupil_centroid`` moves one eye's gaze and a pair's;
- ``eye_camera`` puts an eye where the benchmark's head-path cameras put
  it.

Cases marked ``cuda`` hold the card against the CPU's plain path (skipped
without a card); they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binocular.py -q
"""

import json

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import tracing, track_render
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet
from gsbench import eyes, scenes
from gsbench.entries.binocular import EyeViews
from gsbench.entries.common import program_state
from gsbench.reference import binocular as ref_binocular

N, SLOTS, W, H = 2000, 4096, 112, 96
EYE_H, EYE_W = 64, 96
RINGS = (14.0, 28.0, 56.0)
CAPACITY = 1 << 15
CONFIG = {"width": W, "height": H, "fov_y_deg": 96.0, "ipd": 0.063, "scene": {"sh_degree": 3},
          "slots": SLOTS}
POSES = np.array([[0.0, 0.0], [4.0, -2.5]])
# the left pupil, and the right one verged inwards
GAZES = np.array([[0.42, 0.55], [0.47, 0.55]])


@pytest.fixture(autouse=True)
def few_threads():
    tracing._records.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    tracing._records.clear()
    torch.set_num_threads(threads)


def seeded_weights(device="cpu"):
    """RITnet parameters from a seeded ``init_params``: the model and the
    reference's dict of the same tensors."""
    params = ritnet.init_params(torch.Generator().manual_seed(7))
    model = ritnet.DenseNet2D()
    model.load_state_dict(ritnet.params_from_jax({k: v.numpy() for k, v in params.items()}))
    return model.to(device).eval(), {k: v.to(device) for k, v in params.items()}


@pytest.fixture(scope="module")
def world():
    raw = scenes.make_scene({"kind": "point_cloud", "n": N, "sh_degree": 3, "extent": 2.5},
                            11, "cpu")
    state, _ = program_state(raw, CONFIG)
    model, weights = seeded_weights()
    pair = eyes.eye_images(np.random.default_rng(3), GAZES, EYE_H, EYE_W, 2)
    return dict(raw=raw, state=state, model=model, weights=weights, pair=pair,
                views=EyeViews(POSES, CONFIG, "cpu"), bg=torch.tensor([0.1, 0.0, 0.2]))


def on(state, device):
    return state._replace(params=type(state.params)(*(p.to(device) for p in state.params)),
                          active=state.active.to(device))


def headset(world, pose=0, decimation=(1, 1, 1, 1), device="cpu", model=None):
    views = world["views"] if device == "cpu" else EyeViews(POSES, CONFIG, device)
    with torch.no_grad():
        return track_render.headset_frame(
            on(world["state"], device), views.params(pose), world["bg"].to(device),
            list(world["pair"]), model or world["model"], 3, radii=RINGS,
            decimation=decimation, max_instances=CAPACITY, device=device)


@pytest.mark.parametrize("pose,decimation", [(0, (1, 1, 1, 1)), (1, (4, 2, 1, 1))])
def test_binocular_frame_matches_the_reference(world, pose, decimation):
    uvs, cls, colors, states = headset(world, pose, decimation)
    refs = ref_binocular.frame(world["raw"], world["views"].reference(pose), world["pair"],
                               world["weights"], world["bg"], RINGS, decimation, "cpu")
    assert uvs.shape == (2, 2) and cls.shape == (2, EYE_H, EYE_W)
    assert len(colors) == len(states) == 2
    for e, (r_uv, r_cls, frame) in enumerate(refs):
        assert torch.equal(cls[e], r_cls)
        assert np.allclose(uvs[e], r_uv, atol=1e-9)
        counts = (states[e].offsets[1:] - states[e].offsets[:-1]).long()
        assert torch.equal(counts, frame.lists.counts)
        assert colors[e].shape == (3, H, W)
        assert float((colors[e] - frame.color).abs().max()) < 1e-4
    # two eyes, two views: the frames differ
    assert not torch.equal(colors[0], colors[1])


def host_input(eye):
    """The host NumPy reference's (1, 1, H, W) model input of one eye."""
    return torch.from_numpy(ritnet.normalise_eye_image(eye))[None, None]


def test_pair_forward_equals_two_single_forwards(world):
    pair, model = world["pair"], world["model"]
    x = ritnet.preprocess_eye_images(pair, device="cpu")
    singles = [host_input(eye) for eye in pair]
    assert x.shape == (2, 1, EYE_H, EYE_W) and torch.equal(x, torch.cat(singles))
    with torch.no_grad():
        both = model(x)
        one = torch.cat([model(s) for s in singles])
    # the CPU's convolutions block a batch of two another way and sum in
    # another order (2.5e-6 of the largest logit measured; 0 with the
    # vendored weights at 400x640): the class maps are equal
    assert float((both - one).abs().max()) <= 1e-5 * float(one.abs().max())
    pred = ritnet.get_predictions(both)
    assert torch.equal(pred, ritnet.get_predictions(one))
    np.testing.assert_array_equal(ritnet.pupil_centroids(pred),
                                  [ritnet.pupil_centroid(p) for p in pred])


def eye_pair(shape):
    h, w = shape
    rng = np.random.default_rng(h * w)
    pair = eyes.eye_images(rng, GAZES, h, w, 2)
    pair[1][: h // 3] = rng.integers(0, 256, (h // 3, w))  # a tile row past the clip limit
    return pair


PREP_SHAPES = [(400, 640), (64, 96), (37, 53)]


@pytest.mark.parametrize("shape", PREP_SHAPES)
def test_pair_preprocessing_is_each_eyes_bit_for_bit(shape):
    pair = eye_pair(shape)
    x = ritnet.preprocess_eye_images(np.stack(pair), device="cpu")
    want = torch.cat([host_input(eye) for eye in pair])
    assert x.dtype == torch.float32 and torch.equal(x, want)


def test_each_eye_equals_a_single_eye_view(world):
    uvs, _, colors, states = headset(world, 1, (4, 2, 1, 1))
    for e, cam in enumerate(world["views"].params(1)):
        color, st = track_render.foveated_view(world["state"], cam, world["bg"], uvs[e], 3,
                                               radii=RINGS, decimation=(4, 2, 1, 1), fused=True,
                                               max_instances=CAPACITY)
        assert torch.equal(colors[e], color)
        for name in ("tile_levels", "offsets", "gauss_id", "num_instances", "overflow"):
            assert torch.equal(getattr(states[e], name), getattr(st, name)), name


def test_spans_and_counters_of_a_headset_frame(world, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frames = [headset(world, pose) for pose in (0, 1)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation" and e["name"].startswith("gs.")]

    def inside(name, outer):
        return [(n, s, e) for n, s, e in spans if n == name and outer[1] <= s and e <= outer[2]]

    frame_spans = [sp for sp in spans if sp[0] == "gs.binocular"]
    assert len(frame_spans) == 2
    for outer in frame_spans:
        assert len(inside("gs.gaze", outer)) == 1
        assert len(inside("gs.activate", outer)) == 1
        assert len(inside("gs.fovea", outer)) == 2
        activate = inside("gs.activate", outer)[0]
        assert not [f for f in inside("gs.fovea", outer) if f[1] <= activate[1] <= f[2]]
    counts = tracing.counters()
    assert [c.value for c in counts if c.name == "gs.gaze.eyes"] == [2, 2]
    assert [c.value for c in counts if c.name == "gs.fovea.instances"] == [
        int(st.num_instances) for _, _, _, states in frames for st in states]


def test_single_image_estimate_gaze_is_unchanged(world):
    eye = np.pad(world["pair"][0], ((0, 5), (0, 9)))  # cropped back to 64x96
    uv, cls = track_render.estimate_gaze(eye, world["model"], device="cpu")
    with torch.no_grad():
        want = ritnet.get_predictions(world["model"](host_input(eye[:EYE_H, :EYE_W])))[0]
    assert cls.shape == (EYE_H, EYE_W) and torch.equal(cls, want)
    np.testing.assert_array_equal(uv, ritnet.pupil_centroid(want) / np.array([EYE_W, EYE_H]))
    # the first eye of a pair is the same eye
    uvs, pair_cls = track_render.estimate_gaze(list(world["pair"]), world["model"],
                                               device="cpu")
    np.testing.assert_array_equal(uvs[0], uv)
    assert torch.equal(pair_cls[0], cls)
    with pytest.raises(ValueError):
        track_render.estimate_gaze(eye.astype(np.float32), world["model"], device="cpu")


def test_a_patched_centroid_moves_one_eye_and_a_pair(world, monkeypatch):
    eye, pair = world["pair"][0], list(world["pair"])
    uv, _ = track_render.estimate_gaze(eye, world["model"], device="cpu")
    uvs, _ = track_render.estimate_gaze(pair, world["model"], device="cpu")
    centroid = ritnet.pupil_centroid
    monkeypatch.setattr(ritnet, "pupil_centroid", lambda pred: centroid(pred) + [8.0, 0.0])
    moved, _ = track_render.estimate_gaze(eye, world["model"], device="cpu")
    moved_pair, _ = track_render.estimate_gaze(pair, world["model"], device="cpu")
    shift = np.array([8.0 / EYE_W, 0.0])
    np.testing.assert_allclose(moved - uv, shift, atol=1e-12)
    np.testing.assert_allclose(moved_pair - uvs, [shift, shift], atol=1e-12)


def test_eye_camera_is_the_head_camera_moved_along_its_x_axis(world):
    head = EyeViews(POSES, dict(CONFIG, ipd=0.0), "cpu")
    for pose in (0, 1):
        centre = head.params(pose)[0]
        for side, want in zip((-1, 1), world["views"].params(pose)):
            got = track_render.eye_camera(centre, side * track_render.IPD / 2)
            for name in ("viewmatrix", "projmatrix", "campos"):
                assert torch.allclose(getattr(got, name), getattr(want, name), atol=1e-6), name
            assert (got.tan_fovx, got.width, got.height) == (want.tan_fovx, W, H)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("decimation", [(1, 1, 1, 1), (4, 2, 1, 1)])
def test_headset_frame_card_matches_cpu(world, dev, decimation):
    """The card's frame (K7, K1, K5, cuDNN) against the CPU's plain path:
    class maps on all but 0.1 % of pixels, gazes within 1 px, frames atol
    3e-4 / rtol 1e-3 with the levels and counts exact (the tolerances of
    ``tests/test_torch_cuda.py``'s RITnet and fused-frame cases)."""
    card_model, _ = seeded_weights(dev)
    want = headset(world, 1, decimation)
    got = headset(world, 1, decimation, device=dev, model=card_model)
    assert (got[1].cpu() != want[1]).float().mean() <= 1e-3
    assert np.abs((got[0] - want[0]) * np.array([EYE_W, EYE_H])).max() <= 1.0
    for e in range(2):
        assert torch.allclose(got[2][e].cpu(), want[2][e], atol=3e-4, rtol=1e-3)
        for name in ("tile_levels", "offsets", "num_instances", "overflow"):
            assert torch.equal(getattr(got[3][e], name).cpu(), getattr(want[3][e], name)), name


@pytest.mark.cuda
def test_card_eyes_equal_single_views_and_count(world, dev):
    card_model, _ = seeded_weights(dev)
    headset(world, 0, device=dev, model=card_model)  # builds the kernels
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        uvs, _, colors, states = headset(world, 0, device=dev, model=card_model)
        torch.cuda.synchronize()
    counts = tracing.counters()
    assert [c.value for c in counts if c.name == "gs.gaze.eyes"] == [2]
    assert [c.value for c in counts if c.name == "gs.fovea.instances"] == [
        int(st.num_instances) for st in states]
    state = on(world["state"], dev)
    for e, cam in enumerate(EyeViews(POSES, CONFIG, dev).params(0)):
        color, st = track_render.foveated_view(state, cam, world["bg"].to(dev), uvs[e], 3,
                                               radii=RINGS, max_instances=CAPACITY)
        assert torch.equal(colors[e], color) and torch.equal(states[e].offsets, st.offsets)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PREP_SHAPES)
def test_card_pair_preprocessing_is_the_hosts(dev, shape):
    """The pair's gamma, CLAHE and normalisation on the card equal the
    host NumPy reference's of each eye bit for bit."""
    pair = eye_pair(shape)
    x = ritnet.preprocess_eye_images(pair, device=dev)
    want = torch.cat([host_input(eye) for eye in pair])
    assert x.device.type == "cuda" and torch.equal(x.cpu(), want)


@pytest.mark.cuda
def test_card_gaze_equals_the_host_inputs(dev):
    """One 400x640 eye and a pair through ``estimate_gaze`` on the card,
    with the vendored weights: the class maps and gazes equal bit for bit
    those of the host reference's inputs uploaded and run through the same
    model at the same batch (what the host route gave)."""
    model = ritnet.load_pretrained(device=dev)
    pair = eyes.eye_images(np.random.default_rng(5), GAZES, 400, 640, 2)
    size = np.array([640, 400])
    for batch in ([pair[0]], pair):
        with torch.no_grad():
            want = ritnet.get_predictions(model(torch.cat([host_input(e) for e in batch]).to(dev)))
        want_uv = np.stack([ritnet.pupil_centroid(p) for p in want]) / size
        uv, cls = track_render.estimate_gaze(batch[0] if len(batch) == 1 else batch, model,
                                             device=dev)
        if len(batch) == 1:
            uv, cls = uv[None], cls[None]
        assert (want == ritnet.PUPIL).any()
        assert torch.equal(cls, want) and np.array_equal(uv, want_uv)

