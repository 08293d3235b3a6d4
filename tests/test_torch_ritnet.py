"""PyTorch port vs JAX package: RITnet inference and the gaze estimate.
DenseNet2D with the vendored weights against ``densenet2d_apply`` to atol
1e-4 / rtol 1e-4 (fp32 convolutions summed in another order), class maps
equal wherever the top two logits are more than 1e-4 apart; the
preprocessing bit-equal (the host NumPy reference and the tensor route
that every program path takes, which needs no host reference); the pupil
centroid exact; the gaze of a synthetic eye within 0.5 px."""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet as jrit
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet_data as jdata
from gaussian_splatting_with_eye_tracking_tpu_torch import track_render
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet as trit
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_data as tdata
from tests.torch_helpers import assert_close, assert_equal


@pytest.fixture(scope="module")
def weights():
    return jrit.load_pretrained()


# one compile per input shape instead of one per operation
densenet2d_apply = jax.jit(jrit.densenet2d_apply)


@pytest.fixture(scope="module")
def model():
    return trit.load_pretrained(device="cpu")


def test_weights_copy_is_byte_identical():
    assert filecmp.cmp(trit.VENDORED_WEIGHTS, jrit.VENDORED_WEIGHTS, shallow=False)


def test_params_from_jax_round_trips(weights, model):
    sd = trit.params_from_jax({k: np.asarray(v) for k, v in weights.items()})
    net = trit.DenseNet2D()
    net.load_state_dict(sd)  # strict: every module key is there
    back = {k: v.numpy() for k, v in net.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(weights) and len(back) == 104
    for k, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(weights[k]), err_msg=k)
    assert sum(v.size for v in back.values()) == 249_220
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _top2_gap(logits):
    top2 = torch.topk(logits, 2, dim=1).values
    return top2[:, 0] - top2[:, 1]


def test_densenet_matches_jax(weights, model):
    """A seeded input in the model's input range [-1, 1] (what
    preprocess_eye_image gives)."""
    x = np.random.default_rng(0).uniform(-1.0, 1.0, (1, 1, 64, 96)).astype(np.float32)
    want = np.asarray(densenet2d_apply(weights, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (1, 4, 64, 96) and not model.training
    assert_close(got, want, atol=1e-4, rtol=1e-4)
    clear = _top2_gap(got) > 1e-4
    assert_equal(trit.get_predictions(got)[clear],
                 np.asarray(jrit.get_predictions(jnp.asarray(want)))[clear.numpy()])
    assert clear.float().mean() > 0.99


def test_preprocessing_bit_equal():
    img = np.random.default_rng(1).integers(0, 256, (60, 84), dtype=np.uint8)
    assert_equal(torch.from_numpy(trit.gamma_lut(img)), jrit.gamma_lut(img))
    assert_equal(torch.from_numpy(trit.clahe(img)), jrit.clahe(img))
    want = jrit.preprocess_eye_image(img)
    assert_equal(torch.from_numpy(trit.normalise_eye_image(img))[None, None], want)
    got = trit.preprocess_eye_image(img, device="cpu")  # the tensor route
    assert got.shape == (1, 1, 60, 84) and got.dtype == torch.float32
    assert_equal(got, want)


def test_no_program_path_takes_the_host_reference(model, tmp_path, monkeypatch):
    """With the port's host reference (``clahe``, ``normalise_eye_image``)
    made to raise, ``preprocess_eye_image``, one eye's ``estimate_gaze``
    and ``ritnet_data.batches`` still run on the CPU and equal JAX's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a program path took the host reference")

    monkeypatch.setattr(trit, "clahe", refuse)
    monkeypatch.setattr(trit, "normalise_eye_image", refuse)
    eye = cs.make_eye(seed=3, height=96, width=128)
    want_x = np.array(jrit.preprocess_eye_image(eye))
    assert_equal(trit.preprocess_eye_image(eye, device="cpu"), want_x)
    with torch.no_grad():
        want = trit.get_predictions(model(torch.from_numpy(want_x)))[0]
    uv, pred = track_render.estimate_gaze(eye, model, device="cpu")
    assert torch.equal(pred, want)
    np.testing.assert_array_equal(uv, jrit.pupil_centroid(want.numpy()) / np.array([128, 96]))
    cs.write_eye_dataset(str(tmp_path), 4, 0, height=40, width=56, seed=2)
    got = list(tdata.batches(str(tmp_path), "train", 2, np.random.default_rng(4)))
    ref = list(jdata.batches(str(tmp_path), "train", 2, np.random.default_rng(4)))
    assert len(got) == len(ref) == 2
    for gb, rb in zip(got, ref):
        for a, b in zip(gb, rb):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_pupil_centroid_exact():
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 3, (48, 64))
    pred[10:17, 30:41] = 3
    pred[rng.uniform(size=pred.shape) < 0.01] = 3
    for p in (pred, np.zeros((32, 48), np.int64)):  # and the empty case
        want = jrit.pupil_centroid(p)
        np.testing.assert_array_equal(trit.pupil_centroid(torch.from_numpy(p)), want)
        np.testing.assert_array_equal(trit.pupil_centroid(p), want)
    np.testing.assert_array_equal(trit.pupil_centroid(np.zeros((32, 48))), [24.0, 16.0])


def test_estimate_gaze_matches_jax(weights, model):
    """A synthetic 128x96 eye through the port's estimate_gaze and through
    JAX's RITnet and pupil centroid (track_render.py's steps)."""
    eye = cs.make_eye(seed=0, height=96, width=128)
    logits = densenet2d_apply(weights, jrit.preprocess_eye_image(eye))
    want_pred = np.asarray(jrit.get_predictions(logits))[0]
    want = jrit.pupil_centroid(want_pred) / np.array([128, 96])
    got, pred = track_render.estimate_gaze(eye, model, device="cpu")
    assert pred.shape == (96, 128)
    assert np.abs((got - want) * np.array([128, 96])).max() <= 0.5
    assert (pred.numpy() != want_pred).mean() <= 1e-3
    uv, _ = track_render.estimate_gaze(eye, device="cpu")  # the vendored weights by default
    np.testing.assert_array_equal(uv, got)
    with pytest.raises(ValueError):
        track_render.estimate_gaze(eye.astype(np.float32), model, device="cpu")
