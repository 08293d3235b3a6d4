"""PyTorch port vs JAX package: RITnet training on the CPU.

- The losses at seeded logits, on a batch where every class is present and
  on one where a class is absent (its generalized-Dice weight 1e10): each
  within rtol 1e-5 of JAX's (measured <= 5.8e-7).
- ``boundary_weight_map``, ``distance_maps``, ``alpha_schedule`` and
  ``miou`` (a class absent from both prediction and label included) equal
  to JAX's.
- The train step from JAX's ``init_params(PRNGKey(0))`` at full width (32
  channels) on a 2x1x32x48 batch (JAX's toy batch: label / 3 + N(0, 0.1)),
  against JAX's jitted ``make_train_step``: the loss within rtol 1e-5, every
  gradient (the BatchNorm statistics' included) within 1e-4 of its tensor's
  largest magnitude (measured 7e-6), the parameters after 1 and 3 steps
  within 1 % of a learning-rate step (measured 0.04 %); the BatchNorm
  statistics move by one learning rate in the first step, as JAX's do.
- On an input uniform in [-1, 1] the untrained model's logits reach
  ~7e3 and the sums cancel: there JAX's float32 gradient departs from a
  float64 computation by 1.4e-4 of a tensor's largest value, so the port
  is held against its own float64 run instead (within 2e-5).
- ``augment`` bit-identical to JAX's for seeds 0-19 (every branch), and
  ``batches`` bit-identical on a small OpenEDS-style folder.
- The training form with untouched statistics gives the eval module's
  logits (JAX's affine BatchNorm vs ``nn.BatchNorm2d``'s rounding).
- ``init_params``: JAX's names, shapes, order and scheme.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet as jrit
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet_data as jdata
from gaussian_splatting_with_eye_tracking_tpu.models import ritnet_train as jtrain
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet as trit
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_data as tdata
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet_train as ttrain

LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several worker processes on one machine: keep this
    file's CPU convolutions to two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _labels(absent=None, n=2, h=32, w=48):
    label = np.zeros((n, h, w), np.int32)
    label[:, 8:24, 10:30] = 2
    label[:, 12:20, 15:25] = 3
    label[0, 2:6] = 1
    if absent is not None:
        label[label == absent] = 0 if absent else 2
    return label


def _maps(label):
    return (np.stack([jtrain.boundary_weight_map(x) for x in label]),
            np.stack([jtrain.distance_maps(x) for x in label]))


@pytest.mark.parametrize("absent", [None, 1, 0])
def test_losses_match_jax(absent):
    label = _labels(absent)
    assert (len(np.unique(label)) == 4) == (absent is None)
    wm, dm = _maps(label)
    logits = np.random.default_rng(0).normal(scale=3.0, size=(2, 4, 32, 48)).astype(np.float32)
    j = [jnp.asarray(a) for a in (logits, label, wm, dm)]
    t = [torch.from_numpy(a) for a in (logits, label, wm, dm)]
    pairs = [
        (jtrain.cross_entropy_weighted(j[0], j[1], j[2]),
         ttrain.cross_entropy_weighted(t[0], t[1], t[2])),
        (jtrain.generalized_dice_loss(j[0], j[1]), ttrain.generalized_dice_loss(t[0], t[1])),
        (jtrain.surface_loss(j[0], j[3]), ttrain.surface_loss(t[0], t[3])),
    ] + [(jtrain.total_loss(*j, a), ttrain.total_loss(*t, a)) for a in (1.0, 0.3, 0.0)]
    for want, got in pairs:
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_weight_and_distance_maps_equal_jax():
    rng = np.random.default_rng(3)
    labels = [_labels()[0], _labels(absent=1)[0], rng.integers(0, 4, (20, 28)),
              np.zeros((16, 16), np.int64), cs.eye_label(48, 64, (0.6, 0.4))]
    for label in labels:
        np.testing.assert_array_equal(ttrain.boundary_weight_map(label),
                                      jtrain.boundary_weight_map(label))
        got = ttrain.distance_maps(label)
        assert got.dtype == np.float32 and got.shape == (4,) + label.shape
        np.testing.assert_array_equal(got, jtrain.distance_maps(label))


def test_alpha_schedule_and_miou_equal_jax():
    for epoch in (0, 1, 60, 124, 125, 126, 250):
        assert ttrain.alpha_schedule(epoch) == jtrain.alpha_schedule(epoch)
    assert ttrain.alpha_schedule(10, period=20) == jtrain.alpha_schedule(10, period=20)
    for seed in range(12):
        rng = np.random.default_rng(seed)
        pred, label = rng.integers(0, 4, (2, 16, 24)), rng.integers(0, 4, (2, 16, 24))
        if seed % 3 == 1:  # class 2 absent from both
            pred[pred == 2], label[label == 2] = 0, 1
        if seed % 3 == 2:  # class 3 in the prediction only
            label[label == 3] = 0
        want = float(jtrain.miou(jnp.asarray(pred), jnp.asarray(label)))
        got = ttrain.miou(torch.from_numpy(pred), torch.from_numpy(label))
        assert got.dtype == torch.float32 and float(got) == want, seed
    one = np.zeros((8, 8), np.int32)
    assert float(ttrain.miou(torch.from_numpy(one), torch.from_numpy(one))) == 1.0


def _toy_batch():
    label = _labels()
    img = (label / 3.0 + np.random.default_rng(1).normal(scale=0.1, size=label.shape))
    return (img.astype(np.float32)[:, None], label, *_maps(label))


def _jax_loss(p, batch):
    return jtrain.total_loss(jrit.densenet2d_apply(p, batch[0]), *batch[1:], 1.0)


_jax_grad = jax.jit(jax.value_and_grad(_jax_loss))


@pytest.fixture(scope="module")
def jax_params():
    return {k: np.asarray(v) for k, v in jrit.init_params(jax.random.PRNGKey(0)).items()}


def _to_torch(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def test_train_step_matches_jax(jax_params):
    batch = _toy_batch()
    jb, tb = tuple(map(jnp.asarray, batch)), tuple(map(torch.from_numpy, batch))
    want_loss, want_grads = _jax_grad(jax_params, jb)
    got_loss, got_grads = ttrain.loss_and_grads(_to_torch(jax_params), tb, 1.0)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert set(got_grads) == set(want_grads) and len(got_grads) == 104
    for k, want in want_grads.items():
        want = np.asarray(want)
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got_grads[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)

    tx, step = jtrain.make_train_step(LR)
    ttx, tstep = ttrain.make_train_step(LR)
    jp, jstate = jax_params, tx.init(jax_params)
    tp = _to_torch(jax_params)
    tstate = ttx.init(tp)
    for i in range(3):
        jp, jstate, jloss = step(jp, jstate, jb, 1.0)
        tp, tstate, tloss = tstep(tp, tstate, tb, 1.0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if i in (0, 2):
            for k in jp:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                           atol=0.01 * LR, err_msg=f"step {i + 1}: {k}")
        if i == 0:  # the BatchNorm statistics are trained, one lr a step (Adam's first)
            for name in ("running_mean", "running_var", "weight"):
                k = f"down_block1.bn.{name}"
                moved = (tp[k] - torch.tensor(jax_params[k])).abs()
                np.testing.assert_allclose(moved.numpy(), LR, rtol=1e-3, err_msg=k)
    assert tstate.count == 3


def test_gradients_on_a_wide_input_match_float64(jax_params):
    """Logits near 7e3: held against the port's own float64 run."""
    label = _labels()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 1, 32, 48)).astype(np.float32)
    batch = (x, label, *_maps(label))
    runs = {}
    for dt in (torch.float32, torch.float64):
        tb = tuple(torch.from_numpy(a).to(dt) if a.dtype != np.int32 else torch.from_numpy(a)
                   for a in batch)
        runs[dt] = ttrain.loss_and_grads(
            {k: v.to(dt) for k, v in _to_torch(jax_params).items()}, tb, 1.0)
    (l32, g32), (l64, g64) = runs[torch.float32], runs[torch.float64]
    with torch.no_grad():
        top = trit.densenet2d_apply(_to_torch(jax_params), torch.from_numpy(x)).abs().max()
    assert top > 1e3
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)
    for k, want in g64.items():
        np.testing.assert_allclose(g32[k].double().numpy(), want.numpy(), rtol=0,
                                   atol=2e-5 * float(want.abs().max()), err_msg=k)


def test_training_form_gives_the_eval_modules_logits():
    model = trit.load_pretrained(device="cpu")
    params = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (1, 1, 64, 96))
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x)
        got = trit.densenet2d_apply(params, x)
        assert torch.equal(trit.densenet2d_apply(params, x, bn=trit.batch_norm_eval), want)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)
    with torch.no_grad():
        model.train()  # no batch statistics in either mode
        assert torch.equal(model(x), want)


def test_init_params_follow_jax_scheme(jax_params):
    params = trit.init_params(torch.Generator().manual_seed(0))
    assert list(params) == list(jax_params)
    for k, v in params.items():
        assert v.dtype == torch.float32 and tuple(v.shape) == jax_params[k].shape, k
        if k.endswith(("running_mean", ".bias")):
            assert not v.any(), k
        elif k.endswith(("running_var", "bn.weight")):
            assert (v == 1).all(), k
        else:
            cout, _, ksz, _ = v.shape
            std = np.sqrt(2.0 / (ksz * ksz * cout))
            assert abs(float(v.std()) / std - 1) < 0.2, k
    assert sum(v.numel() for v in params.values()) == 249_220
    again = trit.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_augment_bit_identical_to_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (48, 64), np.uint8)
    label = rng.integers(0, 4, (48, 64)).astype(np.int32)
    branches = set()
    for seed in range(20):
        rec = _RecordedRng(seed)
        want = jdata.augment(img, label, rec)
        got = tdata.augment(img, label, np.random.default_rng(seed))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=str(seed))
        gates = (0.5, 0.2, 0.2, 0.2, 0.2)  # flip, blur, lines, blob, shift
        assert len(rec.gates) == len(gates)
        branches |= {i for i, (v, p) in enumerate(zip(rec.gates, gates)) if v < p}
    assert branches == {0, 1, 2, 3, 4}


class _RecordedRng:
    """A Generator that records the draws deciding augment's branches."""

    def __init__(self, seed):
        self.rng, self.gates = np.random.default_rng(seed), []

    def random(self):
        self.gates.append(self.rng.random())
        return self.gates[-1]

    def uniform(self, *args):
        return self.rng.uniform(*args)

    def integers(self, *args):
        return self.rng.integers(*args)


def test_batches_bit_identical_to_jax(tmp_path):
    cs.write_eye_dataset(str(tmp_path), 6, 3, height=40, width=56, seed=1)
    for split, train in (("train", True), ("validation", False)):
        want = list(jdata.batches(str(tmp_path), split, 2, np.random.default_rng(5), train=train))
        got = list(tdata.batches(str(tmp_path), split, 2, np.random.default_rng(5), train=train))
        assert len(got) == len(want) == (3 if train else 1)
        for gb, wb in zip(got, want):
            assert [a.shape for a in gb] == [(2, 1, 32, 48), (2, 32, 48), (2, 32, 48),
                                            (2, 4, 32, 48)]
            for a, b in zip(gb, wb):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert tdata.list_split(str(tmp_path), "train") == jdata.list_split(str(tmp_path), "train")
