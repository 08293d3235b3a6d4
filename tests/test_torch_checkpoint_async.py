"""The overlapped checkpoint save (``save_checkpoint_dist(...,
async_save=True)`` and ``wait_for_async_saves``, the port of the JAX
package's orbax ``async_save``), in one process on the CPU:

- a state saved with ``async_save=True`` while training steps go on (and
  while its own tensors are then overwritten in place, as an in-place
  optimizer would) loads bit-equal to the state at the save's iteration;
- a second save waits for the first, and both load;
- ``wait_for_async_saves`` with nothing pending returns, and a failed
  background write raises from it."""

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as ckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm

SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def trainer():
    """(state, step(state) -> state) of a 300-point model trained towards
    a random 32x32 image."""
    rng = np.random.default_rng(0)
    opt = OptimizationConfig()
    state, tx = gm.create_from_points(rng.uniform(-1, 1, (300, 3)).astype(np.float32),
                                      rng.uniform(size=(300, 3)).astype(np.float32), 1, opt,
                                      1.0, device="cpu")
    step = train_lib.make_train_step(tx, opt, 1, SIZE, SIZE, max_instances=1 << 14,
                                     device="cpu")
    cam = train_lib.camera_arrays(make_camera(SIZE, SIZE, device="cpu"))
    gt, bg = torch.from_numpy(rng.uniform(size=(3, SIZE, SIZE)).astype(np.float32)), \
        torch.zeros(3)
    return state, lambda s: step(s, *cam, gt, bg, True)[0]


def _bits(state):
    d = ckpt.state_to_dict(state)
    flat = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                flat.append(k)
                walk(x[k])
        elif isinstance(x, torch.Tensor):
            flat.append((x.dtype, tuple(x.shape), x.contiguous().view(torch.uint8).clone()))
        else:
            flat.append(x)

    walk(d)
    return flat


def _equal(a, b):
    return len(a) == len(b) and all(
        torch.equal(x[2], y[2]) and x[:2] == y[:2] if isinstance(x, tuple) else x == y
        for x, y in zip(a, b))


def test_async_save_loads_the_state_at_its_iteration(trainer, tmp_path):
    state, step = trainer
    for _ in range(2):
        state = step(state)
    want = _bits(state)
    path = str(tmp_path / "chkpnt2.shards")
    ckpt.save_checkpoint_dist(path, state, 2, async_save=True)
    later = state
    for _ in range(3):  # the steps go on while the files are written
        later = step(later)
    for t in (*state.params, *state.opt_state.mu, state.xyz_grad_accum):
        t.zero_()  # an in-place update of the saved state's own tensors
    ckpt.wait_for_async_saves()
    loaded, it = ckpt.load_checkpoint_dist(path, device="cpu")
    assert it == 2 and _equal(_bits(loaded), want)
    assert not _equal(_bits(later), want)
    meta = ckpt.checkpoint_meta(path)
    assert meta["layout"] == "replicated" and len(meta["digests"]) == 1
    assert ckpt.latest_checkpoint(str(tmp_path)) == path


def test_second_save_waits_for_the_first(trainer, tmp_path):
    state, step = trainer
    states = [state, step(state)]
    for i, s in enumerate(states):
        ckpt.save_checkpoint_dist(str(tmp_path / f"chkpnt{i}.shards"), s, i, async_save=True)
    ckpt.wait_for_async_saves()
    for i, s in enumerate(states):
        loaded, it = ckpt.load_checkpoint_dist(str(tmp_path / f"chkpnt{i}.shards"),
                                               device="cpu")
        assert it == i and _equal(_bits(loaded), _bits(s))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["chkpnt0.shards", "chkpnt1.shards"]


def test_wait_with_nothing_pending_and_a_failed_write(trainer, tmp_path, monkeypatch):
    ckpt.wait_for_async_saves()  # nothing pending: returns
    state, _ = trainer

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    ckpt.save_checkpoint_dist(str(tmp_path / "chkpnt0.shards"), state, 0, async_save=True)
    with pytest.raises(RuntimeError, match="overlapped checkpoint save failed"):
        ckpt.wait_for_async_saves()
    ckpt.wait_for_async_saves()  # the failure is reported once
