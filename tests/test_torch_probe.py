"""The training-quality probe's state converter (the port's training state
as a JAX one, ``quality_probe_torch.state_to_jax``) and the port's own
split draw in ``train_lib.densify_step``.

The converter is held by a round trip: the port's state through
``state_to_jax`` and back through the port's ``state_from_jax`` comes
back bit for bit, and the JAX optimizer takes the converted optax state.
The split draw: each ``densify_step`` call draws fresh (2, C, 3) standard
normals from the trainer's generator. Its split children, taken back
into each parent's frame (offset = R (n * s), so n = R^T offset / s),
are N(0, 1) over 2,048 candidates x 2 children x 3 axes: mean within
0.05 (5 standard errors) and standard deviation within 1 +- 0.05, the two
children's draws and two calls' draws uncorrelated to 0.05."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quality_probe_torch as probe
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.models import gaussian_model as jgm
from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib as ttrain
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as ttf

FIELDS = tgm.GaussianParams._fields
SHAPES = dict(xyz=(3,), f_dc=(3, 1), f_rest=(3, 15), scaling=(3,), rotation=(4,), opacity=(1,))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(rng, cap, scale=0.1):
    p = {k: rng.normal(size=(cap,) + s).astype(np.float32) * scale for k, s in SHAPES.items()}
    return tgm.GaussianParams(**{k: torch.from_numpy(v) for k, v in p.items()})


def _port_state(cap=96, seed=0):
    rng = np.random.default_rng(seed)
    params = _params(rng, cap, 1.0)
    mu, nu = _params(rng, cap), _params(rng, cap)
    nu = tgm.GaussianParams(*(v.abs() for v in nu))
    return tgm.GaussianModelState(
        params=params, active=torch.from_numpy(rng.uniform(size=cap) < 0.7),
        max_radii2d=torch.from_numpy(rng.integers(0, 9, cap).astype(np.float32)),
        xyz_grad_accum=torch.from_numpy(rng.uniform(size=cap).astype(np.float32)),
        denom=torch.from_numpy(rng.integers(0, 5, cap).astype(np.float32)),
        opt_state=tgm.AdamState(count=7, mu=mu, nu=nu), sh_degree=2)


def test_state_to_jax_round_trip():
    s = _port_state()
    tx = jgm.make_optimizer(JOpt(), 2.5)
    js = probe.state_to_jax(s, tx)
    back = tgm.state_from_jax(js, device="cpu")
    assert back.sh_degree == s.sh_degree == int(js.sh_degree)
    assert back.opt_state.count == s.opt_state.count
    for name in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        assert torch.equal(getattr(back, name), getattr(s, name)), name
    for name in FIELDS:
        assert torch.equal(getattr(back.params, name), getattr(s.params, name)), name
        assert torch.equal(getattr(back.opt_state.mu, name), getattr(s.opt_state.mu, name))
        assert torch.equal(getattr(back.opt_state.nu, name), getattr(s.opt_state.nu, name))
    # the xyz learning-rate schedule counts the same steps, and the JAX
    # optimizer takes the converted state
    assert int(js.opt_state.inner_states["xyz"].inner_state[1].count) == 7
    grads = jgm.GaussianParams(*(jnp.ones_like(v) for v in js.params))
    updates, _ = tx.update(grads, js.opt_state, js.params)
    assert all(bool(jnp.isfinite(u).all()) for u in updates)


def test_camera_draws_replay_the_trainers_permutations():
    rng = np.random.default_rng(0)
    first, second = list(rng.permutation(21)), list(rng.permutation(21))
    draws = probe.camera_draws(21, 0, 1, 42)
    assert draws == [int(x) for x in first[::-1] + second[::-1]]
    assert probe.camera_draws(21, 0, 20, 23) == draws[19:23]


def _split_state(n=2048):
    """n active gaussians in 2n slots, every one a split candidate (high
    gradient, larger than percent_dense * extent), none pruned."""
    rng = np.random.default_rng(4)
    cap = 2 * n
    p = _params(rng, cap, 1.0)
    scaling = torch.from_numpy(rng.uniform(-3.0, -1.5, (cap, 3)).astype(np.float32))
    params = p._replace(scaling=scaling, opacity=torch.full((cap, 1), 2.0))
    tx = tgm.make_optimizer(OptimizationConfig(), 1.0)
    state = tgm.init_training(params, 3, tx, cap)
    active = torch.arange(cap) < n
    return state._replace(active=active, xyz_grad_accum=active.to(torch.float32),
                          denom=torch.ones(cap))


def _frame_normals(parent: tgm.GaussianParams, child: torch.Tensor, rows):
    """n = R^T (child - parent) / s of the parents ``rows``."""
    rot = ttf.quat_to_rotmat(parent.rotation[rows]).double()
    off = (child - parent.xyz[rows]).double()
    return torch.einsum("nji,nj->ni", rot, off) / torch.exp(parent.scaling[rows]).double()


def test_densify_step_draws_fresh_standard_normals(monkeypatch):
    n = 2048
    state = _split_state(n)
    opt = OptimizationConfig()
    drawn = []
    densify = tgm.densify_and_prune

    def spy(st, normals, **kw):
        drawn.append(normals)
        return densify(st, normals, **kw)

    monkeypatch.setattr(tgm, "densify_and_prune", spy)
    gen = torch.Generator().manual_seed(0)
    outs = [ttrain.densify_step(state, gen, opt, 1e-3, 0.0) for _ in range(2)]
    assert [tuple(d.shape) for d in drawn] == [(2, 2 * n, 3)] * 2
    rows = torch.arange(n)
    draws = []
    for new, info in outs:
        assert int(info["split"]) == n and int(info["cloned"]) == 0
        assert int(info["pruned"]) == 0 and int(info["overflow"]) == 0
        # child 1 in place, child 2 in the free slots in candidate order
        z1 = _frame_normals(state.params, new.params.xyz[rows], rows)
        z2 = _frame_normals(state.params, new.params.xyz[n + rows], rows)
        assert torch.allclose(z1, drawn[len(draws)][0][rows].double(), atol=1e-3)
        assert torch.allclose(z2, drawn[len(draws)][1][rows].double(), atol=1e-3)
        z = torch.stack([z1, z2])
        assert abs(float(z.mean())) < 0.05
        assert abs(float(z.std()) - 1.0) < 0.05
        assert abs(float(torch.corrcoef(torch.stack([z1.flatten(), z2.flatten()]))[0, 1])) < 0.05
        draws.append(z)
    assert abs(float(torch.corrcoef(torch.stack([draws[0].flatten(),
                                                 draws[1].flatten()]))[0, 1])) < 0.05
    assert float((draws[0] - draws[1]).abs().max()) > 1.0
