"""The learnable Gaussian scene on capacity-padded buffers.

Port of ``gaussian_splatting_with_eye_tracking_tpu/models/gaussian_model.py``:
raw parameters and their activations, the training state (parameters,
``active`` mask, densification accumulators, per-group Adam state, active
SH degree), per-group Adam with an exponential xyz schedule, SH-degree
annealing, capacity growth, densification statistics and density control
(clone / split / prune / opacity reset).

As in JAX, parameters live in capacity-sized tensors with an ``active``
mask: clone and split write into free slots, prune clears mask bits, and
the Adam moments of touched rows are zeroed (the reference's optimizer
surgery). Every function here is pure, ``state -> state``; density
control takes its random normals as an argument.

Layouts are the JAX package's: SH (C, 3, K) with the DC term in column 0,
quaternions wxyz, opacity (C, 1) logits, log scales.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, NamedTuple, Optional, Union

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import knn as knn_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import sh as sh_ops
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import transforms as tf

OPACITY_FILL = float(np.log(0.1 / 0.9))  # logit of 0.1: padded and new slots
SCALING_FILL = -10.0  # log scale of padded slots


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


class GaussianParams(NamedTuple):
    """Raw (pre-activation) parameters, capacity-padded."""

    xyz: torch.Tensor  # (C, 3)
    f_dc: torch.Tensor  # (C, 3, 1)
    f_rest: torch.Tensor  # (C, 3, K-1)
    scaling: torch.Tensor  # (C, 3) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion (wxyz)
    opacity: torch.Tensor  # (C, 1) logit


class AdamState(NamedTuple):
    """Per-group Adam state: one step count (every group steps together,
    as under optax's multi_transform) and the moments, by field name."""

    count: int
    mu: GaussianParams
    nu: GaussianParams


class GaussianModelState(NamedTuple):
    """A model: what rendering reads (params, which slots are live, the
    active SH degree) and, for training, the densification accumulators
    and the optimizer state (None in a render-only state)."""

    params: GaussianParams
    active: torch.Tensor  # (C,) bool
    sh_degree: int
    max_radii2d: Optional[torch.Tensor] = None  # (C,) float32
    xyz_grad_accum: Optional[torch.Tensor] = None  # (C,) float32
    denom: Optional[torch.Tensor] = None  # (C,) float32
    opt_state: Optional[AdamState] = None


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity[:, 0])


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return p.rotation / torch.linalg.vector_norm(p.rotation, dim=-1, keepdim=True)


def get_sh(p: GaussianParams) -> torch.Tensor:
    return torch.cat([p.f_dc, p.f_rest], dim=-1)  # (N, 3, K)


def get_covariance(p: GaussianParams, scale_modifier: float = 1.0) -> torch.Tensor:
    return tf.build_cov3d(get_scaling(p), p.rotation, scale_modifier)


def sh_band_mask(sh_degree: int, max_sh_degree: int, device=None) -> torch.Tensor:
    """(K,) bool mask of the SH coefficients active at ``sh_degree``."""
    k = (max_sh_degree + 1) ** 2
    idx = torch.arange(k, device=device)
    band = torch.floor(torch.sqrt(idx.to(torch.float32))).to(torch.int32)
    return band <= sh_degree


def activate(p: GaussianParams, sh_degree: int, max_sh_degree: int) -> tuple:
    """(means, scales, rotations, opacities, SH with the bands above
    ``sh_degree`` zeroed): the rasterizer's activated inputs."""
    mask = sh_band_mask(sh_degree, max_sh_degree, p.xyz.device)
    sh = get_sh(p) * mask[None, None, :]
    return p.xyz, get_scaling(p), p.rotation, get_opacity(p), sh


class RawGaussians(NamedTuple):
    """A model's raw parameters (``GaussianParams``' six fields, in its
    order) and its active SH degree: the rasterizer's input in place of
    the five activated tensors where the preprocess kernel (K7) activates
    each row as it loads it (``ops/projection.preprocess``)."""

    xyz: torch.Tensor  # (C, 3)
    f_dc: torch.Tensor  # (C, 3, 1)
    f_rest: torch.Tensor  # (C, 3, K-1)
    scaling: torch.Tensor  # (C, 3) log-scale
    rotation: torch.Tensor  # (C, 4) unnormalized quaternion (wxyz)
    opacity: torch.Tensor  # (C, 1) logit
    sh_degree: int

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def max_sh_degree(self) -> int:
        return math.isqrt(1 + self.f_rest.shape[-1]) - 1

    def activated(self) -> tuple:
        """``activate``'s five tensors, the bands above ``sh_degree`` zeroed."""
        return activate(GaussianParams(*self[:6]), self.sh_degree, self.max_sh_degree)


def num_active(state: GaussianModelState) -> torch.Tensor:
    return torch.sum(state.active)


def params_from_jax(
    params_np: Union[Mapping[str, np.ndarray], NamedTuple], device=None,
) -> GaussianParams:
    """Carry weights across from the JAX package: a dict of numpy arrays,
    or its ``GaussianParams`` with numpy (or array-like) leaves, keeping
    every layout as it is. Runs on CUDA unless ``device`` says otherwise."""
    dev = backend.resolve_device(device)
    src = params_np._asdict() if hasattr(params_np, "_asdict") else dict(params_np)
    return GaussianParams(**{
        name: torch.tensor(np.asarray(src[name], dtype=np.float32), device=dev)
        for name in GaussianParams._fields
    })


def state_from_params(params: GaussianParams, sh_degree: int) -> GaussianModelState:
    """A render state with every slot active."""
    n = params.xyz.shape[0]
    active = torch.ones(n, dtype=torch.bool, device=params.xyz.device)
    return GaussianModelState(params=params, active=active, sh_degree=sh_degree)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def expon_lr_schedule(lr_init: float, lr_final: float, lr_delay_mult: float,
                      max_steps: int, lr_delay_steps: int = 0) -> Callable[[int], float]:
    """Log-linear decay from lr_init to lr_final over max_steps, with an
    optional reverse-cosine warm-up from lr_init*lr_delay_mult over
    lr_delay_steps (0 disables it). Negative steps and an all-zero range
    give 0. Returns ``step -> lr`` on the host."""

    def schedule(step: int) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(math.log(max(lr_init, 1e-32)) * (1 - t)
                            + math.log(max(lr_final, 1e-32)) * t)
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        return delay_rate * log_lerp

    return schedule


class Adam:
    """Per-group Adam (b1 0.9, b2 0.999, eps ``opt.adam_eps``) with the
    learning rates of ``make_optimizer``; each rate is a float or a
    ``step -> lr`` schedule, read at the step count before the increment,
    as optax does."""

    b1 = 0.9
    b2 = 0.999

    def __init__(self, lrs: dict, eps: float):
        self.lrs = lrs
        self.eps = eps

    def init(self, params: GaussianParams) -> AdamState:
        def zeros():
            return GaussianParams(*(torch.zeros_like(v) for v in params))

        return AdamState(count=0, mu=zeros(), nu=zeros())

    def lr(self, name: str, count: int) -> float:
        lr = self.lrs[name]
        return lr(count) if callable(lr) else lr

    def update(self, grads: GaussianParams, state: AdamState,
               params: GaussianParams) -> tuple[GaussianParams, AdamState]:
        """One step: returns (new params, new state)."""
        count = state.count + 1
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        new_p, new_mu, new_nu = {}, {}, {}
        for name in GaussianParams._fields:
            g = getattr(grads, name)
            mu = (1.0 - self.b1) * g + self.b1 * getattr(state.mu, name)
            nu = (1.0 - self.b2) * (g * g) + self.b2 * getattr(state.nu, name)
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            new_p[name] = getattr(params, name) - self.lr(name, state.count) * step
            new_mu[name], new_nu[name] = mu, nu
        return GaussianParams(**new_p), AdamState(
            count=count, mu=GaussianParams(**new_mu), nu=GaussianParams(**new_nu))


def make_optimizer(opt: OptimizationConfig, spatial_lr_scale: float) -> Adam:
    """Per-group Adam, eps 1e-15; f_rest lr = feature_lr / 20; xyz on the
    exponential schedule scaled by the scene extent."""
    xyz_sched = expon_lr_schedule(
        opt.position_lr_init * spatial_lr_scale,
        opt.position_lr_final * spatial_lr_scale,
        opt.position_lr_delay_mult,
        opt.position_lr_max_steps,
        lr_delay_steps=opt.position_lr_delay_steps,
    )
    return Adam({
        "xyz": xyz_sched,
        "f_dc": opt.feature_lr,
        "f_rest": opt.feature_lr / 20.0,
        "opacity": opt.opacity_lr,
        "scaling": opt.scaling_lr,
        "rotation": opt.rotation_lr,
    }, eps=opt.adam_eps)


def _edit_opt_state_rows(opt_state: AdamState, rows_mask: torch.Tensor,
                         fields=None) -> AdamState:
    """Zero the Adam moments (mu, nu) on the masked rows of every field, or
    of ``fields`` only: the reference's optimizer surgery on fixed
    buffers."""

    def fix(moments: GaussianParams) -> GaussianParams:
        return GaussianParams(*[
            torch.where(rows_mask.reshape((-1,) + (1,) * (v.dim() - 1)),
                        torch.zeros_like(v), v)
            if fields is None or name in fields else v
            for name, v in zip(GaussianParams._fields, moments)
        ])

    return opt_state._replace(mu=fix(opt_state.mu), nu=fix(opt_state.nu))


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def next_pow2(n: int) -> int:
    return 1 << max(1, (n - 1)).bit_length()


def _pad_rows(v: torch.Tensor, cap: int, fill=0.0) -> torch.Tensor:
    out = torch.full((cap,) + tuple(v.shape[1:]), fill, dtype=v.dtype, device=v.device)
    out[: v.shape[0]] = v
    return out


def _pad_params(p: GaussianParams, cap: int) -> GaussianParams:
    """Pad every field to ``cap`` rows with the inert fills: zeros, log
    scale -10, identity quaternion, opacity logit of 0.1."""
    n = p.xyz.shape[0]
    rotation = _pad_rows(p.rotation, cap)
    rotation[n:, 0] = 1.0
    return GaussianParams(
        xyz=_pad_rows(p.xyz, cap), f_dc=_pad_rows(p.f_dc, cap),
        f_rest=_pad_rows(p.f_rest, cap), scaling=_pad_rows(p.scaling, cap, SCALING_FILL),
        rotation=rotation, opacity=_pad_rows(p.opacity, cap, OPACITY_FILL))


def init_training(params: GaussianParams, sh_degree: int, tx: Adam,
                  capacity: int = 0) -> GaussianModelState:
    """A training state for ``params`` (all active) at ``capacity`` slots
    (at least next_pow2 of the count): zero accumulators, fresh Adam."""
    n = params.xyz.shape[0]
    cap = max(capacity, next_pow2(n))
    params = _pad_params(params, cap)
    dev = params.xyz.device
    zeros = torch.zeros(cap, dtype=torch.float32, device=dev)
    return GaussianModelState(
        params=params, active=torch.arange(cap, device=dev) < n, sh_degree=sh_degree,
        max_radii2d=zeros, xyz_grad_accum=zeros.clone(), denom=zeros.clone(),
        opt_state=tx.init(params))


def create_from_points(points: np.ndarray, colors: np.ndarray, max_sh_degree: int,
                       opt: OptimizationConfig, spatial_lr_scale: float,
                       capacity: int = 0, device=None) -> tuple[GaussianModelState, Adam]:
    """Initialize from a point cloud: SH DC from RGB, isotropic log scale
    from the mean 3-NN distance, identity rotations, opacity 0.1, SH degree
    0. The capacity defaults to min(next_pow2(8n), max(next_pow2(n), 2^22))
    and is at least next_pow2(n). Runs on CUDA unless ``device`` says
    otherwise."""
    dev = backend.resolve_device(device)
    n = points.shape[0]
    cap = capacity or min(next_pow2(n * 8), max(next_pow2(n), 1 << 22))
    k = (max_sh_degree + 1) ** 2
    dist2 = np.maximum(knn_ops.mean_sq_dist_3nn(points), 1e-7)
    log_scale = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    params = GaussianParams(
        xyz=t(points),
        f_dc=sh_ops.rgb_to_sh_dc(t(colors))[:, :, None],
        f_rest=torch.zeros((n, 3, k - 1), device=dev),
        scaling=t(log_scale),
        rotation=t(np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1))),
        opacity=torch.full((n, 1), OPACITY_FILL, device=dev),
    )
    tx = make_optimizer(opt, spatial_lr_scale)
    return init_training(params, 0, tx, cap), tx


def oneup_sh_degree(state: GaussianModelState, max_sh_degree: int) -> GaussianModelState:
    """Anneal the active SH degree by one, up to ``max_sh_degree``."""
    return state._replace(sh_degree=min(state.sh_degree + 1, max_sh_degree))


def grow_capacity(state: GaussianModelState, new_cap: int) -> GaussianModelState:
    """Pad every per-slot buffer to ``new_cap`` rows: params with the inert
    fills, ``active`` with False, accumulators and Adam moments with zeros.
    The moments are padded by field name, never by matching a leading
    dimension to the capacity. No-op when ``new_cap`` <= capacity."""
    cap = state.params.xyz.shape[0]
    if new_cap <= cap:
        return state
    opt = state.opt_state
    if opt is not None:
        opt = opt._replace(
            mu=GaussianParams(*(_pad_rows(v, new_cap) for v in opt.mu)),
            nu=GaussianParams(*(_pad_rows(v, new_cap) for v in opt.nu)))

    def acc(v):
        return None if v is None else _pad_rows(v, new_cap)

    return state._replace(
        params=_pad_params(state.params, new_cap),
        active=_pad_rows(state.active, new_cap, False),
        max_radii2d=acc(state.max_radii2d), xyz_grad_accum=acc(state.xyz_grad_accum),
        denom=acc(state.denom), opt_state=opt)


# ---------------------------------------------------------------------------
# Densification statistics and density control
# ---------------------------------------------------------------------------


def add_densification_stats(state: GaussianModelState, means2d_grad: torch.Tensor,
                            radii: torch.Tensor, width: int = 2,
                            height: int = 2) -> GaussianModelState:
    """Accumulate |dL/dmean2D| of the visible gaussians. The pixel-space
    gradient is scaled by (0.5 W, 0.5 H) to the reference's NDC
    half-viewport units, so densify_grad_threshold 0.0002 selects what it
    selects there (the defaults of 2 make the scale the identity)."""
    visible = radii > 0
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=means2d_grad.dtype,
                         device=means2d_grad.device)
    g = torch.linalg.vector_norm(means2d_grad * scale, dim=-1)
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(visible, g, torch.zeros_like(g)),
        denom=state.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(state.max_radii2d, radii.to(torch.float32)),
    )


def _allocate_slots(active: torch.Tensor, cand_mask: torch.Tensor):
    """Give each candidate a free slot. Returns (slot, ok); a candidate
    without a free slot, and every non-candidate, gets slot C (dropped)."""
    cap = active.shape[0]
    order = torch.argsort(active.to(torch.int8), stable=True)  # free slots first
    num_free = cap - active.sum()
    rank = torch.cumsum(cand_mask.to(torch.int64), 0) - 1
    ok = cand_mask & (rank < num_free)
    slot = order[rank.clamp(0, cap - 1)]
    return torch.where(ok, slot, torch.full_like(slot, cap)), ok


def _scatter_rows(v: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """v with rows slot[i] set to new[i]; slot C drops the row (JAX's
    ``.at[slot].set(new, mode="drop")``)."""
    out = torch.cat([v, v[:1]])  # row C collects the dropped writes
    out[slot] = new
    return out[:-1]


def _scatter_params(params: GaussianParams, slot, new: GaussianParams) -> GaussianParams:
    return GaussianParams(*(_scatter_rows(v, slot, w) for v, w in zip(params, new)))


def densify_and_prune(
    state: GaussianModelState,
    normals: torch.Tensor,
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float = 0.01,
) -> tuple[GaussianModelState, dict]:
    """Clone + split + prune in one pure step. ``normals`` (2, C, 3) are
    standard normal draws: the two split children's offsets in the
    gaussian's own frame (JAX draws them with ``jax.random.normal`` from
    two split keys).

    Screen-size prune semantics match the reference's ACTUAL behavior: no
    prune by screen radius. The reference's ``big_points_vs =
    max_radii2D > max_screen_size`` is dead code, because
    ``densification_postfix`` zeroes ``max_radii2D`` for every point
    before ``densify_and_prune`` reads it; only the world-size term fires
    when ``max_screen_size`` is set. So ``max_screen_size > 0`` enables
    only the world-size prune (max scale > 0.1 * extent), and
    ``max_radii2d`` is still tracked per window and zeroed here.

    Returns (new state, info) with info's counts as 0-d tensors: cloned,
    split, pruned, active, overflow (candidates left without a slot)."""
    p = state.params
    cap = p.xyz.shape[0]
    grads = state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0)
    scaling = get_scaling(p)
    max_scale = scaling.max(dim=-1).values
    high_grad = (grads >= grad_threshold) & state.active

    # clone: small high-grad gaussians copied verbatim into free slots
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    slot, ok = _allocate_slots(state.active, clone_mask)
    params = _scatter_params(p, slot, p)
    active = _scatter_rows(state.active, slot, torch.ones_like(state.active))
    n_cloned = ok.sum()

    # split: large high-grad gaussians -> 2 children with scale / 1.6,
    # positions sampled from the gaussian; child 1 in place, child 2 in a
    # free slot
    split_mask = high_grad & (max_scale > percent_dense * extent)
    rot = tf.quat_to_rotmat(p.rotation)
    off1 = torch.einsum("nij,nj->ni", rot, normals[0] * scaling)
    off2 = torch.einsum("nij,nj->ni", rot, normals[1] * scaling)
    new_scaling = torch.log(scaling / (0.8 * 2.0))
    m3 = split_mask[:, None]
    params = params._replace(
        xyz=torch.where(m3, p.xyz + off1, params.xyz),
        scaling=torch.where(m3, new_scaling, params.scaling))
    child2 = p._replace(xyz=p.xyz + off2, scaling=new_scaling)
    slot2, ok2 = _allocate_slots(active, split_mask)
    params = _scatter_params(params, slot2, child2)
    active = _scatter_rows(active, slot2, torch.ones_like(active))
    n_split = ok2.sum()

    # rows whose Adam moments restart: newly written slots and split originals
    touched = torch.zeros(cap + 1, dtype=torch.bool, device=active.device)
    touched[slot] = True
    touched[slot2] = True
    touched = touched[:cap] | split_mask

    # prune: transparent gaussians, and world-size giants when enabled
    prune = active & (get_opacity(params) < min_opacity)
    if max_screen_size > 0:
        prune = prune | (active & (torch.exp(params.scaling).max(dim=-1).values > 0.1 * extent))
    active = active & ~prune
    touched = touched | prune

    zeros = torch.zeros(cap, dtype=torch.float32, device=active.device)
    new_state = state._replace(
        params=params, active=active, max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(), opt_state=_edit_opt_state_rows(state.opt_state, touched))
    info = {
        "cloned": n_cloned,
        "split": n_split,
        "pruned": prune.sum(),
        "active": active.sum(),
        "overflow": clone_mask.sum() + split_mask.sum() - n_cloned - n_split,
    }
    return new_state, info


def reset_opacity(state: GaussianModelState) -> GaussianModelState:
    """opacity <- min(opacity, logit 0.01), and its Adam moments restart."""
    p = state.params
    cap_logit = inverse_sigmoid(torch.tensor(0.01, dtype=p.opacity.dtype, device=p.opacity.device))
    opt_state = _edit_opt_state_rows(
        state.opt_state, torch.ones(p.xyz.shape[0], dtype=torch.bool, device=p.xyz.device),
        fields={"opacity"})
    return state._replace(params=p._replace(opacity=torch.minimum(p.opacity, cap_logit)),
                          opt_state=opt_state)


# ---------------------------------------------------------------------------
# From the JAX package
# ---------------------------------------------------------------------------


def state_from_jax(jstate, device=None) -> GaussianModelState:
    """Carry a JAX ``GaussianModelState`` (array leaves, numpy or
    array-like) into the port: params, ``active``, the accumulators, the
    SH degree and, where it has one, the optax state of ``make_optimizer``
    (per group: ``inner_states[name].inner_state[0]`` is its Adam state
    with ``count``, ``mu`` and ``nu``). Runs on CUDA unless ``device``
    says otherwise."""
    dev = backend.resolve_device(device)

    def t(x, dtype=torch.float32):
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    opt_state = None
    if jstate.opt_state is not None:
        adam = {name: jstate.opt_state.inner_states[name].inner_state[0]
                for name in GaussianParams._fields}
        counts = {int(np.asarray(a.count)) for a in adam.values()}
        if len(counts) != 1:
            raise ValueError(f"Adam step counts differ between groups: {counts}")
        opt_state = AdamState(
            count=counts.pop(),
            mu=GaussianParams(**{k: t(getattr(a.mu, k)) for k, a in adam.items()}),
            nu=GaussianParams(**{k: t(getattr(a.nu, k)) for k, a in adam.items()}))
    return GaussianModelState(
        params=params_from_jax(jstate.params, device=dev),
        active=t(jstate.active, torch.bool),
        sh_degree=int(np.asarray(jstate.sh_degree)),
        max_radii2d=t(jstate.max_radii2d), xyz_grad_accum=t(jstate.xyz_grad_accum),
        denom=t(jstate.denom), opt_state=opt_state)
