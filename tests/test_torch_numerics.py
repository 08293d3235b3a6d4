"""The numerics suite's fixture and checks (``…_torch/numerics.py``) and
the reader of the JAX package's checkpoints
(``checkpoint.load_jax_checkpoint``), on the CPU against the JAX package.

The collapse state ``judge_repro/chkpnt3176.ckpt`` reads bit for bit as
JAX's ``load_checkpoint`` followed by ``state_from_jax``, also in a
process where JAX and optax cannot be imported; a pickle naming any other
global is refused. Both packages read one scene (the JAX package's
``train_regression_r04.synthesize_dataset``, written once per module) and
take iteration 3177's step from that state: the port's plain route
against JAX's ``impl="jnp"`` step at the tolerances of
``tests/test_torch_train.py``'s train-step test (loss rtol 1e-5, image
atol 3e-4 / rtol 1e-3, moments 1e-4 of each field's largest value,
parameters within 1 % of a learning-rate step where the gradient is clear
of rounding). SSIM maps, port's and JAX's, each against float64 SSIM of
the same images: on the dark, flat frames within 1e-5 a pixel (the
repo's SSIM-map tolerance; measured 3.2e-7 and 3.3e-7), and port against
JAX within 1e-5 too (4.2e-7); on the collapse frame, where the
cancellation blur(x*x) - mu^2 leaves each float32 map 5.4e-5 (port) and
5.1e-5 (JAX) off float64 on its darkest pixels, each within 1e-4 of
float64, so the two float32 maps are held through float64 rather than
against each other (6.1e-5 apart); the mean SSIM within 1e-6 of float64
on both frames (measured <= 9.5e-9). The gradients at post-reset opacity and near-degenerate scales:
the port's plain route against JAX's jnp route, each field within 1e-3
of its largest value (the bound the card test holds the kernels to).
K4's plain table route against float64 prefix sums at the JAX suite's
shapes, at its tolerance. ``numerics``' own checks, as the card runs
them: the plain route's step against the port's jnp oracle, the two
reduction routes on one set of gradient records (equal on the CPU), and
the per-pixel SSIM check failing on purpose when the blur is rounded to
bf16.
"""

import os
import pickle
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu import train_lib as jtrain
from gaussian_splatting_with_eye_tracking_tpu.config import ModelConfig as JModelConfig
from gaussian_splatting_with_eye_tracking_tpu.config import OptimizationConfig as JOpt
from gaussian_splatting_with_eye_tracking_tpu.models import checkpoint as jckpt
from gaussian_splatting_with_eye_tracking_tpu.ops import rasterize as jrast
from gaussian_splatting_with_eye_tracking_tpu.ops import ssim as jssim
from gaussian_splatting_with_eye_tracking_tpu.ops.projection import CameraParams as JCameraParams
from gaussian_splatting_with_eye_tracking_tpu.scene import Scene as JScene
from gaussian_splatting_with_eye_tracking_tpu_torch import numerics as nm
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint as tckpt
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import segsum
from gaussian_splatting_with_eye_tracking_tpu_torch.ops import ssim as tssim
from tests.torch_helpers import assert_close, assert_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = tgm.GaussianParams._fields


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """torch on two threads, so that the module does not crowd out the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def collapse(tmp_path_factory):
    """Iteration 3177 in both packages from the committed state, on one
    scene: the JAX package's jnp step and the port's steps (its plain
    route and its jnp oracle)."""
    from train_regression_r04 import synthesize_dataset

    tmp = tmp_path_factory.mktemp("numerics")
    root = synthesize_dataset(str(tmp / "scene"))
    state, cam, scene = nm.collapse_fixture(root, device="cpu")
    jscene = JScene(JModelConfig(source_path=root, model_path=str(tmp / "jax_model"), eval=True),
                    JOpt(), seed=0)
    jcams = jscene.get_train_cameras()
    jcam = jcams[nm.camera_index(len(jcams))]
    jstate, it = jckpt.load_checkpoint(nm.CHECKPOINT)
    jstep = jtrain.make_train_step(
        jscene.tx, JOpt(), max_sh_degree=jscene.max_sh_degree, width=jcam.width,
        height=jcam.height, impl="jnp", max_instances=nm.CAPACITY, max_live=nm.CAPACITY)
    jnew, jaux = jstep(jstate, *jtrain.camera_arrays(jcam.params()), jcam.gt(), jnp.zeros(3),
                       True)
    runs = nm.collapse_steps(state, cam, scene)
    new, aux = runs["kernels"]
    return dict(state=state, cam=cam, scene=scene, jstate=jstate, jcam=jcam, jit=it,
                jnew=jnew, jaux=jaux, runs=runs, new=new, aux=aux)


def _fields_of(state):
    """Every tensor of a port state by name, and its Adam count."""
    out = {"active": state.active, "max_radii2d": state.max_radii2d,
           "xyz_grad_accum": state.xyz_grad_accum, "denom": state.denom}
    for name in FIELDS:
        out[f"params.{name}"] = getattr(state.params, name)
        out[f"mu.{name}"] = getattr(state.opt_state.mu, name)
        out[f"nu.{name}"] = getattr(state.opt_state.nu, name)
    return out, state.opt_state.count, state.sh_degree


def test_load_jax_checkpoint_equals_jax_load():
    got, it = tckpt.load_jax_checkpoint(nm.CHECKPOINT, device="cpu")
    jstate, jit = jckpt.load_checkpoint(nm.CHECKPOINT)
    want = tgm.state_from_jax(jstate, device="cpu")
    assert it == jit == 3176
    (a, count, deg), (b, jcount, jdeg) = _fields_of(got), _fields_of(want)
    assert (count, deg) == (jcount, jdeg) == (3176, 3)
    assert int(got.active.sum()) == 2175 and got.active.shape == (8192,)
    for name in a:
        assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name]), name


def test_load_jax_checkpoint_without_jax_or_optax():
    """In a process where importing JAX, optax or the JAX package raises,
    the reader gives the same state (its SHA-256) and imports none."""
    code = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "optax", "gaussian_splatting_with_eye_tracking_tpu")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} may not be imported here")
sys.meta_path.insert(0, Refuse())
for name in ("jax", "optax"):
    try:
        __import__(name)
    except ImportError:
        pass
    else:
        raise SystemExit(f"{name} imported")
from gaussian_splatting_with_eye_tracking_tpu_torch.models import checkpoint
state, it = checkpoint.load_jax_checkpoint(sys.argv[1], device="cpu")
print(it, checkpoint._digest(checkpoint.state_to_dict(state)))
print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
"""
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run([sys.executable, "-c", code, nm.CHECKPOINT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    lines = run.stdout.split("\n")
    want = tgm.state_from_jax(jckpt.load_checkpoint(nm.CHECKPOINT)[0], device="cpu")
    assert lines[0] == f"3176 {tckpt._digest(tckpt.state_to_dict(want))}"
    assert lines[1] == "[]"


@pytest.mark.parametrize("module,name", [
    ("os", "system"), ("builtins", "eval"), ("numpy", "load"),
    ("gaussian_splatting_with_eye_tracking_tpu.models.gaussian_model", "init_training"),
    ("optax._src.base", "GradientTransformation"),
])
def test_jax_checkpoint_refuses_other_globals(tmp_path, module, name):
    path = tmp_path / "evil.ckpt"
    path.write_bytes(f"c{module}\n{name}\n(S'true'\ntR.".encode())
    with pytest.raises(pickle.UnpicklingError, match=re.escape(f"{module}.{name}")):
        tckpt.load_jax_checkpoint(str(path), device="cpu")


@pytest.mark.parametrize("module", ["numpy._core.multiarray", "numpy.core.multiarray"])
def test_jax_checkpoint_reads_either_numpy_path(tmp_path, module):
    """numpy 2 writes ``_reconstruct`` under ``numpy._core``, numpy 1
    under ``numpy.core``: a checkpoint of either reads."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    data = pickle.dumps({"version": 1, "iteration": 7, "state": a}, protocol=3)
    here = b"\n_reconstruct\n"
    written = re.search(rb"c(numpy\.[_a-z.]*multiarray)" + re.escape(here), data).group(1)
    path = tmp_path / "arr.ckpt"
    path.write_bytes(data.replace(b"c" + written + here, b"c" + module.encode() + here))
    with open(path, "rb") as f:
        payload = tckpt.JaxCheckpointUnpickler(f).load()
    np.testing.assert_array_equal(payload["state"], a)
    assert payload["state"].dtype == np.float32


def test_camera_replay_picks_img_015(collapse):
    assert nm.camera_index(21) == 19
    assert collapse["cam"].image_name == collapse["jcam"].image_name == "img_015"
    np.testing.assert_array_equal(collapse["cam"].gt("cpu").numpy(),
                                  np.asarray(collapse["jcam"].gt()))


def test_step_3177_matches_jax(collapse):
    ta, ja = collapse["aux"], collapse["jaux"]
    ts, js = collapse["new"], tgm.state_from_jax(collapse["jnew"], device="cpu")
    js0 = tgm.state_from_jax(collapse["jstate"], device="cpu")
    assert np.isfinite(float(ta.loss))
    for name in ("loss", "l1", "psnr"):
        assert_close(getattr(ta, name), getattr(ja, name), atol=0, rtol=1e-5, msg=name)
    for name in ("num_instances", "num_enumerated", "overflow"):
        assert_equal(getattr(ta, name), getattr(ja, name), msg=name)
    assert int(ta.num_instances) > 0 and not bool(ta.overflow)
    assert_close(ta.image, ja.image, atol=3e-4, rtol=1e-3)
    assert_equal(ts.active, js.active)
    assert ts.opt_state.count == js.opt_state.count == 3177
    assert_equal(ts.denom, js.denom)
    assert_equal(ts.max_radii2d, js.max_radii2d)
    assert_close(ts.xyz_grad_accum, js.xyz_grad_accum,
                 atol=1e-4 * float(js.xyz_grad_accum.abs().max()), rtol=5e-3)
    tx = collapse["scene"].tx
    for name in FIELDS:
        mu, nu = getattr(ts.opt_state.mu, name), getattr(ts.opt_state.nu, name)
        jmu, jnu = getattr(js.opt_state.mu, name), getattr(js.opt_state.nu, name)
        assert_close(mu, jmu, atol=1e-4 * float(jmu.abs().max()), rtol=5e-3, msg=name)
        assert_close(nu, jnu, atol=1e-4 * float(jnu.abs().max()), rtol=1e-2, msg=name)
        # the step's gradient from JAX's moments: g = (mu_t - 0.9 mu_{t-1}) / 0.1
        g = (jmu - 0.9 * getattr(js0.opt_state.mu, name)) / 0.1
        sure = (g.abs() > 1e-6 * g.abs().max()) & ts.active.reshape(-1, *[1] * (g.dim() - 1))
        assert sure.any(), name
        p, jp = getattr(ts.params, name), getattr(js.params, name)
        assert_close(p[sure], jp[sure], atol=0.01 * tx.lr(name, 3176), rtol=1e-5, msg=name)
        assert torch.isfinite(p[ts.active]).all(), name


def _hold_ssim(img: np.ndarray, gt: np.ndarray, pixel_atol: float):
    """The port's and JAX's float32 SSIM maps of (N, C, H, W) images, each
    within ``pixel_atol`` of the port's float64 map, their means within
    1e-6 of its mean; returns (port, JAX) maps."""
    t = tssim.ssim_map(torch.from_numpy(img), torch.from_numpy(gt))
    j = np.asarray(jssim.ssim_map(jnp.asarray(img), jnp.asarray(gt)))
    t64 = tssim.ssim_map(torch.from_numpy(img).double(), torch.from_numpy(gt).double()).numpy()
    assert torch.isfinite(t).all() and float(t.abs().max()) <= nm.SSIM_BOUND
    for name, m in (("port", t.numpy()), ("jax", j)):
        np.testing.assert_allclose(m, t64, atol=pixel_atol, err_msg=name)
        assert abs(m.astype(np.float64).mean() - t64.mean()) <= 1e-6, name
    return t, j


def test_ssim_on_collapse_frame_matches_jax_and_float64(collapse):
    img = torch.clamp(collapse["aux"].image, 0.0, 1.0)[None].numpy()
    _hold_ssim(img, collapse["cam"].gt("cpu")[None].numpy(), 1e-4)


def test_ssim_dark_flat_frames_match_jax_and_float64():
    img, gt = (t.numpy() for t in nm.dark_flat_frames("cpu"))
    t, j = _hold_ssim(img, gt, 1e-5)
    assert_close(t, j, atol=1e-5)


@pytest.fixture(scope="module")
def jax_l1_grads():
    """JAX's jnp-route gradients of mean |color - target| with respect to
    the means, scales and opacities on the gradient cases' camera, jitted
    once."""
    _, c, _ = nm.degenerate_inputs(0.5, None, "cpu")
    cam = JCameraParams(
        viewmatrix=jnp.asarray(c.viewmatrix.numpy()), projmatrix=jnp.asarray(c.projmatrix.numpy()),
        campos=jnp.asarray(c.campos.numpy()), tan_fovx=c.tan_fovx, tan_fovy=c.tan_fovy,
        width=c.width, height=c.height)

    def loss(m, s, o, quats, sh, target):
        out = jrast.rasterize(m, s, quats, o, sh, cam, jnp.zeros(3), sh_degree=1, impl="jnp",
                              max_instances=nm.GRAD_CAPACITY, max_live=nm.GRAD_CAPACITY)
        return jnp.mean(jnp.abs(out.color - target))

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))


@pytest.mark.parametrize("opacity,scale", nm.DEGENERATE)
def test_degenerate_gradients_match_jax(jax_l1_grads, opacity, scale):
    (means, scales, quats, op, sh), _, target = nm.degenerate_inputs(opacity, scale, "cpu")
    got = nm.degenerate_grads(opacity, scale, device="cpu")
    want = jax_l1_grads(*(jnp.asarray(t.numpy()) for t in (means, scales, op, quats, sh, target)))
    for name, a, b in zip(("means", "scales", "opacity"), got, want):
        b = np.asarray(b)
        assert np.isfinite(a.numpy()).all() and np.abs(b).max() > 0, name
        assert_close(a, b, atol=1e-3 * np.abs(b).max(), msg=name)


def test_cull_terms_at_the_degenerate_distributions():
    """Post-reset opacity brings the cull's tau down to ln(0.01 * 255) +
    1e-4; scale 5e-7 leaves every conic at the 0.3 px low-pass (kappa 1,
    radius <= 3 px), inside the cull, not past its kappa > 1e5 switch."""
    for opacity, scale in nm.DEGENERATE:
        t = nm.cull_terms(opacity, scale, "cpu")
        assert t["visible"] == 512
        assert t["tau"] == pytest.approx(np.log(opacity * 255) + 1e-4, abs=1e-6)
        if scale is not None:
            assert t["kappa_max"] == pytest.approx(1.0, abs=1e-5) and t["radius_max"] <= 3


@pytest.mark.parametrize("s,n,seed", nm.SEGSUM_CASES)
def test_segment_sum_bounds_plain_matches_float64(s, n, seed):
    table, bounds = nm.segsum_case(s, n, seed)
    out = segsum.segment_sum_bounds_plain(torch.from_numpy(table), torch.from_numpy(bounds))
    want, row_abs = nm.segsum_oracle(table, bounds)
    assert out.shape == (nm.SEGSUM_ROWS, n)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5 * row_abs.max(), rtol=1e-5)
    assert nm.segsum_error(out.numpy(), table, bounds) <= 1e-5


def test_table_route_equals_gather_route_on_the_cpu():
    """On the CPU both reductions are float64 prefix sums of the same
    slots: the sums of one set of gradient records agree exactly."""
    r = nm.route_check("cpu")
    assert r["gaussians"] == 1500 and not r["failed"], r
    assert set(r["err"].values()) == {0.0}, r


def test_step_check_holds_the_plain_route_to_the_oracle(collapse):
    """``numerics.step_check`` and ``ssim_check``, as the card runs them,
    pass on the CPU's plain route against the port's jnp oracle."""
    r = nm.step_check(collapse["state"], collapse["runs"], collapse["scene"].tx)
    assert not r["failed"], r
    assert set(r["exact"].values()) == {True} and max(r["excess"].values()) <= 1.0
    frame = torch.clamp(collapse["aux"].image, 0.0, 1.0)[None]
    s = nm.ssim_check(frame, collapse["cam"].gt("cpu")[None])
    assert not s["failed"], s


def test_ssim_check_sees_a_reduced_precision_blur(collapse, monkeypatch):
    """The fault the SSIM checks guard, made on purpose: float32 blurs
    rounded to bf16 (the JAX run's collapse) fail the per-pixel check on
    the collapse frame."""
    blur = tssim._blur

    def bf16_blur(x, window):
        out = blur(x, window)
        return out.bfloat16().float() if out.dtype == torch.float32 else out

    monkeypatch.setattr(tssim, "_blur", bf16_blur)
    frame = torch.clamp(collapse["aux"].image, 0.0, 1.0)[None]
    r = nm.ssim_check(frame, collapse["cam"].gt("cpu")[None])
    assert "pixel_f64" in r["failed"], r


def test_numerics_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The reader and the repro run on the card unless told otherwise,
    and write nothing before they refuse."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.load_jax_checkpoint(nm.CHECKPOINT)
    with pytest.raises(RuntimeError, match="CUDA"):
        nm.main(["--scene", str(tmp_path / "scene")])
    with pytest.raises(RuntimeError, match="CUDA"):
        nm.collapse_fixture(str(tmp_path / "scene"))
    assert not os.listdir(tmp_path)
