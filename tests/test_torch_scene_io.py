"""Scene IO of the port against the JAX package, on the CPU: COLMAP files,
the dataset readers, cameras and the resolution policy, cameras.json,
image files, the configuration's command-line reflection and the Scene
lifecycle.

Tolerances: files, images (both packages read, resize and write them
through PIL) and integer fields exact; camera parameters 1e-6 (both build
them in float64 numpy and cast to float32, so they are in fact equal).
"""

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import pytest
import torch
from PIL import Image

from gaussian_splatting_with_eye_tracking_tpu import config as jconfig
from gaussian_splatting_with_eye_tracking_tpu.scene import colmap as jcm
from gaussian_splatting_with_eye_tracking_tpu.scene import dataset_readers as jdsr
from gaussian_splatting_with_eye_tracking_tpu.utils import camera_utils as jcu
from gaussian_splatting_with_eye_tracking_tpu.utils import image_utils as jimg
from gaussian_splatting_with_eye_tracking_tpu_torch import config as tconfig
from gaussian_splatting_with_eye_tracking_tpu_torch import scene_synth
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as tgm
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import colmap as tcm
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import dataset_readers as tdsr
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.utils import camera_utils as tcu
from gaussian_splatting_with_eye_tracking_tpu_torch.utils import image_utils as timg
from tests.test_scene_io import make_colmap_scene


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several worker processes on one machine: this file's
    CPU plain paths keep to two threads so that they do not crowd the
    other workers out (at 8 threads each, torch's spinning workers
    oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- COLMAP files ---------------------------------------------------------


def _colmap_model(seed=0):
    rng = np.random.default_rng(seed)
    cams = {1: (1, "PINHOLE", 64, 48, np.array([60.0, 61.0, 32.0, 24.0])),
            2: (2, "SIMPLE_PINHOLE", 40, 30, np.array([50.0, 20.0, 15.0]))}
    imgs = {}
    for i in range(1, 5):
        q = rng.normal(size=4)
        imgs[i] = (i, q / np.linalg.norm(q), rng.normal(size=3), 1 + i % 2, f"im_{i}.png")
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3))
    return cams, imgs, xyz, rgb


def _write_binaries(mod, d, cams, imgs, xyz, rgb):
    os.makedirs(d, exist_ok=True)
    mod.write_cameras_binary(os.path.join(d, "cameras.bin"),
                             {k: mod.ColmapCamera(*v) for k, v in cams.items()})
    mod.write_images_binary(os.path.join(d, "images.bin"),
                            {k: mod.ColmapImage(*v) for k, v in imgs.items()})
    mod.write_points3d_binary(os.path.join(d, "points3D.bin"), xyz, rgb)


def _write_text(d, cams, imgs, xyz, rgb):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        for cid, model, w, h, params in cams.values():
            f.write(f"{cid} {model} {w} {h} " + " ".join(repr(float(p)) for p in params) + "\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# Image list\n")
        for iid, q, t, cid, name in imgs.values():
            f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t)) + f" {cid} {name}\n")
            f.write("1.0 2.0 -1\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(f"{i} " + " ".join(repr(float(v)) for v in p) + " "
                    + " ".join(str(int(v)) for v in c) + " 0.5 1 2\n")


def _same_colmap(a, b):
    assert a.keys() == b.keys()
    for k in a:
        for x, y in zip(a[k], b[k]):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


def test_colmap_files_identical_and_read_the_same(tmp_path):
    model = _colmap_model()
    _write_binaries(jcm, str(tmp_path / "jax"), *model)
    _write_binaries(tcm, str(tmp_path / "port"), *model)
    _write_text(str(tmp_path / "text"), *model)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    for kind, ext in (("jax", "binary"), ("port", "binary"), ("text", "text")):
        d = str(tmp_path / kind)
        for what in ("cameras", "images"):
            fn = f"read_{what}_{ext}"
            path = os.path.join(d, f"{what}.{'bin' if ext == 'binary' else 'txt'}")
            _same_colmap(getattr(tcm, fn)(path), getattr(jcm, fn)(path))
        path = os.path.join(d, f"points3D.{'bin' if ext == 'binary' else 'txt'}")
        for got, want in zip(getattr(tcm, f"read_points3d_{ext}")(path),
                             getattr(jcm, f"read_points3d_{ext}")(path)):
            np.testing.assert_array_equal(got, want)
    q = np.array([0.9, 0.1, -0.2, 0.3])
    np.testing.assert_array_equal(tcm.qvec_to_rotmat(q), jcm.qvec_to_rotmat(q))


# --- readers, cameras, cameras.json ----------------------------------------


def _same_infos(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in w._fields:
            a, b = getattr(g, f), getattr(w, f)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, f


def _same_scene_info(got, want):
    _same_infos(got.train_cameras, want.train_cameras)
    assert len(got.test_cameras) == len(want.test_cameras)
    if want.test_cameras:
        _same_infos(got.test_cameras, want.test_cameras)
    assert got.nerf_norm_radius == want.nerf_norm_radius
    np.testing.assert_array_equal(got.nerf_norm_translate, want.nerf_norm_translate)
    np.testing.assert_array_equal(got.points, want.points)
    np.testing.assert_array_equal(got.colors, want.colors)
    assert got.ply_path == want.ply_path


def _blender_scene(root, size=(40, 32)):
    """Three RGBA views (red square, alpha 1 inside, 0.5 on a band, 0
    elsewhere), train and test transforms, written by PIL."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(5)
    for split in ("train", "test"):
        frames = []
        for i in range(3 if split == "train" else 1):
            c2w = np.eye(4)
            c2w[:3, 3] = [0.3 * i, -0.2, 3.0 + i]
            frames.append({"file_path": f"./{split}_{i}", "transform_matrix": c2w.tolist()})
            arr = rng.integers(0, 256, (size[1], size[0], 4)).astype(np.uint8)
            arr[:, :, 3] = 0
            arr[8:24, 8:24, 3] = 255
            arr[2:4, :, 3] = 128
            Image.fromarray(arr).save(os.path.join(root, f"{split}_{i}.png"))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.8, "frames": frames}, f)
    return root


@pytest.mark.parametrize("kind", ["colmap", "colmap_eval", "blender_white", "blender_black"])
def test_readers_match_jax(tmp_path, kind):
    if kind.startswith("colmap"):
        root = make_colmap_scene(str(tmp_path / "scene"), n_cams=9, n_pts=120)
        ev = kind == "colmap_eval"
        want = jdsr.read_colmap_scene(root, eval_split=ev)
        _same_scene_info(tdsr.read_colmap_scene(root, eval_split=ev), want)  # reads the cache
        _same_scene_info(tdsr.detect_and_read_scene(root, eval_split=ev), want)
        assert len(want.test_cameras) == (2 if ev else 0)
        return
    root = _blender_scene(str(tmp_path / "blender"))
    white = kind == "blender_white"
    want = jdsr.read_blender_scene(root, white_background=white)
    os.remove(want.ply_path)  # the port draws its own random points
    _same_scene_info(tdsr.read_blender_scene(root, white_background=white), want)
    _same_scene_info(tdsr.detect_and_read_scene(root, white_background=white), want)
    assert len(want.test_cameras) == 1 and want.points.shape == (100_000, 3)
    for info in want.train_cameras + want.test_cameras:
        cam = tcu.load_cam(info, 1)
        np.testing.assert_array_equal(cam.image, jcu.load_cam(info, 1).image)
        assert cam.image[1, 0, 0] == (1.0 if white else 0.0)


def test_load_cam_resolution_policy(tmp_path, capsys):
    """Sizes under -r -1/1/2/4/8 (-1 scales a 1700 px wide image to 1600
    with a one-time notice), and the resized images equal JAX's."""
    rng = np.random.default_rng(2)
    wide, small = str(tmp_path / "wide.png"), str(tmp_path / "small.png")
    Image.fromarray(rng.integers(0, 256, (24, 1700, 3)).astype(np.uint8)).save(wide)
    Image.fromarray(rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)).save(small)
    info = jdsr.CameraInfo(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=0.9,
                           fovy=0.7, image_path=small, image_name="small", width=64, height=48)
    wide_info = info._replace(image_path=wide, image_name="wide", width=1700, height=24)
    warned = jcu.WARNED[0], tcu._WARNED[0]  # the notice is once per process:
    jcu.WARNED[0], tcu._WARNED[0] = True, False  # count the port's alone
    try:
        for res, inf in ((-1, info), (1, info), (2, info), (4, info), (8, info),
                         (-1, wide_info)):
            want, got = jcu.load_cam(inf, res), tcu.load_cam(inf, res)
            assert (got.width, got.height) == (want.width, want.height), res
            assert got.image.dtype == np.float32
            np.testing.assert_array_equal(got.image, want.image)
        assert (got.width, got.height) == (1600, 22)  # the wide image was resampled
        assert capsys.readouterr().out.count("rescaling to 1.6K") == 1
        tcu.load_cam(wide_info, -1)
        assert "1.6K" not in capsys.readouterr().out
    finally:
        jcu.WARNED[0], tcu._WARNED[0] = warned


def test_cameras_match_jax(tmp_path):
    root = make_colmap_scene(str(tmp_path / "scene"), n_cams=3, n_pts=20)
    infos = jdsr.read_colmap_scene(root).train_cameras
    for i, info in enumerate(infos):
        want, got = jcu.load_cam(info, 1), tcu.load_cam(info, 1)
        assert tcu.camera_to_json(i, got) == jcu.camera_to_json(i, want)
        wp, gp = want.params(), got.params(device="cpu")
        for name in ("viewmatrix", "projmatrix", "campos"):
            np.testing.assert_allclose(getattr(gp, name).numpy(), np.asarray(getattr(wp, name)),
                                       atol=1e-6, rtol=0)
        for name in ("tan_fovx", "tan_fovy", "width", "height"):
            assert getattr(gp, name) == pytest.approx(getattr(wp, name), abs=1e-6), name
        gt = got.gt(device="cpu")
        assert gt.dtype == torch.float32 and gt.shape == (3, 48, 64)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(want.gt()))


# --- image files -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "jpeg"])
def test_image_files_read_as_jax_reads_them(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    ch = {"L": 1, "RGB": 3, "RGBA": 4, "jpeg": 3}[kind]
    arr = rng.integers(0, 256, (23, 17, ch)).astype(np.uint8)
    arr[5:9] = arr[4]  # smooth rows as well as noise
    path = str(tmp_path / ("x.jpg" if kind == "jpeg" else "x.png"))
    Image.fromarray(arr[:, :, 0] if ch == 1 else arr).save(path)
    np.testing.assert_array_equal(timg.load_image_chw(path), jimg.load_image_chw(path))
    for bg in (None, 0.0, 1.0):
        got, want = tcu.load_image(path, bg), jcu.load_image(path, bg)
        assert got.shape == (3, 23, 17) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert timg.image_size(path) == (17, 23)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.1, 1.1)])
def test_save_image_writes_what_jax_writes(tmp_path, lo, hi):
    img = np.random.default_rng(1).uniform(lo, hi, (3, 20, 30)).astype(np.float32)
    timg.save_image(img, str(tmp_path / "port.png"))
    jimg.save_image(img, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(timg.load_image_chw(str(tmp_path / "port.png")),
                                  np.round(np.clip(img, 0, 1) * 255) / np.float32(255))
    a, b = img[:, :5], np.clip(img[:, 5:10], 0, 1)
    assert timg.mse_np(a, b) == jimg.mse_np(a, b) and timg.psnr_np(a, b) == jimg.psnr_np(a, b)


def test_image_files_without_pil_name_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "x.png")
    Image.fromarray(np.zeros((4, 6, 3), np.uint8)).save(path)
    monkeypatch.setitem(sys.modules, "PIL", None)  # as on a machine without Pillow
    for call in (lambda: timg.load_image_chw(path), lambda: timg.image_size(path),
                 lambda: tcu.load_image(path), lambda: timg.save_image(np.zeros((3, 2, 2)), path)):
        with pytest.raises(RuntimeError, match="x.png.*PIL"):
            call()
    with pytest.raises(RuntimeError, match="resize_image.*PIL"):
        tcu.resize_image(np.zeros((3, 4, 6), np.float32), (3, 2))


# --- configuration ---------------------------------------------------------


def _parsers(sentinel):
    out = []
    for mod in (jconfig, tconfig):
        p = ArgumentParser()
        mod.add_config_args(p, mod.ModelConfig(), "model", sentinel=sentinel)
        mod.add_config_args(p, mod.OptimizationConfig(), "opt")
        out.append((mod, p))
    return out


def test_configs_parse_the_same(tmp_path):
    argv = ["-s", "scene", "-m", str(tmp_path), "-r", "2", "-w", "--eval", "--iterations",
            "123", "--position_lr_init", "0.001", "--capacity", "4096"]
    got = []
    for mod, p in _parsers(False):
        args = p.parse_args(argv)
        got.append([mod.extract_config(args, c) for c in (mod.ModelConfig, mod.OptimizationConfig)])
    (jm, jo), (tm, to) = got
    assert tm.data_device == "cuda" and jm.data_device == "tpu"
    assert vars(tm) == {**vars(jm), "data_device": "cuda"}
    assert vars(to) == vars(jo)
    assert tm.source_path == os.path.abspath("scene") and tm.resolution == 2

    tconfig.save_cfg_args(str(tmp_path), tm)
    overlay = ["-m", str(tmp_path), "-r", "4", "--data_device", "cpu"]
    (_, jpar), (_, tpar) = _parsers(True)
    jargs = jconfig.get_combined_args(jpar, overlay)
    targs = tconfig.get_combined_args(tpar, overlay)
    assert vars(targs) == vars(jargs)
    assert targs.resolution == 4 and targs.white_background and targs.data_device == "cpu"
    assert targs.source_path == os.path.abspath("scene")


# --- the Scene -------------------------------------------------------------


def test_scene_synth_matches_jax(tmp_path):
    """train_regression_r04's synthetic scene at 3 cameras of 64x64: the
    COLMAP files byte for byte, the ground-truth renders to the level."""
    import train_regression_r04

    jroot = train_regression_r04.synthesize_dataset(str(tmp_path / "jax"), n_cams=3, width=64,
                                                    height=64)
    troot = scene_synth.synthesize_dataset(str(tmp_path / "port"), n_cams=3, width=64,
                                           height=64, device="cpu")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        rel = os.path.join("sparse", "0", name)
        with open(os.path.join(jroot, rel), "rb") as a, open(os.path.join(troot, rel), "rb") as b:
            assert a.read() == b.read(), name
    names = sorted(os.listdir(os.path.join(jroot, "images")))
    assert names == ["img_000.png", "img_001.png", "img_002.png"]
    assert names == sorted(os.listdir(os.path.join(troot, "images")))
    for name in names:
        want, got = (np.asarray(Image.open(os.path.join(r, "images", name))).astype(int)
                     for r in (jroot, troot))
        assert np.abs(got - want).max() <= 1 and (got != want).mean() <= 1e-3, name
        assert want.std() > 10  # the mixture is in view


def test_scene_lifecycle(tmp_path):
    root = make_colmap_scene(str(tmp_path / "scene"))
    model = str(tmp_path / "model")
    cfg = tconfig.ModelConfig(source_path=root, model_path=model, resolution=1, eval=True,
                              data_device="cpu")
    scene = Scene(cfg, tconfig.OptimizationConfig())
    assert len(scene.get_train_cameras()) == 5 and len(scene.get_test_cameras()) == 1
    assert scene.cameras_extent == jdsr.read_colmap_scene(root, eval_split=True).nerf_norm_radius
    assert scene.get_train_cameras()[0].image.shape == (3, 48, 64)
    with open(os.path.join(model, "cameras.json")) as f:
        assert len(json.load(f)) == 6
    assert os.path.exists(os.path.join(model, "input.ply"))
    st = scene.gaussians
    assert int(tgm.num_active(st)) == 500 and st.params.xyz.shape[0] == 4096
    scene.save(7)
    scene2 = Scene(cfg, tconfig.OptimizationConfig(), load_iteration=-1)
    assert scene2.loaded_iter == 7 and scene2.max_sh_degree == 3
    s2 = scene2.gaussians
    assert int(tgm.num_active(s2)) == 500 and s2.params.xyz.shape[0] == 1024  # next_pow2(2n)
    assert s2.sh_degree == 3 and s2.opt_state.count == 0
    for name in tgm.GaussianParams._fields:
        assert torch.equal(getattr(s2.params, name)[:500], getattr(st.params, name)[:500])
    order = [c.image_name for c in Scene(cfg, shuffle=True, seed=0).get_train_cameras()]
    assert order != sorted(order) and sorted(order) == [f"img_{i:03d}" for i in range(1, 6)]
