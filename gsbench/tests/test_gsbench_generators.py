"""Each generator repeats for a seed and differs across seeds."""

import numpy as np
import pytest
import torch

from gsbench import eyes, scenes, traffic


def _head(seed):
    return traffic.head_path(np.random.default_rng([seed, 2]), 200, 6.0, 0.3)


def _gaze(seed):
    return traffic.gaze_path(np.random.default_rng([seed, 3]), 200, 20, 40, 0.3, 0.7)


def _eyes(seed):
    rng = np.random.default_rng([seed, 3])
    return np.stack(eyes.eye_images(rng, traffic.gaze_path(rng, 6, 2, 4, 0.3, 0.7), 32, 48, 2))


@pytest.mark.parametrize("make", [_head, _gaze, _eyes])
def test_paths_repeat_and_differ(make):
    a, b, c = make(2 ** 31 + 11), make(2 ** 31 + 11), make(5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_head_path_stays_in_range():
    pose = _head(3)
    assert np.abs(pose).max() <= 6.0 + 1e-9 and np.abs(np.diff(pose, axis=0)).max() < 3.0


def test_gaze_path_fixates():
    g = _gaze(4)
    changes = np.flatnonzero(np.any(np.diff(g, axis=0) != 0, axis=1))
    assert (g >= 0.3).all() and (g <= 0.7).all() and np.diff(changes).min() >= 20


@pytest.mark.parametrize("spec", [
    {"kind": "random_gaussians", "n": 500, "sh_degree": 3, "spread": 2.5,
     "depth_range": [3.0, 7.0], "scale_range": [-4.6, -3.0], "opacity_range": [0.2, 0.95]},
    {"kind": "point_cloud", "n": 500, "sh_degree": 3, "extent": 2.5}])
def test_scenes_repeat_and_differ(spec):
    a = scenes.make_scene(spec, 2 ** 31 + 3, "cpu")
    b = scenes.make_scene(spec, 2 ** 31 + 3, "cpu")
    c = scenes.make_scene(spec, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])
    assert a["f_rest"].shape == (500, 3, 15) and a["opacity"].shape == (500, 1)
