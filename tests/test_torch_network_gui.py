"""The port's SIBR viewer bridge over a real local socket, on the CPU
(modelled on tests/test_network_gui.py, without its poll counting): a view
request answered with the bytes of ``make_eval_render(device="cpu")``, the
train / keep_alive semantics, a dropped client resetting the connection,
the scaling slider reaching the rasterizer, and ``train.main`` polling a
viewer port nobody connects to."""

import json
import math
import os
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import train, train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.bench_scene import make_camera
from gaussian_splatting_with_eye_tracking_tpu_torch.config import OptimizationConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.config import PipelineConfig
from gaussian_splatting_with_eye_tracking_tpu_torch.models import gaussian_model as gm
from gaussian_splatting_with_eye_tracking_tpu_torch.renderer.network_gui import NetworkGUI
from gaussian_splatting_with_eye_tracking_tpu_torch.renderer.network_gui import image_bytes
from tests.test_scene_io import make_colmap_scene

DEADLINE_S = 120  # the first render on a loaded machine can take seconds
FOV = math.radians(60)  # make_camera's


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class FakeScene:
    max_sh_degree = 0
    model_path = "/models/fake"

    class info:
        ply_path = "x"


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(0)
    st, _ = gm.create_from_points(rng.normal(scale=0.5, size=(40, 3)).astype(np.float32),
                                  rng.uniform(size=(40, 3)).astype(np.float32), 0,
                                  OptimizationConfig(), 1.0, capacity=64, device="cpu")
    return st


def message(width, height, train_flag=False, keep_alive=False, scaling=1.0):
    cam = make_camera(width, height, device="cpu")
    return {"resolution_x": width, "resolution_y": height, "fov_y": FOV, "fov_x": FOV,
            "z_near": 0.01, "z_far": 100.0, "train": train_flag, "shs_python": False,
            "rot_scale_python": False, "keep_alive": keep_alive, "scaling_modifier": scaling,
            "view_matrix": cam.viewmatrix.T.reshape(-1).tolist(),
            "view_projection_matrix": cam.projmatrix.T.reshape(-1).tolist()}


def request(s, msg):
    """Send one message; return (image bytes, source path)."""
    payload = json.dumps(msg).encode()
    s.sendall(struct.pack("I", len(payload)) + payload)
    want, img = msg["resolution_x"] * msg["resolution_y"] * 3, b""
    while len(img) < want:
        part = s.recv(want - len(img))
        assert part
        img += part
    n = struct.unpack("I", s.recv(4))[0]
    return img, s.recv(n).decode()


def expected(state, width, height, scaling=1.0):
    cam = make_camera(width, height, device="cpu")
    render = train_lib.make_eval_render(0, width, height, device="cpu")
    return image_bytes(render(state, *train_lib.camera_arrays(cam), torch.zeros(3), scaling))


def connect(gui):
    """Wait until the viewer's connection is accepted."""
    deadline = time.time() + DEADLINE_S
    while gui.conn is None and time.time() < deadline:
        gui.try_connect()
        time.sleep(0.01)
    assert gui.conn is not None


def serve(gui, state, client, iteration=1, max_iterations=10):
    """Run ``client(port)`` in a thread and poll like the train loop until
    it is done."""
    result = {}

    def run():
        result["out"] = client(gui.listener.getsockname()[1])

    t = threading.Thread(target=run)
    t.start()
    deadline = time.time() + DEADLINE_S
    while t.is_alive() and time.time() < deadline:
        gui.poll(state, FakeScene, PipelineConfig(), iteration, max_iterations)
    t.join(timeout=30)
    assert not t.is_alive()
    return result["out"]


def test_view_request_gets_make_eval_renders_bytes(state):
    gui = NetworkGUI("127.0.0.1", 0)

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            return request(s, message(48, 32, train_flag=True))

    img, source = serve(gui, state, client)
    assert img == expected(state, 48, 32)
    assert source == FakeScene.model_path
    assert len(set(img)) > 1  # not a blank frame


def test_paused_viewer_is_served_within_one_poll_then_released(state):
    """train=False: the poll answers and waits for the next request (three
    sizes), train=True returns; a closed viewer resets the connection."""
    gui = NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    sizes = [(32, 32), (64, 32), (32, 64)]
    imgs = []

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            for w, h in sizes:
                imgs.append(request(s, message(w, h))[0])
            imgs.append(request(s, message(32, 32, train_flag=True))[0])

    t = threading.Thread(target=client)
    t.start()
    connect(gui)
    gui.poll(state, FakeScene, PipelineConfig(), 1, 10)  # serves all four
    t.join(timeout=30)
    assert not t.is_alive() and len(imgs) == 4
    for (w, h), img in zip(sizes, imgs):
        assert img == expected(state, w, h)
    assert gui.conn is not None
    gui.poll(state, FakeScene, PipelineConfig(), 2, 10)  # the viewer has gone
    assert gui.conn is None
    gui.poll(state, FakeScene, PipelineConfig(), 3, 10)  # nobody waiting: returns at once


def test_keep_alive_holds_the_last_iteration(state):
    """After the last iteration a train=True request with keep_alive is
    answered and the same poll goes on serving; one without keep_alive
    ends it."""
    gui = NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    imgs = []

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            imgs.append(request(s, message(32, 32, train_flag=True, keep_alive=True))[0])
            imgs.append(request(s, message(32, 32, train_flag=True))[0])

    t = threading.Thread(target=client)
    t.start()
    connect(gui)
    gui.poll(state, FakeScene, PipelineConfig(), 10, 10)  # serves both
    t.join(timeout=30)
    assert not t.is_alive()
    assert imgs == [expected(state, 32, 32)] * 2


def test_scaling_slider_reaches_the_rasterizer(state):
    gui = NetworkGUI("127.0.0.1", 0)

    def client(port):
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            full = request(s, message(32, 32))[0]
            small = request(s, message(32, 32, train_flag=True, scaling=0.25))[0]
            return full, small

    full, small = serve(gui, state, client)
    assert small == expected(state, 32, 32, 0.25) and small != full


def test_dropped_or_malformed_client_resets_the_connection(state):
    gui = NetworkGUI("127.0.0.1", 0)
    port = gui.listener.getsockname()[1]
    for payload in (struct.pack("I", 100) + b"{", struct.pack("I", 2) + b"{]"):
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        s.sendall(payload)
        if payload.endswith(b"{"):
            s.close()  # gone halfway through its message
        connect(gui)
        gui.poll(state, FakeScene, PipelineConfig(), 1, 10)
        assert gui.conn is None
        s.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_polls_the_viewer_port(tmp_path, monkeypatch, capsys):
    """``train.main`` with ``--port``: the viewer listens there and is
    polled once per iteration while nobody connects; ``--debug`` reaches
    the train step. A port already taken prints "Viewer server disabled"
    and training goes on."""
    root = make_colmap_scene(str(tmp_path / "scene"), n_cams=2, n_pts=40)
    port = _free_port()
    polls, debug = [], []
    orig_poll, orig_step = NetworkGUI.poll, train_lib.make_train_step

    def poll(self, state, scene, pipe, iteration, max_iterations):
        polls.append((self.listener.getsockname(), iteration, max_iterations, pipe.debug))
        return orig_poll(self, state, scene, pipe, iteration, max_iterations)

    def make_train_step(*a, **kw):
        debug.append(kw["debug"])
        return orig_step(*a, **kw)

    monkeypatch.setattr(NetworkGUI, "poll", poll)
    monkeypatch.setattr(train_lib, "make_train_step", make_train_step)
    argv = ["-s", root, "--iterations", "3", "--quiet", "--data_device", "cpu",
            "--ip", "127.0.0.1", "--port", str(port), "--debug"]
    _cli(train.main, argv + ["-m", str(tmp_path / "m1")])
    assert polls == [(("127.0.0.1", port), i, 3, True) for i in (1, 2, 3)]
    assert debug and all(debug)
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        polls.clear()
        out = str(tmp_path / "m2")
        _cli(train.main, [a for a in argv if a not in ("--port", str(port), "--quiet")]
             + ["--port", str(taken.getsockname()[1]), "-m", out])
    assert polls == []
    assert "Viewer server disabled: " in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_3", "point_cloud.ply"))


def _cli(fn, argv):
    """A CLI's main with sys.stdout restored after it (the CLIs timestamp
    or silence it for the rest of the process)."""
    saved = sys.stdout
    try:
        return fn(argv)
    finally:
        sys.stdout = saved
