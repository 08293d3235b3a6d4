"""Non-blocking TCP bridge to the SIBR remote viewer.

Port of ``gaussian_splatting_with_eye_tracking_tpu/renderer/network_gui.py``
(the reference's ``gaussian_renderer/network_gui.py``). The viewer connects
to ``<host>:<port>`` and sends a 4-byte little-endian length and a JSON
message describing the view it wants (resolution, fields of view, view
and projection matrices, the train and keep-alive toggles, the scaling
slider); it gets back the frame as raw RGB bytes (height x width x 3,
uint8), then a 4-byte length and the model's source path. The trainer
polls once per iteration.

As in JAX, a failed read (the viewer gone, a malformed message) or a
failed send drops the connection and training goes on. A failure of the
render itself is not a connection failure: it raises.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import MiniCam


def image_bytes(img: torch.Tensor) -> bytes:
    """(3, H, W) float colour -> the viewer's H x W x 3 uint8 bytes:
    clipped to [0, 1], scaled by 255 and truncated, as JAX sends it."""
    return (torch.clamp(img, 0, 1).permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy().tobytes()


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self):
        """Accept a waiting viewer, if there is one; never blocks."""
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except OSError:
            pass

    def _read_exact(self, n: int) -> bytes:
        """``n`` bytes from the viewer (recv may return fewer); a closed
        connection raises ConnectionError."""
        data = b""
        while len(data) < n:
            part = self.conn.recv(n - len(data))
            if not part:
                raise ConnectionError("viewer disconnected")
            data += part
        return data

    def _read(self) -> dict:
        msg_len = struct.unpack("I", self._read_exact(4))[0]
        return json.loads(self._read_exact(msg_len).decode("utf-8"))

    def receive(self):
        """(MiniCam of the requested view, or None for a zero resolution;
        the message)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, msg
        view = np.reshape(np.array(msg["view_matrix"]), (4, 4)).T
        full_proj = np.reshape(np.array(msg["view_projection_matrix"]), (4, 4)).T
        cam = MiniCam(width, height, msg["fov_y"], msg["fov_x"], msg["z_near"], msg["z_far"],
                      view, full_proj)
        return cam, msg

    def send(self, image: Optional[bytes], source_path: str):
        if image is not None:
            self.conn.sendall(image)
        self.conn.sendall(len(source_path).to_bytes(4, "little"))
        self.conn.sendall(source_path.encode())

    def poll(self, state, scene, pipe, iteration: int, max_iterations: int):
        """One poll of the training loop: connect a waiting viewer, then
        serve its requests. A request with ``train`` false (a paused
        viewer) is answered and the next one awaited in this same poll;
        with ``train`` true the poll returns, except after the last
        iteration while the viewer asks for ``keep_alive``. Frames render
        through ``train_lib.make_eval_render`` on the state's device at the
        slider's scaling modifier (``pipe.debug`` passes to the
        rasterizer)."""
        from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib

        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, msg = self.receive()
            except (OSError, ValueError, KeyError, TypeError, struct.error):
                self.conn = None
                break
            image = None
            if cam is not None:
                dev = state.params.xyz.device
                render = train_lib.make_eval_render(
                    scene.max_sh_degree, cam.width, cam.height, device=dev,
                    debug=bool(pipe is not None and pipe.debug))
                img = render(state, *train_lib.camera_arrays(cam.params(dev)),
                             torch.zeros(3, device=dev), float(msg.get("scaling_modifier", 1.0)))
                image = image_bytes(img)
            try:
                self.send(image, scene.info.ply_path and scene.model_path or "")
            except OSError:
                self.conn = None
                break
            keep_alive = bool(msg.get("keep_alive", False))
            if msg.get("train", True) and (iteration < max_iterations or not keep_alive):
                break
