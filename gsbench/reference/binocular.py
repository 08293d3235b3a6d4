"""Plain reference of a head-mounted display's binocular frame, importing
nothing of the system: for each eye in turn, its eye image through the
reference eye tracker (``ritnet.gaze``: preprocessing, DenseNet2D, the
class map, the pupil centroid) and its gaze-driven foveated frame
(``render.render_foveated``) on that eye's own camera, from the model's
activations. In float32 with TF32 off (``dtype`` runs it in another
precision: the lower-precision control).
"""

from __future__ import annotations

import torch

from gsbench.reference import render, ritnet


def frame(raw: dict, cams, eyes_u8, weights: dict, bg: torch.Tensor, rings, decimation,
          device, dtype=torch.float32, count_work: bool = False) -> list:
    """[(gaze uv as numpy (x, y), class map (H', W'), ``render.Frame``)]
    per eye: ``cams`` one ``render.Camera`` per eye, ``eyes_u8`` one uint8
    (H, W) eye image per eye."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    activations = render.activate(raw, dtype)
    out = []
    for cam, eye in zip(cams, eyes_u8):
        uv, cls = ritnet.gaze(eye, weights, device, dtype)
        prep = render.preprocess(*activations, cam)
        out.append((uv, cls, render.render_foveated(prep, cam, bg, _gaze_xy(uv, cam), rings,
                                                    decimation, count_work=count_work)))
    return out


def levels(frame: render.Frame, cam, uv, rings) -> torch.Tensor:
    """(T,) level 1..4 of each tile of an eye's ``frame``, as
    ``render.render_foveated`` assigned them: its tiles' counts' percentile
    levels under the rings around the gaze ``uv``."""
    counts = frame.lists.counts
    dev = counts.device
    gx, gy = -(-cam.width // render.TILE), -(-cam.height // render.TILE)
    return render.gaze_override(render.percentile_levels(counts), gx, gy,
                                _gaze_xy(uv, cam).to(dev),
                                torch.as_tensor(rings, dtype=torch.float32, device=dev))


def _gaze_xy(uv, cam) -> torch.Tensor:
    """The gaze in the eye view's pixels."""
    return torch.tensor([uv[0] * cam.width, uv[1] * cam.height], dtype=torch.float32)
