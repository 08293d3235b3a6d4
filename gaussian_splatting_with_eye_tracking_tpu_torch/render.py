"""Batch render CLI: the train and test views of a trained model.

Port of ``render_set``, ``render_sets`` and ``main`` from the repository's
root ``render.py`` (the reference's ``render.py``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.render -m <model> \
        [--iteration N] [--skip_train] [--skip_test] [--data_device cpu]

writes ``<model>/{train,test}/ours_<N>/{renders,gt}/NNNNN.png``. The
command line is overlaid on the model directory's ``cfg_args`` (source
path, resolution, background, device). It runs on the card unless the
device is ``cpu``, and raises without one. Views render at an instance
capacity of 2^17 (the trainer's capacity grid) or, once one overflows
it, at the smallest power of two that held it.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import train_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.config import (
    ModelConfig,
    add_config_args,
    extract_config,
    get_combined_args,
)
from gaussian_splatting_with_eye_tracking_tpu_torch.scene import Scene
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.general_utils import safe_state
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_image

RENDER_CAPACITY = 1 << 17  # starting instance capacity; grown past an overflow


def render_set(model_path, name, iteration, views, scene, state, bg):
    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    cap = RENDER_CAPACITY
    for idx, view in enumerate(views):
        img, cap = train_lib.render_view(state, view.params(scene.device), bg,
                                         scene.max_sh_degree, cap)
        save_image(torch.clamp(img, 0, 1).cpu().numpy(),
                   os.path.join(render_path, f"{idx:05d}.png"))
        save_image(view.image, os.path.join(gts_path, f"{idx:05d}.png"))


def render_sets(cfg: ModelConfig, iteration, skip_train=False, skip_test=False):
    scene = Scene(cfg, load_iteration=iteration, shuffle=False)
    state = scene.gaussians
    bg = torch.tensor([1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
                      device=scene.device)
    if not skip_train:
        render_set(cfg.model_path, "train", scene.loaded_iter, scene.get_train_cameras(),
                   scene, state, bg)
    if not skip_test:
        render_set(cfg.model_path, "test", scene.loaded_iter, scene.get_test_cameras(),
                   scene, state, bg)
    return scene


def main(argv=None):
    parser = ArgumentParser(description="Testing script parameters")
    add_config_args(parser, ModelConfig(), "Model Parameters", sentinel=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    args = get_combined_args(parser, argv)
    print("Rendering " + args.model_path)
    safe_state(args.quiet)
    return render_sets(extract_config(args, ModelConfig), args.iteration,
                       args.skip_train, args.skip_test)


if __name__ == "__main__":
    main()
