"""Full evaluation orchestrator: ``python -m gaussian_splatting_with_eye_tracking_tpu_torch.full_eval``.

Port of the root ``full_eval.py`` (the reference's full_eval.py:15-75):
trains, renders and scores the paper's scene sets (MipNeRF360, Tanks &
Temples, Deep Blending) by running the port's ``train``, ``render`` and
``metrics`` CLIs through ``os.system``, one command per scene and stage,
with the JAX package's arguments.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]

PACKAGE = "gaussian_splatting_with_eye_tracking_tpu_torch"


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation script parameters")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", type=str, default="")
    parser.add_argument("--tanksandtemples", "-tat", type=str, default="")
    parser.add_argument("--deepblending", "-db", type=str, default="")
    args = parser.parse_args(argv)

    all_scenes = []
    if args.mipnerf360:
        all_scenes += mipnerf360_outdoor_scenes + mipnerf360_indoor_scenes
    if args.tanksandtemples:
        all_scenes += tanks_and_temples_scenes
    if args.deepblending:
        all_scenes += deep_blending_scenes
    if not all_scenes:
        parser.error("provide at least one of -m360 / -tat / -db dataset roots")

    train, render, metrics = (f"{sys.executable} -m {PACKAGE}.{m}"
                              for m in ("train", "render", "metrics"))

    if not args.skip_training:
        common = " --quiet --eval --test_iterations -1 --disable_viewer"
        for scene in mipnerf360_outdoor_scenes:
            if args.mipnerf360:
                src = os.path.join(args.mipnerf360, scene)
                os.system(f"{train} -s {src} -i images_4 -m {args.output_path}/{scene}{common}")
        for scene in mipnerf360_indoor_scenes:
            if args.mipnerf360:
                src = os.path.join(args.mipnerf360, scene)
                os.system(f"{train} -s {src} -i images_2 -m {args.output_path}/{scene}{common}")
        for scene in tanks_and_temples_scenes:
            if args.tanksandtemples:
                src = os.path.join(args.tanksandtemples, scene)
                os.system(f"{train} -s {src} -m {args.output_path}/{scene}{common}")
        for scene in deep_blending_scenes:
            if args.deepblending:
                src = os.path.join(args.deepblending, scene)
                os.system(f"{train} -s {src} -m {args.output_path}/{scene}{common}")

    if not args.skip_rendering:
        for scene in all_scenes:
            for it in (7000, 30000):
                os.system(
                    f"{render} --iteration {it} -m {args.output_path}/{scene} --quiet --skip_train"
                )

    if not args.skip_metrics:
        scene_paths = " ".join(f"{args.output_path}/{s}" for s in all_scenes)
        os.system(f"{metrics} -m {scene_paths}")


if __name__ == "__main__":
    main()
