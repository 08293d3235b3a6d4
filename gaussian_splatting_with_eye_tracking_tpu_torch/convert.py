"""COLMAP conversion CLI: ``python -m gaussian_splatting_with_eye_tracking_tpu_torch.convert``.

Port of the root ``convert.py`` (the reference's convert.py:31-122): runs
COLMAP's SfM pipeline (feature extraction, exhaustive matching, mapping,
undistortion) on ``<source>/input`` through the ``colmap`` executable,
moves the sparse model into ``sparse/0``, and with ``--resize`` writes 1/2,
1/4 and 1/8 downscales of ``images/`` with PIL's LANCZOS filter. Exits 1
with an error when ``colmap`` is not on PATH and no
``--colmap_executable`` is given, and with a failing command's code.
``--magick_executable`` is parsed and unused, as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def run(cmd: str):
    print("+", cmd)
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}. Exiting.")
        sys.exit(code)


def main(argv=None):
    parser = ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    parser.add_argument("--magick_executable", default="", type=str)
    args = parser.parse_args(argv)

    colmap = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if shutil.which(colmap.strip('"')) is None and not args.colmap_executable:
        print("ERROR: `colmap` not found on PATH. Install COLMAP or pass "
              "--colmap_executable (reference convert.py requires the same).")
        sys.exit(1)

    if not args.skip_matching:
        os.makedirs(src + "/distorted/sparse", exist_ok=True)
        run(f"{colmap} feature_extractor "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--ImageReader.single_camera 1 "
            f"--ImageReader.camera_model {args.camera} "
            f"--SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher "
            f"--database_path {src}/distorted/database.db "
            f"--SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper "
            f"--database_path {src}/distorted/database.db "
            f"--image_path {src}/input "
            f"--output_path {src}/distorted/sparse "
            f"--Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter "
        f"--image_path {src}/input "
        f"--input_path {src}/distorted/sparse/0 "
        f"--output_path {src} --output_type COLMAP")

    files = os.listdir(src + "/sparse")
    os.makedirs(src + "/sparse/0", exist_ok=True)
    for file in files:
        if file == "0":
            continue
        shutil.move(os.path.join(src, "sparse", file),
                    os.path.join(src, "sparse", "0", file))

    if args.resize:
        print("Copying and resizing...")
        from PIL import Image

        for factor, name in [(2, "images_2"), (4, "images_4"), (8, "images_8")]:
            os.makedirs(os.path.join(src, name), exist_ok=True)
            for f in os.listdir(os.path.join(src, "images")):
                p = os.path.join(src, "images", f)
                with Image.open(p) as im:
                    im.resize((im.width // factor, im.height // factor),
                              Image.LANCZOS).save(os.path.join(src, name, f))
    print("Done.")


if __name__ == "__main__":
    main()
