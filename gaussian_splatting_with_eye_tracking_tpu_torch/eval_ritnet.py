"""RITnet batch inference CLI: ``python -m gaussian_splatting_with_eye_tracking_tpu_torch.eval_ritnet``.

Port of the root ``eval_ritnet.py`` (the reference's RITnet/predict.py and
test.py:57-77): segments every eye image of ``--images`` (cropped to
multiples of 16), writes ``<name>_label.npy`` (int32 class map) and
``<name>_mask.png`` (class / 3 as gray) into ``--out_dir``, and prints the
mean IoU over the images that have a ground-truth ``<name>.npy`` in
``--labels``. ``--weights``: an ``.npz`` of checkpoint-named arrays (either
package's), a torch ``.pkl`` state dict (the reference's checkpoint), or
by default the vendored weights. Runs on CUDA unless ``--data_device cpu``.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import backend
from gaussian_splatting_with_eye_tracking_tpu_torch.models import ritnet, ritnet_train
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import (
    pil_image,
    save_image,
)


def main(argv=None):
    """Parse ``argv``, segment each image and write its outputs."""
    parser = ArgumentParser()
    parser.add_argument("--images", required=True, type=str)
    parser.add_argument("--labels", default="", type=str, help="optional GT .npy dir")
    parser.add_argument("--weights", default=None, type=str,
                        help=".npz (ours) or torch .pkl (reference checkpoint); "
                             "default: vendored pretrained weights")
    parser.add_argument("--out_dir", default="ritnet_out", type=str)
    parser.add_argument("--data_device", type=str, default="cuda")
    args = parser.parse_args(argv)
    dev = backend.resolve_data_device(args.data_device)
    os.makedirs(args.out_dir, exist_ok=True)

    model = ritnet.load_pretrained(args.weights, device=dev)
    mious = []
    for fname in sorted(os.listdir(args.images)):
        if not fname.lower().endswith((".png", ".jpg", ".bmp")):
            continue
        path = os.path.join(args.images, fname)
        with pil_image(path).open(path) as im:
            img = np.asarray(im.convert("L"))
        h = img.shape[0] - img.shape[0] % 16
        w = img.shape[1] - img.shape[1] % 16
        x = ritnet.preprocess_eye_image(img[:h, :w], device=dev)
        with torch.no_grad():
            pred = ritnet.get_predictions(model(x))[0].to(torch.int32).cpu().numpy()
        base = os.path.splitext(fname)[0]
        np.save(os.path.join(args.out_dir, base + "_label.npy"), pred)
        save_image(
            np.stack([pred.astype(np.float32) / 3.0] * 3),
            os.path.join(args.out_dir, base + "_mask.png"),
        )
        if args.labels:
            gt_path = os.path.join(args.labels, base + ".npy")
            if os.path.exists(gt_path):
                gt = np.load(gt_path)[:h, :w]
                mious.append(float(ritnet_train.miou(torch.from_numpy(pred),
                                                     torch.from_numpy(gt))))
    if mious:
        print(f"mIoU over {len(mious)} images: {np.mean(mious):.4f}")
    print(f"Wrote predictions to {args.out_dir}")


if __name__ == "__main__":
    main()
