"""Distance-based point pruning study: keep the gaussians nearest the
camera and compare the pruned render with the full one.

Port of the repository's root ``KDtree_test.py`` (the reference's
``KDtree_test.py:64-71``). The threshold is the camera distance of the
active gaussian at index int(``--keep_fraction`` x active) of the sorted
distances (``torch.sort`` on the model's device, no host round trip per
gaussian), and every active gaussian at most that far is kept: k + 1 of
them, as the root script keeps (a fault of the root script's count, kept
so that the two agree). Both frames go through ``ops/rasterize.rasterize``
(the expand and tile-compositor kernels on a card) at bench's front
camera::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.KDtree_test --synthetic --keep_fraction 0.5

writes ``full.png`` and ``pruned.png`` under ``--out_dir`` and returns the
count kept, the PSNR and each frame's milliseconds, instances and
capacity beside the card. Deltas from the root script: the capacity
(``study_lib``; the root script's CPU path also caps each tile at 2,048
instances) and ``--data_device``.
"""

from __future__ import annotations

import os

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import study_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_image


def nearest(means: torch.Tensor, campos: torch.Tensor, active: torch.Tensor,
            keep_fraction: float) -> torch.Tensor:
    """(N,) bool: the active gaussians no farther from ``campos`` than the
    one at index int(keep_fraction x active) of their sorted distances."""
    dist = torch.linalg.norm(means - campos[None, :], dim=-1)
    masked = torch.sort(torch.where(active, dist, torch.inf)).values
    idx = (keep_fraction * active.sum()).to(torch.int32).clamp(0, masked.shape[0] - 1)
    return active & (dist <= masked[idx])


def main(argv=None, device=None):
    parser = study_lib.study_parser("Distance-based pruning study", "kdtree_test_out")
    parser.add_argument("--keep_fraction", default=0.5, type=float)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    model, deg, active, cam, bg = study_lib.study_view(args, device)
    keep = nearest(model[0], cam.campos, active, args.keep_fraction)
    kept, n_active = int(keep.sum()), int(active.sum())
    print(f"keeping {kept}/{n_active} gaussians "
          f"(nearest {args.keep_fraction * 100:.0f}% by camera distance)")
    frames = study_lib.timed_frames(
        {name: study_lib.rasterizer(model, deg, cam, bg, mask)
         for name, mask in (("full", active), ("pruned", keep))}, bg.device)
    full, pruned = frames["full"]["image"], frames["pruned"]["image"]
    doc = {"kept": kept, "active_gaussians": n_active, "keep_fraction": args.keep_fraction,
           "psnr_db": study_lib.psnr(full, pruned), "frames": study_lib.frame_numbers(frames),
           "width": args.width, "height": args.height, **study_lib.device_record(bg.device)}
    print(f"PSNR(pruned, full) = {doc['psnr_db']:.2f} dB")
    save_image(full.clamp(0, 1).cpu().numpy(), f"{args.out_dir}/full.png")
    save_image(pruned.clamp(0, 1).cpu().numpy(), f"{args.out_dir}/pruned.png")
    return doc


if __name__ == "__main__":
    main()
