"""Opacity quantization study: the model rendered with its opacities,
with them quantized to ``--bits`` bits, and with the quantized opacities
plus their residual (the identity check), compared by PSNR and saved.

Port of the repository's root ``opacity_quant_test.py`` (the reference's
``opacity_quant_test.py:55-71``). Each frame goes through
``ops/rasterize.rasterize`` (the expand and tile-compositor kernels on a
card, their plain versions on the CPU), seen by bench's front camera (z =
-5, 60 degrees) at ``--width`` x ``--height``::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.opacity_quant_test --synthetic --bits 4

writes ``original.png``, ``quantized.png`` and ``quantized_residual.png``
under ``--out_dir`` and returns the two PSNRs and each frame's
milliseconds, instances and capacity beside the card. On the card the
identity check compares two of the kernels' frames, so its PSNR is the
120 dB clamp or close to it. Deltas from the root script: the capacity
(``study_lib``; the root script's CPU path also caps each tile at 2,048
instances) and ``--data_device``.
"""

from __future__ import annotations

import os

import torch

from gaussian_splatting_with_eye_tracking_tpu_torch import study_lib
from gaussian_splatting_with_eye_tracking_tpu_torch.utils.image_utils import save_image

FRAMES = ("original", "quantized", "quantized_residual")


def quantize(opacities: torch.Tensor, bits: int):
    """(the opacities rounded to ``bits`` bits, their residual)."""
    levels = (1 << bits) - 1
    op_q = torch.round(opacities * levels) / levels
    return op_q, opacities - op_q


def renders(model, deg, cam, bg, active, bits: int) -> dict:
    """{frame name: render(capacity)} of the three frames."""
    op_q, residual = quantize(model[3], bits)
    opacities = (model[3], op_q, op_q + residual)
    return {name: study_lib.rasterizer((*model[:3], op, model[4]), deg, cam, bg, active)
            for name, op in zip(FRAMES, opacities)}


def main(argv=None, device=None):
    parser = study_lib.study_parser("Opacity quantization study", "opacity_quant_out")
    parser.add_argument("--bits", default=4, type=int)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    model, deg, active, cam, bg = study_lib.study_view(args, device)
    frames = study_lib.timed_frames(renders(model, deg, cam, bg, active, args.bits), bg.device)
    img = {name: f["image"] for name, f in frames.items()}
    doc = {"bits": args.bits,
           "psnr_quantized_db": study_lib.psnr(img["quantized"], img["original"]),
           "psnr_quantized_residual_db": study_lib.psnr(img["quantized_residual"],
                                                        img["original"]),
           "frames": study_lib.frame_numbers(frames), "width": args.width,
           "height": args.height, "active_gaussians": int(active.sum()),
           **study_lib.device_record(bg.device)}
    print(f"{args.bits}-bit opacity quantization:")
    print(f"  PSNR(quantized, original)          = {doc['psnr_quantized_db']:.2f} dB")
    print(f"  PSNR(quantized+residual, original) = {doc['psnr_quantized_residual_db']:.2f} dB "
          "(identity check)")
    for name in FRAMES:
        save_image(img[name].clamp(0, 1).cpu().numpy(), f"{args.out_dir}/{name}.png")
    return doc


if __name__ == "__main__":
    main()
