"""Foveated AMR timing, step by step (port of the repository's root
``fps_test_amr_foveated.py``; the work is ``fps_foveated``'s)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test_amr_foveated --synthetic --gaze
"""

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_foveated


def main(argv=None):
    return fps_foveated.main(argv)


if __name__ == "__main__":
    main()
