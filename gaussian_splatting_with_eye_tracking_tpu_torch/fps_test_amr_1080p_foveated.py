"""Foveated AMR timing at the default 1920x1088 (port of the repository's
root ``fps_test_amr_1080p_foveated.py``; the work is ``fps_foveated``'s)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test_amr_1080p_foveated --synthetic --gaze
"""

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_foveated


def main(argv=None):
    return fps_foveated.main(argv)


if __name__ == "__main__":
    main()
