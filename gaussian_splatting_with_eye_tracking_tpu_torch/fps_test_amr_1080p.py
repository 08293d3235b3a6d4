"""AMR frame rate at 1920x1080 only (port of the repository's root
``fps_test_amr_1080p.py``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test_amr_1080p --synthetic
"""

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test


def main(argv=None):
    return fps_test.main(argv, amr_mode=True, ratios=[1.0])


if __name__ == "__main__":
    main()
