"""AMR frame-rate sweep: ``fps_test``'s protocol with the 5-step foveated
frame (port of the repository's root ``fps_test_amr.py``)::

    python -m gaussian_splatting_with_eye_tracking_tpu_torch.fps_test_amr --synthetic
"""

from gaussian_splatting_with_eye_tracking_tpu_torch import fps_test


def main(argv=None):
    return fps_test.main(argv, amr_mode=True)


if __name__ == "__main__":
    main()
