"""The benchmark of gaussian_splatting_with_eye_tracking_tpu_torch on one
H100: see README.md."""
