"""Scene IO: datasets, cameras, point clouds and the ``Scene``."""

from gaussian_splatting_with_eye_tracking_tpu_torch.scene.cameras import Camera, MiniCam  # noqa: F401
from gaussian_splatting_with_eye_tracking_tpu_torch.scene.scene import Scene  # noqa: F401
