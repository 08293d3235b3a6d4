"""Multi-device rendering and training (``sharded``), their collectives
(``collectives``) and multi-process wiring (``multihost``). Port of
``gaussian_splatting_with_eye_tracking_tpu/parallel``."""

from gaussian_splatting_with_eye_tracking_tpu_torch.parallel.sharded import (  # noqa: F401
    make_gauss_sharded_train_step,
    make_mesh,
    make_sharded_train_step,
    shard_model_state,
    sharded_render,
)
