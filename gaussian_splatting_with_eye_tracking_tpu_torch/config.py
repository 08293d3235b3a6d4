"""Training hyperparameters.

Port of ``OptimizationConfig`` from
``gaussian_splatting_with_eye_tracking_tpu/config.py`` (the reference's
``OptimizationParams``), field for field with the same defaults. The model,
pipeline and rasterizer configs and the CLI reflection come with scene IO.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationConfig:
    """Training hyperparameters (reference OptimizationParams)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_delay_steps: int = 0
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002

    # Adam epsilon of the reference optimizer
    adam_eps: float = 1e-15
