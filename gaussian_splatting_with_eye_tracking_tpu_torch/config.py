"""Configuration dataclasses and their command-line reflection.

Port of ``gaussian_splatting_with_eye_tracking_tpu/config.py`` (the
reference's ``ModelParams``, ``PipelineParams``, ``OptimizationParams``
and ``ParamGroup``), field for field with the same defaults, except that
``ModelConfig.data_device`` names where the port runs: ``"cuda"`` (the
default) or ``"cpu"``. ``get_combined_args`` overlays the command line on
a model directory's persisted ``cfg_args``.

Left out until something reads it: ``RasterizeConfig`` (the tile, chunk
and cutoffs are constants of ``ops/blend.py``; the trainer's starting
instance capacity is ``train.training``'s argument).
"""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser, Namespace
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class ModelConfig:
    """Scene / model loading parameters (reference ModelParams)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"  # where the model, images and kernels run: cuda or cpu
    eval: bool = False

    capacity: int = 0  # 0 = auto (next power of two of the initial points * 8)


@dataclass
class PipelineConfig:
    """Render pipeline toggles (reference PipelineParams). The trainer
    passes them to the viewer's ``poll``; ``debug`` reaches
    ``rasterize(debug=...)``. The two Python-side toggles choose, in the
    reference, where SH colours and 3D covariances are computed; here, as
    in the JAX package, preprocess always computes both."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


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


# every dataclass field becomes --<name>; bools become store_true flags
_SHORTHANDS = {
    "source_path": "-s",
    "model_path": "-m",
    "images": "-i",
    "resolution": "-r",
    "white_background": "-w",
}


def add_config_args(parser: ArgumentParser, cfg, group_name: str, sentinel: bool = False):
    """Reflect a config dataclass into argparse arguments. With
    ``sentinel`` every default is None, so ``get_combined_args`` can tell
    what the command line set."""
    group = parser.add_argument_group(group_name)
    for f in dataclasses.fields(type(cfg)):
        default = None if sentinel else getattr(cfg, f.name)
        names = ["--" + f.name]
        if f.name in _SHORTHANDS:
            names.append(_SHORTHANDS[f.name])
        if f.type in ("bool", bool):
            group.add_argument(*names, default=default, action="store_true")
        else:
            group.add_argument(*names, default=default, type=type(getattr(cfg, f.name)))
    return group


def extract_config(args: Namespace, cls):
    """Build a config dataclass from a parsed namespace; a relative
    ``source_path`` becomes absolute."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kwargs[f.name] = getattr(args, f.name)
    cfg = cls(**kwargs)
    if hasattr(cfg, "source_path") and cfg.source_path:
        cfg.source_path = os.path.abspath(cfg.source_path)
    return cfg


def save_cfg_args(model_path: str, model_cfg: ModelConfig) -> None:
    """Persist the model config as the ``repr`` of a Namespace in
    ``<model_path>/cfg_args``, as the reference does."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**dataclasses.asdict(model_cfg))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(ns))


def get_combined_args(parser: ArgumentParser, argv: Optional[List[str]] = None) -> Namespace:
    """The command line overlaid on the model directory's ``cfg_args``:
    every argument the command line gives (not None) wins.

    ``cfg_args`` is read with ``eval``, as the reference reads it: it runs
    whatever the file holds, so point ``-m`` only at model directories you
    trust (ones this package or the reference wrote)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    cfgfilepath = os.path.join(getattr(args_cmdline, "model_path", "") or "", "cfg_args")
    if os.path.isfile(cfgfilepath):
        with open(cfgfilepath) as f:
            text = f.read()
        ns = eval(text, {"Namespace": Namespace})  # noqa: S307 - the reference's trust model
        merged.update(vars(ns))
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)


def model_config_of(argv: List[str]) -> ModelConfig:
    """The ``ModelConfig`` of a model directory: ``argv`` (``-m`` and any
    model flags) overlaid on its ``cfg_args``."""
    parser = ArgumentParser()
    add_config_args(parser, ModelConfig(), "Model Parameters", sentinel=True)
    return extract_config(get_combined_args(parser, argv), ModelConfig)
