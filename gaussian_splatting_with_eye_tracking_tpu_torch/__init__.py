"""PyTorch + CUDA port of ``gaussian_splatting_with_eye_tracking_tpu``.

Module names mirror the JAX package so each port sits beside its
counterpart: ``ops/`` (transforms, sh, projection, expand, binning,
blend, rasterize, ssim, amr), ``models/`` (gaussian_model, ply_io,
checkpoint, ritnet), ``scene/`` (ply, colmap, dataset_readers, cameras,
scene), ``utils/``, ``renderer/``, ``parallel/`` (the multi-device steps,
their collectives and the multi-process wiring), ``config``,
``train_lib``, ``metrics_lib``, the ``train``, ``render`` and ``metrics``
CLIs and ``scaling_bench``. The hand-written Hopper kernels live in
``csrc/`` and are built and loaded by ``backend``.

Entry points run on CUDA unless the caller passes ``device="cpu"`` (the
CLIs: ``--data_device cpu``); on a CPU tensor each kernel wrapper runs its
plain PyTorch version instead.
"""
