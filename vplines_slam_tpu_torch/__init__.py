"""PyTorch + CUDA port of the points-only VIO device loop.

Mirrors the layout and function names of ``vplines_slam_tpu`` (the JAX
reference, which stays unchanged): ``ops/`` (image pyramid, KLT, corners,
multi-view geometry — the four hand-written CUDA kernels live in ``csrc/``),
``models/`` (camera, IMU, point tracker), ``factors/``, ``solver/``,
``estimator/``, ``pipeline/`` and ``utils/``.

Tensors carry their device; constructors take an explicit ``device``.  On a
CPU tensor every kernel wrapper runs its plain PyTorch twin; on a CUDA tensor
it launches the kernel (built from ``csrc/`` at first use) or raises.
"""
