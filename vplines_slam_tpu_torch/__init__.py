"""PyTorch + CUDA port of the VIO device loop (points, lines, vanishing points).

Mirrors the layout and function names of ``vplines_slam_tpu`` (the JAX
reference, which stays unchanged): ``ops/`` (image pyramid and remap, KLT,
corners, multi-view geometry, lines, line matching, vanishing points — the
hand-written CUDA kernels live in ``csrc/``), ``models/`` (camera, IMU, point
and line trackers), ``factors/``, ``solver/``, ``estimator/``, ``pipeline/``
and ``utils/``.

Tensors carry their device; constructors put theirs on the card unless given
``device="cpu"``.  On a CPU tensor every kernel wrapper runs its plain
PyTorch twin; on a CUDA tensor it launches the kernel (built from ``csrc/``
at first use) or raises.
"""
