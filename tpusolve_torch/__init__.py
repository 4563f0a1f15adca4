"""tpusolve_torch — the PyTorch / CUDA port of ``tpusolve`` for NVIDIA Hopper.

It sits beside the JAX package ``tpusolve``, which stays the reference, and
mirrors its module names: ``parts`` (row decomposition), ``config``,
``timers``, ``formats``, ``matrix`` (ShardedMatrix, SpMV), ``kernels``
(hand-written CUDA kernels and their plain PyTorch versions), ``krylov``,
``ilu``, ``amg`` (BoomerAMG's host setup and the V-cycle) and ``harness`` (the 8-step ``LinearSystem`` lifecycle and the CLI,
``python -m tpusolve_torch INPUT.yaml``).  It imports ``torch``, never
``jax``.
"""

__version__ = "0.1.0"
