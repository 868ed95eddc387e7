"""
beat_tpu_torch — the PyTorch/CUDA port of ``beat_tpu`` for NVIDIA Hopper.

The JAX package ``beat_tpu`` stays the reference; this package mirrors
its module layout (``ops/``, ``heart/``, ``models/``, ``samplers/``) so
each port module's counterpart is easy to find.  It imports ``torch``
and never ``jax``.  Host-only helpers that import numpy and scipy alone
are shared with the JAX package (``beat_tpu.parameter``,
``beat_tpu.utility``, ``beat_tpu.defaults``, ``beat_tpu.covariance``,
``beat_tpu.backend``), which keeps the flat parameter ordering and the
stage files identical by construction.

Device policy: every entry point takes an explicit ``device``; nothing
picks a device on its own and nothing falls back from CUDA to the CPU
(:mod:`beat_tpu_torch.device`).

Covered today (slice 1): the geometry-mode FullMT point moment-tensor
inversion with SMC — GF table gather (kernel K1,
``csrc/bilgather.cu``), synthesis, whitened Gaussian likelihood, the
lockstep Metropolis stage and the SMC host loop.
"""

from beat_tpu_torch import device  # noqa: F401  (TF32 off at import)

__version__ = "0.1.0"
