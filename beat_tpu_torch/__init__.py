"""
beat_tpu_torch — the PyTorch/CUDA port of ``beat_tpu`` for NVIDIA Hopper.

The JAX package ``beat_tpu`` stays the reference; this package mirrors
its module layout (``ops/``, ``heart/``, ``ffi/``, ``models/``,
``samplers/``) so
each port module's counterpart is easy to find.  It imports ``torch``
and never ``jax``, nor anything of ``beat_tpu``: the numpy/scipy host
modules it needs are copies of the JAX package's, trimmed to what the
port calls (``parameter``, ``utility``, ``defaults``, ``covariance``,
``backend``), and the stage files they write are the JAX package's
format, so either package reads the other's runs.

Device policy: every entry point takes an explicit ``device``; nothing
picks a device on its own and nothing falls back from CUDA to the CPU
(:mod:`beat_tpu_torch.device`).

Covered today: the geometry-mode FullMT point moment-tensor inversion —
GF table gather (kernel K1, ``csrc/bilgather.cu``) and its gradient
(kernel K2, the same source), synthesis, whitened Gaussian likelihood,
the lockstep random-walk Metropolis, MALA and HMC stages, the SMC host
loop, the single-stage Metropolis sampler, and MAP + Laplace
(:mod:`beat_tpu_torch.optimize`); and the kinematic finite-fault
inversion — fault discretization, the 5-D GF library built on the device,
batched eikonal onsets, the library stack (kernels K3 and K4,
``csrc/gfstack.cu``), the distributer and Laplacian composites under the
random-walk SMC.  Kernel K5 (``csrc/rowgather.cu``), the plain row
gather, resamples the SMC population on the device.
"""

from beat_tpu_torch import device  # noqa: F401  (TF32 off at import)

__version__ = "0.1.0"
