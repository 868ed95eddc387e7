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

Covered today: the geometry mode — every point and finite source type
(moment tensor, lune MT, double couple, explosion, CLVD, two separated
double couples, ring fault, rectangle), synthesized through the GF table
gather fused with the moment-tensor contraction (kernel K1c,
``csrc/bilgather.cu``; K2c its transpose and backward; K1 and K2 the
plain gather and its gradient), station corrections, two or more
events, the time and spectrum domains, the whitened Gaussian likelihood
with one noise hyperparameter per wavemap or per target, the
hyper-only posterior and the between-stage covariance update; the
lockstep Metropolis stage with every proposal of the JAX package, MALA
and HMC, the SMC host loop, the single-stage Metropolis sampler, and
MAP + Laplace (:mod:`beat_tpu_torch.optimize`); and the kinematic
finite-fault inversion — fault discretization, the 5-D GF library built
on the device, batched eikonal onsets, the library stack (kernels K3 and
K4, ``csrc/gfstack.cu``), the distributer and Laplacian composites under
the random-walk SMC.  Kernel K5 (``csrc/rowgather.cu``), the plain row
gather, resamples the SMC population on the device.  Slice 9 adds
first-motion polarities (per-draw takeoffs from a table the host ray
tracer fills) and bem mode (``bem/``: meshes on the host, the
triangular-dislocation matrices and the solve in float64 on the device).
"""

from beat_tpu_torch import device  # noqa: F401  (TF32 off at import)

__version__ = "0.1.0"
