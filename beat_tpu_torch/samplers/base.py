"""
Proposal distributions (port of ``beat_tpu/samplers/base.py``): a
proposal maps ``(generator, n, cov_chol)`` to (n, dim) perturbations for
all chains at once, drawn with an explicit ``torch.Generator``.

``MALA`` and ``HMC`` are gradient-based and are not proposals of this
catalog: the step dispatch of :mod:`beat_tpu_torch.samplers.metropolis`
handles them.
"""

from __future__ import annotations

import torch

#: gradient-based kernels, handled by the step dispatch
GRADIENT_KERNELS = ("MALA", "HMC")

#: proposals of the JAX package that later port slices add
_LATER = {"Normal", "Cauchy", "Laplace", "Poisson", "DiscreteBoundedUniform",
          "MultivariateCauchy", "MultivariateStudentT"}


def mv_normal_proposal(generator: torch.Generator, n: int, cov_chol: torch.Tensor,
                       z: torch.Tensor | None = None) -> torch.Tensor:
    """Multivariate normal steps ``z @ Lᵀ``; ``z`` (n, dim) standard
    normal noise may be injected (tests feed both packages one draw)."""
    if z is None:
        z = torch.randn((n, cov_chol.shape[0]), generator=generator,
                        dtype=cov_chol.dtype, device=cov_chol.device)
    return z @ cov_chol.T


proposal_catalog = {"MultivariateNormal": mv_normal_proposal}


def choose_proposal(name: str):
    """The proposal generator by its reference-compatible name."""
    if name in proposal_catalog:
        return proposal_catalog[name]
    if name in _LATER:
        raise NotImplementedError(
            f"proposal {name!r} waits for a later port slice (ROADMAP: the other "
            "proposals)")
    raise ValueError(f"Unknown proposal '{name}'; available: "
                     f"{sorted(proposal_catalog) + list(GRADIENT_KERNELS)} (MALA and HMC "
                     "are gradient-based and handled by the step kernel, "
                     "samplers/metropolis.py)")
