"""
Proposal distributions (port of ``beat_tpu/samplers/base.py``): a
proposal maps ``(generator, n, cov_chol)`` to (n, dim) perturbations for
all chains at once, drawn with an explicit ``torch.Generator``.  The
multivariate proposals take the lower Cholesky factor of the proposal
covariance, the univariate ones its diagonal standard deviations (the
row norms of the factor).

Where the step is a fixed transform of standard draws, those draws may
be injected as ``z`` instead (torch cannot reproduce JAX's random bits,
so the tests feed both packages one draw): standard normals (Normal,
MultivariateNormal), standard Cauchy (Cauchy) or Laplace (Laplace)
draws, ``(normals, normals (n, 1))`` (MultivariateCauchy),
``(normals, Gamma(df/2) draws (n, 1))`` (MultivariateStudentT),
``(Poisson(λ) draws, Poisson(λ) draws)`` (Poisson) and standard
uniforms (DiscreteBoundedUniform).

``MALA`` and ``HMC`` are gradient-based and are not proposals of this
catalog: the step dispatch of :mod:`beat_tpu_torch.samplers.metropolis`
handles them.
"""

from __future__ import annotations

import torch

#: gradient-based kernels, handled by the step dispatch
GRADIENT_KERNELS = ("MALA", "HMC")


def _std_from_chol(cov_chol: torch.Tensor) -> torch.Tensor:
    # row norms of the lower Cholesky factor: per-dimension std deviations
    return torch.sqrt(torch.sum(cov_chol**2, dim=1))


def _normal(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _uniform(generator, shape, like):
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def normal_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Independent normal steps with the diagonal's standard deviations."""
    if z is None:
        z = _normal(generator, (n, cov_chol.shape[0]), cov_chol)
    return z * _std_from_chol(cov_chol)


def cauchy_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Independent Cauchy steps: ``tan(π(u - ½))`` of standard uniforms."""
    if z is None:
        z = torch.tan(torch.pi * (_uniform(generator, (n, cov_chol.shape[0]), cov_chol) - 0.5))
    return z * _std_from_chol(cov_chol)


def laplace_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Independent Laplace steps: ``-sign(u)·log1p(-|u|)``, u uniform in
    (-1, 1)."""
    if z is None:
        u = 2.0 * _uniform(generator, (n, cov_chol.shape[0]), cov_chol) - 1.0
        z = -torch.sign(u) * torch.log1p(-torch.abs(u))
    return z * _std_from_chol(cov_chol)


def mv_normal_proposal(generator: torch.Generator, n: int, cov_chol: torch.Tensor,
                       z: torch.Tensor | None = None) -> torch.Tensor:
    """Multivariate normal steps ``z @ Lᵀ``."""
    if z is None:
        z = _normal(generator, (n, cov_chol.shape[0]), cov_chol)
    return z @ cov_chol.T


def mv_cauchy_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Multivariate Cauchy: a correlated normal over one |normal| per
    draw (Normal / sqrt(Chi2_1))."""
    zn, g = z if z is not None else (_normal(generator, (n, cov_chol.shape[0]), cov_chol),
                                     _normal(generator, (n, 1), cov_chol))
    return (zn @ cov_chol.T) / torch.clamp(torch.abs(g), min=1e-12)


def mv_student_t_proposal(generator, n, cov_chol, z=None, df: float = 5.0) -> torch.Tensor:
    """Multivariate Student-t with ``df`` degrees of freedom: a correlated
    normal over sqrt(Gamma(df/2)·2/df) per draw."""
    if z is None:
        concentration = torch.full((n, 1), df / 2.0, dtype=cov_chol.dtype,
                                   device=cov_chol.device)
        z = (_normal(generator, (n, cov_chol.shape[0]), cov_chol),
             torch._standard_gamma(concentration, generator=generator))
    zn, gamma = z
    g = gamma * 2.0 / df
    return (zn @ cov_chol.T) / torch.sqrt(torch.clamp(g, min=1e-12))


def poisson_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Symmetric integer steps: the difference of two Poisson draws whose
    rate is the proposal's standard deviation."""
    if z is None:
        lam = torch.clamp(_std_from_chol(cov_chol), min=1e-6).expand(n, -1).contiguous()
        z = (torch.poisson(lam, generator=generator), torch.poisson(lam, generator=generator))
    return (z[0] - z[1]).to(cov_chol.dtype)


def discrete_bounded_uniform_proposal(generator, n, cov_chol, z=None) -> torch.Tensor:
    """Integer steps uniform in ±3σ (at least ±1): ``floor`` of a uniform
    over [-w, w + 1)."""
    width = torch.clamp(torch.round(3.0 * _std_from_chol(cov_chol)), min=1.0)
    if z is None:
        z = _uniform(generator, (n, cov_chol.shape[0]), cov_chol)
    return torch.floor(z * (2.0 * width + 1.0) - width)


proposal_catalog = {
    "Normal": normal_proposal,
    "Cauchy": cauchy_proposal,
    "Laplace": laplace_proposal,
    "Poisson": poisson_proposal,
    "DiscreteBoundedUniform": discrete_bounded_uniform_proposal,
    "MultivariateNormal": mv_normal_proposal,
    "MultivariateCauchy": mv_cauchy_proposal,
    "MultivariateStudentT": mv_student_t_proposal,
}


def choose_proposal(name: str):
    """The proposal generator by its reference-compatible name."""
    try:
        return proposal_catalog[name]
    except KeyError:
        raise ValueError(f"Unknown proposal '{name}'; available: "
                         f"{sorted(proposal_catalog) + list(GRADIENT_KERNELS)} (MALA and HMC "
                         "are gradient-based and handled by the step kernel, "
                         "samplers/metropolis.py)") from None
