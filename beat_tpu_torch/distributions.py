"""
Likelihood functions on tensors (port of ``beat_tpu/distributions.py``).

The noise hyperparameter ``h`` scales a dataset covariance by exp(2h):

    logp = -0.5 * ( slog_pdet + M*(2h + log 2π) + exp(-2h) * ||W r||² )

with ``W`` the inverse lower Cholesky factor of the covariance.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def multivariate_normal_chol(residual, chol_inverse, slog_pdet, hyperparam) -> torch.Tensor:
    """One dataset's Gaussian log-likelihood for a batch: residual (..., M),
    ``chol_inverse`` (M, M), ``hyperparam`` (...) or a number.  Returns (...)."""
    tmp = residual @ chol_inverse.T
    h = torch.as_tensor(hyperparam, dtype=residual.dtype, device=residual.device)
    return -0.5 * (slog_pdet + residual.shape[-1] * (2.0 * h + LOG_2PI)
                   + torch.exp(-2.0 * h) * torch.sum(tmp * tmp, dim=-1))


def multivariate_normal_chol_batched(residuals, chol_inverses, slog_pdets,
                                     hyperparams, nsamples) -> torch.Tensor:
    """Per-dataset Gaussian log-likelihoods.

    residuals (..., D, M); chol_inverses (D, M, M); slog_pdets (D,);
    hyperparams (..., D); nsamples (D,).  Returns (..., D)."""
    tmp = torch.einsum("dij,...dj->...di", chol_inverses, residuals)
    quad = torch.sum(tmp * tmp, dim=-1)
    norm = nsamples * (2.0 * hyperparams + LOG_2PI)
    return -0.5 * (slog_pdets + norm + torch.exp(-2.0 * hyperparams) * quad)


def hyper_normal(residuals_fixed, slog_pdets, hyperparams, nsamples) -> torch.Tensor:
    """The same Gaussian on fixed residuals: ``residuals_fixed`` are the
    precomputed weighted squared norms ``||W r||²`` (D,), so a draw of the
    hyperparameters (..., D) costs O(D).  Returns (..., D)."""
    norm = nsamples * (2.0 * hyperparams + LOG_2PI)
    return -0.5 * (slog_pdets + norm + torch.exp(-2.0 * hyperparams) * residuals_fixed)


def cumulative_normal(x, s=math.sqrt(2.0)) -> torch.Tensor:
    return 0.5 + 0.5 * torch.special.erf(x / s)


def polarity_llk(obs_polarities, syn_amplitudes, gamma, sigma) -> torch.Tensor:
    """First-motion polarity log-likelihood per observation (Weber 2018
    GJI eq. 6-7): ``obs`` in {-1, +1}, ``gamma`` the probability of a
    wrong reading, ``sigma`` the amplitude noise scale."""
    p_i = gamma + (1.0 - 2.0 * gamma) * cumulative_normal(syn_amplitudes / sigma)
    p_i = torch.clamp(p_i, 1e-12, 1.0 - 1e-12)
    return (((1.0 + obs_polarities) / 2.0) * torch.log(p_i)
            + ((1.0 - obs_polarities) / 2.0) * torch.log(1.0 - p_i))


def uniform_prior_logp(q, lower, upper) -> torch.Tensor:
    """Flat-box prior: 0 inside the bounds, -inf outside (only finiteness
    matters for the Metropolis accept)."""
    inside = torch.all((q >= lower) & (q <= upper), dim=-1)
    return torch.where(inside, 0.0, -math.inf)
