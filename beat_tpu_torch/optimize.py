"""
Gradient-based MAP estimation and the Laplace approximation (port of
``beat_tpu/optimize.py``).

* :func:`map_estimate` — multi-restart L-BFGS in the sigmoid-transformed
  unconstrained space ``q = lo + (hi−lo)·σ(z)``, all restarts advanced in
  lockstep as one batch: every iteration is one batched forward of the
  line-search trials and one batched value-and-grad.  The monotone
  transform keeps the argmax of the likelihood over the prior box, so no
  Jacobian term is wanted.
* :func:`laplace_approximation` — the curvature at the mode: posterior
  covariance ``(−∇²llk)⁻¹`` over the free dimensions and the Laplace
  evidence ``llk* + d/2·log 2π − ½·log|−∇²llk| − log vol(prior)``.  The
  Hessian is reverse-over-reverse (``torch.autograd.functional.hessian``),
  which runs through the GF gather's kernels in both passes; the JAX
  package's forward-over-reverse ``jax.hessian`` cannot pass its gather's
  ``custom_vjp``.

Fixed parameters (``lower == upper``) are held constant and excluded
from both the optimisation and the curvature.

The L-BFGS keeps optax's defaults where they define the algorithm
(memory 10, the initial scaling ``sᵀy / yᵀy``, and ``min(1, 1/|g|)`` on
the first step).  Its line search differs from optax's zoom search
(strong Wolfe conditions, up to 20 sequential trials): it evaluates a
fixed set of step lengths ``1, ½, …, 2^-(K-1)`` at once and takes, per
restart, the longest that meets the Armijo condition.  A pair with
``sᵀy`` too small to keep the inverse-Hessian estimate positive definite
is not stored; a restart whose direction is no descent direction, or
whose trials all fail, drops its memory and steps along the scaled
gradient next.  A restart keeps its last finite iterate when a step
diverges.  Nothing in the loop waits for the device.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.samplers.metropolis import value_and_grad

logger = logging.getLogger("beat_tpu_torch.optimize")

_EPS = 1e-6
#: L-BFGS memory (optax's default)
MEMORY = 10
#: step lengths tried per iteration: 1, 1/2, ..., 2**-(TRIALS-1)
TRIALS = 8
#: sufficient-decrease constant of the Armijo condition (optax's zoom search)
ARMIJO_C1 = 1e-4


def _transforms(lower, upper, device):
    """Sigmoid bijection between the free-dimension box and R^d_free;
    fixed dims (span == 0) pass through constant."""
    lo = torch.as_tensor(lower, dtype=DTYPE, device=device)
    hi = torch.as_tensor(upper, dtype=DTYPE, device=device)
    span = hi - lo
    free = span > 0

    def to_q(z):
        return torch.where(free, lo + span * torch.sigmoid(z), lo)

    def to_z(q):
        u = torch.clamp((q - lo) / torch.where(free, span, torch.ones_like(span)),
                        _EPS, 1 - _EPS)
        return torch.where(free, torch.log(u) - torch.log1p(-u), torch.zeros_like(u))

    return to_q, to_z


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _shift_in(mem: torch.Tensor, new: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Append ``new`` as the newest slot (last) of the restarts in
    ``rows``, dropping their oldest."""
    shifted = torch.cat([mem[:, 1:], new[:, None]], dim=1)
    return torch.where(rows.reshape((-1,) + (1,) * (mem.dim() - 1)), shifted, mem)


@torch.no_grad()
def _run_lbfgs(neg: Callable, z0: torch.Tensor, n_steps: int):
    """Lockstep multi-restart L-BFGS minimising ``neg`` (batched
    ``(R, d) -> (R,)``) from z0 (R, d).  Returns (z, neg(z))."""
    R, d = z0.shape
    dev = z0.device
    S = torch.zeros((R, MEMORY, d), dtype=DTYPE, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((R, MEMORY), dtype=DTYPE, device=dev)
    alphas = 0.5 ** torch.arange(TRIALS, dtype=DTYPE, device=dev)
    z = z0
    f, g = value_and_grad(neg, z)
    for _ in range(n_steps):
        # two-loop recursion; empty (zero) slots contribute nothing
        r = g
        a = [None] * MEMORY
        for i in reversed(range(MEMORY)):
            a[i] = rho[:, i] * _dot(S[:, i], r)
            r = r - a[i][:, None] * Y[:, i]
        sy, yy = _dot(S[:, -1], Y[:, -1]), _dot(Y[:, -1], Y[:, -1])
        first = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1), max=1.0)
        gamma = torch.where(yy > 0, sy / torch.where(yy > 0, yy, torch.ones_like(yy)), first)
        r = gamma[:, None] * r
        for i in range(MEMORY):
            r = r + S[:, i] * (a[i] - rho[:, i] * _dot(Y[:, i], r))[:, None]
        direction = -r
        slope = _dot(g, direction)
        steepest = ~(slope < 0)                 # no descent (or not finite)
        direction = torch.where(steepest[:, None], -first[:, None] * g, direction)
        slope = torch.where(steepest, _dot(g, direction), slope)

        # Armijo backtracking, all trials in one batch: (TRIALS, R)
        trials = z[None] + alphas[:, None, None] * direction[None]
        f_trial = neg(trials.reshape(TRIALS * R, d)).reshape(TRIALS, R)
        armijo = (torch.isfinite(f_trial)
                  & (f_trial <= f[None] + ARMIJO_C1 * alphas[:, None] * slope[None]))
        found = armijo.any(dim=0)
        alpha = alphas[torch.argmax(armijo.to(torch.int8), dim=0)]
        z_new = z + alpha[:, None] * direction
        f_new, g_new = value_and_grad(neg, z_new)
        ok = (found & torch.isfinite(f_new) & torch.all(torch.isfinite(g_new), dim=-1)
              & torch.all(torch.isfinite(z_new), dim=-1))

        keep = ~(steepest | ~ok)[:, None, None]
        S, Y, rho = S * keep, Y * keep, rho * keep[:, :, 0]
        s, y = z_new - z, g_new - g
        sy, yy = _dot(s, y), _dot(y, y)
        store = ok & (yy > 0) & (sy > 1e-10 * yy)
        S, Y = _shift_in(S, s, store), _shift_in(Y, y, store)
        rho = _shift_in(rho, 1.0 / torch.where(store, sy, torch.ones_like(sy)), store)

        z = torch.where(ok[:, None], z_new, z)
        f = torch.where(ok, f_new, f)
        g = torch.where(ok[:, None], g_new, g)
    return z, f


def map_estimate(logp_fn: Callable, lower, upper, n_restarts: int = 32, n_steps: int = 150,
                 seed: int = 0, logp_args=(), start=None, *, device):
    """
    Maximise the data log-likelihood ``logp_fn(q (C, dim), *logp_args)
    -> (C,)`` over the prior box.

    Returns ``(q_map (dim,), llk_map float, all_llks (n_restarts,))`` —
    ``all_llks`` diagnoses multimodality (spread across restarts).
    ``start``: optional (n, dim) extra start points (e.g. the test
    point) prepended to the uniform random restarts.
    """
    dev = resolve(device)
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    q0 = np.random.default_rng(seed).uniform(lower, upper, size=(n_restarts, lower.size))
    # fixed dims: uniform() returns the pinned value (lo == hi)
    if start is not None:
        q0 = np.concatenate([np.atleast_2d(np.asarray(start)), q0], axis=0)

    to_q, to_z = _transforms(lower, upper, dev)

    def neg(z):
        return -logp_fn(to_q(z), *logp_args)

    zf, f = _run_lbfgs(neg, to_z(torch.as_tensor(q0, dtype=DTYPE, device=dev)), n_steps)
    llks = (-f).cpu().numpy()
    best = int(np.argmax(llks))
    q_map = to_q(zf[best]).cpu().numpy().astype(np.float64)
    return q_map, float(llks[best]), llks


def laplace_approximation(logp_fn: Callable, q_map, lower, upper, logp_args=(), *, device):
    """
    Gaussian (Laplace) posterior approximation at the MAP point.

    Returns a dict with the free-dimension posterior covariance
    (``cov``, PSD-guarded), per-dimension standard deviations expanded
    to the full parameter vector (0 for fixed dims), the mask of free
    dims, and the Laplace log-evidence under the uniform box prior
    (comparable to the SMC transitional estimate).
    """
    dev = resolve(device)
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    free = upper > lower
    idx = np.flatnonzero(free)
    q_map = np.asarray(q_map, dtype=np.float64)

    qm = torch.as_tensor(q_map, dtype=DTYPE, device=dev)
    idx_t = torch.as_tensor(idx, device=dev)

    def llk_free(qf):
        return logp_fn(qm.index_put((idx_t,), qf)[None], *logp_args)[0]

    qf0 = qm[idx_t]
    H = torch.autograd.functional.hessian(llk_free, qf0).double().cpu().numpy()
    prec = -(H + H.T) / 2.0
    # interior maximum → positive definite; guard saddle/boundary cases
    w, V = np.linalg.eigh(prec)
    w_floor = np.maximum(w, 1e-10 * max(w.max(), 1.0))
    cov = (V / w_floor) @ V.T
    with torch.no_grad():
        llk_map = float(llk_free(qf0))
    d = idx.size
    log_vol = float(np.sum(np.log(upper[idx] - lower[idx])))
    log_evidence = (llk_map + 0.5 * d * np.log(2 * np.pi)
                    - 0.5 * float(np.sum(np.log(w_floor))) - log_vol)
    sd = np.zeros(lower.size)
    sd[idx] = np.sqrt(np.diag(cov))
    if (w <= 0).any():
        logger.warning(
            "Laplace curvature not positive definite (%d non-positive eigenvalues) — "
            "MAP on a boundary or saddle; evidence/sd floored", int((w <= 0).sum()))
    return {"cov": cov, "sd": sd, "free": free, "llk_map": llk_map,
            "log_evidence": float(log_evidence), "curvature_ok": bool((w > 0).all())}
