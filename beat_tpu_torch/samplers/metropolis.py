"""
Lockstep adaptive Metropolis, MALA and HMC (port of
``beat_tpu/samplers/metropolis.py``): every Markov chain is one row of a
device tensor and each step advances all chains at once.

The step loop runs on the host in Python while every tensor stays on the
device, and nothing inside it waits for the device: the tuning
condition depends on the step index only, and the thinned trace is
recorded into preallocated device tensors that the caller fetches once.

Semantics kept from the JAX package: per-chain adaptive ``scaling``
retuned every ``tune_interval`` global steps (the pymc table for the
random walk, ``exp(1.5·(acc − target))`` toward 0.574 for MALA and
0.651 for HMC); hard prior bounds (out-of-bounds proposals are
evaluated clipped into the box and then rejected); finite-llk and
finite-gradient guards; tempered accept ``log u < β·(llk' − llk) + …``.
``β`` is a scalar or a per-chain (n,) vector (parallel tempering runs
every replica at its own temperature in one batch); a vector enters the
random-walk ratio as it is, and MALA's drift and ratio and HMC's kicks
as an (n, 1) column.  A segmented sampler (parallel tempering) passes its
global step count as ``step_offset``, so tuning fires every
``tune_interval`` global steps even when each segment is shorter than the
interval.

A state may hold a block of a larger population (one rank's chains,
:mod:`beat_tpu_torch.parallel`): ``block = (first global row, global
chain count)``.  Every random draw is then made for the whole population
from the same generator and the block's rows are kept, so a block steps
exactly as its rows of the one-process run would.

The gradient-based kernels carry ``(state, grad)``: one batched
value-and-grad per stage start, then one per MALA step and
``n_leapfrog`` per HMC step.  The chains are independent, so the
gradient of the summed llk is every chain's own gradient.  All state is
detached after each step, so no autograd graph outlives it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.profiling import span
from beat_tpu_torch.samplers.base import GRADIENT_KERNELS, choose_proposal

_TUNE_TABLE = ((lambda a: a < 0.001, 0.1), (lambda a: a < 0.05, 0.5),
               (lambda a: a < 0.2, 0.9), (lambda a: a > 0.95, 10.0),
               (lambda a: a > 0.75, 2.0), (lambda a: a > 0.5, 1.1))

#: Roberts & Rosenthal (1998) optimal MALA acceptance rate
MALA_TARGET_ACC = 0.574
#: Beskos et al. (2013) optimal HMC acceptance rate
HMC_TARGET_ACC = 0.651


def tune_scale(scale: torch.Tensor, acc_rate: torch.Tensor) -> torch.Tensor:
    """pymc step-scale tuning (the first matching row wins):

      <0.001: x0.1   <0.05: x0.5   <0.2: x0.9
      >0.95:  x10    >0.75: x2     >0.5:  x1.1
    """
    factors = torch.ones_like(acc_rate)
    for cond, f in reversed(_TUNE_TABLE):
        factors = torch.where(cond(acc_rate), torch.full_like(acc_rate, f), factors)
    return scale * factors


@dataclass
class MetropolisParams:
    """Single-stage adaptive-Metropolis configuration (the JAX package's
    ``MetropolisParams``)."""

    n_chains: int = 20
    n_steps: int = 25000
    burn: float = 0.1
    thin: int = 2
    tune_interval: int = 100
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    seed: int = 0


class MetropolisState(NamedTuple):
    """State of all chains (leading axis = chains), on the device."""

    q: torch.Tensor          # (n_chains, dim) current positions
    llk: torch.Tensor        # (n_chains,) current data log-likelihoods
    scaling: torch.Tensor    # (n_chains,) adaptive proposal scale / step size
    accepted: torch.Tensor   # (n_chains,) accepts since the last tune
    acc_total: torch.Tensor  # (n_chains,) accepts in this stage


def init_metropolis_state(logp_fn: Callable, q0: torch.Tensor, logp_args: tuple = (),
                          scale: float = 1.0) -> MetropolisState:
    """Evaluate the start population (n, dim) and build the state."""
    llk0 = logp_fn(q0, *logp_args)
    n = q0.shape[0]
    return MetropolisState(q=q0, llk=llk0,
                           scaling=torch.full((n,), float(scale), dtype=DTYPE, device=q0.device),
                           accepted=torch.zeros(n, dtype=DTYPE, device=q0.device),
                           acc_total=torch.zeros(n, dtype=DTYPE, device=q0.device))


def value_and_grad(logp_fn: Callable, q: torch.Tensor, logp_args: tuple = ()):
    """Per-chain ``(llk (n,), ∂llk/∂q (n, dim))`` of a batch, both
    detached (``jax.vmap(jax.value_and_grad(logp))``)."""
    with torch.enable_grad():
        qq = q.detach().requires_grad_()
        llk = logp_fn(qq, *logp_args)
        (grad,) = torch.autograd.grad(llk.sum(), qq)
    return llk.detach(), grad.detach()


def _retuned(state: MetropolisState, step_idx: int, tune_interval: int, target: float):
    """(scaling, accepted) after the gradient kernels' retune toward
    ``target`` acceptance at every ``tune_interval``-th global step."""
    if step_idx > 0 and step_idx % tune_interval == 0:
        acc_frac = state.accepted / tune_interval
        scaling = torch.clamp(state.scaling * torch.exp(1.5 * (acc_frac - target)), 1e-6, 1e3)
        return scaling, torch.zeros_like(state.accepted)
    return state.scaling, state.accepted


def _beta_pair(beta, like: torch.Tensor) -> tuple:
    """``(β, β as a column)`` on ``like``'s device: a scalar twice, or a
    per-chain (n,) vector and its (n, 1) column, which broadcasts against
    (n, dim) rows."""
    beta = torch.as_tensor(beta, dtype=like.dtype, device=like.device)
    return beta, (beta[:, None] if beta.dim() else beta)


def _block_rows(block, n: int) -> tuple:
    """``(rows, n_all)``: the global rows of a state of ``n`` chains and
    the population size the draws are made for (``block = (first row,
    n_all)``; None: the state is the whole population)."""
    if block is None:
        return slice(None), n
    start, n_all = block
    return slice(start, start + n), n_all


def _draw_pair(generator, state, block, noise):
    """The (n, dim) standard normals and (n,) uniforms of a gradient
    step, drawn for the whole population (or taken from ``noise``, given
    for the whole population) and cut to the block's rows."""
    rows, n_all = _block_rows(block, state.q.shape[0])
    xi, u = noise if noise is not None else (None, None)
    if xi is None:
        xi = torch.randn((n_all,) + tuple(state.q.shape[1:]), generator=generator,
                         dtype=state.q.dtype, device=state.q.device)
    if u is None:
        u = torch.rand(n_all, generator=generator, dtype=DTYPE, device=state.q.device)
    return xi[rows], u[rows]


def _sigma_dot(x: torch.Tensor, cov_chol: torch.Tensor) -> torch.Tensor:
    """Σ x = L (Lᵀ x) for rows of x."""
    return (x @ cov_chol) @ cov_chol.T


def _accepted_state(state, scaling, accepted, accept, q_eval, llk_prop):
    return MetropolisState(
        q=torch.where(accept[:, None], q_eval, state.q),
        llk=torch.where(accept, llk_prop, state.llk),
        scaling=scaling,
        accepted=accepted + accept,
        acc_total=state.acc_total + accept)


@torch.no_grad()
def metropolis_step(logp_fn: Callable, state: MetropolisState, step_idx: int, beta,
                    cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
                    generator: torch.Generator, tune_interval: int = 100,
                    logp_args: tuple = (), proposal=None, noise=None,
                    block=None) -> MetropolisState:
    """One lockstep random-walk transition of all chains at global step
    ``step_idx``.

    ``noise = (z, u)`` injects the proposal's standard-normal draws
    (n, dim) and the accept uniforms (n,) instead of drawing them from
    ``generator`` (torch cannot reproduce JAX's threefry bits, so tests
    feed both packages the same numbers).  ``block``: the state's rows of
    a larger population (module docstring); ``noise`` is then the whole
    population's."""
    with span("metropolis.step"):
        with span("metropolis.propose"):
            proposal = proposal or choose_proposal("MultivariateNormal")
            rows, n_all = _block_rows(block, state.q.shape[0])
            scaling, accepted = state.scaling, state.accepted
            if step_idx > 0 and step_idx % tune_interval == 0:
                scaling = tune_scale(scaling, accepted / tune_interval)
                accepted = torch.zeros_like(accepted)

            z, u = noise if noise is not None else (None, None)
            q_prop = state.q + proposal(generator, n_all, cov_chol, z)[rows] * scaling[:, None]
            in_bounds = torch.all((q_prop >= lower) & (q_prop <= upper), dim=-1)
            q_eval = torch.clamp(q_prop, lower, upper)
        # evaluate clipped into the box; out-of-bounds results are rejected
        llk_prop = logp_fn(q_eval, *logp_args)

        with span("metropolis.accept"):
            if u is None:
                u = torch.rand(n_all, generator=generator, dtype=DTYPE, device=state.q.device)
            log_ratio = beta * (llk_prop - state.llk)
            accept = in_bounds & torch.isfinite(llk_prop) & (torch.log(u[rows]) < log_ratio)
            return _accepted_state(state, scaling, accepted, accept, q_prop, llk_prop)


@torch.no_grad()
def mala_step(logp_fn: Callable, state: MetropolisState, grad: torch.Tensor, step_idx: int,
              beta, cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
              generator: torch.Generator, tune_interval: int = 100, logp_args: tuple = (),
              noise=None, block=None):
    """One lockstep MALA transition (``metropolis.py:165-242``): drift
    ``(ε²/2)·Σ·β∇llk`` plus ``ε·L·ξ`` noise, with the asymmetric-proposal
    correction.  ``grad`` is ∇llk at ``state.q``; returns the new
    ``(state, grad)``.  ``noise = (xi, u)`` injects the (n, dim) normal
    and (n,) uniform draws; ``block`` as for :func:`metropolis_step`."""
    with span("metropolis.step"):
        with span("metropolis.propose"):
            scaling, accepted = _retuned(state, step_idx, tune_interval, MALA_TARGET_ACC)
            xi, u = _draw_pair(generator, state, block, noise)

            beta, beta_col = _beta_pair(beta, state.q)
            eps = scaling[:, None]
            half = 0.5 * eps * eps * beta_col
            mean_fwd = state.q + half * _sigma_dot(grad, cov_chol)
            q_prop = mean_fwd + eps * (xi @ cov_chol.T)
            in_bounds = torch.all((q_prop >= lower) & (q_prop <= upper), dim=-1)
            q_eval = torch.clamp(q_prop, lower, upper)
        llk_prop, grad_prop = value_and_grad(logp_fn, q_eval, logp_args)

        def log_g(x, mean):
            # log N(x; mean, ε²Σ) without the terms symmetric in ε and |Σ|
            z = torch.linalg.solve_triangular(cov_chol, (x - mean).T, upper=False)  # (dim, n)
            return -0.5 * torch.sum((z / eps.T) ** 2, dim=0)

        with span("metropolis.accept"):
            mean_rev = q_eval + half * _sigma_dot(grad_prop, cov_chol)
            log_ratio = (beta * (llk_prop - state.llk)
                         + log_g(state.q, mean_rev) - log_g(q_eval, mean_fwd))
            ok = (in_bounds & torch.isfinite(llk_prop)
                  & torch.all(torch.isfinite(grad_prop), dim=-1))
            accept = ok & (torch.log(u) < log_ratio)
            return (_accepted_state(state, scaling, accepted, accept, q_eval, llk_prop),
                    torch.where(accept[:, None], grad_prop, grad))


@torch.no_grad()
def hmc_step(logp_fn: Callable, state: MetropolisState, grad: torch.Tensor, step_idx: int,
             beta, cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
             generator: torch.Generator, tune_interval: int = 100, logp_args: tuple = (),
             n_leapfrog: int = 10, noise=None, block=None):
    """One lockstep HMC transition (``metropolis.py:249-346``):
    ``n_leapfrog`` leapfrog steps of the tempered Hamiltonian with
    kinetic energy ``½ pᵀ Σ p`` (momenta ``p = L⁻ᵀ ξ ~ N(0, Σ⁻¹)``).  The
    carried gradient is the first half-kick, so a transition costs
    ``n_leapfrog`` value-and-grads.  ``noise = (xi, u)`` injects the
    momentum normals and the accept uniforms; ``block`` as for
    :func:`metropolis_step`."""
    if n_leapfrog < 1:
        raise ValueError(f"HMC needs n_leapfrog >= 1, got {n_leapfrog}")
    def kinetic(p):
        return 0.5 * torch.sum((p @ cov_chol) ** 2, dim=-1)

    with span("metropolis.step"):
        with span("metropolis.propose"):
            scaling, accepted = _retuned(state, step_idx, tune_interval, HMC_TARGET_ACC)
            xi, u = _draw_pair(generator, state, block, noise)
            beta, beta_col = _beta_pair(beta, state.q)
            eps = scaling[:, None]
            kick = eps * beta_col
            p0 = torch.linalg.solve_triangular(cov_chol.T, xi.T, upper=True).T
            k0 = kinetic(p0)
        # half-kick with the carried gradient, then (drift, kick) × n_leapfrog
        p = p0 + 0.5 * kick * grad
        q = state.q
        for _ in range(n_leapfrog):
            q = q + eps * _sigma_dot(p, cov_chol)
            llk_prop, grad_prop = value_and_grad(logp_fn, torch.clamp(q, lower, upper),
                                                 logp_args)
            p = p + kick * grad_prop
        # the loop applied a FULL final kick; take half of it back
        p = p - 0.5 * kick * grad_prop

        with span("metropolis.accept"):
            in_bounds = torch.all((q >= lower) & (q <= upper), dim=-1)
            log_ratio = beta * (llk_prop - state.llk) + k0 - kinetic(p)
            ok = (in_bounds & torch.isfinite(llk_prop)
                  & torch.all(torch.isfinite(grad_prop), dim=-1)
                  & torch.all(torch.isfinite(p), dim=-1))
            accept = ok & (torch.log(u) < log_ratio)
            return (_accepted_state(state, scaling, accepted, accept,
                                    torch.clamp(q, lower, upper), llk_prop),
                    torch.where(accept[:, None], grad_prop, grad))


def run_metropolis_stage(logp_fn: Callable, state: MetropolisState, beta,
                         cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
                         n_steps: int, generator: torch.Generator,
                         proposal_name: str = "MultivariateNormal", tune_interval: int = 100,
                         record_every: int = 1, logp_args: tuple = (), n_leapfrog: int = 10,
                         tune: bool = True, step_offset: int = 0, block=None):
    """
    Advance all chains ``n_steps`` at tempering ``beta`` (a scalar, or
    (n,) per chain) with the random-walk ``proposal_name``, or the
    gradient kernel ``"MALA"`` or ``"HMC"`` (``n_leapfrog`` leapfrog
    steps each).  A gradient kernel re-evaluates the start population's
    llk with its gradient.  The scaling retunes at every
    ``tune_interval``-th global step ``step_offset + i`` (never with
    ``tune=False``).  ``block = (first global row, global chain count)``
    when ``state`` holds one rank's chains of a larger population: the
    draws are the whole population's, cut to these rows.

    Returns the final state and the thinned trace ``(q_trace (n_rec,
    n_chains, dim), llk_trace (n_rec, n_chains))`` on the device: the
    state after every ``record_every``-th step, plus the final state when
    ``n_steps`` is not a multiple of it (every step always runs).
    """
    every = max(int(record_every), 1)
    n_blocks, rem = divmod(n_steps, every)
    n_rec = n_blocks + (1 if rem else 0)
    dev = state.q.device
    beta = torch.as_tensor(beta, dtype=DTYPE, device=dev)
    gradient_kernel = proposal_name in GRADIENT_KERNELS
    if gradient_kernel:
        llk0, grad = value_and_grad(logp_fn, state.q, logp_args)
        state = state._replace(llk=llk0)
    else:
        proposal = choose_proposal(proposal_name)
    q_tr = torch.empty((n_rec,) + tuple(state.q.shape), dtype=state.q.dtype, device=dev)
    llk_tr = torch.empty((n_rec,) + tuple(state.llk.shape), dtype=state.llk.dtype,
                         device=dev)
    rec = 0
    for i in range(n_steps):
        # the steps retune at global indices > 0 that tune_interval divides:
        # index 0 stands for "no retune" when tuning is off
        step = step_offset + i if tune else 0
        if proposal_name == "MALA":
            state, grad = mala_step(logp_fn, state, grad, step, beta, cov_chol, lower, upper,
                                    generator, tune_interval, logp_args, block=block)
        elif gradient_kernel:
            state, grad = hmc_step(logp_fn, state, grad, step, beta, cov_chol, lower, upper,
                                   generator, tune_interval, logp_args, n_leapfrog,
                                   block=block)
        else:
            state = metropolis_step(logp_fn, state, step, beta, cov_chol, lower, upper,
                                    generator, tune_interval, logp_args, proposal=proposal,
                                    block=block)
        if (i + 1) % every == 0 or i + 1 == n_steps:
            q_tr[rec] = state.q
            llk_tr[rec] = state.llk
            rec += 1
    return state, (q_tr, llk_tr)


def metropolis_sample(logp_fn: Callable, lower: np.ndarray, upper: np.ndarray, *, device,
                      n_chains: int = 100, n_steps: int = 10000, burn: float = 0.1,
                      thin: int = 2, scale: float = 1.0,
                      proposal_name: str = "MultivariateNormal", tune_interval: int = 100,
                      seed: int = 0, start: np.ndarray | None = None,
                      cov: np.ndarray | None = None, stage_handler=None,
                      logp_args: tuple = (), n_leapfrog: int = 10):
    """
    Plain (non-staged) adaptive Metropolis sampler at β = 1
    (``metropolis.py:446-503``).  The start population is uniform in the
    box from numpy's ``default_rng(seed)`` unless ``start`` is given;
    the proposal covariance is the prior-width diagonal unless ``cov``
    is given.

    Returns ``(q_trace, llk_trace)`` as numpy after burn-in removal and
    thinning, shapes (n_kept, n_chains, dim) / (n_kept, n_chains); with a
    ``stage_handler`` they are saved as the final stage.
    """
    from beat_tpu_torch.covariance import init_proposal_covariance

    dev = resolve(device)
    lower64 = np.asarray(lower, dtype=np.float64)
    upper64 = np.asarray(upper, dtype=np.float64)
    if start is None:
        start = np.random.default_rng(seed).uniform(lower64, upper64,
                                                    size=(n_chains, lower64.size))
    if cov is None:
        cov = init_proposal_covariance(lower64, upper64)
    cov_chol = torch.as_tensor(np.linalg.cholesky(cov), dtype=DTYPE, device=dev)
    lo = torch.as_tensor(lower64, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper64, dtype=DTYPE, device=dev)
    with torch.no_grad():
        state = init_metropolis_state(logp_fn, torch.as_tensor(start, dtype=DTYPE, device=dev),
                                      logp_args, scale=scale)
    _, (q_tr, llk_tr) = run_metropolis_stage(
        logp_fn, state, 1.0, cov_chol, lo, hi, n_steps=n_steps,
        generator=torch.Generator(device=dev).manual_seed(seed),
        proposal_name=proposal_name, tune_interval=tune_interval, record_every=1,
        logp_args=logp_args, n_leapfrog=n_leapfrog)
    n_burn = int(burn * n_steps)
    q_kept = q_tr[n_burn::thin].cpu().numpy()
    llk_kept = llk_tr[n_burn::thin].cpu().numpy()
    if stage_handler is not None:
        stage_handler.save_stage(-1, {"q": q_kept, "llk": llk_kept},
                                 {"beta": 1.0, "n_steps": n_steps, "burn": burn, "thin": thin})
    return q_kept, llk_kept
