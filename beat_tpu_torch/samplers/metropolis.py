"""
Lockstep adaptive Metropolis (port of ``beat_tpu/samplers/metropolis.py``):
every Markov chain is one row of a device tensor and each step advances
all chains at once.

The step loop runs on the host in Python while every tensor stays on the
device, and nothing inside it waits for the device: the tuning
condition depends on the step index only, and the thinned trace is
recorded into preallocated device tensors that the caller fetches once.

Semantics kept from the JAX package: per-chain adaptive ``scaling``
retuned every ``tune_interval`` global steps with the pymc table; hard
prior bounds (out-of-bounds proposals are evaluated clipped into the
box and then rejected); a finite-llk guard; tempered accept
``log u < β·(llk' − llk)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from beat_tpu_torch.device import DTYPE
from beat_tpu_torch.samplers.base import choose_proposal

_TUNE_TABLE = ((lambda a: a < 0.001, 0.1), (lambda a: a < 0.05, 0.5),
               (lambda a: a < 0.2, 0.9), (lambda a: a > 0.95, 10.0),
               (lambda a: a > 0.75, 2.0), (lambda a: a > 0.5, 1.1))


def tune_scale(scale: torch.Tensor, acc_rate: torch.Tensor) -> torch.Tensor:
    """pymc step-scale tuning (the first matching row wins):

      <0.001: x0.1   <0.05: x0.5   <0.2: x0.9
      >0.95:  x10    >0.75: x2     >0.5:  x1.1
    """
    factors = torch.ones_like(acc_rate)
    for cond, f in reversed(_TUNE_TABLE):
        factors = torch.where(cond(acc_rate), torch.full_like(acc_rate, f), factors)
    return scale * factors


class MetropolisState(NamedTuple):
    """State of all chains (leading axis = chains), on the device."""

    q: torch.Tensor          # (n_chains, dim) current positions
    llk: torch.Tensor        # (n_chains,) current data log-likelihoods
    scaling: torch.Tensor    # (n_chains,) adaptive proposal scale
    accepted: torch.Tensor   # (n_chains,) accepts since the last tune
    acc_total: torch.Tensor  # (n_chains,) accepts in this stage


def init_metropolis_state(logp_fn: Callable, q0: torch.Tensor,
                          logp_args: tuple = ()) -> MetropolisState:
    """Evaluate the start population (n, dim) and build the state."""
    llk0 = logp_fn(q0, *logp_args)
    n = q0.shape[0]
    return MetropolisState(q=q0, llk=llk0,
                           scaling=torch.ones(n, dtype=DTYPE, device=q0.device),
                           accepted=torch.zeros(n, dtype=DTYPE, device=q0.device),
                           acc_total=torch.zeros(n, dtype=DTYPE, device=q0.device))


def metropolis_step(logp_fn: Callable, state: MetropolisState, step_idx: int, beta,
                    cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
                    generator: torch.Generator, tune_interval: int = 100,
                    logp_args: tuple = (), proposal=None, noise=None) -> MetropolisState:
    """One lockstep transition of all chains at global step ``step_idx``.

    ``noise = (z, u)`` injects the proposal's standard-normal draws
    (n, dim) and the accept uniforms (n,) instead of drawing them from
    ``generator`` (torch cannot reproduce JAX's threefry bits, so tests
    feed both packages the same numbers)."""
    proposal = proposal or choose_proposal("MultivariateNormal")
    n = state.q.shape[0]
    scaling, accepted = state.scaling, state.accepted
    if step_idx > 0 and step_idx % tune_interval == 0:
        scaling = tune_scale(scaling, accepted / tune_interval)
        accepted = torch.zeros_like(accepted)

    z, u = noise if noise is not None else (None, None)
    q_prop = state.q + proposal(generator, n, cov_chol, z) * scaling[:, None]
    in_bounds = torch.all((q_prop >= lower) & (q_prop <= upper), dim=-1)
    # evaluate clipped into the box; out-of-bounds results are rejected
    llk_prop = logp_fn(torch.clamp(q_prop, lower, upper), *logp_args)

    if u is None:
        u = torch.rand(n, generator=generator, dtype=DTYPE, device=state.q.device)
    log_ratio = beta * (llk_prop - state.llk)
    accept = in_bounds & torch.isfinite(llk_prop) & (torch.log(u) < log_ratio)

    return MetropolisState(
        q=torch.where(accept[:, None], q_prop, state.q),
        llk=torch.where(accept, llk_prop, state.llk),
        scaling=scaling,
        accepted=accepted + accept,
        acc_total=state.acc_total + accept)


def run_metropolis_stage(logp_fn: Callable, state: MetropolisState, beta,
                         cov_chol: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor,
                         n_steps: int, generator: torch.Generator,
                         proposal_name: str = "MultivariateNormal", tune_interval: int = 100,
                         record_every: int = 1, logp_args: tuple = ()):
    """
    Advance all chains ``n_steps`` at tempering ``beta``.

    Returns the final state and the thinned trace ``(q_trace (n_rec,
    n_chains, dim), llk_trace (n_rec, n_chains))`` on the device: the
    state after every ``record_every``-th step, plus the final state when
    ``n_steps`` is not a multiple of it (every step always runs).
    """
    proposal = choose_proposal(proposal_name)
    every = max(int(record_every), 1)
    n_blocks, rem = divmod(n_steps, every)
    n_rec = n_blocks + (1 if rem else 0)
    beta = torch.as_tensor(beta, dtype=DTYPE, device=state.q.device)
    q_tr = torch.empty((n_rec,) + tuple(state.q.shape), dtype=state.q.dtype,
                       device=state.q.device)
    llk_tr = torch.empty((n_rec,) + tuple(state.llk.shape), dtype=state.llk.dtype,
                         device=state.q.device)
    rec = 0
    for i in range(n_steps):
        state = metropolis_step(logp_fn, state, i, beta, cov_chol, lower, upper, generator,
                                tune_interval, logp_args, proposal=proposal)
        if (i + 1) % every == 0 or i + 1 == n_steps:
            q_tr[rec] = state.q
            llk_tr[rec] = state.llk
            rec += 1
    return state, (q_tr, llk_tr)
