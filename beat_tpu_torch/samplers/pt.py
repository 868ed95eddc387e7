"""
Parallel tempering (replica exchange) on one device (port of
``beat_tpu/samplers/pt.py``).

All replicas are rows of one ``(n_chains, dim)`` device tensor: a
segment of lockstep Metropolis steps advances every replica at its own
temperature (a per-chain β vector), then one exchange step swaps
neighbouring replicas by a permutation gather.  Host choices (the
start population, the segment lengths) come from the JAX package's
seeded ``numpy.random.Generator`` calls in the same order; the device
draws come from a ``torch.Generator``.

Algorithm points kept from the JAX package (``pt.py:11-26``):

* the β ladder: ``n_chains_posterior`` replicas at β = 1, the rest
  geometric ``β_k = scale^{-k}``;
* the exchange pairs ``(0,1),(2,3)…`` or ``(1,2),(3,4)…`` by alternating
  parity; a pair decides with the log-uniform at its lower index,
  ``log u < (β₂ − β₁)(llk₁ − llk₂)``;
* the ladder scale retunes every ``beta_tune_interval`` posterior
  samples from the acceptance of the edge pair alone (low index
  ``n_post − 1``: the last β = 1 replica and the first tempered one),
  with the inverse-logic table of :func:`tune_temp_scale`.

Nothing inside the segment loop waits for the device: the exchange
counters accumulate on the device and are read only at a retune, and
every β = 1 draw of every segment goes into a device buffer fetched
once at the end.

With a ``mesh`` (:mod:`beat_tpu_torch.parallel`) the ladder is sharded
over the ``chains`` axis: each rank runs its replicas' segments (drawing
for the whole ladder and keeping its rows), the segment's draws are
gathered, and every rank applies the same exchange on the same uniforms
to the whole ladder and keeps its rows.  Only rank 0 writes.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.covariance import init_proposal_covariance
from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.parallel import CHAIN_AXIS, all_gather, axis_size, chain_block, is_io_process
from beat_tpu_torch.profiling import timings
from beat_tpu_torch.samplers.metropolis import init_metropolis_state, run_metropolis_stage

logger = logging.getLogger("beat_tpu_torch.pt")


def tune_temp_scale(scale: float, acc_rate: float) -> float:
    """Inverse-logic tuning of the temperature scale: a low exchange
    acceptance narrows the ladder, a high one widens it."""
    if acc_rate < 0.001:
        scale *= 0.85
    elif acc_rate < 0.05:
        scale *= 0.9
    elif acc_rate < 0.2:
        scale *= 0.95
    elif acc_rate > 0.95:
        scale *= 1.15
    elif acc_rate > 0.75:
        scale *= 1.10
    elif acc_rate > 0.5:
        scale *= 1.05
    return scale


def make_betas(n_chains: int, n_posterior: int, scale: float) -> np.ndarray:
    """The β ladder: ``n_posterior`` ones, then ``1/scale^k``, k = 1, 2, …"""
    n_temp = n_chains - n_posterior
    betas_temp = 1.0 / np.power(scale, np.arange(1, n_temp + 1))
    return np.concatenate([np.ones(n_posterior), betas_temp])


def swap_step(q: torch.Tensor, llk: torch.Tensor, betas: torch.Tensor, log_u: torch.Tensor,
              parity: int) -> tuple:
    """One even/odd adjacent-pair exchange over the β-sorted replicas.

    q (n, dim), llk (n,), betas (n,); ``log_u`` (n,) the log-uniforms (a
    pair reads its lower index's); ``parity`` 0 pairs (0,1),(2,3)…, 1
    pairs (1,2),(3,4)….  Returns ``(q, llk, accepted, proposed)``, the
    last two (n,) booleans marking the pairs' lower ends."""
    n = llk.shape[0]
    idx = torch.arange(n, device=llk.device)
    partner = torch.where((idx - parity) % 2 == 0, idx + 1, idx - 1).clamp(0, n - 1)
    valid = partner != idx
    alpha = (betas[partner] - betas) * (llk - llk[partner])
    low = torch.minimum(idx, partner)
    accept = (log_u[low] < alpha) & valid
    perm = torch.where(accept, partner, idx)
    is_low = idx == low
    return q[perm], llk[perm], accept & is_low, valid & is_low


@dataclass
class PTParams:
    """Parallel-tempering configuration (the JAX package's ``PTParams``)."""

    n_chains: int = 16
    n_samples: int = 20000          # total posterior Metropolis steps
    swap_interval: tuple = (10, 30)  # segment lengths between exchanges
    n_chains_posterior: int = 4
    tune_interval: int = 100
    beta_tune_interval: int = 1000
    t_scale: float = 1.2
    t_scale_min: float = 1.01
    t_scale_max: float = 2.0
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    record_worker_chains: bool = False
    seed: int = 0


def segment_lengths(params: PTParams, rng: np.random.Generator) -> list:
    """The steps of every segment: ``n_samples // mid`` segments, each of
    the low, middle or high length of ``swap_interval`` drawn from
    ``rng`` (the JAX package quantises them so, to bound its compiles)."""
    lo, hi = params.swap_interval
    n_segments = max(1, params.n_samples // ((lo + hi) // 2))
    choices = sorted({int(lo), int((lo + hi) // 2), int(hi)})
    return [int(rng.choice(choices)) for _ in range(n_segments)]


def pt_sample(logp_fn: Callable, lower: np.ndarray, upper: np.ndarray, params: PTParams, *,
              device, homepath: str | None = None, ordering=None,
              start: np.ndarray | None = None, logp_args: tuple = (), mesh=None):
    """
    Run parallel tempering.

    logp_fn : batched ``(q (C, dim), *logp_args) -> (C,)`` data
        log-likelihood on ``device``.
    start : optional (n_chains, dim) start population; default uniform
        over the box from ``default_rng(params.seed)``.
    mesh : optional ``DeviceMesh`` whose ``chains`` axis shards the
        temperature ladder over ranks; ``n_chains`` must be a multiple of
        its size.  Every rank returns the whole result; rank 0 writes.

    Returns ``(q_trace (n_draws, n_post, dim), llk_trace (n_draws,
    n_post), history)`` as numpy: every β = 1 draw of every segment, and
    the ladder's history (``scale_history``, ``swap_acceptance`` at each
    retune, the final ``betas``).  With ``homepath`` the draws are saved
    as the final stage in the JAX package's format, the history and the
    final population in its state (and the tempered replicas' draws,
    ``worker_q``/``worker_llk``, with ``record_worker_chains``).
    """
    dev = resolve(device)
    lower64 = np.asarray(lower, dtype=np.float64)
    upper64 = np.asarray(upper, dtype=np.float64)
    dim = lower64.size
    n, n_post = params.n_chains, params.n_chains_posterior
    if not 1 <= n_post < n:
        raise ValueError(f"need 1 <= n_chains_posterior < n_chains, got {n_post}, {n}")
    n_shards = axis_size(mesh, CHAIN_AXIS)
    if mesh is not None and n % n_shards:
        raise ValueError(f"n_chains={n} must be a multiple of the mesh size {n_shards} "
                         "for temperature-axis sharding")
    rows = chain_block(mesh, n)
    block = None if mesh is None else (rows.start, n)
    rng = np.random.default_rng(params.seed)
    gen = torch.Generator(device=dev).manual_seed(params.seed)
    t_scale = params.t_scale
    betas = make_betas(n, n_post, t_scale)

    if start is None:
        start = rng.uniform(lower64, upper64, size=(n, dim))
    cov = init_proposal_covariance(lower64, upper64)
    cov_chol = torch.as_tensor(np.linalg.cholesky(cov), dtype=DTYPE, device=dev)
    lo = torch.as_tensor(lower64, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper64, dtype=DTYPE, device=dev)
    with torch.no_grad():
        state = init_metropolis_state(
            logp_fn, torch.as_tensor(start, dtype=DTYPE, device=dev)[rows], logp_args)
    seg_lens = segment_lengths(params, rng)
    n_draws = sum(seg_lens)
    post_q = torch.empty((n_draws, n_post, dim), dtype=DTYPE, device=dev)
    post_llk = torch.empty((n_draws, n_post), dtype=DTYPE, device=dev)
    if params.record_worker_chains:
        worker_q = torch.empty((n_draws, n - n_post, dim), dtype=DTYPE, device=dev)
        worker_llk = torch.empty((n_draws, n - n_post), dtype=DTYPE, device=dev)

    betas_dev = torch.as_tensor(betas, dtype=DTYPE, device=dev)
    edge = n_post - 1
    swaps_accepted = torch.zeros((), dtype=torch.int64, device=dev)
    swaps_proposed = torch.zeros((), dtype=torch.int64, device=dev)
    samples_since_tune = 0
    scale_history, swap_acc_history = [t_scale], []
    parity, global_step = 0, 0
    t0 = time.perf_counter()
    for seg_len in seg_lens:
        state, (q_tr, llk_tr) = run_metropolis_stage(
            logp_fn, state, betas_dev[rows], cov_chol, lo, hi, n_steps=seg_len, generator=gen,
            proposal_name=params.proposal_name, tune_interval=params.tune_interval,
            record_every=1, logp_args=logp_args, n_leapfrog=params.n_leapfrog,
            step_offset=global_step, block=block)
        # the whole ladder's draws; the last is the segment's final state
        q_tr = all_gather(q_tr, mesh, CHAIN_AXIS, 1)
        llk_tr = all_gather(llk_tr, mesh, CHAIN_AXIS, 1)
        draws = slice(global_step, global_step + seg_len)
        global_step += seg_len
        post_q[draws] = q_tr[:, :n_post]
        post_llk[draws] = llk_tr[:, :n_post]
        if params.record_worker_chains:
            worker_q[draws] = q_tr[:, n_post:]
            worker_llk[draws] = llk_tr[:, n_post:]

        log_u = torch.log(torch.rand(n, generator=gen, dtype=DTYPE, device=dev))
        q_all, llk_all, accepted, proposed = swap_step(q_tr[-1], llk_tr[-1], betas_dev, log_u,
                                                       parity)
        parity ^= 1
        state = state._replace(q=q_all[rows], llk=llk_all[rows])
        swaps_accepted += accepted[edge]
        swaps_proposed += proposed[edge]
        samples_since_tune += seg_len * n_post

        if samples_since_tune >= params.beta_tune_interval:
            prop_count = int(swaps_proposed)          # the loop's only reads of the device
            acc_rate = int(swaps_accepted) / prop_count if prop_count else 0.0
            t_scale = float(np.clip(tune_temp_scale(t_scale, acc_rate), params.t_scale_min,
                                    params.t_scale_max))
            betas = make_betas(n, n_post, t_scale)
            betas_dev = torch.as_tensor(betas, dtype=DTYPE, device=dev)
            swap_acc_history.append(acc_rate)
            scale_history.append(t_scale)
            samples_since_tune = 0
            swaps_accepted.zero_()
            swaps_proposed.zero_()
            logger.info("PT retune: swap acceptance %.3f -> t_scale %.4f", acc_rate, t_scale)

    q_trace, llk_trace = post_q.cpu().numpy(), post_llk.cpu().numpy()
    timings.add("pt_sampling", time.perf_counter() - t0, n_evals=params.n_samples * n)
    logger.info("PT: %i segments, %i steps in %.2f s", len(seg_lens), n_draws,
                time.perf_counter() - t0)
    history = {"scale_history": np.asarray(scale_history),
               "swap_acceptance": np.asarray(swap_acc_history), "betas": betas}
    if homepath is not None and is_io_process():
        state_extra = {"beta": 1.0, "cov": cov, "population": q_all.cpu().numpy(),
                       "likelihoods": llk_all.cpu().numpy(), "betas": betas,
                       "scale_history": history["scale_history"],
                       "swap_acceptance": history["swap_acceptance"]}
        if params.record_worker_chains:
            state_extra["worker_q"] = worker_q.cpu().numpy()
            state_extra["worker_llk"] = worker_llk.cpu().numpy()
        SampleStage(homepath, ordering=ordering).save_stage(
            -1, {"q": q_trace, "llk": llk_trace}, state_extra)
    return q_trace, llk_trace, history
