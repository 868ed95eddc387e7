"""
Sequential Monte Carlo / transitional MCMC (port of
``beat_tpu/samplers/smc.py``; Ching & Chen 2007).

The stage transitions — β bisection, importance-weighted proposal
covariance, systematic resampling, the log-evidence sum — are host
float64 numpy, copied from the JAX package, with its numpy
``default_rng(seed)`` for the initial population and the resampling.
Each stage's lockstep Metropolis run keeps its state on the device and
is fetched to the host once per stage; the resampled population of the
next stage is gathered on the device from that state (the row gather,
kernel K5), not uploaded again.  Stage checkpoints go through
the port's copy of the JAX package's ``SampleStage``, in the same file
format, so the JAX package's tools read them.

With a ``mesh`` (:mod:`beat_tpu_torch.parallel`) every rank runs the
host loop with the same numpy generator, so β, the weights, the
covariance and the resampling indexes agree; each rank advances its
block of chains (drawing for the whole population and keeping its rows),
the population and its llks are gathered over the ``chains`` axis after
every stage, and each rank gathers its own resampled rows from them with
K5.  Only rank 0 writes.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.covariance import init_proposal_covariance
from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.ops.rowgather import gather_rows
from beat_tpu_torch.parallel import CHAIN_AXIS, all_gather, axis_size, chain_block, is_io_process
from beat_tpu_torch.profiling import TimingRegistry, stage_timer, timings, torch_trace
from beat_tpu_torch.samplers.metropolis import (MetropolisState, init_metropolis_state,
                                                run_metropolis_stage)
from beat_tpu_torch.utility import ensure_cov_psd

logger = logging.getLogger("beat_tpu_torch.smc")


def calc_beta(beta: float, likelihoods: np.ndarray, coef_variation: float = 1.0):
    """
    Bisect the next tempering β so that the coefficient of variation of the
    importance weights equals ``coef_variation``.

    Returns (new_beta, old_beta, normalised weights).
    """
    llks = np.asarray(likelihoods, dtype=np.float64)
    low_beta = beta
    up_beta = 2.0
    current_beta = up_beta
    temp = np.exp((current_beta - beta) * (llks - llks.max()))
    while up_beta - low_beta > 1e-6:
        current_beta = (low_beta + up_beta) / 2.0
        temp = np.exp((current_beta - beta) * (llks - llks.max()))
        cov_temp = np.std(temp) / np.mean(temp)
        if cov_temp > coef_variation:
            up_beta = current_beta
        else:
            low_beta = current_beta
    weights = temp / np.sum(temp)
    return current_beta, beta, weights


def calc_covariance(population: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Importance-weighted proposal covariance with PSD repair."""
    cov = np.cov(population, aweights=weights.ravel(), bias=False, rowvar=False)
    cov = ensure_cov_psd(np.atleast_2d(cov))
    if np.isnan(cov).any() or np.isinf(cov).any():
        raise ValueError("Sample covariance contains NaN/Inf — check hyper bounds")
    return cov


def systematic_resample(weights: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """
    Kitagawa deterministic/systematic resampling: one shared uniform
    offset, children counts via the inverse CDF.  Returns parent indexes
    sorted ascending.
    """
    n = weights.size
    u = (np.arange(n) + rng.random()) / n
    cum = np.cumsum(weights)
    cum[-1] = 1.0  # guard fp round-off
    return np.searchsorted(cum, u).astype(np.int64)


@dataclass
class SMCParams:
    """Sampler configuration (the JAX package's ``SMCParams``)."""

    n_chains: int = 1000
    n_steps: int = 100
    coef_variation: float = 1.0
    tune_interval: int = 25
    proposal_name: str = "MultivariateNormal"
    #: leapfrog steps per transition when proposal_name == "HMC"
    n_leapfrog: int = 10
    stage: int = 0                  # resume stage ('0' fresh, N continue)
    buffer_thinning: int = 1
    rm_flag: bool = False
    max_stages: int = 100
    sample_factor_final_stage: int = 1
    seed: int = 0


def smc_sample(logp_fn: Callable, lower: np.ndarray, upper: np.ndarray, params: SMCParams,
               *, device, homepath: str | None = None, ordering=None,
               logp_args: tuple = (), update_weights: Callable | None = None,
               start: np.ndarray | None = None, mesh=None):
    """
    Run the full SMC sampler.

    logp_fn : batched ``(q (C, dim), *logp_args) -> (C,)`` data
        log-likelihood on ``device``.
    lower, upper : flat prior bounds.
    homepath : stage checkpoint directory (resume supported); None = no IO.
    update_weights : optional ``(map_q (dim,) numpy) -> new logp_args or
        None``, called after every stage but the last at the stage's best
        sample to re-estimate the data covariances; a returned value
        replaces ``logp_args``, and the population's llks are evaluated
        again under it.
    start : optional (n_chains, dim) initial population of a fresh run
        (e.g. jittered around a least-squares solution); default a
        uniform draw from the prior.
    mesh : optional ``DeviceMesh`` whose ``chains`` axis shards the
        chains over ranks (:func:`beat_tpu_torch.parallel.make_chain_mesh`);
        ``n_chains`` must be a multiple of its size.  Every rank returns
        the whole trace; only rank 0 writes stage files.

    Returns the final-stage (β = 1) trace ``(q_trace, llk_trace)`` as numpy.
    """
    n_shards = axis_size(mesh, CHAIN_AXIS)
    if mesh is not None and params.n_chains % n_shards:
        raise ValueError(f"n_chains={params.n_chains} must be a multiple of the mesh size "
                         f"{n_shards} for chain sharding (see pad_chains)")
    dev = resolve(device)
    lower64 = np.asarray(lower, dtype=np.float64)
    upper64 = np.asarray(upper, dtype=np.float64)
    dim = lower64.size
    lo = torch.as_tensor(lower64, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper64, dtype=DTYPE, device=dev)
    rng = np.random.default_rng(params.seed)
    gen = torch.Generator(device=dev).manual_seed(params.seed)
    # every rank reads a resumed state; rank 0 alone writes
    reader = SampleStage(homepath, ordering=ordering) if homepath else None
    handler = reader if is_io_process() else None
    rows = chain_block(mesh, params.n_chains)
    block = None if mesh is None else (rows.start, params.n_chains)

    def gather(x, dim=0):
        return all_gather(x, mesh, CHAIN_AXIS, dim)

    # ---- resume ----
    stage = params.stage
    beta = 0.0
    cov = init_proposal_covariance(lower64, upper64)
    population = likelihoods = None
    log_evidence = 0.0
    if handler is not None and stage == 0 and params.rm_flag:
        handler.rm_all()
    if reader is not None and stage != 0:
        top = reader.highest_sampled_stage()
        if top == -1:
            logger.info("Found complete final stage — nothing to do")
            tr = reader.load_trace(-1)
            return tr.q_trace, tr.llk_trace
        if top >= 0:
            st = reader.load_state(top)
            beta = float(st["beta"])
            cov = np.asarray(st["cov"])
            population = np.asarray(st["population"])
            likelihoods = np.asarray(st["likelihoods"])
            log_evidence = float(st.get("log_evidence", 0.0))
            stage = top + 1
            logger.info("Resuming from stage %i at beta=%.5f", top, beta)
        else:
            stage = 0

    if params.n_chains < 2:
        raise ValueError("SMC needs n_chains >= 2 (population-based sampler); "
                         f"got {params.n_chains}")

    # the current population on the device, beside its float64 host copy
    if population is None:
        if start is None:
            start = rng.uniform(lower64, upper64, size=(params.n_chains, dim))
        population = np.asarray(start, dtype=np.float64)
        if population.shape != (params.n_chains, dim):
            raise ValueError(f"start population {population.shape}, expected "
                             f"({params.n_chains}, {dim})")
        if np.any(population < lower64) or np.any(population > upper64):
            raise ValueError("Start population outside prior bounds — chains "
                             "could never re-enter the support")
        q_dev = torch.as_tensor(population, dtype=DTYPE, device=dev)
        with torch.no_grad():
            llk_dev = gather(init_metropolis_state(logp_fn, q_dev[rows], logp_args=logp_args).llk)
        likelihoods = llk_dev.double().cpu().numpy()
        if not np.isfinite(likelihoods).all():
            raise ValueError("NaN/Inf in initial likelihood evaluation — "
                             "invalid model or start outside prior bounds")
        if handler is not None:
            handler.save_stage(0, {"q": population[None], "llk": likelihoods[None]},
                               {"beta": 0.0, "cov": cov, "population": population,
                                "likelihoods": likelihoods, "stage": 0})
        stage = max(stage, 1)
    else:
        q_dev = torch.as_tensor(population, dtype=DTYPE, device=dev)
        llk_dev = torch.as_tensor(likelihoods, dtype=DTYPE, device=dev)

    # stage checkpoints are written by one background thread, in order,
    # overlapping the compressed npz writes with the next stage's device
    # work (as the JAX package does); every write is joined before return
    saver = ThreadPoolExecutor(max_workers=1, thread_name_prefix="smc_stage_saver")
    timings_mark = len(timings.records)   # this run's records only (per-stage timings)
    saves = []
    acceptance = []
    try:
        while beta < 1.0 and stage < params.max_stages:
            new_beta, old_beta, weights = calc_beta(beta, likelihoods, params.coef_variation)
            final_stage = new_beta >= 1.0
            if final_stage:
                new_beta = 1.0
                weights_final = np.exp((1.0 - old_beta) * (likelihoods - likelihoods.max()))
                weights = weights_final / weights_final.sum()
            # evidence increment log S_j from the PRE-resampling population
            d_beta = new_beta - old_beta
            log_evidence += d_beta * likelihoods.max() + float(np.log(np.mean(
                np.exp(d_beta * (likelihoods - likelihoods.max())))))

            cov = calc_covariance(population, weights)
            resampling_idx = systematic_resample(weights, rng)
            population = population[resampling_idx]
            likelihoods = likelihoods[resampling_idx]

            n_steps = params.n_steps * (params.sample_factor_final_stage if final_stage else 1)
            logger.info("Stage %i: beta %.6f -> %.6f, %i steps x %i chains",
                        stage, old_beta, new_beta, n_steps, params.n_chains)

            n = rows.stop - rows.start
            idx_dev = torch.as_tensor(resampling_idx, device=dev)[rows]
            state = MetropolisState(
                q=gather_rows(q_dev, idx_dev), llk=llk_dev[idx_dev],
                scaling=torch.ones(n, dtype=DTYPE, device=dev),
                accepted=torch.zeros(n, dtype=DTYPE, device=dev),
                acc_total=torch.zeros(n, dtype=DTYPE, device=dev))
            cov_chol = torch.as_tensor(np.linalg.cholesky(cov), dtype=DTYPE, device=dev)
            with stage_timer(f"smc_stage_{-1 if final_stage else stage}",
                             n_evals=n_steps * params.n_chains,
                             beta=round(float(new_beta), 6)), torch_trace():
                final, (q_tr, llk_tr) = run_metropolis_stage(
                    logp_fn, state, new_beta, cov_chol, lo, hi, n_steps=n_steps, generator=gen,
                    proposal_name=params.proposal_name, tune_interval=params.tune_interval,
                    record_every=params.buffer_thinning, logp_args=logp_args,
                    n_leapfrog=params.n_leapfrog, block=block)
                # the whole population on every rank, then one device->host
                # fetch per stage (it ends the stage's timing)
                q_dev, llk_dev = gather(final.q), gather(final.llk)
                population = q_dev.double().cpu().numpy()
                likelihoods = llk_dev.double().cpu().numpy()
            acc_rate = float(gather(final.acc_total).mean().item() / n_steps)
            q_host, llk_host = gather(q_tr, 1).cpu().numpy(), gather(llk_tr, 1).cpu().numpy()
            acceptance.append(acc_rate)
            beta = new_beta
            logger.info("Stage %i done: acceptance %.3f, max llk %.2f, "
                        "log evidence so far %.3f",
                        stage, acc_rate, likelihoods.max(), log_evidence)

            if handler is not None:
                saves.append(saver.submit(
                    handler.save_stage, -1 if final_stage else stage,
                    {"q": q_host, "llk": llk_host},
                    {"beta": beta, "cov": cov, "population": population,
                     "likelihoods": likelihoods, "stage": stage,
                     "resampling_indexes": resampling_idx,
                     "acceptance": np.asarray(acceptance),
                     "log_evidence": np.float64(log_evidence)}))

            if final_stage:
                for f in saves:
                    f.result()
                if handler is not None:
                    TimingRegistry(records=timings.records[timings_mark:]).dump(
                        os.path.join(homepath, "timings.json"))
                return q_host, llk_host
            if update_weights is not None:
                new_args = update_weights(population[int(np.argmax(likelihoods))])
                if new_args is not None:
                    logp_args = tuple(new_args)
                with torch.no_grad():
                    llk_dev = gather(logp_fn(q_dev[rows], *logp_args))
                likelihoods = llk_dev.double().cpu().numpy()
            stage += 1
        for f in saves:
            f.result()
    finally:
        saver.shutdown(wait=True)
    raise RuntimeError(f"SMC did not reach beta=1 within {params.max_stages} stages")

