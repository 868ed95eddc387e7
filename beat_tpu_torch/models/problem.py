"""
Problem: priors and composites assembled into one batched
log-likelihood, and the sampler run over it — SMC or single-stage
Metropolis, each with the random walk, MALA or HMC (port of
``beat_tpu/models/problem.py``).
"""

from __future__ import annotations

import logging
import os

from beat_tpu_torch.parameter import PriorSet
from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.device import resolve
from beat_tpu_torch.samplers.metropolis import MetropolisParams, metropolis_sample
from beat_tpu_torch.samplers.smc import SMCParams, smc_sample

logger = logging.getLogger("beat_tpu_torch.models.problem")


class Problem:
    """Sampled parameters (source priors + hyperparameters) and the
    composites whose log-likelihoods sum into ``like``; everything runs
    on ``device``."""

    def __init__(self, priors: PriorSet, composites: dict, *, device,
                 outfolder: str = "out", sampler_params=None):
        self.device = resolve(device)
        self.source_priors = priors
        self.composites = dict(composites)
        self.outfolder = outfolder
        self.sampler_params = sampler_params or SMCParams()

        # full sampled space: source params + hierarchicals + hyperparams
        self.priors = PriorSet()
        for p in priors.parameters.values():
            self.priors.add(p)
        for get in ("get_hierarchical_parameters", "get_hyper_parameters"):
            for comp in self.composites.values():
                for p in getattr(comp, get)():
                    if p.name not in self.priors:
                        self.priors.add(p)

    @property
    def ordering(self):
        return self.priors.ordering

    def logp_data(self) -> tuple:
        """Per-composite device data, passed to ``logp`` as an argument."""
        return tuple(comp.device_data() for comp in self.composites.values())

    def make_logp_fn(self):
        """``(logp, data)``: ``logp(q (C, dim), data) -> (C,)`` total data
        log-likelihood of a batch of chains, and the device data to pass
        as its second argument."""
        ordering = self.ordering
        comps = list(self.composites.values())

        def logp(q, data):
            point = ordering.to_point(q)
            total = 0.0
            for comp, d in zip(comps, data):
                total = total + comp.loglike(point, d)
            return total

        return logp, self.logp_data()

    def sample(self, params=None):
        """Run the configured sampler: ``SMCParams`` → SMC,
        ``MetropolisParams`` → single-stage Metropolis saved as the final
        stage.  Returns the final-stage ``(q_trace, llk_trace)``."""
        params = params or self.sampler_params
        if not isinstance(params, (SMCParams, MetropolisParams)):
            raise NotImplementedError(
                f"{type(params).__name__} waits for a later port slice (ROADMAP: PT); "
                "the port samples with SMCParams or MetropolisParams")
        lower, upper = self.priors.bounds_arrays()
        logp_fn, data = self.make_logp_fn()
        os.makedirs(self.outfolder, exist_ok=True)
        if isinstance(params, SMCParams):
            return smc_sample(logp_fn, lower, upper, params, device=self.device,
                              homepath=self.outfolder, ordering=self.ordering,
                              logp_args=(data,))
        return metropolis_sample(
            logp_fn, lower, upper, device=self.device, n_chains=params.n_chains,
            n_steps=params.n_steps, burn=params.burn, thin=params.thin,
            proposal_name=params.proposal_name, tune_interval=params.tune_interval,
            seed=params.seed, stage_handler=SampleStage(self.outfolder, ordering=self.ordering),
            logp_args=(data,), n_leapfrog=params.n_leapfrog)
