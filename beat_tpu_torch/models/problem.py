"""
Problem: priors and composites assembled into one batched
log-likelihood, and the sampler run over it — SMC, parallel tempering or
single-stage Metropolis, each with any random-walk proposal, MALA or
HMC, or the trans-dimensional Voronoi sampler on a static finite-fault
composite — plus the
hyperparameter-only posterior (``make_hyper_logp_fn``,
``estimate_hypers``) and the between-stage covariance update
(``update_weights``); the results of a finished run — synthetics,
variance reductions, the posterior summary and derived samples — and
:func:`load_model`, the problem of a project directory (port of
``beat_tpu/models/problem.py``).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from beat_tpu_torch import defaults, parallel
from beat_tpu_torch.distributions import hyper_normal
from beat_tpu_torch.parameter import PriorSet
from beat_tpu_torch.backend import SampleStage, summarize_trace
from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.ffi.transd import TransDParams
from beat_tpu_torch.samplers.metropolis import MetropolisParams, metropolis_sample
from beat_tpu_torch.samplers.pt import PTParams, pt_sample
from beat_tpu_torch.samplers.smc import SMCParams, smc_sample

logger = logging.getLogger("beat_tpu_torch.models.problem")


class Problem:
    """Sampled parameters (source priors + hyperparameters) and the
    composites whose log-likelihoods sum into ``like``; everything runs
    on ``device``."""

    def __init__(self, priors: PriorSet, composites: dict, *, device,
                 outfolder: str = "out", sampler_params=None, hyper_sampler_params=None,
                 initialization: str = "random"):
        """``initialization``: 'random' starts SMC from the prior, 'lsq'
        from a population jittered around the composites' non-negative
        least-squares slips (:meth:`_lsq_start`)."""
        if initialization not in ("random", "lsq"):
            raise ValueError(f"initialization {initialization!r} (random|lsq)")
        self.device = resolve(device)
        self.initialization = initialization
        self.source_priors = priors
        self.composites = dict(composites)
        self.outfolder = outfolder
        self.sampler_params = sampler_params or SMCParams()
        self.hyper_sampler_params = hyper_sampler_params

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

    @property
    def hypernames(self) -> list:
        return [name for comp in self.composites.values() for name in comp.get_hypernames()]

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

    def make_hyper_logp_fn(self, fixed_point: dict):
        """``(logp, data)`` of the hyperparameter-only posterior with the
        residuals frozen at ``fixed_point`` (no chain axis).  Composites
        with ``hyper_data`` get their weighted residual norms computed once
        here, so a draw costs O(targets); the others evaluate
        ``hyper_loglike``."""
        ordering = self.ordering
        comps = list(self.composites.values())
        precomp, fallback = [], []
        for ci, comp in enumerate(comps):
            hd = getattr(comp, "hyper_data", None)
            if hd is not None:
                precomp.append(hd(fixed_point))
            else:
                fallback.append(ci)

        def logp(q, data):
            point = ordering.to_point(q)
            n = q.shape[0]
            total = 0.0
            for wrw, pds, ns, names in precomp:
                hs = torch.stack([point[name].reshape(n) if name in point
                                  else torch.zeros(n, dtype=q.dtype, device=q.device)
                                  for name in names], dim=-1)
                total = total + torch.sum(hyper_normal(wrw, pds, hs, ns), dim=-1)
            for ci in fallback:
                total = total + comps[ci].hyper_loglike(point, fixed_point, data[ci])
            return total

        return logp, self.logp_data()

    def sample(self, params=None, update_weights: bool = False):
        """Run the configured sampler: ``SMCParams`` → SMC,
        ``PTParams`` → parallel tempering, ``MetropolisParams`` →
        single-stage Metropolis, each saved as the final stage;
        ``TransDParams`` → the trans-dimensional sampler on the first
        static distributer composite.  ``update_weights`` re-estimates the
        data covariances at each SMC stage's best sample.  Returns the
        final-stage ``(q_trace, llk_trace)``, PT's with its history, the
        trans-dimensional sampler's output dict."""
        params = params or self.sampler_params
        if not isinstance(params, (SMCParams, PTParams, MetropolisParams, TransDParams)):
            raise TypeError(f"unknown sampler parameters {type(params).__name__}")
        if isinstance(params, TransDParams):
            from beat_tpu_torch.models.distributer import (GeodeticDistributerComposite,
                                                           transd_sample_ffi)

            comp = next((c for c in self.composites.values()
                         if isinstance(c, GeodeticDistributerComposite)), None)
            if comp is None:
                raise ValueError("TransD sampling needs a geodetic distributer composite "
                                 "(ffi mode)")
            return transd_sample_ffi(comp, params, homepath=self.outfolder)
        lower, upper = self.priors.bounds_arrays()
        logp_fn, data = self.make_logp_fn()
        os.makedirs(self.outfolder, exist_ok=True)
        mesh = (self._auto_mesh(params.n_chains)
                if isinstance(params, (SMCParams, PTParams)) else None)
        if isinstance(params, SMCParams):
            update_cb = None
            if update_weights:
                def update_cb(map_q):
                    self.update_weights(self.ordering.to_point(map_q))
                    return (self.logp_data(),)
            start = (self._lsq_start(params.n_chains, lower, upper, seed=params.seed)
                     if self.initialization == "lsq" else None)
            return smc_sample(logp_fn, lower, upper, params, device=self.device,
                              homepath=self.outfolder, ordering=self.ordering,
                              logp_args=(data,), update_weights=update_cb, start=start,
                              mesh=mesh)
        if isinstance(params, PTParams):
            return pt_sample(logp_fn, lower, upper, params, device=self.device,
                             homepath=self.outfolder, ordering=self.ordering,
                             logp_args=(data,), mesh=mesh)
        handler = SampleStage(self.outfolder, ordering=self.ordering)
        return metropolis_sample(
            logp_fn, lower, upper, device=self.device, n_chains=params.n_chains,
            n_steps=params.n_steps, burn=params.burn, thin=params.thin,
            proposal_name=params.proposal_name, tune_interval=params.tune_interval,
            seed=params.seed, stage_handler=handler if parallel.is_io_process() else None,
            logp_args=(data,), n_leapfrog=params.n_leapfrog)

    def _auto_mesh(self, n_chains: int):
        """The chain mesh over every rank when more than one exists and
        the chain count divides evenly (``torchrun`` engages it with no
        code change; one rank stays meshless).  With ``WORLD_SIZE > 1`` in
        the environment and no process group yet, this joins it on the
        problem's device type; call ``parallel.init_distributed()`` before
        building the problem instead, so each rank builds on its own card."""
        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            parallel.init_distributed(device=self.device.type)
        n_ranks = parallel.n_ranks()
        if n_ranks <= 1:
            return None
        if n_chains % n_ranks:
            logger.warning("%i chains do not divide %i ranks — running unsharded (pad "
                           "n_chains for chain parallelism)", n_chains, n_ranks)
            return None
        logger.info("Chain-sharding %i chains over %i ranks", n_chains, n_ranks)
        return parallel.make_chain_mesh()

    def _lsq_start(self, n_chains: int, lower, upper, seed: int = 0) -> np.ndarray:
        """Start population (n_chains, dim): the slip components jittered
        around the first composite's ``lsq_solution`` (normal, sd 10 % of
        the prior range, clipped to the bounds), every other parameter
        drawn from the prior.  The solve's host seconds are kept in
        ``self.lsq_seconds``."""
        rng = np.random.default_rng(seed)
        start = rng.uniform(lower, upper, size=(n_chains, lower.size))
        solver = next((c.lsq_solution for c in self.composites.values()
                       if hasattr(c, "lsq_solution")), None)
        if solver is None:
            logger.warning("initialization='lsq' but no composite has an lsq_solution — "
                           "starting from the prior")
            return start
        t0 = time.perf_counter()
        sol = solver()
        self.lsq_seconds = time.perf_counter() - t0
        logger.info("NNLS warm start: %.2f s", self.lsq_seconds)
        for name, values in sol.items():
            if name not in self.ordering.names:
                continue
            sl = self.ordering[name].slc
            scale = 0.1 * (upper[sl] - lower[sl])
            jitter = rng.normal(0.0, scale, size=(n_chains, values.size))
            start[:, sl] = np.clip(values[None, :] + jitter, lower[sl], upper[sl])
            logger.info("LSQ start for %s: mean %.3f", name, values.mean())
        return start

    def estimate_hypers(self, n_steps: int | None = None, n_chains: int | None = None,
                        seed: int = 0) -> dict:
        """A hyperparameter-only Metropolis run at the prior test point,
        which rewrites each hyperparameter's prior bounds to the sampled
        range widened by 1 and rounded outwards, clipped to the registry's
        physical bounds.  Returns ``{name: (lower, upper)}``."""
        hp = self.hyper_sampler_params
        n_steps = n_steps or getattr(hp, "n_steps", None) or 5000
        n_chains = n_chains or getattr(hp, "n_chains", None) or 20
        test_point = self.priors.test_point()
        logp_fn, data = self.make_hyper_logp_fn(test_point)
        lower, upper = self.priors.bounds_arrays()
        # sample only the hyper dimensions: with the residuals frozen the
        # posterior is flat in all others
        slices = {name: self.ordering[name].slc for name in self.hypernames}
        idx = np.concatenate([np.arange(s.start, s.stop) for s in slices.values()])
        test_q = torch.as_tensor(self.point_to_array(test_point), dtype=DTYPE,
                                 device=self.device)
        idx_dev = torch.as_tensor(idx, device=self.device)

        def hyper_only_logp(h, data):
            q = test_q.expand(h.shape[0], -1).clone()
            q[:, idx_dev] = h
            return logp_fn(q, data)

        q_tr, _ = metropolis_sample(hyper_only_logp, lower[idx], upper[idx], device=self.device,
                                    n_chains=n_chains, n_steps=n_steps, burn=0.5, thin=2,
                                    seed=seed, logp_args=(data,))
        samples = q_tr.reshape(-1, q_tr.shape[-1])
        pos, off = {}, 0
        for name, s in slices.items():
            pos[name] = slice(off, off + (s.stop - s.start))
            off += s.stop - s.start
        for name in self.hypernames:
            vals = samples[:, pos[name]]
            par = self.priors.parameters[name]
            phys_lo, phys_hi = defaults.physical_bounds(name)
            par.lower = np.maximum(np.floor(vals.min(axis=0) - 1.0), phys_lo)
            par.upper = np.minimum(np.ceil(vals.max(axis=0) + 1.0), phys_hi)
            par.testvalue = (par.lower + par.upper) / 2.0
            logger.info("Hyper %s bounds -> [%s, %s]", name, par.lower, par.upper)
        return {name: (self.priors.parameters[name].lower, self.priors.parameters[name].upper)
                for name in self.hypernames}

    def point_to_array(self, point: dict) -> np.ndarray:
        """Flatten a (possibly partial) point; the others take their prior
        test values."""
        full = self.priors.test_point()
        full.update(point)
        return self.ordering.to_array(full)

    def update_weights(self, point: dict) -> None:
        for comp in self.composites.values():
            comp.update_weights(point)

    def get_synthetics(self, point: dict) -> dict:
        return {name: comp.get_synthetics(point) for name, comp in self.composites.items()}

    def get_variance_reductions(self, point: dict) -> dict:
        return {name: comp.get_variance_reductions(point)
                for name, comp in self.composites.items()}

    def summarize(self, stage: int = -1) -> dict:
        """The posterior summary of a stage (:func:`~beat_tpu_torch.backend.summarize_trace`)."""
        handler = SampleStage(self.outfolder, ordering=self.ordering)
        return summarize_trace(handler.load_trace(stage))

    def derived_samples(self, stage: int = -1, max_samples: int = 2000) -> dict:
        """Derived variables of up to ``max_samples`` evenly spaced draws
        of a stage: for moment-tensor sources the normalised MT
        components (``<m>_derived``) and both nodal planes; for a
        RectangularSource or a fault's slips the moment magnitude.  The
        moment tensors are computed on the problem's device in one batch,
        the decompositions on the host (:mod:`beat_tpu_torch.mt_utils`)."""
        from beat_tpu_torch import mt_utils
        from beat_tpu_torch.models.seismic import point_getter, source_m6
        from beat_tpu_torch.sources import (MTQTSource, MTSource, RectangularSource,
                                            moment_to_magnitude)

        trace = SampleStage(self.outfolder, ordering=self.ordering).load_trace(stage)
        flat = trace.q_trace.reshape(-1, trace.q_trace.shape[-1])
        idx = np.linspace(0, flat.shape[0] - 1, min(max_samples, flat.shape[0])).astype(int)
        template = fault = None
        for comp in self.composites.values():
            if getattr(comp, "sources", None):
                template = comp.sources[0]
            if hasattr(comp, "fault"):
                fault = comp.fault
        out: dict[str, list] = {}

        def add(name, val):
            out.setdefault(name, []).append(float(val))

        m6s = None
        if isinstance(template, (MTSource, MTQTSource)):
            q = torch.as_tensor(flat[idx], dtype=DTYPE, device=self.device)
            get = point_getter(template, self.ordering.to_point(q), 0, 1, q.shape[0],
                               self.device)
            with torch.no_grad():
                m6s = source_m6(template, get).double().cpu().numpy()
        for j, q in enumerate(flat[idx]):
            point = self.ordering.to_point(q)
            if m6s is not None:
                m6 = m6s[j]
                m6n = m6 / max(mt_utils.scalar_moment(m6), 1e-30)
                for comp_name, v in zip(("mnn", "mee", "mdd", "mne", "mnd", "med"), m6n):
                    add(f"{comp_name}_derived", v)
                (s1, d1, r1), (s2, d2, r2) = mt_utils.both_strike_dip_rake(m6)
                for n_, v in (("strike1", s1), ("dip1", d1), ("rake1", r1),
                              ("strike2", s2), ("dip2", d2), ("rake2", r2)):
                    add(n_, v)
            if isinstance(template, RectangularSource) and "slip" in point:
                area = point.get("length", template.length) * point.get("width", template.width)
                m0 = 33e9 * area * abs(float(np.atleast_1d(point["slip"])[0]))
                add("magnitude", float(moment_to_magnitude(m0)))
            if fault is not None and "uparr" in point:
                slips = np.sqrt(np.asarray(point["uparr"]) ** 2
                                + np.asarray(point.get("uperp", 0.0)) ** 2)
                add("magnitude", fault.magnitude(slips))
        return {k: np.asarray(v) for k, v in out.items()}


def load_model(project_dir: str, mode: str = "geometry", *, device="cuda") -> Problem:
    """The Problem of a project directory's ``mode`` config, on
    ``device`` (the card by default)."""
    from beat_tpu_torch.config import load_config, problem_from_config

    return problem_from_config(load_config(project_dir, mode), project_dir, device=device)
