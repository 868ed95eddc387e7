"""
Distributed-slip (FFI) composites — linear forward models over
precomputed Green's-function libraries (port of
``beat_tpu/models/distributer.py``), batched over a leading chain axis.

The static composite (:class:`GeodeticDistributerComposite`): the LOS
synthetics are ``Σ_c s_c @ G_c`` over the slip components of the
geodetic library, then the per-dataset whitened Gaussian; it also gives
the non-negative least-squares warm start of the slips (``lsq_solution``).

The kinematic composite (:class:`SeismicDistributerComposite`):

    eikonal rupture-onset times from nucleation point + patch velocities
    → index quantisation on the library's (duration, starttime) grid
    → the 5-D library stack, kernels K3/K4, one launch per (wavemap,
      slip component) per evaluation
    → Cholesky-whitened Gaussian likelihood per target

A sampled ``point`` maps parameter names to (C,) tensors, or (C, k) for
vector parameters (``uparr``, ``durations``, ``velocities`` are
(C, npatches)); the likelihood returns (C,).

Station time shifts, the ``spectrum`` domain, per-target hyperparameters
(``hp_specific``) and the hyper-only posterior (``hyper_loglike``,
``hyper_data``) of the kinematic composite wait for a later slice
(ROADMAP: what slice 3 left out), as does ``transd_sample_ffi`` (ROADMAP:
trans-dimensional FFI).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.distributions import multivariate_normal_chol_batched
from beat_tpu_torch.ffi.gflibrary import INTERPOLATIONS
from beat_tpu_torch.models.base import Composite
from beat_tpu_torch.models.geodetic import GeodeticComposite

logger = logging.getLogger("beat_tpu_torch.models.distributer")

_LATER = "a later port slice (ROADMAP: what slice 3 left out)"

#: per-wavemap device arrays (besides the GF libraries)
DEVICE_KEYS = ("data", "weights", "slog_pdets", "nsamples")


class GeodeticDistributerComposite(GeodeticComposite):
    """Static slip inversion: synthetics ``Σ_c s_c @ G_c``.  The datasets,
    weights, hyperparameters, hyper-only posterior and diagnostics are
    the geodetic composite's (without corrections); the library is a
    submodule (``gflibrary``)."""

    def __init__(self, datasets, gflibrary, fault, hp_specific=False, *, device):
        super().__init__(datasets, hp_specific=hp_specific, device=device)
        lib_device = gflibrary.gf(gflibrary.component_names[0]).device
        if lib_device != self.data.device:
            raise ValueError(f"library on {lib_device}, composite on {self.data.device}")
        if (gflibrary.npatches, gflibrary.nsamples) != (fault.npatches, self.stack.samples):
            raise ValueError(f"library is ({gflibrary.npatches}, {gflibrary.nsamples}), "
                             f"expected ({fault.npatches}, {self.stack.samples})")
        self.gflibrary = gflibrary
        self.fault = fault

    def device_data(self) -> dict:
        return dict(super().device_data(), gflib=self.gflibrary)

    def synthetics_los(self, point: dict, data=None) -> torch.Tensor:
        """(C, nsamples) LOS synthetics of a batch of slips."""
        gflib = self.gflibrary if data is None else data["gflib"]
        return gflib.stack_all(**{c: point[c] for c in gflib.component_names if c in point})

    def lsq_solution(self, ridge: float = 0.0) -> dict:
        """Non-negative least-squares slips of the whitened system: the
        library and the weights are read from the device and solved in
        float64 on the host (``scipy.optimize.nnls``).  Returns
        ``{component: (npatches,) slips}``."""
        from scipy.optimize import nnls

        comps = self.gflibrary.component_names
        G = np.concatenate([self.gflibrary.gf(c).double().cpu().numpy().T for c in comps],
                           axis=1)                                     # (nsamples, C·P)
        d = np.asarray(self.stack.displacement, dtype=np.float64)
        Gw, dw = np.empty_like(G), np.empty_like(d)
        for i, slc in enumerate(self.stack.slices):
            W = getattr(self, f"dataset{i}_weights").double().cpu().numpy()
            Gw[slc] = W @ G[slc]
            dw[slc] = W @ d[slc]
        if ridge > 0:
            Gw = np.vstack([Gw, np.sqrt(ridge) * np.eye(Gw.shape[1])])
            dw = np.concatenate([dw, np.zeros(Gw.shape[1])])
        sol, _ = nnls(Gw, dw)
        npatch = self.gflibrary.npatches
        return {c: sol[i * npatch:(i + 1) * npatch] for i, c in enumerate(comps)}


class SeismicDistributerComposite(Composite):
    """Kinematic slip inversion: eikonal onsets, then the library stack.

    The libraries are submodules (``libs[<wavemap index>][<component>]``);
    every per-wavemap array is a registered buffer named
    ``wavemap<i>_<key>``."""

    name = "seismic"

    def __init__(self, wavemaps_libs, fault, slip_varnames=("uparr",),
                 interpolation="multilinear", hp_specific=False, *, device):
        """wavemaps_libs : list of (WaveformMapping, {component: SeismicGFLibrary})"""
        super().__init__()
        dev = resolve(device)
        if interpolation not in INTERPOLATIONS:
            raise NotImplementedError(f"Interpolation {interpolation}")
        if hp_specific:
            raise NotImplementedError(f"hp_specific hyperparameters wait for {_LATER}")
        self.wavemaps = [wmap for wmap, _ in wavemaps_libs]
        self.fault = fault
        self.slip_varnames = list(slip_varnames)
        self.interpolation = interpolation
        self.libs = nn.ModuleList()
        for i, (wmap, libs) in enumerate(wavemaps_libs):
            if wmap.station_corrections or wmap.domain != "time":
                raise NotImplementedError(
                    f"station time shifts and the spectrum domain wait for {_LATER}")
            for comp in self.slip_varnames:
                lib = libs[comp]
                if lib.data.device != dev:
                    raise ValueError(f"wavemap {wmap.name}: library '{comp}' on "
                                     f"{lib.data.device}, composite on {dev}")
                if (lib.ntargets, lib.npatches, lib.nsamples) != (
                        wmap.ntargets, fault.npatches, wmap.nsamples_win):
                    raise ValueError(
                        f"wavemap {wmap.name}: library '{comp}' is {tuple(lib.data.shape)}, "
                        f"expected ({wmap.ntargets}, {fault.npatches}, ·, ·, "
                        f"{wmap.nsamples_win})")
            self.libs.append(nn.ModuleDict({c: libs[c] for c in self.slip_varnames}))
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise()
            for key, arr in self._wavemap_arrays(wmap).items():
                self.register_buffer(f"wavemap{i}_{key}", torch.as_tensor(arr, device=dev))
        logger.info("Seismic distributer composite: %i wavemaps, %i patches",
                    len(self.wavemaps), fault.npatches)

    @staticmethod
    def _wavemap_arrays(wmap) -> dict:
        """Host arrays of one wavemap, keyed as :data:`DEVICE_KEYS`."""
        return {
            "data": wmap.data_fit,
            "weights": np.stack([np.asarray(ds.covariance.chol_inverse, dtype=np.float32)
                                 for ds in wmap.datasets]),
            "slog_pdets": np.asarray([ds.covariance.log_pdet for ds in wmap.datasets],
                                     dtype=np.float32),
            "nsamples": np.full(wmap.ntargets, wmap.nsamples_fit, dtype=np.float32),
        }

    def device_data(self) -> list:
        """One dict per wavemap: its buffers plus its ``libs``."""
        return [dict({key: getattr(self, f"wavemap{i}_{key}") for key in DEVICE_KEYS},
                     libs=self.libs[i])
                for i in range(len(self.wavemaps))]

    def get_hypernames(self):
        return [wmap.hypername for wmap in self.wavemaps]

    # -- forward --------------------------------------------------------------

    def point2starttimes(self, point: dict) -> torch.Tensor:
        """(C, npatches) eikonal onset times of all patches, SI units (m,
        m/s).  Multi-subfault: nucleation coordinates and times are
        (C, nsubfaults), or (C,) shared by all subfaults."""
        velocities = point["velocities"]
        n_chains = velocities.shape[0]
        ordering = self.fault.ordering
        times = []
        for i in range(self.fault.nsubfaults):
            sf = self.fault.get_subfault(i)

            def comp(name, default):
                if name not in point:
                    return torch.full((n_chains,), float(default), dtype=velocities.dtype,
                                      device=velocities.device)
                val = point[name].reshape(n_chains, -1)
                return val[:, i] if val.shape[1] > 1 else val[:, 0]

            times.append(self.fault.point2starttimes(
                i, ordering.vector2subfault(i, velocities),
                comp("nucleation_strike", sf.plane.length / 2.0),
                comp("nucleation_dip", sf.plane.width / 2.0), comp("time", 0.0)))
        return torch.cat(times, dim=1)

    def synthetics_windows(self, point: dict, w_idx: int, data=None,
                           starttimes: torch.Tensor | None = None) -> torch.Tensor:
        """(C, T, nsamples_win) stacked synthetic windows of one wavemap.
        ``starttimes`` (C, npatches) skips the eikonal solve, which does
        not depend on the wavemap."""
        libs = (self.device_data() if data is None else data)[w_idx]["libs"]
        if starttimes is None:
            starttimes = self.point2starttimes(point)
        if "durations" in point:
            durations = point["durations"]
        else:
            durations = torch.ones_like(starttimes)
        # without station time shifts every target sees the patch onsets
        st = starttimes[:, None, :]
        synth = 0.0
        for comp in self.slip_varnames:
            synth = synth + libs[comp].stack_all(durations, st, point[comp],
                                                 self.interpolation)
        return synth

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) data log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        starttimes = self.point2starttimes(point)
        n_chains, device = starttimes.shape[0], starttimes.device
        total = 0.0
        for w_idx, wmap in enumerate(self.wavemaps):
            dev = data[w_idx]
            synth = self.synthetics_windows(point, w_idx, data, starttimes)
            h = (point[wmap.hypername].reshape(n_chains) if wmap.hypername in point
                 else torch.zeros(n_chains, dtype=DTYPE, device=device))
            llks = multivariate_normal_chol_batched(
                dev["data"] - synth, dev["weights"], dev["slog_pdets"],
                h[:, None].expand(n_chains, wmap.ntargets), dev["nsamples"])
            total = total + torch.sum(llks, dim=-1)
        return total

    # -- results ----------------------------------------------------------------

    def _batch_of_one(self, point: dict) -> dict:
        dev = self.wavemap0_data.device
        return {k: torch.as_tensor(np.asarray(v), dtype=DTYPE, device=dev)[None]
                for k, v in point.items()}

    def get_synthetics(self, point: dict) -> dict:
        """``{mapid: (T, nsamples_win) numpy}`` synthetics of one point
        (host values, as a result point holds them)."""
        batched = self._batch_of_one(point)
        return {wmap.mapid: self.synthetics_windows(batched, i)[0].cpu().numpy()
                for i, wmap in enumerate(self.wavemaps)}

    def get_variance_reductions(self, point: dict) -> dict:
        synths = self.get_synthetics(point)
        out = {}
        for wmap in self.wavemaps:
            obs = wmap.data_windows
            res = obs - synths[wmap.mapid]
            out[wmap.mapid] = 1.0 - float((res * res).sum()) / max(float((obs * obs).sum()),
                                                                   1e-30)
        return out
