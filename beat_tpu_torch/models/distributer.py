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
(C, npatches)); the likelihood returns (C,).  Per-target station time
shifts (``<mapid>_<station>_time_shift``, the hierarchicals of a wavemap
with ``station_corrections``) are subtracted from the onsets of their
target, so the stack takes (C, T, P) onsets; a ``spectrum`` wavemap fits
the amplitude spectra of the stacked windows; ``hp_specific`` gives every
target its own noise hyperparameter.  ``library_dtype=torch.bfloat16``
keeps the libraries in bfloat16 (half the memory), summed in float32.

:func:`transd_sample_ffi` runs the trans-dimensional Voronoi sampler
(:mod:`beat_tpu_torch.ffi.transd`) on a static composite.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.distributions import multivariate_normal_chol_batched
from beat_tpu_torch.ffi.gflibrary import INTERPOLATIONS
from beat_tpu_torch.models.base import Composite, wavemap_hyper_terms
from beat_tpu_torch.models.geodetic import GeodeticComposite
from beat_tpu_torch.models.seismic import batched_point
from beat_tpu_torch.ops.cplx import amplitude_spectrum

logger = logging.getLogger("beat_tpu_torch.models.distributer")


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
    ``wavemap<i>_<key>`` (a ``spectrum`` wavemap also has its rfft bases
    ``fit_basis_c``, ``fit_basis_s``).

    library_dtype : the libraries' storage type; a library in another
        type is converted on its device (``SeismicGFLibrary.to_dtype``).
        ``None`` reads ``BEAT_TPU_STACK_DTYPE`` as the JAX composite does:
        ``bfloat16`` stores every library in bfloat16 (half the memory; the
        stack sums in float32), any other value or none keeps each as it
        comes.  An explicit type wins over the variable.  The JAX package's ``BEAT_TPU_STACK_KEEP_DATA`` has no
        counterpart: the port keeps one layout, the natural (T, P, D, S, N)
        array the kernels read, so there is no second copy to drop."""

    name = "seismic"

    def __init__(self, wavemaps_libs, fault, slip_varnames=("uparr",),
                 interpolation="multilinear", hp_specific=False, *, device,
                 library_dtype: torch.dtype | None = None):
        """wavemaps_libs : list of (WaveformMapping, {component: SeismicGFLibrary})"""
        super().__init__()
        dev = resolve(device)
        if interpolation not in INTERPOLATIONS:
            raise NotImplementedError(f"Interpolation {interpolation}")
        if library_dtype is None and os.environ.get("BEAT_TPU_STACK_DTYPE") == "bfloat16":
            library_dtype = torch.bfloat16    # beat_tpu/models/distributer.py:185-188
        self.wavemaps = [wmap for wmap, _ in wavemaps_libs]
        self.fault = fault
        self.slip_varnames = list(slip_varnames)
        self.interpolation = interpolation
        self.hp_specific = hp_specific
        self.libs = nn.ModuleList()
        self._keys = []
        for i, (wmap, libs) in enumerate(wavemaps_libs):
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
            self.libs.append(nn.ModuleDict({
                c: (libs[c] if library_dtype in (None, libs[c].data.dtype)
                    else libs[c].to_dtype(library_dtype)) for c in self.slip_varnames}))
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise()
            arrays = self._wavemap_arrays(wmap)
            self._keys.append(tuple(arrays))
            for key, arr in arrays.items():
                self.register_buffer(f"wavemap{i}_{key}", torch.as_tensor(arr, device=dev))
        logger.info("Seismic distributer composite: %i wavemaps, %i patches",
                    len(self.wavemaps), fault.npatches)

    @staticmethod
    def _wavemap_arrays(wmap) -> dict:
        """Host arrays of one wavemap: the fit-space data, weights and
        log-determinants, the samples per target, and the rfft bases of a
        ``spectrum`` wavemap."""
        arrays = {
            "data": wmap.data_fit,
            "weights": np.stack([np.asarray(ds.covariance.chol_inverse, dtype=np.float32)
                                 for ds in wmap.datasets]),
            "slog_pdets": np.asarray([ds.covariance.log_pdet for ds in wmap.datasets],
                                     dtype=np.float32),
            "nsamples": np.full(wmap.ntargets, wmap.nsamples_fit, dtype=np.float32),
        }
        if wmap.domain == "spectrum":
            arrays["fit_basis_c"], arrays["fit_basis_s"] = wmap.fit_basis()
        return arrays

    def device_data(self) -> list:
        """One dict per wavemap: its buffers plus its ``libs``."""
        return [dict({key: getattr(self, f"wavemap{i}_{key}") for key in self._keys[i]},
                     libs=self.libs[i])
                for i in range(len(self.wavemaps))]

    # -- hyperparameters and hierarchicals ------------------------------------

    def get_hypernames(self):
        if self.hp_specific:
            return [f"{w.hypername}_{i}" for w in self.wavemaps for i in range(w.ntargets)]
        return [wmap.hypername for wmap in self.wavemaps]

    def get_hierarchical_names(self):
        return [name for wmap in self.wavemaps for name in wmap.time_shift_names()]

    def _hyper_vector(self, point, wmap, n_chains, device) -> torch.Tensor:
        """(C, T) noise hyperparameters of one wavemap's targets."""
        def h(name):
            return (point[name].reshape(n_chains) if name in point
                    else torch.zeros(n_chains, dtype=DTYPE, device=device))

        if self.hp_specific:
            return torch.stack([h(f"{wmap.hypername}_{i}") for i in range(wmap.ntargets)],
                               dim=-1)
        return h(wmap.hypername)[:, None].expand(n_chains, wmap.ntargets)

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
        # every target sees the patch onsets, less its station's time shift
        st = starttimes[:, None, :]
        names = self.wavemaps[w_idx].time_shift_names()
        if names:
            shifts = torch.stack([point[n].reshape(-1) for n in names], dim=-1)   # (C, T)
            st = st - shifts[:, :, None]
        synth = 0.0
        for comp in self.slip_varnames:
            synth = synth + libs[comp].stack_all(durations, st, point[comp],
                                                 self.interpolation)
        return synth

    def synthetics_fit(self, point: dict, w_idx: int, data=None,
                       starttimes: torch.Tensor | None = None) -> torch.Tensor:
        """(C, T, nsamples_fit) synthetics of one wavemap in fit space:
        the windows, or their amplitude spectra for ``domain='spectrum'``."""
        dev = (self.device_data() if data is None else data)[w_idx]
        wins = self.synthetics_windows(point, w_idx, data, starttimes)
        if self.wavemaps[w_idx].domain == "spectrum":
            return amplitude_spectrum(wins, dev["fit_basis_c"], dev["fit_basis_s"])
        return wins

    def _loglike(self, point: dict, synths: list, data: list) -> torch.Tensor:
        ref = next(iter(point.values()))
        total = 0.0
        for w_idx, (synth, wmap) in enumerate(zip(synths, self.wavemaps)):
            dev = data[w_idx]
            llks = multivariate_normal_chol_batched(
                dev["data"] - synth, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap, ref.shape[0], ref.device), dev["nsamples"])
            total = total + torch.sum(llks, dim=-1)
        return total

    def _synthetics_fit_all(self, point: dict, data: list) -> list:
        starttimes = self.point2starttimes(point)
        return [self.synthetics_fit(point, w, data, starttimes)
                for w in range(len(self.wavemaps))]

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) data log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        return self._loglike(point, self._synthetics_fit_all(point, data), data)

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None) -> torch.Tensor:
        """(C,) log-likelihood of the chains' hyperparameters with the
        residuals of one ``fixed_point`` (no chain axis)."""
        data = self.device_data() if data is None else data
        ref = next(iter(point.values()))
        with torch.no_grad():
            synths = self._synthetics_fit_all(batched_point(fixed_point, ref.device), data)
        return self._loglike(point, synths, data)

    def hyper_data(self, fixed_point: dict, data=None) -> tuple:
        """The fixed-residual terms of the hyper-only posterior at
        ``fixed_point`` (no chain axis): one stack, after which a draw of
        the hyperparameters costs O(targets)
        (:func:`~beat_tpu_torch.models.base.wavemap_hyper_terms`)."""
        data = self.device_data() if data is None else data
        with torch.no_grad():
            synths = self._synthetics_fit_all(batched_point(fixed_point,
                                                            data[0]["data"].device), data)
        return wavemap_hyper_terms(data, [s[0] for s in synths], self.wavemaps,
                                   self.hp_specific)

    # -- results ----------------------------------------------------------------

    def get_synthetics(self, point: dict) -> dict:
        """``{mapid: (T, nsamples_win) numpy}`` synthetic windows of one
        point (host values, as a result point holds them)."""
        batched = batched_point(point, self.wavemap0_data.device)
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


def transd_sample_ffi(composite, params, slip_varname: str | None = None,
                      value_bounds: tuple | None = None, homepath: str | None = None,
                      logp_args=None) -> dict:
    """
    Trans-dimensional Voronoi slip inversion on a static distributer
    composite: node birth/death RJ-MCMC over the fault plane, the patch
    slips the values of the nearest active nodes
    (:func:`~beat_tpu_torch.ffi.transd.transd_sample`), on the
    composite's device.

    A multi-subfault fault is unrolled into one along-strike atlas:
    subfault ``i`` spans ``[Σ_{j<i} length_j, Σ_{j≤i} length_j]`` along
    strike with its own down-dip coordinate, so one node field spans the
    fault.  ``value_bounds`` defaults to the registry bounds of the slip
    component; with ``homepath`` the kept slip trace is saved as the
    final stage (per-patch ordering of the component).

    Returns the sampler's output dict (k_trace, slip_trace, ...).
    """
    from beat_tpu_torch.ffi.transd import transd_sample
    from beat_tpu_torch.parameter import Parameter

    fault = composite.fault
    comp = slip_varname or composite.gflibrary.component_names[0]
    if value_bounds is None:
        par = Parameter.from_defaults(comp)
        value_bounds = (float(np.atleast_1d(par.lower)[0]), float(np.atleast_1d(par.upper)[0]))
    # the subfaults laid end to end along strike, in the fault's
    # subfault-major patch order
    sfs = [fault.get_subfault(i) for i in range(fault.nsubfaults)]
    s_off = np.concatenate([[0.0], np.cumsum([sf.plane.length for sf in sfs])])
    centers = np.concatenate([sf.patch_centers_local() + np.array([s_off[i], 0.0])
                              for i, sf in enumerate(sfs)])
    args = logp_args if logp_args is not None else (composite.device_data(),)

    def logp(slips, data):
        return composite.loglike({comp: slips}, data)

    out = transd_sample(
        logp, centers[:, 0], centers[:, 1], extent_s=(0.0, float(s_off[-1])),
        extent_d=(0.0, max(float(sf.plane.width) for sf in sfs)),
        value_bounds=value_bounds, params=params, device=composite.data.device,
        logp_args=args)
    if homepath is not None:
        from beat_tpu_torch.backend import SampleStage
        from beat_tpu_torch.utility import Ordering

        handler = SampleStage(homepath, ordering=Ordering([(comp, (fault.npatches,))]))
        handler.save_stage(-1, {"q": out["slip_trace"], "llk": out["llk_trace"]},
                           {"beta": 1.0, "k_trace": out["k_trace"],
                            "accept_rate": out["accept_rate"]})
    return out

