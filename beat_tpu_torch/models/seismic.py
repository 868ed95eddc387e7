"""
Seismic geometry composite: waveform likelihood of point and finite
sources through GF-table synthesis (port of
``beat_tpu/models/seismic.py``), batched over a leading chain axis.

A sampled ``point`` maps parameter names to (C,) tensors — or (C, k)
for vector parameters, as ``Ordering.to_point`` returns them; the
likelihood returns (C,).  The diagnostics (:meth:`get_synthetics` and
the others) take one point without a chain axis and return numpy, as
the JAX package's do.

Every source type of :mod:`beat_tpu_torch.sources` synthesizes through
``GreensTable.point_spectra`` (kernel K1c; K2c is its backward).  A
source made of K point sources — the two couples of a DoubleDC, the
ring of a Ringfault, the patches of a finite rectangle — passes them to
``point_spectra`` as one more leading axis, so one evaluation is still
one K1c launch per table and source, and each sub-source's onset
phasor is applied in the sum over that axis (:func:`summed_point_spectra`).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
from torch import nn

from beat_tpu_torch.covariance import (Covariance, non_toeplitz_covariance,
                                       seismic_cov_velocity_models)
from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.distributions import multivariate_normal_chol_batched
from beat_tpu_torch.heart.taper import stf_spectrum_pair
from beat_tpu_torch.models.base import Composite, wavemap_hyper_terms
from beat_tpu_torch.ops.cplx import amplitude_spectrum, cexp, cmul, from_np_complex
from beat_tpu_torch.profiling import span
from beat_tpu_torch.sources import (SQRT2, CLVDSource, DCSource, DoubleDCSource,
                                    ExplosionSource, MTQTSource, MTSource, RectangularSource,
                                    RingfaultSource, magnitude_to_moment, matrix_to_m6,
                                    mtqt_to_m6, rectangular_patch_grid, sdr_to_m6)

logger = logging.getLogger("beat_tpu_torch.models.seismic")

M6_NAMES = ("mnn", "mee", "mdd", "mne", "mnd", "med")

def point_getter(template, point: dict, idx: int, n_sources: int, n_chains: int, device,
                 dtype=DTYPE):
    """Accessor for source ``idx``'s parameters as (C,) tensors: sampled
    values override the template's attributes (``dtype`` theirs)."""

    def get(name):
        if name in point:
            val = point[name]
            if val.dim() > 1 and n_sources > 1:
                return val[:, idx]
            return val.reshape(n_chains)
        return torch.full((n_chains,), float(getattr(template, name)), dtype=dtype,
                          device=device)

    return get


def offset_getter(get, de: float, dn: float, dtim: float):
    """Wrap a getter so position and time reads are shifted by the
    wavemap's event offset (multi-event: source coordinates are relative
    to each event's own origin)."""
    if de == 0.0 and dn == 0.0 and dtim == 0.0:
        return get
    off = {"east_shift": de, "north_shift": dn, "time": dtim}

    def get_offset(name):
        v = get(name)
        return v + off[name] if name in off else v

    return get_offset


def double_dc_m6_pair(get) -> tuple:
    """The two (C, 6) double couples of a DoubleDCSource, the moment split
    by ``mix``."""
    m0 = magnitude_to_moment(get("magnitude"))
    mix = get("mix")
    return (sdr_to_m6(get("strike1"), get("dip1"), get("rake1"), (1.0 - mix) * m0),
            sdr_to_m6(get("strike2"), get("dip2"), get("rake2"), mix * m0))


def double_dc_sub_sources(get) -> tuple:
    """The two separated point DCs of a DoubleDCSource: ``(m6 (C, 2, 6),
    d_east, d_north, d_depth, d_time (C, 2))``.  The couples sit at
    ±distance/2 along ``azimuth``; the second is also offset by
    ``delta_depth`` and ``delta_time``."""
    m1, m2 = double_dc_m6_pair(get)
    az = torch.deg2rad(get("azimuth"))
    de = get("distance") / 2.0 * torch.sin(az)
    dn = get("distance") / 2.0 * torch.cos(az)
    zero = torch.zeros_like(de)
    return (torch.stack([m1, m2], dim=1), torch.stack([-de, de], dim=1),
            torch.stack([-dn, dn], dim=1), torch.stack([zero, get("delta_depth")], dim=1),
            torch.stack([zero, get("delta_time")], dim=1))


def source_m6(template, get) -> torch.Tensor:
    """(C, 6) NED moment tensors of a point source from the getter."""
    if isinstance(template, MTSource):
        comps = torch.stack([get(n) for n in M6_NAMES], dim=-1)
        # Frobenius scalar moment: off-diagonals count twice
        norm = torch.sqrt(torch.sum(comps[:, :3] ** 2, dim=-1)
                          + 2.0 * torch.sum(comps[:, 3:] ** 2, dim=-1)) / SQRT2
        return (comps / torch.clamp(norm, min=1e-20)[:, None]
                * magnitude_to_moment(get("magnitude"))[:, None])
    if isinstance(template, MTQTSource):
        return mtqt_to_m6(get("w"), get("v"), get("kappa"), get("sigma"), get("h"),
                          get("magnitude"))
    if isinstance(template, DCSource):
        return sdr_to_m6(get("strike"), get("dip"), get("rake"),
                         magnitude_to_moment(get("magnitude")))
    if isinstance(template, ExplosionSource):
        m0 = (magnitude_to_moment(get("magnitude")) if template.magnitude is not None
              else 33e9 * get("volume_change"))
        zero = torch.zeros_like(m0)
        return torch.stack([m0, m0, m0, zero, zero, zero], dim=-1)
    if isinstance(template, CLVDSource):
        az, di = torch.deg2rad(get("azimuth")), torch.deg2rad(get("dip"))
        a = torch.stack([torch.cos(az) * torch.cos(di), torch.sin(az) * torch.cos(di),
                         torch.sin(di)], dim=-1)
        m = a[:, :, None] * a[:, None, :] - torch.eye(3, device=a.device) / 3.0
        m = (m / torch.sqrt(torch.sum(m * m, dim=(-2, -1)) / 2.0)[:, None, None]
             * magnitude_to_moment(get("magnitude"))[:, None, None])
        return matrix_to_m6(m)
    if isinstance(template, DoubleDCSource):
        m1, m2 = double_dc_m6_pair(get)
        return m1 + m2          # co-located sum; the waveforms split them
    raise NotImplementedError(f"m6 for {type(template).__name__}")


def summed_point_spectra(table, m6, east_shift, north_shift, depth, onset, duration,
                         station_east, station_north, comp_idx, stf_type="HalfSinusoid",
                         filter_response=None):
    """Spectra (C, T, nf, 2) of sources made of K point sources sharing
    one STF: m6 (C, K, 6), positions and onsets (C, K), duration (C,).

    One ``point_spectra`` call (one K1c launch) over (K, C, T) queries:
    a tile of K1c's queries then holds chains of one sub-source (6 %
    faster on the card than (C, K, T), whose tiles hold the 40 patches of
    one or two chains; ``PERF.md``).  Each sub-source's onset phasor is
    applied inside the sum over K, one complex product and one
    reduction, so no more than one (K, C, T, nf) temporary exists besides
    K1c's output."""
    spec = table.point_spectra(m6.transpose(0, 1), east_shift.t(), north_shift.t(),
                               depth.t(), station_east, station_north, comp_idx)
    arg = -2.0 * math.pi * onset.t()[..., None] * table.freqs
    phasor = torch.complex(torch.cos(arg), torch.sin(arg))                  # (K, C, nf)
    summed = torch.sum(torch.view_as_complex(spec.contiguous()) * phasor[..., None, :], dim=0)
    factor = torch.view_as_complex(
        stf_spectrum_pair(table.freqs, duration, stf_type).contiguous())[:, None, :]
    if filter_response is not None:
        factor = factor * torch.view_as_complex(filter_response.contiguous())
    return torch.view_as_real(summed * factor)


def finite_rectangular_spectra(table, get, station_east, station_north, comp_idx,
                               stf_type, filter_response, n_patches=(4, 4),
                               anchor: str = "top"):
    """Spectra (C, T, nf, 2) of RectangularSources: the plane cut into a
    fixed ``n_patches`` grid of point DCs, each with 1/npatch of the
    moment (at the table's rigidity) and the onset of a constant-velocity
    rupture from the nucleation point (``nucleation_x`` ∈ [-1, 1] along
    strike from the center, ``nucleation_y`` ∈ [-1, 1] down dip, -1 the
    top edge)."""
    length, width, time0, slip = get("length"), get("width"), get("time"), get("slip")
    velocity = torch.clamp(get("velocity"), min=1.0)
    duration = torch.clamp(get("duration"), min=1e-3)
    m0_total = table.rho * table.vs**2 * length * width * slip
    np_l, np_w = n_patches
    east_p, north_p, depth_p, along, down = rectangular_patch_grid(
        get("strike"), get("dip"), length, width, get("east_shift"), get("north_shift"),
        get("depth"), np_l, np_w, anchor=anchor)
    nuc_along = (get("nucleation_x") * length / 2.0)[:, None]
    nuc_down = ((get("nucleation_y") + 1.0) / 2.0 * width)[:, None]
    rupture_dist = torch.sqrt((along - nuc_along) ** 2 + (down - nuc_down) ** 2)
    onset = time0[:, None] + rupture_dist / velocity[:, None]
    m6 = sdr_to_m6(get("strike"), get("dip"), get("rake"), m0_total / (np_l * np_w))
    return summed_point_spectra(table, m6[:, None, :].expand(-1, np_l * np_w, -1), east_p,
                                north_p, depth_p, onset, duration, station_east,
                                station_north, comp_idx, stf_type, filter_response)


def recommended_finite_patches(length: float, width: float, fmax: float,
                               velocity: float = 2800.0) -> tuple:
    """Minimum (n_length, n_width) grid that resolves the filter band: the
    rupture-onset step across one patch stays below a quarter of the
    shortest period 1/fmax."""
    def n_for(size):
        return max(2, int(np.ceil(4.0 * float(size) * float(fmax) / max(float(velocity), 1.0))))

    return n_for(length), n_for(width)


def batched_point(point: dict, device) -> dict:
    """A point without a chain axis (numbers or arrays) as one chain."""
    return {k: torch.as_tensor(np.asarray(v), dtype=DTYPE, device=device)[None]
            for k, v in point.items()}


class SeismicGeometryComposite(Composite):
    """Waveform likelihood for point- and finite-source geometry
    inversion.

    The GF tables are submodules (shared tables once); every per-wavemap
    array is a registered buffer named ``wavemap<i>_<key>``.

    finite_patches : (n_length, n_width) grid of a RectangularSource.
    n_events : multi-event problems give source ``k`` to event ``k``; a
        wavemap synthesizes only ``sources[wavemap.event_idx]``, offset
        by its event's position and time.
    hp_specific : one noise hyperparameter per target, not per wavemap.
    noise_analyser : the structure of the data covariances; a
        ``non-toeplitz`` one is re-estimated from the residuals at
        :meth:`update_weights`.
    ensemble_tables : GF tables of perturbed earth models, whose spread
        of synthetics becomes the prediction covariance ``pred_v`` at
        :meth:`update_weights`.
    """

    name = "seismic"

    def __init__(self, wavemaps, sources, stf_type="HalfSinusoid", hp_specific=False,
                 noise_analyser=None, finite_patches=(4, 4), n_events=1,
                 ensemble_tables=None, *, device):
        super().__init__()
        dev = resolve(device)
        self.wavemaps = list(wavemaps)
        self.sources = list(sources)
        self.stf_type = stf_type
        self.hp_specific = hp_specific
        self.noise_analyser = noise_analyser
        self.finite_patches = tuple(finite_patches)
        self.n_events = int(n_events)
        self.ensemble_tables = nn.ModuleList(ensemble_tables or [])
        if self.n_events > 1:
            if len(self.sources) != self.n_events:
                raise ValueError(f"multi-event problems need one source per event: "
                                 f"{len(self.sources)} sources, {self.n_events} events")
            for wmap in self.wavemaps:
                if not 0 <= wmap.event_idx < self.n_events:
                    raise ValueError(f"wavemap {wmap.name}: event_idx {wmap.event_idx} "
                                     f"outside [0, {self.n_events})")
        self.tables = nn.ModuleList()
        self._table_idx = []
        for t in self.ensemble_tables:
            if t.freqs.device != dev:
                raise ValueError(f"ensemble table on {t.freqs.device}, composite on {dev}")
        for wmap in self.wavemaps:
            if wmap.table.freqs.device != dev:
                raise ValueError(f"wavemap {wmap.name}: table on {wmap.table.freqs.device}, "
                                 f"composite on {dev}")
            known = [i for i, t in enumerate(self.tables) if t is wmap.table]
            if not known:
                self.tables.append(wmap.table)
            self._table_idx.append(known[0] if known else len(self.tables) - 1)
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise(noise_analyser)
        self._keys = []
        for i, wmap in enumerate(self.wavemaps):
            arrays = self._wavemap_arrays(wmap)
            self._keys.append(tuple(arrays))
            for key, arr in arrays.items():
                self.register_buffer(f"wavemap{i}_{key}", torch.as_tensor(arr, device=dev))
        logger.info("Seismic composite: %i wavemaps, %i targets", len(self.wavemaps),
                    sum(w.ntargets for w in self.wavemaps))

    @staticmethod
    def _weight_arrays(wmap) -> dict:
        return {"weights": np.stack([np.asarray(ds.covariance.chol_inverse, dtype=np.float32)
                                     for ds in wmap.datasets]),
                "slog_pdets": np.asarray([ds.covariance.log_pdet for ds in wmap.datasets],
                                         dtype=np.float32)}

    @classmethod
    def _wavemap_arrays(cls, wmap) -> dict:
        """Host arrays of one wavemap (the JAX composite's
        ``_wavemap_device``, registered here as buffers); a ``spectrum``
        wavemap also has its rfft bases ``fit_basis_c``, ``fit_basis_s``."""
        ICw, ISw = wmap.table.windowed_ibasis(wmap.window_starts, wmap.taper_window,
                                              wmap.nsamples_win)
        arrays = {
            "data": wmap.data_fit,
            "station_east": np.asarray(wmap.station_east, dtype=np.float32),
            "station_north": np.asarray(wmap.station_north, dtype=np.float32),
            "comp_idx": np.asarray(wmap.comp_idx, dtype=np.int32),
            "win_basis_c": ICw, "win_basis_s": ISw,
            "filter": from_np_complex(wmap.filter_response),
            **cls._weight_arrays(wmap),
            "nsamples": np.full(wmap.ntargets, wmap.nsamples_fit, dtype=np.float32),
        }
        if wmap.domain == "spectrum":
            arrays["fit_basis_c"], arrays["fit_basis_s"] = wmap.fit_basis()
        return arrays

    def device_data(self) -> list:
        """One dict per wavemap: its buffers plus its ``table`` module."""
        return [dict({key: getattr(self, f"wavemap{i}_{key}") for key in self._keys[i]},
                     table=self.tables[self._table_idx[i]])
                for i in range(len(self.wavemaps))]

    # -- hyperparameters and hierarchicals ------------------------------------

    def get_hypernames(self):
        if self.hp_specific:
            return [f"{w.hypername}_{i}" for w in self.wavemaps for i in range(w.ntargets)]
        return [w.hypername for w in self.wavemaps]

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

    def _selected_sources(self, wmap) -> list:
        """(index, template, event offset) of the sources a wavemap sees."""
        if self.n_events > 1:
            k = wmap.event_idx
            return [(k, self.sources[k], tuple(float(x) for x in wmap.event_offset))]
        return [(i, s, (0.0, 0.0, 0.0)) for i, s in enumerate(self.sources)]

    def _source_spectra(self, table, src, get, point, targets, n_chains, device):
        """(C, T, nf, 2) spectra of one source at the given targets."""
        st_e, st_n, comp_idx, filt = targets
        if isinstance(src, RectangularSource):
            return finite_rectangular_spectra(table, get, st_e, st_n, comp_idx, self.stf_type,
                                              filt, n_patches=self.finite_patches,
                                              anchor=src.anchor)
        duration = (get("duration") if "duration" in point else
                    torch.full((n_chains,), float(src.duration or 1.0), dtype=DTYPE,
                               device=device))
        if isinstance(src, (DoubleDCSource, RingfaultSource)):
            if isinstance(src, DoubleDCSource):
                m6s, de, dn, dz, dt = double_dc_sub_sources(get)
            else:
                m6s, de, dn, dz = src.sub_sources(get)
                dt = torch.zeros_like(de)
            return summed_point_spectra(
                table, m6s, get("east_shift")[:, None] + de, get("north_shift")[:, None] + dn,
                get("depth")[:, None] + dz, get("time")[:, None] + dt,
                torch.clamp(duration, min=1e-3), st_e, st_n, comp_idx, self.stf_type, filt)
        return table.synthesize_spectra(
            source_m6(src, get), get("east_shift"), get("north_shift"), get("depth"),
            get("time"), duration, st_e, st_n, comp_idx, stf_type=self.stf_type,
            filter_response=filt)

    def synthetics_all(self, point: dict, data=None) -> list:
        """(C, T_w, nsamples_win) synthetic windows of every wavemap.

        Wavemaps that share a GF table (and, in multi-event problems, an
        event) are synthesized together: their targets are concatenated,
        so one evaluation of C chains makes one K1c launch per table and
        source, not one per wavemap."""
        data = self.device_data() if data is None else data
        ref = next(iter(point.values()))
        n_chains, device = ref.shape[0], ref.device
        groups = {}
        for w_idx, dev in enumerate(data):
            wmap = self.wavemaps[w_idx]
            key = (id(dev["table"]),)
            if self.n_events > 1:
                key += (wmap.event_idx, tuple(float(x) for x in wmap.event_offset))
            groups.setdefault(key, []).append(w_idx)
        out = [None] * len(data)
        for w_idxs in groups.values():
            devs = [data[w] for w in w_idxs]
            table = devs[0]["table"]
            sizes = [d["station_east"].shape[0] for d in devs]
            targets = (torch.cat([d["station_east"] for d in devs]),
                       torch.cat([d["station_north"] for d in devs]),
                       torch.cat([d["comp_idx"] for d in devs]),
                       torch.cat([d["filter"].expand(t, -1, -1) for d, t in zip(devs, sizes)]))
            spec_total = 0.0
            for i, src, off in self._selected_sources(self.wavemaps[w_idxs[0]]):
                get = offset_getter(point_getter(src, point, i, len(self.sources), n_chains,
                                                 device), *off)
                spec_total = spec_total + self._source_spectra(table, src, get, point, targets,
                                                               n_chains, device)
            for w, d, spec in zip(w_idxs, devs, torch.split(spec_total, sizes, dim=-3)):
                wmap = self.wavemaps[w]
                if wmap.station_corrections:
                    with span("fullmt.phasors"):
                        shifts = torch.stack([point[n].reshape(n_chains)
                                              for n in wmap.time_shift_names()], dim=-1)
                        spec = cmul(spec, cexp(-2.0 * math.pi * table.freqs
                                               * shifts[..., None]))
                with span("fullmt.idft"):
                    out[w] = table.synthesize_windows_fused(spec, d["win_basis_c"],
                                                            d["win_basis_s"])
        return out

    def synthetics_fit_all(self, point: dict, data=None) -> list:
        """(C, T_w, nsamples_fit) synthetics of every wavemap in fit space:
        the windows, or their amplitude spectra for ``domain='spectrum'``."""
        data = self.device_data() if data is None else data
        out = self.synthetics_all(point, data)
        for w_idx, wmap in enumerate(self.wavemaps):
            if wmap.domain == "spectrum":
                out[w_idx] = amplitude_spectrum(out[w_idx], data[w_idx]["fit_basis_c"],
                                                data[w_idx]["fit_basis_s"])
        return out

    def synthetics_windows(self, point: dict, wmap_idx: int, data=None) -> torch.Tensor:
        """(C, T, nsamples_win) synthetic windows of one wavemap."""
        return self.synthetics_all(point, data)[wmap_idx]

    def synthetics_fit(self, point: dict, wmap_idx: int, data=None) -> torch.Tensor:
        """(C, T, nsamples_fit) fit-space synthetics of one wavemap."""
        return self.synthetics_fit_all(point, data)[wmap_idx]

    # -- likelihood -----------------------------------------------------------

    def _loglike(self, point: dict, synths: list, data: list) -> torch.Tensor:
        ref = next(iter(point.values()))
        total = 0.0
        with span("fullmt.misfit"):
            for w_idx, synth in enumerate(synths):
                dev, wmap = data[w_idx], self.wavemaps[w_idx]
                llks = multivariate_normal_chol_batched(
                    dev["data"] - synth, dev["weights"], dev["slog_pdets"],
                    self._hyper_vector(point, wmap, ref.shape[0], ref.device), dev["nsamples"])
                total = total + torch.sum(llks, dim=-1)
        return total

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) data log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        return self._loglike(point, self.synthetics_fit_all(point, data), data)

    def hyper_loglike(self, point: dict, fixed_point: dict, data=None) -> torch.Tensor:
        """(C,) log-likelihood of the chains' hyperparameters with the
        residuals of one ``fixed_point`` (no chain axis)."""
        data = self.device_data() if data is None else data
        ref = next(iter(point.values()))
        synths = self.synthetics_fit_all(batched_point(fixed_point, ref.device), data)
        return self._loglike(point, synths, data)

    def hyper_data(self, fixed_point: dict, data=None) -> tuple:
        """The fixed-residual terms of the hyper-only posterior at
        ``fixed_point`` (no chain axis): one synthesis, after which a draw
        of the hyperparameters costs O(targets)
        (:func:`~beat_tpu_torch.models.base.wavemap_hyper_terms`)."""
        data = self.device_data() if data is None else data
        device = data[0]["data"].device
        with torch.no_grad():
            synths = self.synthetics_fit_all(batched_point(fixed_point, device), data)
        return wavemap_hyper_terms(data, [s[0] for s in synths], self.wavemaps,
                                   self.hp_specific)

    # -- updates and diagnostics ----------------------------------------------

    def update_weights(self, point: dict) -> None:
        """Re-estimate the data covariances at ``point`` (no chain axis):
        the residual-based non-Toeplitz data part, and the velocity-model
        prediction part ``pred_v`` when ensemble tables are set.  The new
        weights are copied into the registered buffers in place, so the
        device data a sampler holds stay current."""
        non_toeplitz = (self.noise_analyser is not None
                        and self.noise_analyser.structure == "non-toeplitz")
        if not non_toeplitz and not len(self.ensemble_tables):
            return
        bpoint = batched_point(point, self.wavemap0_data.device)
        with torch.no_grad():
            fits = ([s[0].cpu().numpy() for s in self.synthetics_fit_all(bpoint)]
                    if non_toeplitz else None)
            for w_idx, wmap in enumerate(self.wavemaps):
                if non_toeplitz:
                    # residuals in fit space: the covariance is
                    # (nsamples_fit, nsamples_fit), as the weights
                    res = wmap.data_fit - fits[w_idx]
                    for i, ds in enumerate(wmap.datasets):
                        cov = ds.covariance if ds.covariance is not None else Covariance()
                        cov.data = non_toeplitz_covariance(
                            res[i], window_size=max(4, res[i].size // 5))
                        ds.covariance = cov
                if len(self.ensemble_tables):
                    pred_vs = seismic_cov_velocity_models(self, bpoint, self.ensemble_tables,
                                                          w_idx)
                    for ds, pv in zip(wmap.datasets, pred_vs):
                        cov = ds.covariance if ds.covariance is not None else Covariance()
                        cov.pred_v = pv
                        ds.covariance = cov
                for key, arr in self._weight_arrays(wmap).items():
                    buf = getattr(self, f"wavemap{w_idx}_{key}")
                    buf.copy_(torch.as_tensor(arr, device=buf.device))

    def get_synthetics(self, point: dict) -> dict:
        """``{mapid: (T, nsamples_win)}`` windows at one point (no chain axis)."""
        with torch.no_grad():
            wins = self.synthetics_all(batched_point(point, self.wavemap0_data.device))
        return {wmap.mapid: w[0].cpu().numpy() for wmap, w in zip(self.wavemaps, wins)}

    def get_variance_reductions(self, point: dict) -> dict:
        """``{mapid: 1 - ||obs - synth||² / ||obs||²}`` over the windows."""
        synths = self.get_synthetics(point)
        out = {}
        for wmap in self.wavemaps:
            obs = wmap.data_windows
            res = obs - synths[wmap.mapid]
            out[wmap.mapid] = 1.0 - float((res * res).sum()) / max(float((obs * obs).sum()),
                                                                   1e-30)
        return out

    def seis_derivative(self, point: dict, parameter: str, wmap_idx: int = 0,
                        mode: str = "autodiff", h: float = None,
                        stencil_order: int = 3) -> np.ndarray:
        """Sensitivity of one wavemap's synthetic windows to a source
        parameter at ``point`` (no chain axis).

        ``mode="autodiff"``: exact forward mode.  Each component of the
        parameter is one chain whose tangent is that component's unit
        vector, and one dual-tensor evaluation gives every column (the
        table gather runs through K1c's forward-mode rule: one more K1c
        launch on the tangents).  ``mode="fd"``: the central stencil of
        ``stencil_order`` points (:data:`~beat_tpu_torch.utility.STENCILS`)
        with step ``h`` (default 1e-3 · max(|value|, 1)), all shifted
        values as chains of one evaluation.

        Returns (T, nsamples_win) for a scalar parameter and, in autodiff
        mode, one more trailing axis per parameter component otherwise (fd
        shifts every component together)."""
        if parameter not in point:
            raise AttributeError(f"Parameter '{parameter}' not in point; derivatives are "
                                 f"available for: {', '.join(sorted(point))}")
        if mode not in ("autodiff", "fd"):
            raise ValueError(f"mode must be 'autodiff' or 'fd', got {mode!r}")
        device = self.wavemap0_data.device
        base = batched_point(point, device)
        v0 = base[parameter][0]
        if mode == "autodiff":
            k = max(v0.numel(), 1)
            chains = {name: val.expand((k,) + val.shape[1:]) for name, val in base.items()}
            tangent = torch.eye(k, dtype=DTYPE, device=device).reshape((k,) + v0.shape)
            with torch.no_grad(), fwAD.dual_level():
                chains[parameter] = fwAD.make_dual(chains[parameter].contiguous(), tangent)
                jac = fwAD.unpack_dual(self.synthetics_windows(chains, wmap_idx)).tangent
            jac = jac.cpu().numpy()                                    # (k, T, W)
            return jac[0] if v0.dim() == 0 else np.moveaxis(jac, 0, -1).reshape(
                jac.shape[1:] + tuple(v0.shape))
        from beat_tpu_torch.utility import STENCILS

        if h is None:
            h = 1e-3 * max(float(v0.abs().max()), 1.0)
        st = STENCILS[stencil_order]
        offs = np.arange(len(st["coefficients"])) - len(st["coefficients"]) // 2
        used = [(c, o) for c, o in zip(st["coefficients"], offs) if c != 0.0]
        chains = {name: val.expand((len(used),) + val.shape[1:]) for name, val in base.items()}
        chains[parameter] = torch.stack([v0 + torch.tensor(o * h, dtype=DTYPE, device=device)
                                         for _, o in used])
        with torch.no_grad():
            wins = self.synthetics_windows(chains, wmap_idx).cpu().numpy()
        acc = 0.0
        for (c, _), win in zip(used, wins):
            acc = acc + c * win
        return acc / (st["denominator"] * h)

    def get_standardized_residuals(self, point: dict) -> dict:
        """``{mapid: (T, nsamples_fit)}`` whitened fit-space residuals."""
        with torch.no_grad():
            fits = self.synthetics_fit_all(batched_point(point, self.wavemap0_data.device))
        out = {}
        for wmap, synth in zip(self.wavemaps, fits):
            res = wmap.data_fit - synth[0].cpu().numpy()
            out[wmap.mapid] = np.stack([ds.covariance.chol_inverse @ res[i]
                                        for i, ds in enumerate(wmap.datasets)])
        return out


def build_seismic_composite(seismic_config, project_dir, sources, events=None,
                            finite_patches=None, stf_type: str = "HalfSinusoid", *, device):
    """The composite of a project's seismic config: the traces of
    ``<project_dir>/<datadir>/seismic_data.npz``; the GF table
    ``gf_table.npz`` of the project if present (``gf_table.var*.npz`` its
    earth-model ensemble), else a homogeneous table from ``gf_config``
    (vp/vs/rho, distance and depth grids, nt, dt); each included
    waveform config's channels, taper, filter, domain, picked arrivals
    (``arrivals_path``), blacklist and distance range.

    events : [main event, *subevents] — a wavemap with ``event_idx > 0``
        is windowed around its own event and sees that event's source.
    finite_patches : the RectangularSource grid."""
    import glob
    import os

    from beat_tpu_torch.config import build_filterer
    from beat_tpu_torch.covariance import SeismicNoiseAnalyser
    from beat_tpu_torch.heart.geodesy import local_offset
    from beat_tpu_torch.heart.gftable import GreensTable, build_homogeneous_table
    from beat_tpu_torch.heart.seismic import WaveformMapping
    from beat_tpu_torch.heart.taper import ArrivalTaper
    from beat_tpu_torch.inputf import load_arrivals_csv, load_seismic_datasets

    dev = resolve(device)
    datasets = load_seismic_datasets(project_dir, getattr(seismic_config, "datadir", "./"))
    table_path = os.path.join(project_dir, "gf_table.npz")
    ensemble_tables = [GreensTable.load(p, device=dev) for p in
                       sorted(glob.glob(os.path.join(project_dir, "gf_table.var*.npz")))]
    if ensemble_tables:
        logger.info("Loaded %i velocity-model variation tables (prediction covariances "
                    "active)", len(ensemble_tables))
    if os.path.exists(table_path):
        table = GreensTable.load(table_path, device=dev)
    else:
        gfc = dict(seismic_config.gf_config or {})
        table = build_homogeneous_table(
            distances=np.linspace(gfc.get("distance_min", 10e3), gfc.get("distance_max", 150e3),
                                  int(gfc.get("n_distances", 24))),
            depths=np.linspace(gfc.get("depth_min", 1e3), gfc.get("depth_max", 30e3),
                               int(gfc.get("n_depths", 12))),
            nt=int(gfc.get("nt", 512)), dt=float(gfc.get("dt", 0.5)),
            vp=float(gfc.get("vp", 6000.0)), vs=float(gfc.get("vs", 3500.0)),
            rho=float(gfc.get("rho", 2700.0)), device=dev)

    wavemaps = []
    for mapnumber, wfc in enumerate(seismic_config.waveforms):
        if not getattr(wfc, "include", True):
            continue
        selected = [ds for ds in datasets if ds.channel in wfc.channels]
        if not selected:
            logger.warning("Wavemap %s: no datasets for channels %s", wfc.name, wfc.channels)
            continue
        overrides = None
        arrivals_path = getattr(wfc, "arrivals_path", None)
        if arrivals_path:
            overrides = load_arrivals_csv(arrivals_path if os.path.isabs(arrivals_path)
                                          else os.path.join(project_dir, arrivals_path))
        event_idx = int(getattr(wfc, "event_idx", 0))
        event_offset = (0.0, 0.0, 0.0)
        if events and event_idx > 0:
            if event_idx >= len(events):
                raise ValueError(f"wavemap {wfc.name}: event_idx {event_idx} but only "
                                 f"{len(events)} events (main + subevents) configured")
            main, ev = events[0], events[event_idx]
            de, dn = local_offset(main.lat, main.lon, ev.lat, ev.lon)
            event_offset = (de, dn, float(ev.time - main.time))
        wmap = WaveformMapping(
            name=wfc.name, datasets=selected, table=table,
            taper=ArrivalTaper(wfc.arrival_taper.a, wfc.arrival_taper.b, wfc.arrival_taper.c,
                               wfc.arrival_taper.d),
            filterer=build_filterer(wfc.filterer), domain=wfc.domain,
            quantity=getattr(wfc, "quantity", "displacement"),
            station_corrections=getattr(seismic_config, "station_corrections", False),
            arrival_overrides=overrides, event_idx=event_idx, event_offset=event_offset,
            mapnumber=mapnumber, preprocess_data=getattr(wfc, "preprocess_data", True))
        distances = getattr(wfc, "distances", None)
        if wfc.blacklist or distances:
            deg2m = 111194.9  # mean-Earth degree of arc
            # epicentral distances from the wavemap's own event
            wmap.station_weeding(
                blacklist=wfc.blacklist,
                distances=tuple(float(d) * deg2m for d in distances) if distances else None,
                event_east=event_offset[0], event_north=event_offset[1])
        wavemaps.append(wmap)
    if not wavemaps:
        raise ValueError("No wavemaps configured — check waveforms config")

    ne = getattr(seismic_config, "noise_estimator", None)
    analyser = (SeismicNoiseAnalyser(structure=ne.structure, pre_arrival_time=ne.pre_arrival_time)
                if ne is not None else None)
    return SeismicGeometryComposite(
        wavemaps, sources, stf_type=stf_type,
        hp_specific=getattr(seismic_config, "dataset_specific_residual_noise_estimation", False),
        noise_analyser=analyser, finite_patches=finite_patches or (4, 4),
        n_events=len(events) if events else 1, ensemble_tables=ensemble_tables, device=dev)
