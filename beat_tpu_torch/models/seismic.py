"""
Seismic geometry composite: waveform likelihood of point moment-tensor
sources through GF-table synthesis (port of
``beat_tpu/models/seismic.py``), batched over a leading chain axis.

A sampled ``point`` maps parameter names to (C,) tensors — or (C, k)
for vector parameters, as ``Ordering.to_point`` returns them; the
likelihood returns (C,).

Sources other than ``MTSource``, station corrections, multi-event
offsets, the ``spectrum`` domain, ``update_weights`` and
``hyper_loglike`` are ROADMAP items of a later slice.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.distributions import multivariate_normal_chol_batched
from beat_tpu_torch.models.base import Composite
from beat_tpu_torch.ops.cplx import from_np_complex
from beat_tpu_torch.sources import SQRT2, MTSource, magnitude_to_moment

logger = logging.getLogger("beat_tpu_torch.models.seismic")

M6_NAMES = ("mnn", "mee", "mdd", "mne", "mnd", "med")

#: per-wavemap device arrays (besides the shared GF table module)
DEVICE_KEYS = ("data", "station_east", "station_north", "comp_idx", "win_basis_c",
               "win_basis_s", "filter", "weights", "slog_pdets", "nsamples")


def point_getter(template, point: dict, idx: int, n_sources: int, n_chains: int, device):
    """Accessor for source ``idx``'s parameters as (C,) tensors: sampled
    values override the template's attributes."""

    def get(name):
        if name in point:
            val = point[name]
            if val.dim() > 1 and n_sources > 1:
                return val[:, idx]
            return val.reshape(n_chains)
        return torch.full((n_chains,), float(getattr(template, name)), dtype=DTYPE,
                          device=device)

    return get


def source_m6(template, get) -> torch.Tensor:
    """(C, 6) NED moment tensors of an ``MTSource`` from the getter."""
    comps = torch.stack([get(n) for n in M6_NAMES], dim=-1)
    # Frobenius scalar moment: off-diagonals count twice
    norm = torch.sqrt(torch.sum(comps[:, :3] ** 2, dim=-1)
                      + 2.0 * torch.sum(comps[:, 3:] ** 2, dim=-1)) / SQRT2
    return (comps / torch.clamp(norm, min=1e-20)[:, None]
            * magnitude_to_moment(get("magnitude"))[:, None])


class SeismicGeometryComposite(Composite):
    """Waveform likelihood for point-source geometry inversion.

    The GF tables are submodules (shared tables once); every per-wavemap
    array is a registered buffer named ``wavemap<i>_<key>``."""

    name = "seismic"

    def __init__(self, wavemaps, sources, stf_type="HalfSinusoid", *, device):
        super().__init__()
        dev = resolve(device)
        for src in sources:
            if not isinstance(src, MTSource):
                raise NotImplementedError(
                    f"{type(src).__name__} waits for a later port slice "
                    "(ROADMAP: the other sources)")
        self.wavemaps = list(wavemaps)
        self.sources = list(sources)
        self.stf_type = stf_type
        self.tables = nn.ModuleList()
        self._table_idx = []
        for wmap in self.wavemaps:
            if wmap.table.freqs.device != dev:
                raise ValueError(f"wavemap {wmap.name}: table on {wmap.table.freqs.device}, "
                                 f"composite on {dev}")
            known = [i for i, t in enumerate(self.tables) if t is wmap.table]
            if not known:
                self.tables.append(wmap.table)
            self._table_idx.append(known[0] if known else len(self.tables) - 1)
            if wmap.datasets[0].covariance is None:
                wmap.analyse_noise()
        for i, wmap in enumerate(self.wavemaps):
            for key, arr in self._wavemap_arrays(wmap).items():
                self.register_buffer(f"wavemap{i}_{key}", torch.as_tensor(arr, device=dev))
        logger.info("Seismic composite: %i wavemaps, %i targets", len(self.wavemaps),
                    sum(w.ntargets for w in self.wavemaps))

    @staticmethod
    def _wavemap_arrays(wmap) -> dict:
        """Host arrays of one wavemap, keyed as :data:`DEVICE_KEYS` (the
        JAX composite's ``_wavemap_device``, registered here as buffers)."""
        ICw, ISw = wmap.table.windowed_ibasis(wmap.window_starts, wmap.taper_window,
                                              wmap.nsamples_win)
        return {
            "data": wmap.data_fit,
            "station_east": np.asarray(wmap.station_east, dtype=np.float32),
            "station_north": np.asarray(wmap.station_north, dtype=np.float32),
            "comp_idx": np.asarray(wmap.comp_idx, dtype=np.int32),
            "win_basis_c": ICw, "win_basis_s": ISw,
            "filter": from_np_complex(wmap.filter_response),
            "weights": np.stack([np.asarray(ds.covariance.chol_inverse, dtype=np.float32)
                                 for ds in wmap.datasets]),
            "slog_pdets": np.asarray([ds.covariance.log_pdet for ds in wmap.datasets],
                                     dtype=np.float32),
            "nsamples": np.full(wmap.ntargets, wmap.nsamples_fit, dtype=np.float32),
        }

    def device_data(self) -> list:
        """One dict per wavemap: its buffers plus its ``table`` module."""
        return [dict({key: getattr(self, f"wavemap{i}_{key}") for key in DEVICE_KEYS},
                     table=self.tables[self._table_idx[i]])
                for i in range(len(self.wavemaps))]

    # -- hyperparameters ------------------------------------------------------

    def get_hypernames(self):
        return [w.hypername for w in self.wavemaps]

    @staticmethod
    def _hyper_vector(point, wmap, n_chains, device) -> torch.Tensor:
        """(C, T) noise hyperparameter of one wavemap, per target."""
        h = (point[wmap.hypername].reshape(n_chains) if wmap.hypername in point
             else torch.zeros(n_chains, dtype=DTYPE, device=device))
        return h[:, None].expand(n_chains, wmap.ntargets)

    # -- forward --------------------------------------------------------------

    def synthetics_all(self, point: dict, data=None) -> list:
        """(C, T_w, nsamples_win) synthetic windows of every wavemap.

        Wavemaps that share a GF table are synthesized together: their
        targets are concatenated, so one evaluation of C chains makes one
        K1 launch of C·ΣT_w queries per table, not one per wavemap."""
        data = self.device_data() if data is None else data
        ref = next(iter(point.values()))
        n_chains, device = ref.shape[0], ref.device
        groups = {}
        for w_idx, dev in enumerate(data):
            groups.setdefault(id(dev["table"]), []).append(w_idx)
        out = [None] * len(data)
        for w_idxs in groups.values():
            devs = [data[w] for w in w_idxs]
            table = devs[0]["table"]
            sizes = [d["station_east"].shape[0] for d in devs]
            st_e = torch.cat([d["station_east"] for d in devs])
            st_n = torch.cat([d["station_north"] for d in devs])
            comp_idx = torch.cat([d["comp_idx"] for d in devs])
            filt = torch.cat([d["filter"].expand(t, -1, -1) for d, t in zip(devs, sizes)])
            spec_total = 0.0
            for i, src in enumerate(self.sources):
                get = point_getter(src, point, i, len(self.sources), n_chains, device)
                if "duration" in point:
                    duration = get("duration")
                else:
                    duration = torch.full((n_chains,), float(src.duration or 1.0),
                                          dtype=DTYPE, device=device)
                spec_total = spec_total + table.synthesize_spectra(
                    source_m6(src, get), get("east_shift"), get("north_shift"),
                    get("depth"), get("time"), duration, st_e, st_n, comp_idx,
                    stf_type=self.stf_type, filter_response=filt)
            for w, d, spec in zip(w_idxs, devs, torch.split(spec_total, sizes, dim=-3)):
                out[w] = table.synthesize_windows_fused(spec, d["win_basis_c"],
                                                        d["win_basis_s"])
        return out

    def synthetics_windows(self, point: dict, wmap_idx: int, data=None) -> torch.Tensor:
        """(C, T, nsamples_win) synthetic windows of one wavemap."""
        return self.synthetics_all(point, data)[wmap_idx]

    def synthetics_fit(self, point: dict, wmap_idx: int, data=None) -> torch.Tensor:
        """Synthetics in fit space: the time windows (the ``spectrum``
        domain waits for a later slice)."""
        return self.synthetics_windows(point, wmap_idx, data)

    def loglike(self, point: dict, data=None) -> torch.Tensor:
        """(C,) data log-likelihood of a batch of chains."""
        data = self.device_data() if data is None else data
        ref = next(iter(point.values()))
        total = 0.0
        for w_idx, synth in enumerate(self.synthetics_all(point, data)):
            dev, wmap = data[w_idx], self.wavemaps[w_idx]
            llks = multivariate_normal_chol_batched(
                dev["data"] - synth, dev["weights"], dev["slog_pdets"],
                self._hyper_vector(point, wmap, ref.shape[0], ref.device), dev["nsamples"])
            total = total + torch.sum(llks, dim=-1)
        return total
