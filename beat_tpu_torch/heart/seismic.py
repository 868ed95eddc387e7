"""
Seismic waveform datasets and waveform mappings (port of
``beat_tpu/heart/seismic.py``).

Host numpy: a :class:`WaveformMapping` bundles the stations/channels of
one fit configuration into fixed-shape arrays (station coordinates,
channel indexes, window starts, taper, filter response) and processes
the observed traces through the same taper/filter pipeline as the
synthetics.  Arrival times for the windows are straight-ray (or table)
travel times computed in numpy, at the wavemap's own event in
multi-event problems; picked arrivals override them.  The fit space is
the tapered time windows, or their amplitude spectra
(``domain="spectrum"``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from beat_tpu_torch.covariance import Covariance, SeismicNoiseAnalyser
from beat_tpu_torch.heart.gftable import GreensTable, component_index
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.ops.cplx import rfft_basis

logger = logging.getLogger("beat_tpu_torch.heart.seismic")

@dataclass
class SeismicDataset:
    """One observed trace: station/channel + raw samples on the table
    time grid (t0-aligned), with noise covariance over the fit window."""

    station: str
    channel: str                  # 'Z' | 'R' | 'T'
    east: float                   # station local coordinates [m]
    north: float
    ydata: np.ndarray             # raw trace on the table grid
    covariance: Covariance | None = None


@dataclass
class WaveformMapping:
    """Targets of one waveform fit configuration: shared phase, taper,
    filter and window length."""

    name: str                      # e.g. 'any_P'
    datasets: list                 # of SeismicDataset
    table: GreensTable
    taper: ArrivalTaper
    filterer: Filter
    domain: str = "time"           # time | spectrum
    quantity: str = "displacement"  # | velocity | acceleration
    station_corrections: bool = False
    #: picked arrival times per station [s after origin], overriding the
    #: table's predicted arrivals
    arrival_overrides: dict | None = None
    #: which event this wavemap belongs to in multi-event problems
    event_idx: int = 0
    #: (east, north, time) of this wavemap's event relative to the main
    #: event origin [m, m, s]
    event_offset: tuple = (0.0, 0.0, 0.0)
    #: position of this wavemap in the config's waveforms list
    mapnumber: int = 0
    #: filter the observed traces during preparation (False: the data
    #: were filtered offline); synthetics are always filtered
    preprocess_data: bool = True

    # filled by prepare()
    station_east: np.ndarray = field(default=None)
    station_north: np.ndarray = field(default=None)
    comp_idx: np.ndarray = field(default=None)
    window_starts: np.ndarray = field(default=None)
    arrival_times: np.ndarray = field(default=None)
    taper_window: np.ndarray = field(default=None)
    filter_response: np.ndarray = field(default=None)
    data_windows: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.domain not in ("time", "spectrum"):
            raise ValueError(f"Unknown domain {self.domain!r} (time|spectrum)")
        if self.station_east is None:
            self.prepare()

    @property
    def ntargets(self) -> int:
        return len(self.datasets)

    @property
    def nsamples_win(self) -> int:
        return self.taper.nsamples(self.table.dt)

    @property
    def nsamples_fit(self) -> int:
        """Samples entering the likelihood: the window length, or its rfft
        bins for ``domain='spectrum'``."""
        if self.domain == "spectrum":
            return self.nsamples_win // 2 + 1
        return self.nsamples_win

    def fit_transform_np(self, windows: np.ndarray) -> np.ndarray:
        """Windows → fit space (host): identity or amplitude spectrum."""
        if self.domain == "spectrum":
            return np.abs(np.fft.rfft(windows, axis=-1))
        return windows

    def fit_basis(self) -> tuple:
        """(C, S) rfft bases (nsamples_win, nsamples_fit) of the device's
        amplitude spectrum."""
        return rfft_basis(self.nsamples_win)

    @property
    def mapid(self) -> str:
        return f"{self.name}_{self.mapnumber}"

    @property
    def hypername(self) -> str:
        return f"h_{self.mapid}"

    def prepare(self) -> None:
        """Geometry, windows and processed observations: arrival times at
        this wavemap's event and the table's mid depth keep window shapes
        chain-invariant; the source ``time`` moves the synthetics by phase
        shifts instead."""
        dt = self.table.dt
        if self.nsamples_win > self.table.nt:
            raise ValueError(
                f"Arrival taper window ({self.taper.duration:.1f} s = "
                f"{self.nsamples_win} samples) exceeds the GF table length "
                f"({self.table.nt} samples at dt={dt})")
        self.station_east = np.array([ds.east for ds in self.datasets])
        self.station_north = np.array([ds.north for ds in self.datasets])
        self.comp_idx = np.array([component_index[ds.channel] for ds in self.datasets],
                                 dtype=np.int32)
        e0, n0 = self.event_offset[:2]
        dist = np.sqrt((self.station_east - e0) ** 2 + (self.station_north - n0) ** 2)
        z_ref = float(np.mean(self.table.depths))
        # a subevent's arrivals are delayed by its time after the main origin
        self.arrival_times = (np.array(self.table.travel_time(self.name, dist, z_ref))
                              + float(self.event_offset[2]))
        if self.arrival_overrides:
            for i, ds in enumerate(self.datasets):
                if ds.station in self.arrival_overrides:
                    self.arrival_times[i] = float(self.arrival_overrides[ds.station])
        start_times = self.arrival_times + self.taper.a - self.table.t0
        self.window_starts = np.clip(np.round(start_times / dt).astype(np.int32),
                                     0, self.table.nt - self.nsamples_win)
        self.taper_window = self.taper.window(dt)
        # observed traces (restituted to `quantity` already) see the plain
        # bandpass; synthetics from the displacement tables also take
        # (iω)^n in their response
        self.filter_response_obs = self.filterer.response(self.table.nt, dt)
        n_diff = {"displacement": 0, "velocity": 1, "acceleration": 2}.get(self.quantity)
        if n_diff is None:
            raise ValueError(f"Unknown quantity {self.quantity!r} "
                             "(displacement|velocity|acceleration)")
        w = 2.0 * np.pi * np.fft.rfftfreq(self.table.nt, dt)
        self.filter_response = self.filter_response_obs * (1j * w) ** n_diff
        self._process_observed()

    def _filtered(self, ds: SeismicDataset) -> np.ndarray:
        resp = self.filter_response_obs if self.preprocess_data else 1.0
        spec = np.fft.rfft(ds.ydata, n=self.table.nt)
        return np.fft.irfft(spec * resp, n=self.table.nt)

    def _process_observed(self) -> None:
        """Filter + chop + taper the observed traces."""
        n_win = self.nsamples_win
        self.data_windows = np.stack([
            self._filtered(ds)[start:start + n_win] * self.taper_window
            for ds, start in zip(self.datasets, self.window_starts)]).astype(np.float32)

    @property
    def data_fit(self) -> np.ndarray:
        """Observed data in fit space (the tapered windows, or their
        amplitude spectra)."""
        return self.fit_transform_np(self.data_windows).astype(np.float32)

    def analyse_noise(self, analyser: SeismicNoiseAnalyser | None = None) -> None:
        """Per-dataset covariances over the fit samples, with the variance
        level from the pre-arrival noise."""
        analyser = analyser or SeismicNoiseAnalyser(structure="variance")
        dt = self.table.dt
        for ds, start, arr in zip(self.datasets, self.window_starts, self.arrival_times):
            filtered = self._filtered(ds)
            pre_arrival_idx = max(int(round((arr - self.table.t0 - 1.0) / dt)), 2)
            noise = filtered[:pre_arrival_idx]
            if self.domain == "spectrum":
                # the amplitude spectrum's noise variance: the window's
                # noise level times its length
                var = float(np.var(noise)) if noise.size > 2 else float(np.var(filtered))
                cov = np.eye(self.nsamples_fit) * max(var, 1e-30) * self.nsamples_win
            else:
                window = filtered[start:start + self.nsamples_win]
                cov = analyser.get_data_covariance(window, dt, noise=noise)
            ds.covariance = Covariance(data=cov)

    def get_station_names(self) -> list:
        return [ds.station for ds in self.datasets]

    def station_weeding(self, blacklist=(), distances=None, event_east: float = 0.0,
                        event_north: float = 0.0) -> int:
        """Remove blacklisted stations (``station`` or ``station.channel``)
        and stations outside the epicentral distance range [m]; returns
        the number of removed datasets and prepares the mapping again."""
        kept = []
        for ds in self.datasets:
            if ds.station in blacklist or f"{ds.station}.{ds.channel}" in blacklist:
                continue
            if distances is not None:
                dist = np.hypot(ds.east - event_east, ds.north - event_north)
                if not (distances[0] <= dist <= distances[1]):
                    continue
            kept.append(ds)
        removed = len(self.datasets) - len(kept)
        if not kept:
            raise ValueError(
                f"station weeding removed every station of wavemap {self.name} "
                f"(blacklist {list(blacklist)}, distance range {distances})")
        if removed:
            self.datasets = kept
            self.prepare()
        return removed

    def time_shift_names(self) -> list:
        """The station-correction parameter names, one per target."""
        if not self.station_corrections:
            return []
        return [f"{self.mapid}_{ds.station}_time_shift" for ds in self.datasets]
