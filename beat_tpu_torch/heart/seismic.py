"""
Seismic waveform datasets and waveform mappings (port of
``beat_tpu/heart/seismic.py``).

Host numpy: a :class:`WaveformMapping` bundles the stations/channels of
one fit configuration into fixed-shape arrays (station coordinates,
channel indexes, window starts, taper, filter response) and processes
the observed traces through the same taper/filter pipeline as the
synthetics.  Arrival times for the windows are straight-ray (or table)
travel times computed in numpy.

Station corrections, multi-event offsets and the ``spectrum`` domain are
ROADMAP items of a later slice.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from beat_tpu_torch.covariance import Covariance, SeismicNoiseAnalyser
from beat_tpu_torch.heart.gftable import GreensTable, component_index
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter

logger = logging.getLogger("beat_tpu_torch.heart.seismic")

_LATER = ("a later port slice (ROADMAP: station corrections, multi-event offsets, "
          "spectrum domain)")


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
    domain: str = "time"
    station_corrections: bool = False
    event_idx: int = 0
    event_offset: tuple = (0.0, 0.0, 0.0)
    #: position of this wavemap in the config's waveforms list
    mapnumber: int = 0

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
        if self.domain != "time":
            raise NotImplementedError(f"domain={self.domain!r} waits for {_LATER}")
        if self.station_corrections:
            raise NotImplementedError(f"station corrections wait for {_LATER}")
        if self.event_idx != 0 or any(float(x) != 0.0 for x in self.event_offset):
            raise NotImplementedError(f"multi-event wavemaps wait for {_LATER}")
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
        return self.nsamples_win

    @property
    def mapid(self) -> str:
        return f"{self.name}_{self.mapnumber}"

    @property
    def hypername(self) -> str:
        return f"h_{self.mapid}"

    def prepare(self) -> None:
        """Geometry, windows and processed observations: arrival times at
        the event location and the table's mid depth keep window shapes
        chain-invariant; the source ``time`` moves the synthetics by
        phase shifts instead."""
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
        dist = np.sqrt(self.station_east**2 + self.station_north**2)
        z_ref = float(np.mean(self.table.depths))
        self.arrival_times = self.table.travel_time(self.name, dist, z_ref)
        start_times = self.arrival_times + self.taper.a - self.table.t0
        self.window_starts = np.clip(np.round(start_times / dt).astype(np.int32),
                                     0, self.table.nt - self.nsamples_win)
        self.taper_window = self.taper.window(dt)
        # observed traces and (displacement) synthetics see the same bandpass
        self.filter_response = self.filterer.response(self.table.nt, dt)
        self._process_observed()

    def _filtered(self, ds: SeismicDataset) -> np.ndarray:
        spec = np.fft.rfft(ds.ydata, n=self.table.nt)
        return np.fft.irfft(spec * self.filter_response, n=self.table.nt)

    def _process_observed(self) -> None:
        """Filter + chop + taper the observed traces."""
        n_win = self.nsamples_win
        self.data_windows = np.stack([
            self._filtered(ds)[start:start + n_win] * self.taper_window
            for ds, start in zip(self.datasets, self.window_starts)]).astype(np.float32)

    @property
    def data_fit(self) -> np.ndarray:
        """Observed data in fit space (the tapered windows)."""
        return self.data_windows.astype(np.float32)

    def analyse_noise(self, analyser: SeismicNoiseAnalyser | None = None) -> None:
        """Per-dataset covariances over the fit window, with the variance
        level from the pre-arrival noise."""
        analyser = analyser or SeismicNoiseAnalyser(structure="variance")
        dt = self.table.dt
        for ds, start, arr in zip(self.datasets, self.window_starts, self.arrival_times):
            filtered = self._filtered(ds)
            pre_arrival_idx = max(int(round((arr - self.table.t0 - 1.0) / dt)), 2)
            noise = filtered[:pre_arrival_idx]
            window = filtered[start:start + self.nsamples_win]
            ds.covariance = Covariance(
                data=analyser.get_data_covariance(window, dt, noise=noise))
