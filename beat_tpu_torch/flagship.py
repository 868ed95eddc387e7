"""
The hermetic FullMT problem (port of ``__graft_entry__._build_flagship``):
a homogeneous GF table, stations on a ring, synthetic waveforms from a
known double couple (strike 40°, dip 55°, rake 20°, Mw 5.8) at 9 km
depth plus 2 % noise, and a full moment-tensor + magnitude + depth +
time + duration inversion.

Two wavemaps share the table: ``any_P`` fits the Z and R channels of
every station, ``any_S`` the T channel, so the gather reads all three
channel blocks.

Sizes (:data:`REAL_SIZE`, :data:`TEST_SIZE`): the real size is the grid
of the real FullMT table (206 distance × 15 depth nodes over 10–215 km
and 1–29 km, nt = 1024 at dt = 0.5 s; spectra 228 MB) with the FullMT
project's 10 stations; the test size keeps every width and shrinks the
grid and the trace length.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.parameter import Parameter, PriorSet
from beat_tpu_torch.device import resolve
from beat_tpu_torch.heart.gftable import build_homogeneous_table
from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.models.seismic import SeismicGeometryComposite
from beat_tpu_torch.sources import MTSource, magnitude_to_moment, sdr_to_m6

REAL_SIZE = dict(n_stations=10, n_distances=206, n_depths=15, nt=1024)
TEST_SIZE = dict(n_stations=4, n_distances=11, n_depths=5, nt=128)

DT = 0.5
DISTANCE_RANGE = (10e3, 215e3)
DEPTH_RANGE = (1e3, 29e3)
STATION_RANGE = (40e3, 150e3)
TAPER = dict(a=-3.0, b=-1.5, c=15.0, d=18.0)
FILTER = dict(lower_corner=0.02, upper_corner=0.5, order=3)
TRUE_SDR = (40.0, 55.0, 20.0)
TRUE_MAGNITUDE = 5.8
TRUE_DEPTH = 9e3
TRUE_DURATION = 1.5
NOISE_LEVEL = 0.02
#: wavemap name -> channels it fits, in target order
WAVEMAPS = {"any_P": ("Z", "R"), "any_S": ("T",)}


def flagship_priors() -> PriorSet:
    """The source priors of the JAX flagship (hyperparameters are added
    by the Problem from the composite)."""
    priors = PriorSet()
    for name in ("mnn", "mee", "mdd", "mne", "mnd", "med"):
        priors.add(Parameter.from_defaults(name))
    priors.add(Parameter("magnitude", [5.0], [6.5]))
    priors.add(Parameter("depth", [3e3], [18e3]))
    priors.add(Parameter("time", [-2.0], [2.0]))
    priors.add(Parameter("duration", [0.5], [4.0]))
    return priors


def flagship_stations(n_stations: int, rng: np.random.Generator):
    """(east, north) station coordinates [m] on a ring."""
    az = np.linspace(0, 2 * np.pi, n_stations, endpoint=False) + 0.3
    dist = rng.uniform(*STATION_RANGE, n_stations)
    return dist * np.sin(az), dist * np.cos(az)


def flagship_observations(table, station_east, station_north,
                          rng: np.random.Generator) -> dict:
    """Noisy raw traces ``{channel: (n_stations, nt)}`` of the true
    source, synthesized with the port's forward on the table's device."""
    dev = table.freqs.device
    n = len(station_east)
    comp = torch.as_tensor(np.repeat([0, 1, 2], n), device=dev)
    st_e = torch.as_tensor(np.tile(station_east, 3), dtype=torch.float32, device=dev)
    st_n = torch.as_tensor(np.tile(station_north, 3), dtype=torch.float32, device=dev)
    m6 = sdr_to_m6(*TRUE_SDR, magnitude_to_moment(TRUE_MAGNITUDE)).to(dev)[None]

    def one(v):
        return torch.full((1,), v, dtype=torch.float32, device=dev)

    spec = table.synthesize_spectra(m6, one(0.0), one(0.0), one(TRUE_DEPTH), one(0.0),
                                    one(TRUE_DURATION), st_e, st_n, comp)
    raw = table.to_time_domain(spec)[0].cpu().numpy()
    raw = raw + rng.normal(0, NOISE_LEVEL * np.abs(raw).max(), raw.shape)
    return {ch: raw[i * n:(i + 1) * n] for i, ch in enumerate("ZRT")}


def flagship_datasets(station_east, station_north, raw: dict) -> dict:
    """``{wavemap name: [SeismicDataset, ...]}`` in target order."""
    return {name: [SeismicDataset(station=f"ST{i:02d}", channel=ch, east=station_east[i],
                                  north=station_north[i], ydata=raw[ch][i])
                   for ch in channels for i in range(len(station_east))]
            for name, channels in WAVEMAPS.items()}


def build_flagship(n_stations: int, n_distances: int, n_depths: int, nt: int,
                   seed: int = 0, *, device, outfolder: str = "flagship_run") -> Problem:
    """The flagship Problem at the given size, all tensors on ``device``."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    table = build_homogeneous_table(np.linspace(*DISTANCE_RANGE, n_distances),
                                    np.linspace(*DEPTH_RANGE, n_depths), nt=nt, dt=DT,
                                    device=dev)
    st_e, st_n = flagship_stations(n_stations, rng)
    raw = flagship_observations(table, st_e, st_n, rng)
    wavemaps = [WaveformMapping(name=name, datasets=dsets, table=table,
                                taper=ArrivalTaper(**TAPER), filterer=Filter(**FILTER),
                                mapnumber=i)
                for i, (name, dsets) in enumerate(flagship_datasets(st_e, st_n, raw).items())]
    comp = SeismicGeometryComposite(
        wavemaps, [MTSource(depth=TRUE_DEPTH, magnitude=TRUE_MAGNITUDE)], device=dev)
    return Problem(flagship_priors(), {"seismic": comp}, device=dev, outfolder=outfolder)
