"""
The port's hermetic problems.

**The FullMT problem** (port of ``__graft_entry__._build_flagship``):
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

The same problem inverts for any other source type
(``build_flagship(source=...)``, priors of :func:`source_priors`), with
the wavemap and composite options of the geometry mode: station
corrections, the ``spectrum`` domain, one noise hyperparameter per
target, two events, non-Toeplitz covariances and ensemble tables.  A
``RectangularSource`` problem fits data synthesized from a true 8 × 5 km
rectangle (:data:`TRUE_RECTANGLE`) on the patch grid that
``recommended_finite_patches`` gives for its priors' upper bounds.

**The kinematic FFI problem** (:func:`build_ffi_flagship`, port of
``examples/laquila_scale_ffi.py``): a 2 km patch grid on a normal fault
(strike 135°, dip 50°, rake −90°), stations on a ring, the 5-D GF
library built from a homogeneous table, observed windows stacked from a
known heterogeneous slip with on-grid durations and eikonal onsets plus
2 % noise, and an inversion for slip, duration and rupture velocity per
patch and the nucleation point, with a Laplacian smoothness prior.
:data:`FFI_REAL_SIZE` is the example's production scale (12 targets ×
500 patches × 10 durations × 32 starttimes × 512 samples: a 3.9 GiB
float32 library, 1504 sampled dimensions); :data:`FFI_TEST_SIZE` keeps
the grids of durations and starttimes and shrinks the fault, the
station count and the traces.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.covariance import Covariance
from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.ffi import discretize_sources, seis_construct_gf_linear
from beat_tpu_torch.heart.geodesy import DatasetStack
from beat_tpu_torch.heart.gftable import build_homogeneous_table
from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.models.distributer import SeismicDistributerComposite
from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.models.seismic import (SeismicGeometryComposite,
                                           finite_rectangular_spectra,
                                           recommended_finite_patches)
from beat_tpu_torch.parameter import Parameter, PriorSet
from beat_tpu_torch.sources import (MTSource, RectangularSource, magnitude_to_moment,
                                    sdr_to_m6, source_catalog)

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


#: the finite source behind the data of the RectangularSource problem
#: (anchored at its top-center; Mw ≈ 5.82 with the table's rigidity)
TRUE_RECTANGLE = dict(strike=40.0, dip=55.0, rake=20.0, length=8e3, width=5e3, slip=0.45,
                      depth=7e3, nucleation_x=-0.4, nucleation_y=0.2, velocity=2800.0,
                      duration=TRUE_DURATION)
#: (east, north, time) of the second event of a two-event problem
EVENT_OFFSETS = ((0.0, 0.0, 0.0), (3e3, -2e3, 4.0))

_DC = dict(strike=(0.0, 180.0), dip=(10.0, 90.0), rake=(-90.0, 90.0))
_POINT = dict(east_shift=(-3e3, 3e3), north_shift=(-3e3, 3e3), depth=(3e3, 18e3),
              time=(-2.0, 2.0), duration=(0.5, 4.0))
_MAGNITUDE = dict(magnitude=(5.0, 6.5))
#: the source priors of each source type, ``name: (lower, upper)``
#: (the registry's bounds where the value is None)
SOURCE_PRIORS = {
    "MTSource": dict(**{n: None for n in ("mnn", "mee", "mdd", "mne", "mnd", "med")},
                     magnitude=(5.0, 6.5), depth=(3e3, 18e3), time=(-2.0, 2.0),
                     duration=(0.5, 4.0)),
    "MTQTSource": dict(w=None, v=None, kappa=None, sigma=None, h=None, **_MAGNITUDE, **_POINT),
    "DCSource": dict(**_DC, **_MAGNITUDE, **_POINT),
    "ExplosionSource": dict(volume_change=(1e6, 1e8), **_POINT),
    "CLVDSource": dict(azimuth=(0.0, 180.0), dip=(0.0, 90.0), **_MAGNITUDE, **_POINT),
    "DoubleDCSource": dict(**{k + i: v for i in "12" for k, v in _DC.items()},
                           mix=(0.0, 1.0), delta_time=(0.0, 3.0), delta_depth=(0.0, 3e3),
                           distance=(0.0, 5e3), azimuth=(0.0, 180.0), **_MAGNITUDE, **_POINT),
    "RingfaultSource": dict(strike=(0.0, 180.0), dip=(0.0, 30.0), diameter=(1e3, 5e3),
                            sign=(-1.0, 1.0), **_MAGNITUDE, **_POINT),
    "RectangularSource": dict(length=(6e3, 10e3), width=(3e3, 6e3), slip=(0.1, 1.5),
                              rake=(-30.0, 70.0), east_shift=(-3e3, 3e3),
                              north_shift=(-3e3, 3e3), depth=(4e3, 10e3),
                              nucleation_x=(-1.0, 1.0), nucleation_y=(-1.0, 1.0),
                              velocity=(2000.0, 3500.0), time=(-2.0, 2.0),
                              duration=(0.5, 4.0)),
}


def source_priors(source: str = "MTSource", n_sources: int = 1) -> PriorSet:
    """The source priors of ``source`` for ``n_sources`` sources (vector
    parameters when more than one; hyperparameters are added by the
    Problem from the composite)."""
    priors = PriorSet()
    for name, bounds in SOURCE_PRIORS[source].items():
        p = Parameter.from_defaults(name, n_sources)
        if bounds is not None:
            p = Parameter(name, [bounds[0]] * n_sources, [bounds[1]] * n_sources)
        priors.add(p)
    return priors


def flagship_priors() -> PriorSet:
    """The source priors of the JAX flagship (the MTSource problem)."""
    return source_priors("MTSource")


def source_template(source: str):
    """The template of a source type: the true source where the problem
    has one, the type's defaults otherwise (the sampled parameters
    override them)."""
    if source == "RectangularSource":
        return RectangularSource(**TRUE_RECTANGLE)
    if source == "MTSource":
        return MTSource(depth=TRUE_DEPTH, magnitude=TRUE_MAGNITUDE)
    return source_catalog[source](depth=TRUE_DEPTH)


def finite_patches(priors: PriorSet) -> tuple:
    """The RectangularSource patch grid for the priors' upper length and
    width and the filter's upper corner."""
    return recommended_finite_patches(float(priors.parameters["length"].upper.max()),
                                      float(priors.parameters["width"].upper.max()),
                                      FILTER["upper_corner"])


def flagship_stations(n_stations: int, rng: np.random.Generator):
    """(east, north) station coordinates [m] on a ring."""
    az = np.linspace(0, 2 * np.pi, n_stations, endpoint=False) + 0.3
    dist = rng.uniform(*STATION_RANGE, n_stations)
    return dist * np.sin(az), dist * np.cos(az)


def flagship_observations(table, station_east, station_north, rng: np.random.Generator,
                          rectangle_patches: tuple | None = None,
                          rectangle: dict | None = None) -> dict:
    """Noisy raw traces ``{channel: (n_stations, nt)}`` of the true source
    (the double couple, or with ``rectangle_patches`` a rectangle on that
    grid: ``rectangle``, by default :data:`TRUE_RECTANGLE`), synthesized
    with the port's forward on the table's device."""
    dev = table.freqs.device
    n = len(station_east)
    comp = torch.as_tensor(np.repeat([0, 1, 2], n), device=dev)
    st_e = torch.as_tensor(np.tile(station_east, 3), dtype=torch.float32, device=dev)
    st_n = torch.as_tensor(np.tile(station_north, 3), dtype=torch.float32, device=dev)

    def one(v):
        return torch.full((1,), v, dtype=torch.float32, device=dev)

    with torch.no_grad():
        if rectangle_patches is None:
            m6 = sdr_to_m6(*TRUE_SDR, magnitude_to_moment(TRUE_MAGNITUDE)).to(dev)[None]
            spec = table.synthesize_spectra(m6, one(0.0), one(0.0), one(TRUE_DEPTH), one(0.0),
                                            one(TRUE_DURATION), st_e, st_n, comp)
        else:
            true = dict(dict(east_shift=0.0, north_shift=0.0, time=0.0),
                        **(rectangle or TRUE_RECTANGLE))
            spec = finite_rectangular_spectra(table, lambda name: one(true[name]), st_e, st_n,
                                              comp, "HalfSinusoid", None,
                                              n_patches=rectangle_patches)
        raw = table.to_time_domain(spec)[0].cpu().numpy()
    raw = raw + rng.normal(0, NOISE_LEVEL * np.abs(raw).max(), raw.shape)
    return {ch: raw[i * n:(i + 1) * n] for i, ch in enumerate("ZRT")}


def flagship_datasets(station_east, station_north, raw: dict) -> dict:
    """``{wavemap name: [SeismicDataset, ...]}`` in target order."""
    return {name: [SeismicDataset(station=f"ST{i:02d}", channel=ch, east=station_east[i],
                                  north=station_north[i], ydata=raw[ch][i])
                   for ch in channels for i in range(len(station_east))]
            for name, channels in WAVEMAPS.items()}


def flagship_table(n_distances: int, n_depths: int, nt: int, *, device, vp: float = 6000.0,
                   vs: float = 3500.0):
    """The homogeneous GF table of the FullMT problem (other velocities:
    the ensemble tables of a velocity-model variation)."""
    return build_homogeneous_table(np.linspace(*DISTANCE_RANGE, n_distances),
                                   np.linspace(*DEPTH_RANGE, n_depths), nt=nt, dt=DT, vp=vp,
                                   vs=vs, device=device)


def build_flagship(n_stations: int, n_distances: int, n_depths: int, nt: int,
                   seed: int = 0, *, device, outfolder: str = "flagship_run",
                   source: str = "MTSource", table=None, domain: str = "time",
                   station_corrections: bool = False, n_events: int = 1,
                   **composite_options) -> Problem:
    """The flagship Problem at the given size, all tensors on ``device``,
    inverting for a ``source`` of that type with its :func:`source_priors`.

    table : the GF table to use (built when None), so several variants
        share one.
    domain, station_corrections : the wavemaps' options.
    n_events : 2 adds the wavemaps of a second event at
        ``EVENT_OFFSETS[1]`` (the same observations) and a second source.
    composite_options : ``SeismicGeometryComposite`` keywords
        (``hp_specific``, ``noise_analyser``, ``ensemble_tables``)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    if table is None:
        table = flagship_table(n_distances, n_depths, nt, device=dev)
    priors = source_priors(source, n_events)
    patches = finite_patches(priors) if source == "RectangularSource" else None
    st_e, st_n = flagship_stations(n_stations, rng)
    raw = flagship_observations(table, st_e, st_n, rng, rectangle_patches=patches)
    wavemaps = []
    for event in range(n_events):
        for name, dsets in flagship_datasets(st_e, st_n, raw).items():
            wavemaps.append(WaveformMapping(
                name=name, datasets=dsets, table=table, taper=ArrivalTaper(**TAPER),
                filterer=Filter(**FILTER), domain=domain,
                station_corrections=station_corrections, event_idx=event,
                event_offset=EVENT_OFFSETS[event], mapnumber=len(wavemaps)))
    if patches is not None:
        composite_options.setdefault("finite_patches", patches)
    comp = SeismicGeometryComposite(wavemaps, [source_template(source)] * n_events,
                                    n_events=n_events, device=dev, **composite_options)
    problem = Problem(priors, {"seismic": comp}, device=dev, outfolder=outfolder)
    problem.observations = (st_e, st_n, raw)
    return problem


def write_fullmt_project(problem, pdir: str, sampler_parameters: dict) -> None:
    """The FullMT flagship problem as a project directory, written by the
    port's own writers: ``init_config`` and ``dump_config`` (the
    flagship's priors, wavemaps, taper, filter and ``sampler_parameters``),
    ``save_seismic_datasets`` and ``GreensTable.save`` to ``gf_table.npz``;
    ``models.problem.load_model(pdir)`` loads it."""
    import os

    from beat_tpu_torch.config import (ArrivalTaperConfig, EventConfig, FilterConfig,
                                       WaveformFitConfig, dump_config, init_config)
    from beat_tpu_torch.inputf import save_seismic_datasets

    cfg = init_config("fullmt", pdir, datatypes=("seismic",), source_types=("MTSource",),
                      event=EventConfig(depth=TRUE_DEPTH))
    set_config_priors(cfg, problem.source_priors.parameters)
    cfg.seismic_config.waveforms = [
        WaveformFitConfig(name=name, channels=list(channels), filterer=FilterConfig(**FILTER),
                          arrival_taper=ArrivalTaperConfig(**TAPER))
        for name, channels in WAVEMAPS.items()]
    cfg.sampler_config.parameters = dict(sampler_parameters)
    dump_config(cfg, pdir)
    st_e, st_n, raw = problem.observations
    save_seismic_datasets([ds for dsets in flagship_datasets(st_e, st_n, raw).values()
                           for ds in dsets], pdir)
    problem.composites["seismic"].tables[0].save(os.path.join(pdir, "gf_table.npz"))


def set_config_priors(cfg, priors: dict, hierarchicals: dict | None = None) -> None:
    """Replace a config's priors by ``priors`` (``{name: Parameter}`` in
    SI, as the problems hold them), in the config's units;
    ``hierarchicals`` go to its ``hyperparameters`` section."""
    pc = cfg.problem_config
    pc.priors = {}
    for target, params in ((pc.priors, priors), (pc.hyperparameters, hierarchicals or {})):
        for p in params.values():
            scale = 1e-3 if p.name in pc.KM_SCALED_VARS else 1.0
            d = p.to_dict()
            for key in ("lower", "upper", "testvalue"):
                d[key] = [v * scale for v in d[key]]
            target[p.name] = d


# ---------------------------------------------------------------------------
# The kinematic FFI problem
# ---------------------------------------------------------------------------

FFI_REAL_SIZE = dict(n_targets=12, n_strike=50, n_dip=10, nt=1024, nwin=512)
FFI_TEST_SIZE = dict(n_targets=3, n_strike=4, n_dip=2, nt=256, nwin=64)

FFI_DT = 0.25
FFI_PATCH = 2e3                                  # patch edge [m]
FFI_PLANE = dict(depth=2e3, strike=135.0, dip=50.0, rake=-90.0)
FFI_DISTANCES = (20e3, 150e3, 12)                # table grid: start, stop, nodes
FFI_DEPTHS = (1e3, 25e3, 8)
FFI_STATION_RANGE = (50e3, 130e3)
FFI_FILTER = dict(lower_corner=0.02, upper_corner=0.5, order=3)
FFI_DURATIONS = dict(duration_bounds=(0.5, 5.0), duration_sampling=0.5)
FFI_STARTTIMES = dict(starttime_bounds=(0.0, 7.75), starttime_sampling=0.25)
FFI_TRUE_VELOCITY = 3000.0
FFI_NOISE_LEVEL = 0.02


def ffi_taper(nwin: int) -> ArrivalTaper:
    """The arrival taper spanning exactly ``nwin`` samples at FFI_DT."""
    return ArrivalTaper(a=-4.0, b=-2.0, c=nwin * FFI_DT - 10.0, d=nwin * FFI_DT - 4.0)


def ffi_priors(n_strike: int, n_dip: int) -> PriorSet:
    """Slip, duration and rupture velocity per patch and the nucleation
    point (the hyperparameters are added by the Problem)."""
    n = n_strike * n_dip
    return (PriorSet()
            .add(Parameter("uparr", [0.0] * n, [4.0] * n))
            .add(Parameter("durations", [0.5] * n, [4.0] * n))
            .add(Parameter("velocities", [2000.0] * n, [4000.0] * n))
            .add(Parameter("nucleation_strike", [0.0], [n_strike * FFI_PATCH]))
            .add(Parameter("nucleation_dip", [0.0], [n_dip * FFI_PATCH])))


def ffi_true_point(fault, n_strike: int, rng: np.random.Generator) -> dict:
    """The known rupture (host numpy): slip tapering off along strike,
    on-grid durations, a uniform rupture velocity, nucleation at 0.3 of
    the length and 1 km down dip."""
    n = fault.npatches
    slips = rng.uniform(0.3, 2.5, n) * np.exp(
        -((np.arange(n) % n_strike - n_strike / 2) ** 2) / (n_strike / 3) ** 2)
    return {"uparr": slips,
            "durations": np.round(rng.uniform(0.5, 3.0, n) * 2) / 2,
            "velocities": np.full(n, FFI_TRUE_VELOCITY),
            "nucleation_strike": 0.3 * n_strike * FFI_PATCH,
            "nucleation_dip": 1e3}


def build_ffi_flagship(n_targets: int, n_strike: int, n_dip: int, nt: int, nwin: int,
                       seed: int = 0, *, device, outfolder: str = "ffi_run",
                       interpolation: str = "multilinear") -> Problem:
    """The kinematic FFI Problem at the given size, all tensors on
    ``device``.  ``problem.true_point`` holds the rupture behind the
    data (on-grid onsets: the eikonal times rounded to the starttime
    sampling)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    ref = RectangularSource(length=n_strike * FFI_PATCH, width=n_dip * FFI_PATCH, **FFI_PLANE)
    fault = discretize_sources([ref], patch_length=FFI_PATCH, patch_width=FFI_PATCH)

    d0, d1, nd = FFI_DISTANCES
    z0, z1, nz = FFI_DEPTHS
    table = build_homogeneous_table(np.linspace(d0, d1, nd), np.linspace(z0, z1, nz), nt=nt,
                                    dt=FFI_DT, device=dev)
    az = np.linspace(0, 2 * np.pi, n_targets, endpoint=False) + 0.3
    dist = rng.uniform(*FFI_STATION_RANGE, n_targets)
    st_e, st_n = dist * np.sin(az), dist * np.cos(az)
    datasets = [SeismicDataset(station=f"ST{i:02d}", channel="Z", east=st_e[i], north=st_n[i],
                               ydata=np.zeros(nt)) for i in range(n_targets)]
    wavemap = WaveformMapping(name="any_P", datasets=datasets, table=table,
                              taper=ffi_taper(nwin), filterer=Filter(**FFI_FILTER))
    lib = seis_construct_gf_linear(table, wavemap, fault, component="uparr",
                                   **FFI_DURATIONS, **FFI_STARTTIMES)

    # observed data from the known rupture, stacked at the nearest cells
    true = ffi_true_point(fault, n_strike, rng)

    def row(x):
        return torch.as_tensor(np.atleast_1d(x), dtype=DTYPE, device=dev)[None]

    onsets = fault.point2starttimes(0, row(true["velocities"]), row(true["nucleation_strike"])[0],
                                    row(true["nucleation_dip"])[0])
    sampling = FFI_STARTTIMES["starttime_sampling"]
    onsets = torch.round(onsets / sampling) * sampling
    synth = lib.stack_all(row(true["durations"]), onsets[:, None, :], row(true["uparr"]),
                          "nearest_neighbor")[0].cpu().numpy()
    sd = FFI_NOISE_LEVEL * np.abs(synth).max()
    wavemap.data_windows = (synth + rng.normal(0, sd, synth.shape)).astype(np.float32)
    for ds in wavemap.datasets:
        ds.covariance = Covariance(data=np.eye(wavemap.nsamples_win) * sd**2)

    comp = SeismicDistributerComposite([(wavemap, {"uparr": lib})], fault,
                                       slip_varnames=("uparr",), interpolation=interpolation,
                                       device=dev)
    lap = LaplacianDistributerComposite(fault, slip_varnames=("uparr",), device=dev)
    problem = Problem(ffi_priors(n_strike, n_dip), {"seismic": comp, "laplacian": lap},
                      device=dev, outfolder=outfolder)
    problem.true_point = true
    return problem


# The geodetic problems
# ---------------------------------------------------------------------------
#
# Both follow BEAT's documented L'Aquila workflow (the geometry run, then
# the static finite-fault inversion of ``docs/examples/FFI_static.rst``),
# hermetic: the scenes are synthesized, not read.  Each has two InSAR
# scenes with Envisat-like geometry (ascending heading −13°, descending
# −167°, incidence 23°), points scattered with a density falling off away
# from the source as quadtree leaves are, a full exponential noise
# covariance (sd 5 mm, 5 km correlation length) and a draw of that noise.

GEO_REAL_SIZE = dict(n_points=1500)
GEO_TEST_SIZE = dict(n_points=120)
#: the L'Aquila rectangle of the published geometry inversion (anchored at
#: its top-center)
GEO_TRUE = dict(east_shift=1000.0, north_shift=-500.0, depth=1.5e3, strike=146.0, dip=52.0,
                rake=-110.0, length=12e3, width=10e3, slip=0.6)
GEO_PRIORS = dict(east_shift=(-5e3, 5e3), north_shift=(-5e3, 5e3), depth=(0.5e3, 4e3),
                  strike=(120.0, 170.0), dip=(35.0, 70.0), rake=(-150.0, -70.0),
                  length=(8e3, 16e3), width=(6e3, 14e3), slip=(0.2, 1.5))
#: scene name: (heading, incidence) [deg]
GEO_SCENES = {"asc": (-13.0, 23.0), "dsc": (-167.0, 23.0)}
#: scene name: (azimuth ramp, range ramp [m/m], offset [m]) behind the data
GEO_RAMPS = {"asc": (2.0e-7, -1.5e-7, 4e-3), "dsc": (-1.0e-7, 2.5e-7, -3e-3)}
GEO_RAMP_PRIORS = dict(azimuth_ramp=(-1e-6, 1e-6), range_ramp=(-1e-6, 1e-6),
                       offset=(-0.02, 0.02))
GEO_HALF_BOX = 40e3                 # the scenes cover ±40 km
GEO_NOISE_SD = 5e-3
GEO_CORRELATION_LENGTH = 5e3
#: the event's geographic reference (L'Aquila), for the GNSS stations
GEO_EVENT_LATLON = (42.35, 13.38)
#: the plate rotation and strain rate behind the GNSS data
GEO_POLE = dict(pole_lat=50.0, pole_lon=5.0, omega=0.3)
GEO_POLE_PRIORS = dict(pole_lat=(45.0, 55.0), pole_lon=(0.0, 10.0), omega=(0.1, 0.5))
GEO_STRAIN = dict(exx=20.0, eyy=-15.0, exy=8.0, rotation=-5.0)
GEO_STRAIN_PRIORS = dict(exx=(-50.0, 50.0), eyy=(-50.0, 50.0), exy=(-50.0, 50.0),
                         rotation=(-50.0, 50.0))
GEO_GNSS_SD = {"east": 1e-3, "north": 1e-3, "up": 3e-3}


def scatter_points(n: int, rng: np.random.Generator, half_along: float, half_across: float,
                   dense_at=(0.0, 0.0), scale: float = 12e3) -> np.ndarray:
    """(n, 2) points in the box ±half_along × ±half_across [m], each kept
    with probability exp(-r/scale) + 0.1, r its distance to ``dense_at``:
    dense near the source, sparse far from it, as the leaves of a
    quadtree-subsampled scene."""
    pts = np.empty((0, 2))
    while len(pts) < n:
        cand = rng.uniform([-half_along, -half_across], [half_along, half_across], (4 * n, 2))
        r = np.hypot(*(cand - np.asarray(dense_at)).T)
        pts = np.concatenate([pts, cand[rng.uniform(size=len(cand)) < np.exp(-r / scale) + 0.1]])
    return pts[:n]


def exponential_covariance(coords: np.ndarray, sd: float, length: float) -> np.ndarray:
    """C_ij = sd² exp(-|x_i - x_j| / length)."""
    d = np.hypot(*(coords[:, None, :] - coords[None, :, :]).transpose(2, 0, 1))
    return sd**2 * np.exp(-d / length)


def insar_scenes(coords_by_scene: dict, signal_fn, rng: np.random.Generator,
                 ramps: dict | None = None) -> list:
    """The two InSAR datasets: LOS of ``signal_fn(coords) → (n, 3)`` ENU
    displacements, plus the scene's ramp, plus a correlated noise draw,
    each with its exponential covariance."""
    from beat_tpu_torch.heart.geodesy import diff_ifg

    datasets = []
    for name, (heading, incidence) in GEO_SCENES.items():
        coords = coords_by_scene[name]
        cov = exponential_covariance(coords, GEO_NOISE_SD, GEO_CORRELATION_LENGTH)
        noise = np.linalg.cholesky(cov) @ rng.normal(size=len(coords))
        ds = diff_ifg(name, coords, np.zeros(len(coords)), incidence, heading,
                      covariance=Covariance(data=cov))
        disp = np.sum(signal_fn(coords) * ds.los_vector, axis=-1) + noise
        if ramps is not None:
            az, rg, off = ramps[name]
            disp = disp + coords[:, 1] * az + coords[:, 0] * rg + off
        ds.displacement = disp
        datasets.append(ds)
    return datasets


def rectangle_displacement(coords: np.ndarray, **params) -> np.ndarray:
    """(n, 3) ENU displacements of one rectangle, float64 on the host."""
    from beat_tpu_torch.heart.okada import okada_surface_displacement

    c = torch.as_tensor(coords, dtype=torch.float64)
    p = {k: torch.tensor(float(v), dtype=torch.float64) for k, v in params.items()}
    return okada_surface_displacement(c, **p).numpy()


def geodetic_source_priors(source: str) -> PriorSet:
    """The source priors of the geodetic geometry problem: GEO_PRIORS for
    the rectangle; for the other source types those of the waveform
    problem without time and duration, around the rectangle's position."""
    if source == "RectangularSource":
        bounds = GEO_PRIORS
    else:
        bounds = {k: v for k, v in SOURCE_PRIORS[source].items()
                  if k not in ("time", "duration", "delta_time")}
        bounds.update(east_shift=(-5e3, 5e3), north_shift=(-5e3, 5e3), depth=(2e3, 10e3))
    priors = PriorSet()
    for name, b in bounds.items():
        priors.add(Parameter.from_defaults(name) if b is None else Parameter(name, [b[0]], [b[1]]))
    return priors


def geodetic_ramp_priors(priors: PriorSet) -> tuple:
    """``(priors, true)``: the source priors plus one ramp per scene (3
    parameters each, GEO_RAMP_PRIORS), and the parameters behind the data
    (GEO_TRUE and GEO_RAMPS)."""
    true = dict(GEO_TRUE)
    for name in GEO_SCENES:
        for key, value in zip(GEO_RAMP_PRIORS, GEO_RAMPS[name]):
            priors.add(Parameter(f"{name}_{key}", [GEO_RAMP_PRIORS[key][0]],
                                 [GEO_RAMP_PRIORS[key][1]]))
            true[f"{name}_{key}"] = value
    return priors, true


def gnss_network(n_stations: int, rng: np.random.Generator, signal_fn) -> tuple:
    """Three GNSS component datasets (east, north, up) of ``n_stations``
    stations within ±80 km, displaced by ``signal_fn`` plus the plate
    rotation and strain rate of GEO_POLE and GEO_STRAIN over one year plus
    noise, and their Euler-pole and strain-rate corrections."""
    from beat_tpu_torch.heart.corrections import (EulerPoleCorrection, StrainRateCorrection,
                                                  velocities_from_pole,
                                                  velocities_from_strain_rate_tensor)
    from beat_tpu_torch.heart.geodesy import EARTH_RADIUS, D2R, gnss_compound

    lat0, lon0 = GEO_EVENT_LATLON
    coords = rng.uniform(-80e3, 80e3, (n_stations, 2))
    lats = lat0 + coords[:, 1] / (D2R * EARTH_RADIUS)
    lons = lon0 + coords[:, 0] / (D2R * EARTH_RADIUS * np.cos(lat0 * D2R))
    norths, easts = coords[:, 1] - coords[:, 1].mean(), coords[:, 0] - coords[:, 0].mean()
    f64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in GEO_POLE.items()}
    v_pole = velocities_from_pole(lats, lons, **f64).numpy()
    s64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in GEO_STRAIN.items()}
    v_strain = velocities_from_strain_rate_tensor(norths, easts, **s64).numpy()
    enu = signal_fn(coords)
    stations = np.array([f"GN{i:02d}" for i in range(n_stations)])
    datasets, corrections = [], []
    for axis, comp in enumerate(("east", "north", "up")):
        neu = (1, 0, 2)[axis]
        sd = GEO_GNSS_SD[comp]
        disp = enu[:, axis] + v_pole[:, neu] + v_strain[:, neu] + rng.normal(0, sd, n_stations)
        name = f"gnss_{comp}"
        datasets.append(gnss_compound(name, coords, disp, comp, lats=lats, lons=lons,
                                      stations=stations,
                                      covariance=Covariance(data=np.eye(n_stations) * sd**2)))
        corrections += [EulerPoleCorrection(0, lats, lons, dataset_name=name),
                        StrainRateCorrection(0, norths, easts, dataset_name=name)]
    return datasets, corrections


def build_geodetic_flagship(n_points: int, seed: int = 0, *, device,
                            outfolder: str = "geo_run", source: str = "RectangularSource",
                            gnss_stations: int = 0, static_table=None, finite_patches=(4, 4),
                            noise_structure: str = "import", ensemble_nus=None,
                            ensemble_tables=None, hp_specific: bool = False) -> Problem:
    """The geodetic geometry Problem (BASELINE config 1): two InSAR
    scenes of ``n_points`` each from the rectangle GEO_TRUE plus ramps
    and correlated noise; sampled are ``source``'s parameters (GEO_PRIORS
    for the rectangle), one ramp per scene (3 parameters each) and the
    hyperparameter(s).  ``gnss_stations`` adds a GNSS network with an
    Euler-pole and a strain-rate correction; ``static_table`` routes the
    forward through a static GF table.  ``problem.true_point`` holds the
    parameters behind the data (the rectangle's)."""
    from beat_tpu_torch.heart.corrections import RampCorrection
    from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    center = (GEO_TRUE["east_shift"], GEO_TRUE["north_shift"])
    coords = {name: scatter_points(n_points, rng, GEO_HALF_BOX, GEO_HALF_BOX) + center
              for name in GEO_SCENES}

    def signal(c):
        return rectangle_displacement(c, **GEO_TRUE)

    datasets = insar_scenes(coords, signal, rng, GEO_RAMPS)
    corrections = [RampCorrection(name) for name in GEO_SCENES]
    priors, true = geodetic_ramp_priors(geodetic_source_priors(source))
    if gnss_stations:
        gnss, gnss_corr = gnss_network(gnss_stations, rng, signal)
        datasets += gnss
        corrections += gnss_corr
        for bounds, values in ((GEO_POLE_PRIORS, GEO_POLE), (GEO_STRAIN_PRIORS, GEO_STRAIN)):
            for key, (lo, hi) in bounds.items():
                priors.add(Parameter(f"0_{key}", [lo], [hi]))
                true[f"0_{key}"] = values[key]
    template = (RectangularSource(**GEO_TRUE) if source == "RectangularSource"
                else source_catalog[source](depth=5e3))
    comp = GeodeticGeometryComposite(
        datasets, [template], static_table=static_table, finite_patches=finite_patches,
        ensemble_nus=ensemble_nus, ensemble_tables=ensemble_tables, corrections=corrections,
        noise_structure=noise_structure, hp_specific=hp_specific, device=dev)
    problem = Problem(priors, {"geodetic": comp}, device=dev, outfolder=outfolder)
    problem.true_point = dict(true, **{h: 0.0 for h in comp.get_hypernames()})
    return problem


STATIC_FFI_REAL_SIZE = dict(n_strike=50, n_dip=10, n_points=1500)
STATIC_FFI_TEST_SIZE = dict(n_strike=4, n_dip=2, n_points=100)
#: the sampled slip ranges of ``FFI_static.rst`` (uparr, uperp) [m]
STATIC_FFI_PRIORS = dict(uparr=(-0.1, 2.0), uperp=(-1.0, 1.0))
STATIC_FFI_MARGIN = 30e3            # the scenes cover the fault's projection ± 30 km
STATIC_FFI_PEAK_SLIP = 1.5


def static_ffi_true_slips(fault, n_strike: int, n_dip: int) -> dict:
    """The smooth slip patch behind the data: a Gaussian of peak 1.5 m
    along rake centred at 0.4 of the length and of the width, and a tenth
    of it across rake."""
    centers = fault.subfaults[0].patch_centers_local()
    length, width = n_strike * FFI_PATCH, n_dip * FFI_PATCH
    blob = STATIC_FFI_PEAK_SLIP * np.exp(
        -0.5 * (((centers[:, 0] - 0.4 * length) / (0.15 * length + 2e3)) ** 2
                + ((centers[:, 1] - 0.4 * width) / (0.3 * width + 2e3)) ** 2))
    return {"uparr": blob, "uperp": 0.1 * blob}


def static_ffi_data(ref, fault, true: dict, n_points: int, rng: np.random.Generator, *,
                    device) -> tuple:
    """``(datasets, library)`` of a static finite-fault problem on
    ``fault`` (the plane ``ref``): two InSAR scenes of ``n_points`` each
    over the fault's surface projection ± 30 km, dense around the patch of
    the largest ``uparr``, synthesized through the library (built on
    ``device`` for the fault's components) from the slips ``true`` plus
    correlated noise (ramps fixed and removed)."""
    from beat_tpu_torch.ffi.gflibrary import geo_construct_gf_linear
    from beat_tpu_torch.heart.geodesy import los_vectors

    components = tuple(fault.components)
    # the scenes in the fault's frame: along strike from the plane's
    # center, across it horizontally from the middle of its projection
    st = np.deg2rad(ref.strike)
    across_w = ref.width * np.cos(np.deg2rad(ref.dip))
    s_vec, t_vec = np.array([np.sin(st), np.cos(st)]), np.array([np.cos(st), -np.sin(st)])
    blob_c = fault.subfaults[0].patches[int(np.argmax(true["uparr"]))].center()[:2]
    origin = np.array([ref.east_shift, ref.north_shift]) + 0.5 * across_w * t_vec
    blob_rel = blob_c - origin
    coords = {}
    for name in GEO_SCENES:
        local = scatter_points(n_points, rng, ref.length / 2 + STATIC_FFI_MARGIN,
                               across_w / 2 + STATIC_FFI_MARGIN,
                               dense_at=(blob_rel @ s_vec, blob_rel @ t_vec))
        coords[name] = origin + local[:, :1] * s_vec + local[:, 1:] * t_vec
    all_coords = np.concatenate(list(coords.values()))
    los = np.concatenate([los_vectors(len(coords[name]), GEO_SCENES[name][1],
                                      GEO_SCENES[name][0]) for name in GEO_SCENES])
    lib = geo_construct_gf_linear(fault, all_coords, los, components=components, device=device)
    synth = sum(true[c] @ lib.gf(c).double().cpu().numpy() for c in components)
    offsets = np.cumsum([0] + [len(coords[name]) for name in GEO_SCENES])
    datasets = insar_scenes(coords, lambda c: np.zeros((len(c), 3)), rng)
    for ds, a, b in zip(datasets, offsets[:-1], offsets[1:]):
        ds.displacement = ds.displacement + synth[a:b]
    return datasets, lib


def build_static_ffi_flagship(n_strike: int, n_dip: int, n_points: int, seed: int = 0, *,
                              device, outfolder: str = "static_ffi_run",
                              initialization: str = "lsq") -> Problem:
    """The static finite-fault Problem (BASELINE config 4): the fault of
    :func:`build_ffi_flagship` (strike 135°, dip 50°, 2 km patches), two
    InSAR scenes of ``n_points`` each over the fault's surface projection
    ± 30 km, synthesized through the library from a smooth slip patch
    plus correlated noise (ramps fixed and removed); sampled are
    ``uparr`` and ``uperp`` per patch, ``h_laplacian`` and ``h_SAR``,
    started from the NNLS solution (``initialization``).
    ``problem.true_point`` holds the slips behind the data."""
    from beat_tpu_torch.models.distributer import GeodeticDistributerComposite

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    ref = RectangularSource(length=n_strike * FFI_PATCH, width=n_dip * FFI_PATCH, **FFI_PLANE)
    fault = discretize_sources([ref], patch_length=FFI_PATCH, patch_width=FFI_PATCH,
                               components=("uparr", "uperp"))
    true = static_ffi_true_slips(fault, n_strike, n_dip)
    datasets, lib = static_ffi_data(ref, fault, true, n_points, rng, device=dev)

    priors = PriorSet()
    for name, (lo, hi) in STATIC_FFI_PRIORS.items():
        priors.add(Parameter(name, [lo] * fault.npatches, [hi] * fault.npatches))
    comp = GeodeticDistributerComposite(datasets, lib, fault, device=dev)
    lap = LaplacianDistributerComposite(fault, slip_varnames=("uparr", "uperp"), device=dev)
    problem = Problem(priors, {"geodetic": comp, "laplacian": lap}, device=dev,
                      outfolder=outfolder, initialization=initialization)
    problem.true_point = dict(true, h_SAR=0.0, h_laplacian=0.0)
    return problem


#: the trans-dimensional problem's two slip levels [m]: the central
#: along-strike third of the fault, and the rest
TRANSD_SLIPS = (1.5, 0.3)


def transd_true_slips(fault, n_strike: int) -> dict:
    """The two-level slip behind the trans-dimensional problem's data:
    1.5 m on the patches of the central third along strike, 0.3 m
    elsewhere (along rake)."""
    along = fault.subfaults[0].patch_centers_local()[:, 0]
    length = n_strike * FFI_PATCH
    central = (along > length / 3) & (along < 2 * length / 3)
    return {"uparr": np.where(central, *TRANSD_SLIPS)}


def build_transd_flagship(n_strike: int, n_dip: int, n_points: int, seed: int = 0, *,
                          device, outfolder: str = "transd_run") -> Problem:
    """The trans-dimensional Voronoi problem on the static FFI flagship's
    fault and scenes (:func:`static_ffi_data`): ``uparr`` only, a
    two-level slip behind the data (:func:`transd_true_slips`).  Sample
    it with ``problem.sample(TransDParams(...))``; the priors (``uparr``
    per patch in ``STATIC_FFI_PRIORS``, ``h_SAR``) serve the other
    samplers and the diagnostics.  ``problem.true_point`` holds the slips
    behind the data."""
    from beat_tpu_torch.models.distributer import GeodeticDistributerComposite

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    ref = RectangularSource(length=n_strike * FFI_PATCH, width=n_dip * FFI_PATCH, **FFI_PLANE)
    fault = discretize_sources([ref], patch_length=FFI_PATCH, patch_width=FFI_PATCH,
                               components=("uparr",))
    true = transd_true_slips(fault, n_strike)
    datasets, lib = static_ffi_data(ref, fault, true, n_points, rng, device=dev)
    lo, hi = STATIC_FFI_PRIORS["uparr"]
    priors = PriorSet().add(Parameter("uparr", [lo] * fault.npatches, [hi] * fault.npatches))
    comp = GeodeticDistributerComposite(datasets, lib, fault, device=dev)
    problem = Problem(priors, {"geodetic": comp}, device=dev, outfolder=outfolder)
    problem.true_point = dict(true, h_SAR=0.0)
    return problem


# ---------------------------------------------------------------------------
# The joint seismic + geodetic problem
# ---------------------------------------------------------------------------
#
# BASELINE config 3: one rectangle behind both data types, the waveforms of
# the FullMT problem's stations and table and the InSAR scenes of the
# geodetic problem.

JOINT_REAL_SIZE = dict(n_stations=10, n_distances=206, n_depths=15, nt=1024, n_points=1500)
JOINT_TEST_SIZE = dict(n_stations=4, n_distances=11, n_depths=5, nt=128, n_points=120)
#: the rectangle behind both data types: the published rectangle with the
#: kinematics of the waveform problem's TRUE_RECTANGLE
JOINT_TRUE = dict(GEO_TRUE, **{k: TRUE_RECTANGLE[k] for k in (
    "nucleation_x", "nucleation_y", "velocity", "duration")}, time=0.0)
#: the seismic composite's patch grid (that of the waveform problem's rectangle)
JOINT_PATCHES = (8, 5)
#: the source parameters only the waveforms see
JOINT_SEISMIC_ONLY = ("nucleation_x", "nucleation_y", "velocity", "time", "duration")


def build_joint_flagship(n_stations: int, n_distances: int, n_depths: int, nt: int,
                         n_points: int, seed: int = 0, *, device,
                         outfolder: str = "joint_run", table=None) -> Problem:
    """The joint seismic + geodetic Problem (BASELINE config 3), all
    tensors on ``device``: the geodetic problem's two InSAR scenes of
    ``n_points`` each (:func:`build_geodetic_flagship`, the rectangle
    ``GEO_TRUE`` plus ramps and correlated noise) and the FullMT
    problem's stations, table and wavemaps with waveforms of the same
    rectangle (:data:`JOINT_TRUE`, on :data:`JOINT_PATCHES`) plus 2 %
    noise.  Sampled: the rectangle's parameters (shared by both
    composites, ``GEO_PRIORS``), the waveform-only kinematics
    (:data:`JOINT_SEISMIC_ONLY`, the waveform problem's priors), a ramp
    per scene and the hyperparameters ``h_SAR``, ``h_any_P_0`` and
    ``h_any_S_1``.  ``problem.true_point`` holds the parameters behind
    the data."""
    dev = resolve(device)
    geo = build_geodetic_flagship(n_points, seed, device=dev, outfolder=outfolder)
    rng = np.random.default_rng(seed + 1)
    if table is None:
        table = flagship_table(n_distances, n_depths, nt, device=dev)
    st_e, st_n = flagship_stations(n_stations, rng)
    raw = flagship_observations(table, st_e, st_n, rng, rectangle_patches=JOINT_PATCHES,
                                rectangle=JOINT_TRUE)
    wavemaps = [WaveformMapping(name=name, datasets=dsets, table=table,
                                taper=ArrivalTaper(**TAPER), filterer=Filter(**FILTER),
                                mapnumber=i)
                for i, (name, dsets) in enumerate(
                    flagship_datasets(st_e, st_n, raw).items())]
    seis = SeismicGeometryComposite(wavemaps, [RectangularSource(**JOINT_TRUE)],
                                    finite_patches=JOINT_PATCHES, device=dev)
    priors = PriorSet()
    for p in geo.source_priors.parameters.values():
        priors.add(p)
    for name in JOINT_SEISMIC_ONLY:
        lo, hi = SOURCE_PRIORS["RectangularSource"][name]
        priors.add(Parameter(name, [lo], [hi]))
    problem = Problem(priors, {"seismic": seis, "geodetic": geo.composites["geodetic"]},
                      device=dev, outfolder=outfolder)
    problem.true_point = dict(geo.true_point,
                              **{k: JOINT_TRUE[k] for k in JOINT_SEISMIC_ONLY},
                              **{h: 0.0 for h in seis.get_hypernames()})
    problem.observations = (st_e, st_n, raw)
    return problem


# ---------------------------------------------------------------------------
# First-motion polarities joint with the FullMT waveforms
# ---------------------------------------------------------------------------
# The FullMT problem plus two polarity maps: P first motions at
# ``n_polarity_p`` stations and SH at ``n_polarity_sh``, over the table's
# distance range and all azimuths, noise-free from the true double couple
# at the true depth; takeoffs from the default crust through one
# (depth × distance) table per phase, so every chain's sampled depth moves
# its ray geometry.

POLARITY_REAL_SIZE = dict(REAL_SIZE, n_polarity_p=60, n_polarity_sh=20, takeoff_depths=33,
                          takeoff_distances=64)
POLARITY_TEST_SIZE = dict(TEST_SIZE, n_polarity_p=12, n_polarity_sh=6, takeoff_depths=9,
                          takeoff_distances=16)
#: polarity map name: (ray phase, radiation pattern's phase)
POLARITY_MAPS = {"any_P": "p", "any_SH": "s"}


def polarity_targets(n_stations: int, phase: str, wavename: str, model,
                     rng: np.random.Generator) -> tuple:
    """``(targets, true amplitudes)`` of ``n_stations`` stations over
    DISTANCE_RANGE and all azimuths: the first motions of the true double
    couple at TRUE_DEPTH (takeoffs from the host ray tracer, float64)."""
    from beat_tpu_torch.heart.polarity import PolarityTarget, radiation_weights, takeoff_vector
    from beat_tpu_torch.heart.velocity_model import takeoff_angles

    dist = rng.uniform(*DISTANCE_RANGE, n_stations)
    az = rng.uniform(0.0, 2 * np.pi, n_stations)
    to = takeoff_angles(model, TRUE_DEPTH, dist, phase)
    az64, to64 = torch.as_tensor(az), torch.as_tensor(to)
    w = radiation_weights(wavename, takeoff_vector(az64, to64), az64, to64)
    amps = (w @ sdr_to_m6(*TRUE_SDR, 1.0).double()).numpy()
    targets = [PolarityTarget(station=f"{wavename}{i:02d}", azimuth_rad=float(az[i]),
                              takeoff_rad=float(to[i]), polarity=int(np.sign(amps[i])),
                              distance_m=float(dist[i]))
               for i in range(n_stations)]
    return targets, amps


def build_polarity_flagship(n_stations: int, n_distances: int, n_depths: int, nt: int,
                            n_polarity_p: int, n_polarity_sh: int, takeoff_depths: int,
                            takeoff_distances: int, seed: int = 0, *, device,
                            outfolder: str = "polarity_run", table=None) -> Problem:
    """The FullMT Problem (:func:`build_flagship`) with a polarity
    composite beside the waveforms: maps ``any_P`` and ``any_SH``
    (hyperparameters ``h_any_P_pol_0``, ``h_any_SH_pol_1``) with per-draw
    takeoffs from :class:`~beat_tpu_torch.heart.polarity.TakeoffTable`\\ s
    of ``takeoff_depths`` × ``takeoff_distances`` nodes over the GF
    table's depth and distance ranges.  ``problem.polarity_amplitudes``
    holds each map's true radiation amplitudes."""
    from beat_tpu_torch.heart.polarity import build_takeoff_table
    from beat_tpu_torch.heart.velocity_model import LayeredModel
    from beat_tpu_torch.models.polarity import PolarityComposite, PolarityMapping

    dev = resolve(device)
    seis = build_flagship(n_stations, n_distances, n_depths, nt, seed, device=dev,
                          outfolder=outfolder, table=table)
    rng = np.random.default_rng(seed + 2)
    model = LayeredModel.default_crust()
    maps, amplitudes = [], {}
    for i, ((wavename, phase), n) in enumerate(zip(POLARITY_MAPS.items(),
                                                   (n_polarity_p, n_polarity_sh))):
        targets, amplitudes[wavename] = polarity_targets(n, phase, wavename, model, rng)
        takeoffs = build_takeoff_table(model, np.linspace(*DEPTH_RANGE, takeoff_depths),
                                       np.linspace(*DISTANCE_RANGE, takeoff_distances),
                                       phase, device=dev)
        maps.append(PolarityMapping(wavename, targets, mapnumber=i, takeoff_table=takeoffs,
                                    device=dev))
    comp = seis.composites["seismic"]
    pol = PolarityComposite(sources=comp.sources, maps=maps, device=dev)
    problem = Problem(seis.source_priors, {"seismic": comp, "polarity": pol}, device=dev,
                      outfolder=outfolder)
    problem.observations = seis.observations
    problem.polarity_amplitudes = amplitudes
    return problem


# ---------------------------------------------------------------------------
# BEM: a pressurized sill under the geodetic problem's scenes
# ---------------------------------------------------------------------------
# The disk of ``examples/bem_dike.py`` (1 km radius, 3 km deep, 20 MPa of
# normal traction) in a half space, seen by the geodetic flagship's two
# InSAR scenes (Envisat-like geometry, quadtree-like density around the
# source, full exponential covariances and a draw of that noise).  The
# linear problem fixes the geometry and samples the traction; the geometry
# problem samples the depth as well, at the engine's cheaper sampling
# levels.

BEM_REAL_SIZE = dict(n_points=1500, mesh_size=100.0, quadrature_level=2,
                     near_quadrature_level=6)
BEM_GEOMETRY_REAL_SIZE = dict(n_points=1500, mesh_size=300.0, quadrature_level=1,
                              near_quadrature_level=5)
BEM_TEST_SIZE = dict(n_points=300, mesh_size=1000.0, quadrature_level=1,
                     near_quadrature_level=3)
BEM_SOURCE = dict(depth=3e3, a_half_axis=1e3)
BEM_TRUE_TRACTION = 20.0                         # [MPa]
BEM_PRIORS = dict(normal_traction=(1.0, 60.0), depth=(1.5e3, 6e3))


def build_bem_flagship(n_points: int, mesh_size: float, quadrature_level: int,
                       near_quadrature_level: int, seed: int = 0, *, device,
                       geometry: bool = False, outfolder: str = "bem_run") -> Problem:
    """The BEM Problem, every matrix in float64 on ``device``: with
    ``geometry=False`` the :class:`GeodeticBEMLinearComposite` of the true
    disk, sampling ``normal_traction``; with ``geometry=True`` the
    :class:`GeodeticBEMComposite`, sampling ``depth`` as well.  The data
    are the two scenes' LOS of the true disk (BEM_SOURCE, BEM_TRUE_TRACTION)
    at the engine's levels plus correlated noise.  ``problem.true_point``
    holds the parameters behind the data."""
    from beat_tpu_torch.bem import BEMEngine, BoundaryCondition, DiskBEMSource
    from beat_tpu_torch.models.bem import (GeodeticBEMComposite, GeodeticBEMLinearComposite,
                                           unit_los_responses)

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    engine = BEMEngine([BoundaryCondition("normal", [0], [0], traction=BEM_TRUE_TRACTION)],
                       mesh_size=mesh_size, quadrature_level=quadrature_level,
                       near_quadrature_level=near_quadrature_level, device=dev)
    coords = {name: scatter_points(n_points, rng, GEO_HALF_BOX, GEO_HALF_BOX)
              for name in GEO_SCENES}
    # zero-signal scenes first (the noise draw), then the LOS of the truth
    datasets = insar_scenes(coords, lambda c: np.zeros((len(c), 3)), rng)
    stack_coords = np.concatenate([ds.coords for ds in datasets])
    stack_los = np.concatenate([ds.los_vector for ds in datasets])
    truth = [DiskBEMSource(**BEM_SOURCE)]
    unit_los = unit_los_responses(engine, truth, stack_coords, stack_los)
    signal = (unit_los[:, 0] * BEM_TRUE_TRACTION).cpu().numpy()
    start = 0
    for ds in datasets:
        ds.displacement = ds.displacement + signal[start:start + ds.samples]
        start += ds.samples
    priors = PriorSet().add(Parameter("normal_traction", [BEM_PRIORS["normal_traction"][0]],
                                      [BEM_PRIORS["normal_traction"][1]]))
    if geometry:
        priors.add(Parameter("depth", [BEM_PRIORS["depth"][0]], [BEM_PRIORS["depth"][1]]))
        comp = GeodeticBEMComposite(datasets, [DiskBEMSource(**BEM_SOURCE)], engine,
                                    device=dev)
    else:
        comp = GeodeticBEMLinearComposite(datasets, truth, engine, unit_los=unit_los,
                                          device=dev)
    problem = Problem(priors, {"geodetic": comp}, device=dev, outfolder=outfolder)
    problem.true_point = {"normal_traction": BEM_TRUE_TRACTION,
                          "depth": BEM_SOURCE["depth"],
                          **{h: 0.0 for h in comp.get_hypernames()}}
    return problem


# ---------------------------------------------------------------------------
# Problems on tables built by the port's layered builders
# ---------------------------------------------------------------------------
# The FullMT problem on a layered waveform table (the real FullMT table's
# grid, by the Kennett recursion on the card), and the geodetic problem's
# two scenes acquired at two post-seismic epochs through a viscoelastic
# table: build_gfs' geodetic grid (beat_tpu/apps/commands.py:570-575) for
# the default crust with Maxwell viscosities below its elastic lid.

LAYERED_REAL_SIZE = REAL_SIZE
LAYERED_TEST_SIZE = dict(n_stations=4, n_distances=6, n_depths=3, nt=128)
VISCO_REAL_SIZE = dict(n_points=1500, n_distances=40, n_depths=12)
VISCO_TEST_SIZE = dict(n_points=120, n_distances=6, n_depths=3)
VISCO_DISTANCES = (1e3, 120e3)
VISCO_DEPTHS = (0.5e3, 25e3)
#: Maxwell viscosities of the default crust's layers [Pa·s]: an elastic upper
#: crust over a 1e19 lower crust and a 1e18 mantle
VISCO_ETA2 = (0.0, 1e19, 1e18)
#: scene name: acquisition epoch [days after the event]
VISCO_EPOCH_DAYS = {"asc": 30.0, "dsc": 365.0}
VISCO_S_PER_DECADE = 8


def layered_earth_model():
    """The default crust continued by ak135-f average to 660 km and
    earth-flattened: 31 layers, all of it text in the repo."""
    from beat_tpu_torch.heart.velocity_model import LayeredModel, join_nd_with_ak135

    return LayeredModel.from_nd(join_nd_with_ak135(LayeredModel.default_crust().to_nd()),
                                name="default_crust+ak135").earth_flattened()


def layered_flagship_table(n_distances: int, n_depths: int, nt: int, *, device, model=None,
                           method: str = "kennett", stats: dict | None = None, **kwargs):
    """The FullMT problem's grid (DISTANCE_RANGE × DEPTH_RANGE, dt DT) as a
    layered waveform table of ``model`` (:func:`layered_earth_model` by
    default), built on ``device``; the depth grid nudged off the interfaces."""
    from beat_tpu_torch.heart.layered_waveforms import (build_layered_waveform_table,
                                                        nudge_depths_off_interfaces)

    model = layered_earth_model() if model is None else model
    depths = nudge_depths_off_interfaces(model, np.linspace(*DEPTH_RANGE, n_depths))
    return build_layered_waveform_table(model, np.linspace(*DISTANCE_RANGE, n_distances),
                                        depths, nt=nt, dt=DT, method=method, device=device,
                                        stats=stats, **kwargs)


def build_layered_flagship(n_stations: int, n_distances: int, n_depths: int, nt: int,
                           seed: int = 0, *, device, outfolder: str = "layered_run",
                           table=None, **table_kwargs) -> Problem:
    """The FullMT problem of :func:`build_flagship` on a layered waveform
    table (:func:`layered_flagship_table`, built on ``device`` when
    ``table`` is None): the data synthesized through it, the windows placed
    by its ray-traced travel times."""
    dev = resolve(device)
    if table is None:
        table = layered_flagship_table(n_distances, n_depths, nt, device=dev, **table_kwargs)
    return build_flagship(n_stations, n_distances, n_depths, nt, seed, device=dev,
                          outfolder=outfolder, table=table)


def visco_model() -> tuple:
    """``(model, rheology)`` of the post-seismic problem: the default crust
    with the Maxwell viscosities VISCO_ETA2."""
    from beat_tpu_torch.heart.velocity_model import LayeredModel
    from beat_tpu_torch.heart.viscoelastic import BurgersRheology

    model = LayeredModel.default_crust()
    return model, BurgersRheology(eta1=np.zeros(model.nlayers), eta2=np.asarray(VISCO_ETA2),
                                  alpha=np.ones(model.nlayers))


def visco_time_table(n_distances: int, n_depths: int, *, device,
                     s_per_decade: int = VISCO_S_PER_DECADE):
    """The viscoelastic table of the post-seismic problem
    (:func:`visco_model`) on build_gfs' grid at the scenes' epochs."""
    from beat_tpu_torch.heart.viscoelastic import DAY, build_viscoelastic_static_table

    model, rheo = visco_model()
    return build_viscoelastic_static_table(
        model, rheo, np.linspace(*VISCO_DISTANCES, n_distances),
        np.linspace(*VISCO_DEPTHS, n_depths),
        [VISCO_EPOCH_DAYS[name] * DAY for name in GEO_SCENES], s_per_decade=s_per_decade,
        device=device)


def build_visco_flagship(n_points: int, n_distances: int, n_depths: int, seed: int = 0, *,
                         device, outfolder: str = "visco_run", ttable=None,
                         finite_patches=(4, 4)) -> Problem:
    """The geodetic geometry problem (:func:`build_geodetic_flagship`'s
    rectangle GEO_TRUE, scenes, ramps and priors) with the scenes acquired
    at VISCO_EPOCH_DAYS after the event, through an
    :class:`~beat_tpu_torch.heart.viscoelastic.EpochStaticGFTable` of the
    time table ``ttable`` (:func:`visco_time_table` when None): the data
    are each scene's LOS through its own epoch's slab (the rectangle as
    ``finite_patches`` point MTs), plus its ramp and correlated noise.
    ``problem.true_point`` holds the parameters behind the data,
    ``problem.time_table`` the time table."""
    from beat_tpu_torch.heart.corrections import RampCorrection
    from beat_tpu_torch.heart.viscoelastic import epoch_table_for_datasets
    from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    if ttable is None:
        ttable = visco_time_table(n_distances, n_depths, device=dev)
    center = (GEO_TRUE["east_shift"], GEO_TRUE["north_shift"])
    coords = {name: scatter_points(n_points, rng, GEO_HALF_BOX, GEO_HALF_BOX) + center
              for name in GEO_SCENES}
    datasets = insar_scenes(coords, lambda c: np.zeros((len(c), 3)), rng, GEO_RAMPS)
    table = epoch_table_for_datasets(ttable, datasets, VISCO_EPOCH_DAYS, device=dev)
    truth = RectangularSource(**GEO_TRUE)
    signal = GeodeticGeometryComposite(datasets, [truth], static_table=table,
                                       finite_patches=finite_patches,
                                       device=dev).synthetics_np(dict(GEO_TRUE))
    for ds, slc in zip(datasets, DatasetStack.from_datasets(datasets).slices):
        ds.displacement = ds.displacement + signal[slc]
    priors, true = geodetic_ramp_priors(geodetic_source_priors("RectangularSource"))
    comp = GeodeticGeometryComposite(datasets, [truth], static_table=table,
                                     finite_patches=finite_patches,
                                     corrections=[RampCorrection(n) for n in GEO_SCENES],
                                     device=dev)
    problem = Problem(priors, {"geodetic": comp}, device=dev, outfolder=outfolder)
    problem.true_point = dict(true, **{h: 0.0 for h in comp.get_hypernames()})
    problem.time_table = ttable
    return problem
