"""
Project configuration and the assembly of a project's ``Problem`` (copied
from ``beat_tpu/config.py``, with the problem builders on the port's
composites).

One YAML config per mode in the project directory
(``config_geometry.yaml``, ``config_ffi.yaml``, ``config_bem.yaml``), in
the JAX package's schema and stamped with its config format
(:data:`~beat_tpu_torch.upgrade.CONFIG_FORMAT_VERSION`), so either
package reads the other's projects.  :func:`problem_from_config` builds
the problem of every mode — geometry (geodetic, seismic and polarity
data), ffi (the static and kinematic slip libraries of ``build_gfs``,
with the Laplacian smoothing prior) and bem — on ``device`` (the card by
default; :func:`~beat_tpu_torch.device.resolve` raises without one).
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from dataclasses import asdict, dataclass, field

import numpy as np
import yaml

from beat_tpu_torch.device import resolve
from beat_tpu_torch.parameter import Parameter, PriorSet
from beat_tpu_torch.samplers import MetropolisParams, PTParams, SMCParams
from beat_tpu_torch.upgrade import CONFIG_FORMAT_VERSION, check_config_version

logger = logging.getLogger("beat_tpu_torch.config")

geometry_mode_str = "geometry"
ffi_mode_str = "ffi"
bem_mode_str = "bem"
MODES = [geometry_mode_str, ffi_mode_str, bem_mode_str]

#: slip-component variable registries
static_dist_vars = ["uparr", "uperp", "utens"]
hypo_vars = ["nucleation_strike", "nucleation_dip", "time"]
partial_kinematic_vars = ["durations", "velocities"] + hypo_vars


@dataclass
class EventConfig:
    name: str = "event"
    lat: float = 0.0
    lon: float = 0.0
    depth: float = 10000.0  # [m]
    time: float = 0.0       # epoch [s]
    magnitude: float = 6.0
    #: catalog source duration [s]
    duration: float | None = None
    #: catalog moment tensor (mnn/mee/mdd/mne/mnd/med [+ sdr pairs]): the
    #: reference value of plots and acceptance checks
    moment_tensor: dict | None = None


# ---------------------------------------------------------------------------
# Datatype configs
# ---------------------------------------------------------------------------


@dataclass
class NoiseEstimatorConfig:
    """Seismic or geodetic noise estimator options."""

    structure: str = "variance"   # variance|exponential|import|non-toeplitz
    pre_arrival_time: float = 5.0
    max_dist_perc: float = 0.2


@dataclass
class RampConfig:
    enabled: bool = True
    dataset_names: list = field(default_factory=list)


@dataclass
class EulerPoleConfig:
    enabled: bool = True
    station_whitelist: list = field(default_factory=list)
    station_blacklist: list = field(default_factory=list)
    #: datasets this correction applies to; empty = every dataset with
    #: geographic coordinates.  SAR datasets honor their polygon ``mask``.
    dataset_names: list = field(default_factory=list)


@dataclass
class StrainRateConfig:
    enabled: bool = True
    station_whitelist: list = field(default_factory=list)
    station_blacklist: list = field(default_factory=list)
    dataset_names: list = field(default_factory=list)


@dataclass
class GeodeticCorrectionsConfig:
    ramps: RampConfig | None = None
    euler_poles: list = field(default_factory=list)
    strain_rates: list = field(default_factory=list)


@dataclass
class GeodeticConfig:
    datadir: str = "./"
    names: list = field(default_factory=lambda: ["all"])
    #: dataset types to load: declared types select which datasets enter
    #: the problem
    types: list = field(default_factory=lambda: ["SAR", "GNSS"])
    noise_estimator: NoiseEstimatorConfig = field(
        default_factory=lambda: NoiseEstimatorConfig(structure="import"))
    interpolation: str = "multilinear"
    corrections: GeodeticCorrectionsConfig = field(default_factory=GeodeticCorrectionsConfig)
    dataset_specific_residual_noise_estimation: bool = False
    #: layered static GF build parameters: earth_model, distance/depth
    #: grids, n_variations/error_* for the uncertainty ensemble,
    #: nu_variations (homogeneous Poisson-ratio ensemble), rheology and
    #: times_days (viscoelastic)
    gf_config: dict = field(default_factory=dict)


@dataclass
class ArrivalTaperConfig:
    """Cosine taper a<b<c<d [s] around the phase arrival."""

    a: float = -15.0
    b: float = -10.0
    c: float = 50.0
    d: float = 55.0


@dataclass
class FilterConfig:
    """One filter spec: ``type`` selects butterworth (bandpass), bandstop,
    or frequency (flat passband with cosine flanks, using
    ``freqlimits``).  A wavemap's ``filterer`` may be one spec or a list
    applied in sequence."""

    lower_corner: float = 0.001
    upper_corner: float = 0.1
    order: int = 4
    type: str = "butterworth"
    freqlimits: tuple = None


def build_filterer(fc):
    """The filter object(s) of a FilterConfig or a list of them (a list
    applies its filters in sequence)."""
    from beat_tpu_torch.heart.taper import BandstopFilter, Filter, FilterChain, FrequencyFilter

    def one(c):
        t = getattr(c, "type", "butterworth").lower()
        if t == "butterworth":
            return Filter(c.lower_corner, c.upper_corner, c.order)
        if t == "bandstop":
            return BandstopFilter(c.lower_corner, c.upper_corner, c.order)
        if t == "frequency":
            return FrequencyFilter(tuple(c.freqlimits) if c.freqlimits is not None
                                   else (0.005, 0.01, 0.1, 0.2))
        raise ValueError(f"Unknown filter type {c.type!r} (butterworth | bandstop | frequency)")

    if isinstance(fc, (list, tuple)):
        filters = [one(c) for c in fc]
        return filters[0] if len(filters) == 1 else FilterChain(tuple(filters))
    return one(fc)


@dataclass
class WaveformFitConfig:
    include: bool = True
    #: filter the observed traces during preparation; False for data
    #: filtered offline (synthetics are always filtered)
    preprocess_data: bool = True
    name: str = "any_P"           # phase
    #: CSV of picked arrivals `station,time_s` (seconds after origin)
    #: overriding predicted arrival times
    arrivals_path: str | None = None
    channels: list = field(default_factory=lambda: ["Z"])
    filterer: FilterConfig = field(default_factory=FilterConfig)
    arrival_taper: ArrivalTaperConfig = field(default_factory=ArrivalTaperConfig)
    #: epicentral distance range [deg] stations must fall in; None
    #: disables distance weeding
    distances: tuple = None
    interpolation: str = "multilinear"
    domain: str = "time"          # time | spectrum
    quantity: str = "displacement"
    blacklist: list = field(default_factory=list)
    event_idx: int = 0


@dataclass
class SeismicConfig:
    datadir: str = "./"
    noise_estimator: NoiseEstimatorConfig = field(default_factory=NoiseEstimatorConfig)
    #: StationXML inventory for instrument-response removal at import
    responses_path: str | None = None
    #: trim traces to the arrival window before stacking sources: the
    #: windowed-iDFT forward is numerically the pre-cut path, so False is
    #: accepted and has no effect
    pre_stack_cut: bool = True
    station_corrections: bool = False
    waveforms: list = field(default_factory=lambda: [WaveformFitConfig()])
    dataset_specific_residual_noise_estimation: bool = False
    gf_config: dict = field(default_factory=dict)


@dataclass
class PolarityFitConfig:
    """One polarity phase map: picked first motions of one phase, fit
    with its own radiation pattern and noise hyperparameter."""

    name: str = "any_P"           # phase: *_P | *_SH | *_SV
    include: bool = True
    #: per-map data file ``polarity_data_<name>.npz`` in the datadir
    #: overrides the shared ``polarity_data.npz``
    polarities_path: str | None = None
    blacklist: list = field(default_factory=list)
    #: multi-event problems: which event's source this map constrains
    event_idx: int = 0


@dataclass
class PolarityConfig:
    datadir: str = "./"
    waveforms: list = field(default_factory=lambda: [PolarityFitConfig()])
    gf_config: dict = field(default_factory=dict)


@dataclass
class BoundaryConditionConfig:
    """One traction boundary condition linking source/receiver meshes.
    The driving traction itself is a sampled parameter
    (``<slip_component>_traction`` prior, defaults-registry bounds)."""

    slip_component: str = "normal"   # strike | dip | normal
    source_idxs: list = field(default_factory=lambda: [0])
    receiver_idxs: list = field(default_factory=lambda: [0])


@dataclass
class BEMConfig:
    """bem-mode engine configuration; ``mesh_size`` in km (config units)."""

    poissons_ratio: float = 0.25
    shear_modulus: float = 33e9      # [Pa]
    mesh_size: float = 0.5           # [km] target triangle size
    check_mesh_intersection: bool = True
    medium: str = "halfspace"        # halfspace (Mindlin) | fullspace (Kelvin)
    #: far/near triangle-subdivision levels of the traction assembly
    #: ((2, 6) ≈ 3 % penny-crack accuracy; (1, 4-5) ≈ 4x faster solves
    #: for geometry sampling)
    quadrature_level: int = 2
    near_quadrature_level: int = 6
    boundary_conditions: list = field(
        default_factory=lambda: [BoundaryConditionConfig()])

    def make_engine(self, *, device):
        from beat_tpu_torch.bem import BEMEngine, BoundaryCondition

        bcs = [BoundaryCondition(bc.slip_component, list(bc.source_idxs),
                                 list(bc.receiver_idxs))
               for bc in self.boundary_conditions]
        return BEMEngine(bcs, mesh_size=self.mesh_size * 1e3,
                         poissons_ratio=self.poissons_ratio,
                         shear_modulus=self.shear_modulus,
                         check_mesh_intersection=self.check_mesh_intersection,
                         medium=self.medium,
                         quadrature_level=self.quadrature_level,
                         near_quadrature_level=self.near_quadrature_level,
                         device=device)


# ---------------------------------------------------------------------------
# Problem / sampler configs
# ---------------------------------------------------------------------------


@dataclass
class ProblemConfig:
    mode: str = geometry_mode_str
    source_types: list = field(default_factory=lambda: ["RectangularSource"])
    n_sources: list = field(default_factory=lambda: [1])
    datatypes: list = field(default_factory=lambda: ["geodetic"])
    stf_type: str = "HalfSinusoid"
    #: ffi-mode start population: 'random' (prior) or 'lsq' (around the
    #: NNLS warm start)
    initialization: str = "random"
    decimation_factors: dict = field(default_factory=dict)
    priors: dict = field(default_factory=dict)   # name -> Parameter dict
    #: hyperparameter (and hierarchical) prior overrides, filled by
    #: :func:`update_hypers_in_config`
    hyperparameters: dict = field(default_factory=dict)

    #: variables the config holds in km (km/s for velocities); the
    #: problems are SI
    KM_SCALED_VARS = ("east_shift", "north_shift", "depth", "length", "width",
                      "nucleation_strike", "nucleation_dip", "diameter",
                      "locking_depth", "depth_bottom", "distance",
                      "a_half_axis", "b_half_axis", "a_half_axis_bottom",
                      "b_half_axis_bottom", "delta_east_shift_bottom",
                      "delta_north_shift_bottom", "velocities", "height")

    def get_prior_set(self, to_si: bool = False, skip_fixed: bool = False) -> PriorSet:
        """Priors in config units, or converted to SI.  Parameters with
        ``lower == upper`` are fixed and skipped when requested."""
        ps = PriorSet()
        for name, d in self.priors.items():
            p = Parameter.from_dict(d)
            if skip_fixed and np.all(p.lower == p.upper):
                continue
            if to_si and name in self.KM_SCALED_VARS:
                p = Parameter(name=p.name, lower=p.lower * 1e3,
                              upper=p.upper * 1e3, testvalue=p.testvalue * 1e3,
                              form=p.form)
            ps.add(p)
        return ps

    def get_fixed_params(self, to_si: bool = True) -> dict:
        """Parameters fixed via lower == upper (config units or SI)."""
        out = {}
        for name, d in self.priors.items():
            p = Parameter.from_dict(d)
            if np.all(p.lower == p.upper):
                val = p.lower * (1e3 if (to_si and name in self.KM_SCALED_VARS) else 1.0)
                out[name] = val if p.dimension > 1 else float(val[0])
        return out

    def set_default_priors(self, variables: list[str], n_sources: int = 1) -> None:
        """Seed priors from the defaults registry."""
        for name in variables:
            dim = n_sources if n_sources > 1 else 1
            p = Parameter.from_defaults(name, dimension=dim)
            self.priors[name] = p.to_dict()

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        self.get_prior_set().validate()

    def set_decimation_factors(self) -> None:
        """Fill datatype decimation factors for extended-source synthesis:
        only RectangularSource is affected; a higher factor is a coarser
        point-source discretization."""
        if "RectangularSource" in self.source_types:
            for datatype in self.datatypes:
                self.decimation_factors.setdefault(
                    datatype, DEFAULT_DECIMATION_FACTORS.get(datatype, 1))

    def finite_patches(self, datatype: str) -> tuple:
        """(n_length, n_width) point-source grid of finite
        RectangularSource synthesis: the base 8x8 grid divided by the
        datatype's decimation factor."""
        factor = int(self.decimation_factors.get(
            datatype, DEFAULT_DECIMATION_FACTORS.get(datatype, 2)))
        n = max(2, _FINITE_PATCH_BASE // max(factor, 1))
        return (n, n)


#: default decimation factor per datatype
DEFAULT_DECIMATION_FACTORS = {"polarity": 1, "geodetic": 4, "seismic": 2}
#: finite-source base grid: 8x8 point sources at decimation_factor 1
_FINITE_PATCH_BASE = 8


@dataclass
class SamplerConfig:
    name: str = "SMC"  # SMC | Metropolis | PT | TransD (ffi slip mode)
    backend: str = "npz"
    progressbar: bool = True
    buffer_thinning: int = 1
    parameters: dict = field(default_factory=dict)

    def get_params(self):
        if self.name == "SMC":
            return SMCParams(**self.parameters)
        elif self.name == "PT":
            return PTParams(**self.parameters)
        elif self.name == "Metropolis":
            return MetropolisParams(**self.parameters)
        elif self.name == "TransD":
            from beat_tpu_torch.ffi.transd import TransDParams

            return TransDParams(**self.parameters)
        raise ValueError(f"Unknown sampler {self.name}")


@dataclass
class BEATconfig:
    """Top-level project config."""

    name: str = "project"
    date: str = ""
    version: str = ""   # the config format, stamped by dump_config
    event: EventConfig = field(default_factory=EventConfig)
    #: further events estimated jointly with the main event: wavemaps
    #: select theirs via ``WaveformFitConfig.event_idx``
    subevents: list = field(default_factory=list)
    project_dir: str = "./"
    problem_config: ProblemConfig = field(default_factory=ProblemConfig)
    geodetic_config: GeodeticConfig | None = None
    seismic_config: SeismicConfig | None = None
    polarity_config: PolarityConfig | None = None
    bem_config: BEMConfig | None = None
    sampler_config: SamplerConfig = field(default_factory=SamplerConfig)
    hyper_sampler_config: SamplerConfig | None = None

    def validate(self):
        self.problem_config.validate()

    @property
    def events(self) -> list:
        """[main event] + subevents."""
        return [self.event] + list(self.subevents)


# ---------------------------------------------------------------------------
# YAML round trip
# ---------------------------------------------------------------------------

_NESTED = {
    "event": EventConfig,
    "problem_config": ProblemConfig,
    "geodetic_config": GeodeticConfig,
    "seismic_config": SeismicConfig,
    "polarity_config": PolarityConfig,
    "sampler_config": SamplerConfig,
    "hyper_sampler_config": SamplerConfig,
    "noise_estimator": NoiseEstimatorConfig,
    "corrections": GeodeticCorrectionsConfig,
    "ramps": RampConfig,
    "filterer": FilterConfig,
    "arrival_taper": ArrivalTaperConfig,
    "bem_config": BEMConfig,
}

_NESTED_LISTS = {
    "subevents": EventConfig,
    "waveforms": WaveformFitConfig,
    "filterer": FilterConfig,
    "euler_poles": EulerPoleConfig,
    "strain_rates": StrainRateConfig,
    "boundary_conditions": BoundaryConditionConfig,
}

#: field names whose element type depends on the owning config class
#: (``waveforms`` is a list of PolarityFitConfig in a PolarityConfig)
_NESTED_LISTS_BY_CLASS = {
    ("PolarityConfig", "waveforms"): PolarityFitConfig,
}


def _from_dict(cls, d):
    if d is None:
        return None
    kwargs = {}
    for k, v in d.items():
        elem_cls = _NESTED_LISTS_BY_CLASS.get((cls.__name__, k), _NESTED_LISTS.get(k))
        if k in _NESTED and isinstance(v, dict):
            kwargs[k] = _from_dict(_NESTED[k], v)
        elif elem_cls is not None and isinstance(v, list):
            kwargs[k] = [_from_dict(elem_cls, x) if isinstance(x, dict) else x for x in v]
        else:
            kwargs[k] = v
    return cls(**kwargs)


def config_file_name(mode: str) -> str:
    return f"config_{mode}.yaml"


def dump_config(config: BEATconfig, project_dir: str | None = None) -> str:
    """Write the mode's config file, stamped with the config format."""
    project_dir = project_dir or config.project_dir
    os.makedirs(project_dir, exist_ok=True)
    config.version = CONFIG_FORMAT_VERSION
    path = os.path.join(project_dir, config_file_name(config.problem_config.mode))
    with open(path, "w") as f:
        yaml.safe_dump(asdict(config), f, sort_keys=False)
    logger.info("Wrote config to %s", path)
    return path


def load_config(project_dir: str, mode: str = geometry_mode_str) -> BEATconfig:
    """Read and validate the mode's config; a config stamped by an older
    format is refused."""
    path = os.path.join(project_dir, config_file_name(mode))
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"No {config_file_name(mode)} in {project_dir} — run 'beat-tpu init' first")
    with open(path) as f:
        d = yaml.safe_load(f)
    check_config_version(d.get("version"), path, project_dir)
    config = _from_dict(BEATconfig, d)
    config.project_dir = project_dir
    config.validate()
    return config


# ---------------------------------------------------------------------------
# Project scaffolding + problem construction
# ---------------------------------------------------------------------------

#: variables sampled per source type in geometry mode
source_geometry_vars = {
    "RectangularSource": ["east_shift", "north_shift", "depth", "strike",
                          "dip", "rake", "length", "width", "slip"],
    "MTSource": ["east_shift", "north_shift", "depth",
                 "mnn", "mee", "mdd", "mne", "mnd", "med", "magnitude"],
    "MTQTSource": ["east_shift", "north_shift", "depth",
                   "w", "v", "kappa", "sigma", "h", "magnitude"],
    "DCSource": ["east_shift", "north_shift", "depth",
                 "strike", "dip", "rake", "magnitude"],
    "ExplosionSource": ["east_shift", "north_shift", "depth", "volume_change"],
    "CLVDSource": ["east_shift", "north_shift", "depth",
                   "azimuth", "dip", "magnitude"],
    "DoubleDCSource": ["east_shift", "north_shift", "depth",
                       "strike1", "dip1", "rake1", "strike2", "dip2", "rake2",
                       "mix", "delta_time", "delta_depth", "distance",
                       "azimuth", "magnitude"],
    "RingfaultSource": ["east_shift", "north_shift", "depth",
                        "strike", "dip", "diameter", "sign", "magnitude"],
}

#: extra temporal variables when seismic data participates
seismic_geometry_vars = ["time", "duration"]

#: variables sampled per BEM source type in bem mode (the geometry of the
#: meshed crack; the driving tractions come per boundary condition)
bem_source_geometry_vars = {
    "TriangleBEMSource": ["east_shift", "north_shift", "depth"],
    "RectangularBEMSource": ["east_shift", "north_shift", "depth",
                             "strike", "dip", "length", "width"],
    "EllipseBEMSource": ["east_shift", "north_shift", "depth",
                         "a_half_axis", "b_half_axis", "strike", "dip",
                         "plunge"],
    "DiskBEMSource": ["east_shift", "north_shift", "depth",
                      "a_half_axis", "b_half_axis", "strike", "dip", "plunge"],
    "RingfaultBEMSource": ["east_shift", "north_shift", "depth",
                           "diameter", "height", "strike"],
    "CurvedBEMSource": ["east_shift", "north_shift", "depth",
                        "strike", "dip", "length", "width",
                        "bend_location", "bend_amplitude",
                        "curv_amplitude_bottom", "curv_location_bottom"],
}


def init_config(name: str, project_dir: str, mode: str = geometry_mode_str,
                source_types=("RectangularSource",), n_sources=(1,),
                datatypes=("geodetic",), sampler="SMC",
                event: EventConfig | None = None) -> BEATconfig:
    """Scaffold a new project: the mode's variables with the registry's
    default priors, one config section per datatype; written to the
    project directory and returned."""
    if mode == bem_mode_str:
        datatypes = ["geodetic"]   # bem mode is geodetic-only
        if all(st not in bem_source_geometry_vars for st in source_types):
            source_types = ["DiskBEMSource"]
    pc = ProblemConfig(mode=mode, source_types=list(source_types),
                       n_sources=list(n_sources), datatypes=list(datatypes))
    variables: list[str] = []
    bem_config = None
    if mode == ffi_mode_str:
        variables.extend(static_dist_vars[:2])  # uparr, uperp
        if "seismic" in datatypes:
            variables.extend(partial_kinematic_vars)
    elif mode == bem_mode_str:
        from collections import Counter

        bem_config = BEMConfig()
        for st in source_types:
            variables.extend(bem_source_geometry_vars[st])
        # one traction prior per slip component, vector-valued over the
        # boundary conditions sharing it
        bc_counts = Counter(bc.slip_component for bc in bem_config.boundary_conditions)
        for comp_name, n in sorted(bc_counts.items()):
            p = Parameter.from_defaults(f"{comp_name}_traction", dimension=n)
            pc.priors[f"{comp_name}_traction"] = p.to_dict()
    else:
        for st in source_types:
            variables.extend(source_geometry_vars[st])
        if "seismic" in datatypes:
            variables.extend(seismic_geometry_vars)
    pc.set_default_priors(sorted(set(variables)), n_sources=int(sum(n_sources)))
    pc.set_decimation_factors()

    config = BEATconfig(name=name, project_dir=project_dir, event=event or EventConfig(),
                        problem_config=pc, bem_config=bem_config,
                        sampler_config=SamplerConfig(name=sampler))
    if "geodetic" in datatypes:
        config.geodetic_config = GeodeticConfig()
    if "seismic" in datatypes:
        config.seismic_config = SeismicConfig()
    if "polarity" in datatypes:
        config.polarity_config = PolarityConfig()
    config.validate()
    dump_config(config, project_dir)
    return config


def load_polarity_targets(project_dir: str, datadir: str = "./",
                          source_depth: float | None = None,
                          velocity_model=None, phase: str = "p",
                          filename: str = "polarity_data.npz",
                          blacklist=()) -> list:
    """First motions of ``<project_dir>/<datadir>/<filename>``: arrays
    ``stations``, ``azimuths_deg``, ``polarities`` (±1) and either
    ``takeoffs_deg`` (from the downward vertical) or ``distances_m``, whose
    takeoffs the host ray tracer finds through ``velocity_model`` (the
    project's, :func:`load_velocity_model`) from ``source_depth``."""
    from beat_tpu_torch.heart.polarity import PolarityTarget

    path = os.path.join(project_dir, datadir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No polarity data at {path}")
    blacklist = set(blacklist or ())
    with np.load(path, allow_pickle=False) as z:
        az = np.deg2rad(z["azimuths_deg"])
        pol = z["polarities"].astype(int)
        stations = [str(s) for s in z["stations"]]
        dists = z["distances_m"].astype(float) if "distances_m" in z.files else None
        if "takeoffs_deg" in z.files:
            to = np.deg2rad(z["takeoffs_deg"])
        else:
            from beat_tpu_torch.heart.velocity_model import takeoff_angles

            if dists is None:
                raise ValueError("polarity_data.npz needs 'takeoffs_deg' or 'distances_m'")
            if source_depth is None:
                raise ValueError("ray-traced takeoffs need the event source depth")
            model = velocity_model or load_velocity_model(project_dir)
            to = takeoff_angles(model, float(source_depth), dists, phase=phase)
    return [PolarityTarget(station=stations[i], azimuth_rad=float(az[i]),
                           takeoff_rad=float(to[i]), polarity=int(pol[i]),
                           distance_m=(float(dists[i]) if dists is not None else None))
            for i in range(len(stations)) if stations[i] not in blacklist]


def _build_polarity_takeoff_table(project_dir: str, priors, targets, event_depth: float,
                                  phase: str, n_depths: int = 25, n_dists: int = 48, *,
                                  device):
    """(depth × distance) takeoff grid over the sampled location priors,
    ray-traced once on the host through the project's layered model, on
    ``device`` for the per-draw gather."""
    from beat_tpu_torch.heart.polarity import build_takeoff_table

    if "depth" in priors:
        p = priors["depth"]
        zlo, zhi = float(np.min(p.lower)), float(np.max(p.upper))
    else:
        zlo = zhi = float(event_depth)
    if zhi - zlo < 1.0:  # degenerate span: widen so bilinear has a cell
        zlo, zhi = zlo - max(0.05 * zlo, 50.0), zhi + max(0.05 * zhi, 50.0)
    zlo = max(zlo, 1.0)

    dists = np.asarray([t.distance_m for t in targets], dtype=float)
    shift = 0.0
    for name in ("east_shift", "north_shift"):
        if name in priors:
            p = priors[name]
            shift = max(shift, float(np.max(np.abs(p.lower))), float(np.max(np.abs(p.upper))))
    # shifts move the epicenter; distances change by at most the
    # horizontal shift magnitude (hypot of both components)
    rlo = max(float(dists.min()) - np.sqrt(2.0) * shift, 1.0)
    rhi = float(dists.max()) + np.sqrt(2.0) * shift + 1.0
    return build_takeoff_table(load_velocity_model(project_dir), np.linspace(zlo, zhi, n_depths),
                               np.linspace(rlo, rhi, n_dists), phase=phase, device=device)


def _warn_coarse_finite_grid(pc, priors, seismic_config) -> None:
    """Warn when the RectangularSource patch grid under-resolves the
    largest prior fault at the highest filter corner."""
    if "RectangularSource" not in pc.source_types:
        return
    from beat_tpu_torch.models.seismic import recommended_finite_patches

    # fixed parameters (lower == upper, skipped from the prior set) are
    # the common way fault geometry is configured: the guard must see them
    fixed = pc.get_fixed_params(to_si=True)

    def upper(name, default):
        if name in priors:
            return float(np.max(priors[name].upper))
        if name in fixed:
            return float(np.max(fixed[name]))
        return default

    def lower(name, default):
        if name in priors:
            return float(np.min(priors[name].lower))
        if name in fixed:
            return float(np.min(fixed[name]))
        return default

    def max_passband_freq(fc):
        """Highest frequency a filterer spec lets through (bandstop
        rejects a band and bounds nothing)."""
        specs = fc if isinstance(fc, (list, tuple)) else [fc]
        tops = []
        for c in specs:
            t = getattr(c, "type", "butterworth").lower()
            if t == "butterworth":
                tops.append(float(c.upper_corner))
            elif t == "frequency":
                fl = c.freqlimits if c.freqlimits is not None else (0.005, 0.01, 0.1, 0.2)
                tops.append(float(fl[2]))
        return min(tops) if tops else None

    corners = [max_passband_freq(w.filterer) for w in (seismic_config.waveforms or [])
               if getattr(w, "filterer", None) is not None and getattr(w, "include", True)]
    corners = [c for c in corners if c is not None]
    if not corners:
        return
    # worst case: largest fault, slowest rupture, highest corner
    n_rec = recommended_finite_patches(upper("length", 0.0), upper("width", 0.0), max(corners),
                                       velocity=lower("velocity", 3500.0))
    n_cfg = pc.finite_patches("seismic")
    if n_cfg[0] < n_rec[0] or n_cfg[1] < n_rec[1]:
        logger.warning(
            "finite-source grid %s under-resolves the prior: the largest fault (length %.3g m, "
            "width %.3g m) at the highest filter corner %.3g Hz with rupture velocity %.3g m/s "
            "needs >= %s patches (onset step < T_min/4). Lower decimation_factors['seismic'] "
            "or narrow the priors.", n_cfg, upper("length", 0.0), upper("width", 0.0),
            max(corners), lower("velocity", 3500.0), n_rec)


def import_results_as_priors(project_dir: str, mode: str, from_mode: str,
                             alpha: float = 0.06, *, device="cuda") -> list:
    """Narrow ``mode``'s priors to the posterior of a finished
    ``from_mode`` run: every sampled variable present in both the run's
    summary and the target config (source parameters, hyperparameters,
    hierarchicals, slip vectors) gets the posterior HDI as its bounds
    (clipped to the registry's physical bounds) and the posterior mean as
    its test value.  Rewrites the target config and returns the updated
    names."""
    from beat_tpu_torch import defaults
    from beat_tpu_torch.backend import extract_bounds_from_summary
    from beat_tpu_torch.models.problem import load_model

    summary = load_model(project_dir, from_mode, device=device).summarize(-1)
    config = load_config(project_dir, mode)
    pc = config.problem_config
    # make sure the hyper/hierarchical section exists so those import too
    try:
        update_hypers_in_config(config, problem_from_config(config, project_dir, device=device))
    except Exception as e:  # data for the target mode may not exist yet
        logger.debug("Hyper refresh skipped: %s", e)

    updated = []
    for prior_dict in (pc.priors, pc.hyperparameters):
        for name, d in list(prior_dict.items()):
            p = Parameter.from_dict(d)
            shape = () if p.dimension == 1 else (p.dimension,)
            try:
                lo, hi = extract_bounds_from_summary(summary, name, shape=shape, alpha=alpha)
                means = [summary[name if not shape else f"{name}[{k}]"]["mean"]
                         for k in range(p.dimension)]
            except KeyError:
                continue
            # the trace and its summary are SI; the config is in km
            scale = 1e-3 if name in pc.KM_SCALED_VARS else 1.0
            lo, hi = np.atleast_1d(lo) * scale, np.atleast_1d(hi) * scale
            mean = np.asarray(means) * scale
            phys_lo, phys_hi = defaults.physical_bounds(name)
            p.lower = np.maximum(lo, phys_lo)
            p.upper = np.minimum(np.maximum(hi, p.lower + 1e-9), phys_hi)
            p.testvalue = np.clip(mean, p.lower, p.upper)
            prior_dict[name] = p.to_dict()
            updated.append(name)
    dump_config(config, project_dir)
    logger.info("Imported %s posterior into %s priors: %s", from_mode, mode,
                ", ".join(updated) or "(nothing matched)")
    return updated


def geometry_map_point(project_dir: str, *, device="cuda") -> dict | None:
    """The best sample of the project's final geometry stage (None
    without a geometry posterior): the anchor of the geometry → ffi
    workflow."""
    stage_dir = os.path.join(project_dir, geometry_mode_str, "stage_-1")
    if not os.path.isdir(stage_dir):
        return None
    from beat_tpu_torch.backend import SampleStage

    problem = problem_from_config(load_config(project_dir, geometry_mode_str), project_dir,
                                  device=device)
    handler = SampleStage(problem.outfolder, ordering=problem.ordering)
    pop, llks = handler.load_trace(-1).end_points()
    return problem.ordering.to_point(pop[int(np.argmax(llks))])


def _apply_fixed_corrections(datasets, corrections, point) -> list:
    """Subtract the corrections' displacements at ``point`` from the
    datasets, once, on the host in float64; returns the names of the
    datasets corrected.  Free ramps trade off with artificial slip on deep
    patches, so a slip inversion keeps the corrections fixed at the
    geometry run's values."""
    import torch

    from beat_tpu_torch.heart.corrections import RampCorrection

    hier = {k: torch.as_tensor(np.asarray(v, dtype=np.float64))[None] for k, v in point.items()}
    corrected = []
    for ds in datasets:
        total = np.zeros(ds.samples)
        for corr in corrections:
            if isinstance(corr, RampCorrection):
                if corr.dataset_name != ds.name:
                    continue
                arr = ds.coords
            else:
                if ds.typ != "GNSS" or corr.dataset_name not in (None, ds.name):
                    continue
                arr = ds.los_vector
            with torch.no_grad():
                disp = corr.displacement(hier, torch.as_tensor(np.asarray(arr, dtype=np.float64)))
            total = total + disp[0].numpy()
        if np.any(total != 0.0):
            ds.displacement = ds.displacement - total
            corrected.append(ds.name)
    return corrected


def clone_config_to_mode(project_dir: str, new_mode: str, from_mode: str = geometry_mode_str,
                         datatypes: list | None = None) -> BEATconfig:
    """Derive a ``new_mode`` config from an existing one of the same
    project: event, data, noise and corrections carry over, the sampled
    variables switch to the new mode's (ffi: slip components, re-sized
    to the discretized fault at load, plus the kinematic variables with
    seismic data; the rupture ``time`` prior is kept).  Writes
    ``config_<new_mode>.yaml`` and returns the new config."""
    import copy

    config = load_config(project_dir, from_mode)
    new = copy.deepcopy(config)
    pc = new.problem_config
    pc.mode = new_mode
    if datatypes:
        pc.datatypes = sorted(datatypes)
    if new_mode == ffi_mode_str:
        variables = list(static_dist_vars[:2])
        if "seismic" in pc.datatypes:
            variables.extend(partial_kinematic_vars)
        old_priors = pc.priors
        pc.priors = {}
        pc.set_default_priors(sorted(set(variables)))
        for keep in ("time",):
            if keep in old_priors and keep in (partial_kinematic_vars + hypo_vars):
                pc.priors[keep] = old_priors[keep]
    elif new_mode == bem_mode_str:
        raise ValueError("clone to bem mode: init a bem project with `beat-tpu init --mode bem` "
                         "instead (BEM source geometry cannot be derived from other modes)")
    dump_config(new, project_dir)
    return new


def update_hypers_in_config(config: "BEATconfig", problem) -> list:
    """Add the problem's hyperparameters and hierarchicals missing from
    the config's ``hyperparameters`` section; returns the names added."""
    pc = config.problem_config
    added = []
    for comp in problem.composites.values():
        for p in comp.get_hyper_parameters() + comp.get_hierarchical_parameters():
            if p.name not in pc.hyperparameters:
                pc.hyperparameters[p.name] = p.to_dict()
                added.append(p.name)
    return added


def apply_hyper_overrides(problem, pc: ProblemConfig) -> None:
    """Apply the config's hyperparameter and hierarchical bounds to a
    freshly built problem's priors."""
    for name, d in pc.hyperparameters.items():
        if name in problem.priors:
            p = Parameter.from_dict(d)
            tgt = problem.priors[name]
            tgt.lower = np.asarray(p.lower, dtype=float)
            tgt.upper = np.asarray(p.upper, dtype=float)
            tgt.testvalue = np.asarray(p.testvalue, dtype=float)


def load_velocity_model(project_dir: str):
    """The project's 1-D model: ``velocity_model.npz`` or
    ``velocity_model.nd``, else the default crust."""
    from beat_tpu_torch.heart.velocity_model import LayeredModel

    npz = os.path.join(project_dir, "velocity_model.npz")
    nd = os.path.join(project_dir, "velocity_model.nd")
    if os.path.exists(npz):
        return LayeredModel.load(npz)
    if os.path.exists(nd):
        return LayeredModel.from_nd(nd)
    return LayeredModel.default_crust()


def save_polarity_targets(targets, project_dir: str, datadir: str = "./") -> str:
    outdir = os.path.join(project_dir, datadir)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "polarity_data.npz")
    payload = dict(stations=np.array([t.station for t in targets]),
                   azimuths_deg=np.rad2deg([t.azimuth_rad for t in targets]),
                   takeoffs_deg=np.rad2deg([t.takeoff_rad for t in targets]),
                   polarities=np.array([t.polarity for t in targets]))
    if all(t.distance_m is not None for t in targets):
        # keep the distances for the per-draw takeoffs of a sampled location
        payload["distances_m"] = np.array([t.distance_m for t in targets])
    np.savez_compressed(path, **payload)
    return path


def load_geodetic_datasets(project_dir: str, gc: GeodeticConfig,
                           event: "EventConfig | None" = None) -> list:
    """The datasets of ``<project_dir>/<datadir>/geodetic_data.npz``: per
    dataset ``<name>``, the arrays ``<name>:coords``, ``:displacement``,
    ``:los`` and the optional ``:odw``, ``:covariance``, ``:typ`` (0 SAR,
    1 GNSS), ``:lats``, ``:lons``, ``:stations``, ``:mask``, ``:time``.

    With ``event``, datasets with geographic coordinates get their local
    east/north coordinates relative to it; without it, such a dataset
    whose coordinates are all zero is refused.  ``gc.types`` and
    ``gc.names`` select the datasets."""
    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.heart.geodesy import GeodeticDataset

    path = os.path.join(project_dir, gc.datadir, "geodetic_data.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No geodetic data at {path} — run 'beat-tpu import'")
    datasets = []
    with np.load(path, allow_pickle=False) as z:
        for name in sorted({k.split(":")[0] for k in z.files}):
            cov = None
            if f"{name}:covariance" in z.files:
                cov = Covariance(data=z[f"{name}:covariance"])
            typ = "GNSS" if f"{name}:typ" in z.files and int(z[f"{name}:typ"]) == 1 else "SAR"

            def opt(key, name=name, z=z):
                return z[f"{name}:{key}"] if f"{name}:{key}" in z.files else None

            time, mask = opt("time"), opt("mask")
            datasets.append(GeodeticDataset(
                name=name, typ=typ, coords=z[f"{name}:coords"],
                displacement=z[f"{name}:displacement"], los_vector=z[f"{name}:los"],
                odw=opt("odw"), lats=opt("lats"), lons=opt("lons"), stations=opt("stations"),
                covariance=cov, time=float(time) if time is not None else None,
                mask=mask.astype(bool) if mask is not None else None))
    for ds in datasets:
        if ds.lats is not None and ds.lons is not None:
            if event is not None:
                ds.update_local_coords(event.lat, event.lon)
            elif not np.any(ds.coords):
                raise ValueError(
                    f"geodetic dataset {ds.name} has all-zero local coordinates and no event "
                    "to project its lat/lon against — load with the project config (or re-run "
                    "'beat-tpu import') so station positions are projected relative to the "
                    "event")
    if gc.types:
        selected = [ds for ds in datasets if ds.typ in gc.types]
        dropped = [ds.name for ds in datasets if ds.typ not in gc.types]
        if dropped:
            logger.warning("geodetic_config.types %s excludes datasets %s — add their type to "
                           "load them", list(gc.types), dropped)
        if not selected:
            raise ValueError(f"geodetic_config.types {list(gc.types)} matches none of the "
                             f"imported datasets ({sorted({ds.typ for ds in datasets})})")
        datasets = selected
    if gc.names and gc.names != ["all"]:
        datasets = [ds for ds in datasets if ds.name in gc.names]
        if not datasets:
            raise ValueError(f"geodetic_config.names {gc.names} matches no imported dataset")
    return datasets


def save_geodetic_datasets(datasets, project_dir: str, datadir: str = "./") -> str:
    arrays = {}
    for ds in datasets:
        arrays[f"{ds.name}:coords"] = ds.coords
        arrays[f"{ds.name}:displacement"] = ds.displacement
        arrays[f"{ds.name}:los"] = ds.los_vector
        arrays[f"{ds.name}:odw"] = ds.odw
        arrays[f"{ds.name}:covariance"] = ds.covariance.data
        arrays[f"{ds.name}:typ"] = np.array(1 if ds.typ == "GNSS" else 0)
        for key in ("lats", "lons", "stations", "mask"):
            val = getattr(ds, key, None)
            if val is not None:
                arrays[f"{ds.name}:{key}"] = np.asarray(val)
        if getattr(ds, "time", None) is not None:
            # acquisition epoch [s] after the event: the viscoelastic table's
            arrays[f"{ds.name}:time"] = np.float64(ds.time)
    outdir = os.path.join(project_dir, datadir)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "geodetic_data.npz")
    np.savez_compressed(path, **arrays)
    return path


def _source_templates(pc, catalog, event_depth: float, fixed: dict) -> list:
    """One template per configured source, at the event depth, with the
    fixed parameters (lower == upper) applied."""
    sources = []
    for st, ns in zip(pc.source_types, pc.n_sources):
        if st not in catalog:
            raise ValueError(f"unknown source type {st!r} for {pc.mode} mode "
                             f"({sorted(catalog)})")
        for _ in range(int(ns)):
            src = catalog[st](depth=event_depth)
            for name, val in fixed.items():
                if hasattr(src, name):
                    v = np.atleast_1d(val)
                    setattr(src, name, float(v[len(sources)] if v.size > 1 else v[0]))
            sources.append(src)
    return sources


def _problem(config, priors, composites, project_dir: str, device, **kwargs):
    """The Problem of a config: its sampler settings, outfolder
    ``<project_dir>/<mode>``, the persisted hyperparameter bounds."""
    from beat_tpu_torch.models.problem import Problem

    pc = config.problem_config
    hyper_params = (config.hyper_sampler_config.get_params()
                    if config.hyper_sampler_config is not None else None)
    problem = Problem(priors, composites, device=device,
                      outfolder=os.path.join(project_dir, pc.mode),
                      sampler_params=config.sampler_config.get_params(),
                      hyper_sampler_params=hyper_params, **kwargs)
    problem.event = config.event   # geographic origin for map plots
    apply_hyper_overrides(problem, pc)
    return problem


def problem_from_config(config: BEATconfig, project_dir: str, *, device="cuda"):
    """The Problem of a loaded config on ``device``: geometry mode with
    its geodetic (halfspace, static or viscoelastic table), seismic and
    polarity composites; ffi and bem modes by their own builders."""
    from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite
    from beat_tpu_torch.sources import source_catalog

    dev = resolve(device)
    pc = config.problem_config
    if pc.mode == ffi_mode_str:
        return _ffi_problem_from_config(config, project_dir, device=dev)
    if pc.mode == bem_mode_str:
        return _bem_problem_from_config(config, project_dir, device=dev)
    priors = pc.get_prior_set(to_si=True, skip_fixed=True)
    sources = _source_templates(pc, source_catalog, config.event.depth,
                                pc.get_fixed_params(to_si=True))

    composites = {}
    if "geodetic" in pc.datatypes and config.geodetic_config is not None:
        from beat_tpu_torch.heart.statictable import StaticGFTable

        gc = config.geodetic_config
        datasets = load_geodetic_datasets(project_dir, gc, event=config.event)
        corrections = _build_corrections(gc, datasets)
        # a layered table in the project switches the composite from the
        # halfspace to table synthesis; a viscoelastic one reads each
        # dataset's acquisition epoch
        static_table = None
        st_path = os.path.join(project_dir, "static_gf_table.npz")
        visco_path = os.path.join(project_dir, "static_gf_table_visco.npz")
        gf = gc.gf_config or {}
        if os.path.exists(visco_path):
            from beat_tpu_torch.heart.viscoelastic import (TimeDependentStaticGFTable,
                                                           epoch_table_for_datasets)

            if datasets:
                static_table = epoch_table_for_datasets(
                    TimeDependentStaticGFTable.load(visco_path), datasets,
                    gf.get("times_days") or {}, device=dev)
            else:
                logger.warning("Viscoelastic table %s present but no geodetic datasets "
                               "loaded — ignoring it", visco_path)
        else:
            # a viscoelastic setup without its table must fail loudly: the
            # elastic table would invert post-seismic scenes with
            # co-seismic GFs
            if (bool(gf.get("rheology")) or bool(gf.get("times_days"))
                    or any(getattr(ds, "time", None) for ds in datasets)):
                raise ValueError(
                    "gf_config.rheology/times_days (or dataset acquisition times) are "
                    "configured but static_gf_table_visco.npz is missing in "
                    f"{project_dir} — run `beat-tpu build_gfs` to build the time-dependent "
                    "table (the elastic table would silently bias post-seismic scenes)")
            if os.path.exists(st_path):
                static_table = StaticGFTable.load(st_path, device=dev)
                logger.info("Using layered static GF table %s", st_path)
        # the earth-model ensemble → prediction covariances
        ensemble_tables = []
        if static_table is not None:
            ensemble_tables = [StaticGFTable.load(p, device=dev) for p in sorted(
                glob.glob(os.path.join(project_dir, "static_gf_table.var*.npz")))]
        composites["geodetic"] = GeodeticGeometryComposite(
            datasets, sources, noise_structure=gc.noise_estimator.structure,
            hp_specific=gc.dataset_specific_residual_noise_estimation,
            corrections=corrections, static_table=static_table,
            finite_patches=pc.finite_patches("geodetic"),
            ensemble_nus=gf.get("nu_variations"), ensemble_tables=ensemble_tables,
            device=dev)
    if "seismic" in pc.datatypes and config.seismic_config is not None:
        from beat_tpu_torch.models.seismic import build_seismic_composite

        _warn_coarse_finite_grid(pc, priors, config.seismic_config)
        composites["seismic"] = build_seismic_composite(
            config.seismic_config, project_dir, sources,
            events=config.events if config.subevents else None,
            finite_patches=pc.finite_patches("seismic"), stf_type=pc.stf_type, device=dev)
    if "polarity" in pc.datatypes and config.polarity_config is not None:
        from beat_tpu_torch.models.polarity import PolarityComposite, PolarityMapping

        polc = config.polarity_config
        wfcs = [w for w in polc.waveforms if getattr(w, "include", True)] or [
            PolarityFitConfig()]
        maps = []
        for i, pfc in enumerate(wfcs):
            phase = "s" if pfc.name.lower().endswith(("sh", "sv")) else "p"
            event_idx = int(getattr(pfc, "event_idx", 0))
            depth = (config.events[event_idx].depth if event_idx < len(config.events)
                     else config.event.depth)
            per_map = f"polarity_data_{pfc.name}.npz"
            fname = pfc.polarities_path or (
                per_map if os.path.exists(os.path.join(project_dir, polc.datadir, per_map))
                else "polarity_data.npz")
            targets = load_polarity_targets(project_dir, polc.datadir, source_depth=depth,
                                            phase=phase, filename=fname,
                                            blacklist=pfc.blacklist)
            # per-draw geometry: with a sampled location and the targets'
            # epicentral distances, a (depth × distance) takeoff table the
            # composite gathers at each draw's location
            table = None
            samples_location = any(k in priors for k in ("depth", "east_shift", "north_shift"))
            if (samples_location and targets
                    and all(t.distance_m is not None for t in targets)):
                table = _build_polarity_takeoff_table(project_dir, priors, targets, depth,
                                                      phase, device=dev)
            maps.append(PolarityMapping(pfc.name, targets, event_idx=event_idx, mapnumber=i,
                                        takeoff_table=table, device=dev))
        composites["polarity"] = PolarityComposite(sources=sources, maps=maps, device=dev)
    return _problem(config, priors, composites, project_dir, dev,
                    initialization=getattr(pc, "initialization", "random"))


def _bem_problem_from_config(config: BEATconfig, project_dir: str, *, device):
    """bem mode: the engine of ``bem_config``, BEM source templates with
    the fixed parameters applied, and the per-draw meshing composite — or,
    when every geometry parameter is fixed, the linear unit-traction
    composite."""
    from beat_tpu_torch.bem import source_catalog as bem_source_catalog

    pc = config.problem_config
    if config.bem_config is None:
        raise ValueError("bem mode needs a bem_config section")
    engine = config.bem_config.make_engine(device=device)
    priors = pc.get_prior_set(to_si=True, skip_fixed=True)
    sources = _source_templates(pc, bem_source_catalog, config.event.depth,
                                pc.get_fixed_params(to_si=True))
    gc = config.geodetic_config or GeodeticConfig()
    datasets = load_geodetic_datasets(project_dir, gc, event=config.event)
    kwargs = dict(noise_structure=gc.noise_estimator.structure,
                  hp_specific=gc.dataset_specific_residual_noise_estimation,
                  corrections=_build_corrections(gc, datasets), device=device)
    geometry_sampled = [n for n in priors.names if any(hasattr(s, n) for s in sources)]
    if geometry_sampled:
        from beat_tpu_torch.models.bem import GeodeticBEMComposite

        logger.info("bem mode: sampling geometry %s via the BEM callback composite",
                    geometry_sampled)
        comp = GeodeticBEMComposite(datasets, sources, engine, **kwargs)
    else:
        from beat_tpu_torch.models.bem import GeodeticBEMLinearComposite

        logger.info("bem mode: fixed geometry — linear unit-traction composite")
        comp = GeodeticBEMLinearComposite(datasets, sources, engine, **kwargs)
    return _problem(config, priors, {"geodetic": comp}, project_dir, device)


def ffi_seismic_grid_bounds(config: BEATconfig, fault):
    """Duration and starttime grids of the kinematic library from the
    configured priors: durations span their prior; starttimes span
    [time_lower, time_upper + the fault diagonal / v_min]."""
    base = config.problem_config.get_prior_set(to_si=False)

    def bounds(name, default):
        if name in base:
            return float(base[name].lower.min()), float(base[name].upper.max())
        return default

    dur_lo, dur_hi = bounds("durations", (0.5, 4.0))
    t_lo, t_hi = bounds("time", (-2.0, 2.0))
    v_lo, _ = bounds("velocities", (1.5, 4.5))  # [km/s]
    diag_km = max(np.hypot(sf.plane.length, sf.plane.width) for sf in fault.subfaults) / 1e3
    st_lo = min(t_lo, 0.0)
    st_hi = t_hi + diag_km / max(v_lo, 0.1)
    dur_step = max((dur_hi - dur_lo) / 8.0, 0.25)
    st_step = max((st_hi - st_lo) / 24.0, 0.25)
    return (dur_lo, dur_hi), dur_step, (st_lo, st_hi), st_step


def _fault_classes() -> dict:
    """The classes a fault geometry file may name, by (module, name): the
    JAX package's, which ``build_gfs`` writes, mapped to the port's."""
    from beat_tpu_torch.ffi.discretization import IrregularSubfault
    from beat_tpu_torch.ffi.fault import FaultGeometry, FaultOrdering, SubfaultGrid
    from beat_tpu_torch.sources import RectangularSource

    out = {}
    for cls in (FaultGeometry, FaultOrdering, SubfaultGrid, IrregularSubfault,
                RectangularSource):
        origin = cls.__module__.replace("beat_tpu_torch", "beat_tpu", 1)
        out[(origin, cls.__name__)] = cls
        out[(cls.__module__, cls.__name__)] = cls
    return out


# what a pickled ndarray or numpy scalar names (numpy 1 and 2 module
# paths; ``_frombuffer`` for protocol 5, ``_codecs.encode`` for the bytes
# of protocol 2)
_ARRAY_NAMES = frozenset(
    [("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode")]
    + [(f"numpy.{core}.{mod}", name) for core in ("core", "_core")
       for mod, name in (("multiarray", "_reconstruct"), ("multiarray", "scalar"),
                         ("numeric", "_frombuffer"))])


class FaultUnpickler(pickle.Unpickler):
    """Reads ``fault_geometry.pkl`` without importing the JAX package:
    the fault classes it names map to the port's (:func:`_fault_classes`),
    the names of numpy's array and scalar reconstruction pass
    (``_ARRAY_NAMES``), and any other name is refused."""

    def find_class(self, module, name):
        cls = _fault_classes().get((module, name))
        if cls is not None:
            return cls
        if (module, name) in _ARRAY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"fault geometry file names {module}.{name}, which is "
                                     "not a fault class")


def load_fault_geometry(path: str):
    with open(path, "rb") as f:
        return FaultUnpickler(f).load()


class _FaultPickler(pickle._Pickler):
    """Writes a fault geometry under the JAX package's names of its
    classes (``beat_tpu.ffi.fault.FaultGeometry``, ...), so that the JAX
    package's plain ``pickle.load`` and :class:`FaultUnpickler` both read
    it; the names are written as they are, without importing the JAX
    package.  Protocol 2: a class is one ``GLOBAL`` opcode."""

    def save_global(self, obj, name=None):
        for (module, cls_name), cls in _fault_classes().items():
            if cls is obj and module.split(".")[0] == "beat_tpu":
                self.write(pickle.GLOBAL + f"{module}\n{cls_name}\n".encode("utf-8"))
                self.memoize(obj)
                return
        super().save_global(obj, name)


def save_fault_geometry(fault, path: str) -> None:
    """Write ``fault_geometry.pkl`` (``build_gfs`` in ffi mode)."""
    with open(path, "wb") as f:
        _FaultPickler(f, protocol=2).dump(fault)


def _ffi_problem_from_config(config: BEATconfig, project_dir: str, *, device):
    """ffi mode: the fault geometry and the linear GF libraries of
    ``build_gfs`` under ``ffi/linear_gfs``, the static (geodetic) and
    kinematic (seismic) distributer composites and the Laplacian
    smoothing prior; the slip priors re-sized to the patch count."""
    from beat_tpu_torch import defaults
    from beat_tpu_torch.ffi import GeodeticGFLibrary
    from beat_tpu_torch.models.distributer import GeodeticDistributerComposite
    from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite

    gfdir = os.path.join(project_dir, "ffi", "linear_gfs")
    fault_path = os.path.join(gfdir, "fault_geometry.pkl")
    if not os.path.exists(fault_path):
        raise FileNotFoundError(f"No FFI fault geometry in {gfdir} — run 'beat-tpu build_gfs'")
    fault = load_fault_geometry(fault_path)

    pc = config.problem_config
    base = pc.get_prior_set(to_si=False)
    composites = {}
    slip_components: list = []

    lib_path = os.path.join(gfdir, "geodetic_gfs.npz")
    if "geodetic" in pc.datatypes:
        if not os.path.exists(lib_path):
            raise FileNotFoundError(f"No geodetic GF library in {gfdir} — run 'beat-tpu "
                                    "build_gfs'")
        gc = config.geodetic_config
        datasets = load_geodetic_datasets(project_dir, gc, event=config.event)
        corrections = _build_corrections(gc, datasets)
        if corrections:
            # fixed at the geometry MAP: free ramps feed artificial deep slip
            map_point = geometry_map_point(project_dir, device=device)
            names = [n for c in corrections for n in c.parameter_names]
            if map_point is not None and all(n in map_point for n in names):
                fixed = _apply_fixed_corrections(datasets, corrections, map_point)
                logger.info("ffi: corrections (%s) fixed at the geometry-MAP values and "
                            "removed from %s", ", ".join(sorted(set(names))), ", ".join(fixed))
            else:
                logger.warning(
                    "ffi: corrections are configured but no geometry-mode posterior exists in "
                    "%s — the slip inversion sees UNCORRECTED data (ramps trade off with deep "
                    "slip); run `beat-tpu sample --mode geometry` first", project_dir)
        lib = GeodeticGFLibrary.load(lib_path, device=device)
        slip_components = list(lib.component_names)
        composites["geodetic"] = GeodeticDistributerComposite(
            datasets, lib, fault, hp_specific=gc.dataset_specific_residual_noise_estimation,
            device=device)

    if "seismic" in pc.datatypes and config.seismic_config is not None:
        from beat_tpu_torch.ffi import SeismicGFLibrary
        from beat_tpu_torch.models.distributer import SeismicDistributerComposite
        from beat_tpu_torch.models.seismic import build_seismic_composite

        geom_comp = build_seismic_composite(config.seismic_config, project_dir, [],
                                            device=device)
        wavemaps_libs = []
        components = []
        for wmap in geom_comp.wavemaps:
            libs = {}
            for comp_name in static_dist_vars[:2]:
                name = f"seismic_{comp_name}_{wmap.mapid}"
                if os.path.exists(os.path.join(gfdir, f"{name}.npz")):
                    libs[comp_name] = SeismicGFLibrary.load(gfdir, name, component=comp_name,
                                                            device=device)
            if not libs:
                raise FileNotFoundError(
                    f"No seismic GF libraries for wavemap {wmap.mapid} in {gfdir} — run "
                    "'beat-tpu build_gfs --datatypes seismic'")
            components = sorted(libs)
            wavemaps_libs.append((wmap, libs))
        slip_components = sorted(set(slip_components) | set(components))
        sc = config.seismic_config
        composites["seismic"] = SeismicDistributerComposite(
            wavemaps_libs, fault, slip_varnames=tuple(components),
            interpolation=sc.waveforms[0].interpolation if sc.waveforms else "multilinear",
            hp_specific=getattr(sc, "dataset_specific_residual_noise_estimation", False),
            device=device)

    composites["laplacian"] = LaplacianDistributerComposite(
        fault, slip_varnames=tuple(slip_components), device=device)

    # priors re-sized to the discretization (slip and kinematics per
    # patch, hypocentre and onset per subfault)
    priors = PriorSet()

    def add_sized(name, size):
        if name in base:
            lo, hi = float(base[name].lower.min()), float(base[name].upper.max())
            test = float(base[name].testvalue.mean())
        else:
            lo, hi = defaults.default_bounds(name)
            test = (lo + hi) / 2.0
        scale = 1e3 if name in ProblemConfig.KM_SCALED_VARS else 1.0
        priors.add(Parameter(name, np.full(size, lo * scale), np.full(size, hi * scale),
                             testvalue=np.full(size, test * scale)))

    for comp_name in slip_components:
        add_sized(comp_name, fault.npatches)
    if "seismic" in composites:
        add_sized("durations", fault.npatches)
        add_sized("velocities", fault.npatches)
        for name in ("nucleation_strike", "nucleation_dip", "time"):
            add_sized(name, fault.nsubfaults)
    return _problem(config, priors, composites, project_dir, device,
                    initialization=getattr(pc, "initialization", "random"))


def _build_corrections(gc: GeodeticConfig, datasets):
    """The configured corrections, one instance per (config entry,
    dataset): instances of one entry share hierarchicals; each applies to
    its own dataset's observations, less the entry's station
    white/blacklist and the dataset's polygon mask (points inside it —
    the deforming region — get no plate-motion correction)."""
    from beat_tpu_torch.heart.corrections import (EulerPoleCorrection, RampCorrection,
                                                  StrainRateCorrection, station_mask)

    corrections = []
    cc = gc.corrections
    if cc.ramps is not None and cc.ramps.enabled:
        names = cc.ramps.dataset_names or [ds.name for ds in datasets if ds.typ == "SAR"]
        corrections.extend(RampCorrection(dataset_name=n) for n in names)

    def eligible(entry):
        names = list(getattr(entry, "dataset_names", []) or [])
        if names:
            return [ds for ds in datasets if ds.name in names]
        return [ds for ds in datasets if ds.typ == "GNSS"]

    def masked(ds, entry, kind, i):
        mask = None
        if entry.station_whitelist or entry.station_blacklist:
            if ds.stations is None:
                logger.warning("%s correction %i has station white/blacklists but dataset %s "
                               "carries no station names — the lists are ignored and the "
                               "correction applies to every observation", kind, i, ds.name)
            else:
                mask = station_mask(ds.stations, entry.station_whitelist,
                                    entry.station_blacklist)
        if getattr(ds, "mask", None) is not None and np.any(ds.mask):
            keep = ~np.asarray(ds.mask, dtype=bool)
            mask = keep if mask is None else (mask & keep)
        return mask

    for i, ep in enumerate(cc.euler_poles):
        if not getattr(ep, "enabled", True):
            continue
        for ds in eligible(ep):
            if ds.lats is None:
                continue
            corrections.append(EulerPoleCorrection(number=i, lats=ds.lats, lons=ds.lons,
                                                   dataset_name=ds.name,
                                                   mask=masked(ds, ep, "Euler-pole", i)))
    for i, sr in enumerate(cc.strain_rates):
        if not getattr(sr, "enabled", True):
            continue
        for ds in eligible(sr):
            centroid = ds.coords.mean(axis=0)
            corrections.append(StrainRateCorrection(
                number=i, norths=ds.coords[:, 1] - centroid[1],
                easts=ds.coords[:, 0] - centroid[0], dataset_name=ds.name,
                mask=masked(ds, sr, "strain-rate", i)))
    return corrections
