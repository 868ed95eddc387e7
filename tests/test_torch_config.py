"""
The port's project layer (``beat_tpu_torch.config``, ``load_model``)
against the JAX package's: one small project per mode written by
``beat_tpu.config`` — geometry with geodetic data, with waveforms on a
homogeneous ``gf_config`` table, with first motions (a per-draw takeoff
table), a static and a kinematic FFI on a JAX-written
``fault_geometry.pkl`` and libraries, and a linear BEM problem — builds
the same ``Problem`` in both packages, with equal log-likelihoods; a
config written by either package loads in the other (its format stamp);
``import_results_as_priors`` and ``clone_config_to_mode`` write the same
configs; the filters, the
parameter records, the unit conversion, the seismic
data files and the store conversion (through a stub ``pyrocko.gf``)
against the JAX package's; the BEM source refused by the geometry
composite with the message that names the BEM composite.

The llk bar is the waveform slice's per-chain rtol 2e-5
(``tests/test_torch_seismic_llk.py``) in every mode: it is at least as
strict as the geodetic bar (``tests/test_torch_geodetic.py``, rtol 2e-5
of |llk| plus the residual-free terms).
"""

import copy
import math
import os
import pickle
import shutil
import sys
import types
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import beat_tpu.config as jcfg
import beat_tpu_torch.config as pcfg
from beat_tpu_torch.models.problem import load_model
from test_torch_common import THREADS  # noqa: F401  (thread policy)

LLK_RTOL = 2e-5

# ---------------------------------------------------------------------------
# projects written by the JAX package, one per mode
# ---------------------------------------------------------------------------


def write_scene(pdir, extent=12e3, g=10, seed=0, name="scene"):
    """An InSAR scene of a rectangle's displacement plus white noise."""
    from beat_tpu.covariance import Covariance
    from beat_tpu.heart.geodesy import GeodeticDataset
    from beat_tpu.sources import RectangularSource

    rng = np.random.default_rng(seed)
    e = np.linspace(-extent, extent, g)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    src = RectangularSource(east_shift=1e3, depth=2e3, strike=15.0, dip=60.0, rake=90.0,
                            length=7e3, width=4e3, slip=1.0)
    disp = np.asarray(src.surface_displacement(jnp.asarray(coords)))
    los = np.tile([-0.6, 0.1, 0.79], (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    obs = (disp * los).sum(1)
    sd = 0.01 * np.abs(obs).max()
    ds = GeodeticDataset(name=name, typ="SAR", coords=coords,
                         displacement=obs + rng.normal(0, sd, obs.shape), los_vector=los,
                         covariance=Covariance(data=np.eye(obs.size) * sd**2))
    jcfg.save_geodetic_datasets([ds], pdir)
    return ds


def geodetic_project(pdir):
    cfg = jcfg.init_config("geo", pdir)
    cfg.geodetic_config.corrections.ramps = jcfg.RampConfig(enabled=True)
    jcfg.dump_config(cfg, pdir)
    write_scene(pdir)


GF_CONFIG = dict(distance_min=20e3, distance_max=100e3, n_distances=6, depth_min=2e3,
                 depth_max=15e3, n_depths=4, nt=256, dt=0.25)


def seismic_project(pdir, source="DCSource"):
    """Waveforms of a double couple on two channels of four stations,
    synthesized through the homogeneous table ``gf_config`` describes."""
    from beat_tpu.heart.gftable import build_homogeneous_table
    from beat_tpu.heart.seismic import SeismicDataset
    from beat_tpu.inputf import save_seismic_datasets
    from beat_tpu.sources import sdr_to_m6

    cfg = jcfg.init_config("seis", pdir, datatypes=("seismic",), source_types=(source,))
    cfg.seismic_config.gf_config = dict(GF_CONFIG)
    wfc = cfg.seismic_config.waveforms[0]
    wfc.channels = ["Z", "R"]
    wfc.arrival_taper.a, wfc.arrival_taper.b = -3.0, -1.5
    wfc.arrival_taper.c, wfc.arrival_taper.d = 15.0, 18.0
    wfc.filterer.lower_corner, wfc.filterer.upper_corner = 0.02, 0.5
    P = cfg.problem_config.priors
    for name in ("east_shift", "north_shift"):
        P[name].update(lower=[-2.0], upper=[2.0], testvalue=[0.3])
    P["depth"].update(lower=[3.0], upper=[12.0], testvalue=[7.0])
    P["magnitude"].update(lower=[5.0], upper=[6.5], testvalue=[5.8])
    P["time"].update(lower=[-2.0], upper=[2.0], testvalue=[0.2])
    P["duration"].update(lower=[0.5], upper=[3.0], testvalue=[1.2])
    jcfg.dump_config(cfg, pdir)
    table = build_homogeneous_table(distances=np.linspace(20e3, 100e3, 6),
                                    depths=np.linspace(2e3, 15e3, 4), nt=256, dt=0.25)
    rng = np.random.default_rng(0)
    az = np.linspace(0.3, 2 * np.pi, 4, endpoint=False)
    dist = rng.uniform(35e3, 85e3, 4)
    st_e, st_n = dist * np.sin(az), dist * np.cos(az)
    m6 = jnp.asarray(sdr_to_m6(40.0, 55.0, 20.0, 6e17))
    datasets = []
    for ci, ch in enumerate("ZR"):
        spec = table.synthesize_spectra(m6, 0.0, 0.0, jnp.asarray(8e3), jnp.asarray(0.0),
                                        jnp.asarray(1.5), jnp.asarray(st_e), jnp.asarray(st_n),
                                        jnp.full(4, ci, dtype=jnp.int32))
        raw = np.asarray(table.to_time_domain(spec))
        raw = raw + rng.normal(0, 0.02 * np.abs(raw).max(), raw.shape)
        datasets += [SeismicDataset(station=f"S{i}", channel=ch, east=st_e[i], north=st_n[i],
                                    ydata=raw[i]) for i in range(4)]
    save_seismic_datasets(datasets, pdir)


def polarity_project(pdir):
    """First motions of 16 stations with distances, the depth sampled:
    the per-draw takeoff table is ray-traced through the default crust."""
    from beat_tpu.heart.polarity import PolarityTarget
    from beat_tpu.heart.velocity_model import LayeredModel, takeoff_angles
    from beat_tpu.parameter import Parameter

    cfg = jcfg.init_config("pol", pdir, datatypes=("polarity",), source_types=("DCSource",))
    rng = np.random.default_rng(1)
    n = 16
    dists = rng.uniform(30e3, 150e3, n)
    az = rng.uniform(0, 2 * np.pi, n)
    to = takeoff_angles(LayeredModel.default_crust(), 12e3, dists)
    pol = rng.choice([-1, 1], n)
    jcfg.save_polarity_targets([PolarityTarget(station=f"S{i}", azimuth_rad=az[i],
                                               takeoff_rad=to[i], polarity=int(pol[i]),
                                               distance_m=float(dists[i])) for i in range(n)],
                               pdir)
    P = cfg.problem_config.priors
    for name in list(P):
        if name not in ("strike", "dip", "rake", "depth"):
            del P[name]
    P["depth"] = Parameter("depth", [4.0], [20.0], testvalue=[10.0]).to_dict()
    jcfg.dump_config(cfg, pdir)


def write_fault(pdir, fault):
    outdir = os.path.join(pdir, "ffi", "linear_gfs")
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "fault_geometry.pkl"), "wb") as f:
        pickle.dump(fault, f)
    return outdir


def static_ffi_project(pdir):
    """The scene, a 4 × 2-patch fault pickled as the JAX package's
    ``build_gfs`` pickles it, and its geodetic library."""
    from beat_tpu.ffi import discretize_sources, geo_construct_gf_linear
    from beat_tpu.heart.geodesy import DatasetStack
    from beat_tpu.sources import RectangularSource

    ds = write_scene(pdir)
    jcfg.init_config("sffi", pdir, mode="ffi", datatypes=("geodetic",))
    ref = RectangularSource(east_shift=1e3, depth=2e3, strike=15.0, dip=60.0, rake=90.0,
                            length=8e3, width=4e3)
    fault = discretize_sources([ref], patch_length=2e3, patch_width=2e3)
    outdir = write_fault(pdir, fault)
    stack = DatasetStack.from_datasets([ds])
    geo_construct_gf_linear(fault, stack.coords, stack.los, components=("uparr", "uperp")).save(
        os.path.join(outdir, "geodetic_gfs.npz"))


def kinematic_ffi_project(pdir):
    """The seismic project's data, a 3 × 2-patch fault and the 5-D
    libraries of both slip components, built as ``build_gfs`` builds them."""
    from beat_tpu.ffi import discretize_sources, seis_construct_gf_linear
    from beat_tpu.models.seismic import build_seismic_composite
    from beat_tpu.parameter import Parameter
    from beat_tpu.sources import RectangularSource

    seismic_project(pdir)
    cfg = jcfg.init_config("kin", pdir, mode="ffi", datatypes=("seismic",))
    cfg.seismic_config = jcfg.load_config(pdir).seismic_config
    P = cfg.problem_config.priors
    P["durations"] = Parameter("durations", [0.5], [2.0], testvalue=[1.0]).to_dict()
    P["velocities"] = Parameter("velocities", [2.0], [4.0], testvalue=[3.0]).to_dict()
    jcfg.dump_config(cfg, pdir)
    ref = RectangularSource(depth=4e3, strike=20.0, dip=70.0, rake=0.0, length=6e3, width=4e3)
    fault = discretize_sources([ref], 2e3, 2e3)
    outdir = write_fault(pdir, fault)
    comp = build_seismic_composite(cfg.seismic_config, pdir, [])
    (dlo, dhi), dstep, (slo, shi), sstep = jcfg.ffi_seismic_grid_bounds(cfg, fault)
    for wmap in comp.wavemaps:
        for component in ("uparr", "uperp"):
            seis_construct_gf_linear(wmap.table, wmap, fault, component=component,
                                     duration_bounds=(dlo, dhi), duration_sampling=dstep,
                                     starttime_bounds=(slo, shi), starttime_sampling=sstep,
                                     stf_type=cfg.problem_config.stf_type).save(
                outdir, f"seismic_{component}_{wmap.mapid}")


def bem_project(pdir):
    """A pressurised rectangular crack of fixed geometry (the linear
    unit-traction composite) under a 25-point scene; two triangles keep
    the JAX package's op-by-op assembly short."""
    from beat_tpu.parameter import Parameter

    cfg = jcfg.init_config("bem", pdir, mode="bem", source_types=("RectangularBEMSource",))
    write_scene(pdir, extent=6e3, g=5, name="volcano")
    P = cfg.problem_config.priors
    for name, v in (("east_shift", 0.0), ("north_shift", 0.0), ("depth", 3.0),
                    ("strike", 30.0), ("dip", 10.0), ("length", 2.0), ("width", 1.5)):
        P[name] = Parameter(name, [v], [v]).to_dict()
    P["normal_traction"] = Parameter("normal_traction", [0.0], [60.0],
                                     testvalue=[10.0]).to_dict()
    cfg.bem_config.mesh_size = 2.5
    cfg.bem_config.check_mesh_intersection = False
    cfg.bem_config.quadrature_level = 1
    cfg.bem_config.near_quadrature_level = 3
    jcfg.dump_config(cfg, pdir)


#: case: (mode of the config, writer)
PROJECTS = {"geometry_geodetic": ("geometry", geodetic_project),
            "geometry_seismic": ("geometry", seismic_project),
            "polarity": ("geometry", polarity_project),
            "static_ffi": ("ffi", static_ffi_project),
            "kinematic_ffi": ("ffi", kinematic_ffi_project),
            "bem_linear": ("bem", bem_project)}


@pytest.fixture(scope="session")
def jax_projects(tmp_path_factory):
    """Each case's project directory, written once."""
    made = {}

    def get(case):
        if case not in made:
            pdir = str(tmp_path_factory.mktemp(case))
            PROJECTS[case][1](pdir)
            made[case] = pdir
        return made[case]

    return get


def jax_llks(problem, Q):
    logp, data = problem.make_logp_fn()
    return np.array([float(logp(jnp.asarray(q, dtype=jnp.float32), data)) for q in Q])


def port_llks(problem, Q):
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        return logp(torch.as_tensor(Q, dtype=torch.float32), data).double().numpy()


@pytest.mark.parametrize("case", list(PROJECTS))
def test_project_builds_equal_problems(jax_projects, case):
    mode = PROJECTS[case][0]
    pdir = jax_projects(case)
    jp = jcfg.problem_from_config(jcfg.load_config(pdir, mode), pdir)
    pp = load_model(pdir, mode, device="cpu")
    assert pp.priors.names == jp.priors.names
    for name in jp.priors.names:
        for key in ("lower", "upper", "testvalue"):
            np.testing.assert_array_equal(getattr(pp.priors[name], key),
                                          getattr(jp.priors[name], key))
    assert ({k: type(c).__name__ for k, c in pp.composites.items()}
            == {k: type(c).__name__ for k, c in jp.composites.items()})
    assert pp.outfolder == jp.outfolder and pp.device == torch.device("cpu")
    if hasattr(jp, "event"):              # the JAX package's bem builder sets none
        assert asdict(pp.event) == asdict(jp.event)
    lo, hi = jp.priors.bounds_arrays()
    Q = np.concatenate([jp.priors.test_array()[None],
                        np.random.default_rng(0).uniform(lo, hi, (2, lo.size))])
    want, got = jax_llks(jp, Q), port_llks(pp, Q)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_entry_points_default_to_the_card(jax_projects):
    """``load_model`` and ``problem_from_config`` resolve ``"cuda"`` by
    default: without a card they raise, they do not fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    pdir = jax_projects("geometry_geodetic")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(pdir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcfg.problem_from_config(pcfg.load_config(pdir), pdir)


# ---------------------------------------------------------------------------
# configs across the packages
# ---------------------------------------------------------------------------

INIT_CASES = {"geometry": dict(datatypes=("geodetic", "seismic", "polarity"),
                               source_types=("MTSource", "DCSource"), n_sources=(1, 2)),
              "ffi": dict(mode="ffi", datatypes=("geodetic", "seismic")),
              "bem": dict(mode="bem")}


def config_dict(config) -> dict:
    d = asdict(config)
    d.pop("project_dir")
    return d


@pytest.mark.parametrize("mode", list(INIT_CASES))
@pytest.mark.parametrize("writer,reader", [(pcfg, jcfg), (jcfg, pcfg)],
                         ids=["port_writes", "jax_writes"])
def test_config_written_by_one_package_loads_in_the_other(tmp_path, mode, writer, reader):
    cfg = writer.init_config("proj", str(tmp_path), **INIT_CASES[mode])
    cfg.subevents = [writer.EventConfig(name="sub", lat=0.1, depth=5e3)]
    cfg.problem_config.hyperparameters = {"h_SAR": {"name": "h_SAR", "form": "Uniform",
                                                    "lower": [-1.0], "upper": [2.0],
                                                    "testvalue": [0.5]}}
    path = writer.dump_config(cfg, str(tmp_path))
    with open(path) as f:
        assert yaml.safe_load(f)["version"] == "0.2.0"
    loaded = reader.load_config(str(tmp_path), cfg.problem_config.mode)
    assert type(loaded).__module__ == reader.__name__
    assert config_dict(loaded) == config_dict(cfg)


def test_old_config_is_refused_by_both_packages(tmp_path):
    pcfg.init_config("old", str(tmp_path))
    path = os.path.join(str(tmp_path), "config_geometry.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)
    d["version"] = "0.1.0"
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
    for package in (pcfg, jcfg):
        with pytest.raises(ValueError, match="written by version 0.1.0"):
            package.load_config(str(tmp_path))


def _stage_trace(problem, seed=0):
    """A final stage in the problem's outfolder: draws within its priors."""
    from beat_tpu.backend import SampleStage

    lo, hi = problem.priors.bounds_arrays()
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (12, 16, lo.size)).astype(np.float32)
    llk = rng.normal(size=(12, 16)).astype(np.float32)
    SampleStage(problem.outfolder, ordering=problem.ordering).save_stage(
        -1, {"q": q, "llk": llk}, {"beta": 1.0})


def test_import_results_as_priors_gives_the_same_configs(jax_projects, tmp_path):
    src = jax_projects("geometry_geodetic")
    dirs = {}
    for name, package in (("jax", jcfg), ("port", pcfg)):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(src, dirs[name])
    jp = jcfg.problem_from_config(jcfg.load_config(dirs["jax"]), dirs["jax"])
    _stage_trace(jp)
    shutil.copytree(os.path.join(dirs["jax"], "geometry"), os.path.join(dirs["port"], "geometry"))
    updated_j = jcfg.import_results_as_priors(dirs["jax"], "geometry", "geometry")
    updated_p = pcfg.import_results_as_priors(dirs["port"], "geometry", "geometry",
                                              device="cpu")
    assert updated_p == updated_j and "depth" in updated_p and "h_SAR" in updated_p
    assert (config_dict(pcfg.load_config(dirs["port"]))
            == config_dict(jcfg.load_config(dirs["jax"])))


@pytest.mark.parametrize("datatypes", [None, ["geodetic", "seismic"]])
def test_clone_config_to_mode_gives_the_same_configs(tmp_path, datatypes):
    dirs = {}
    for name, package in (("jax", jcfg), ("port", pcfg)):
        dirs[name] = str(tmp_path / name)
        cfg = package.init_config("clone", dirs[name], datatypes=("geodetic", "seismic"))
        cfg.problem_config.priors["time"]["upper"] = [3.0]
        package.dump_config(cfg, dirs[name])
        package.clone_config_to_mode(dirs[name], "ffi", datatypes=datatypes)
    got = config_dict(pcfg.load_config(dirs["port"], "ffi"))
    want = config_dict(jcfg.load_config(dirs["jax"], "ffi"))
    assert got == want and got["problem_config"]["priors"]["time"]["upper"] == [3.0]
    with pytest.raises(ValueError, match="bem"):
        pcfg.clone_config_to_mode(dirs["port"], "bem")


def test_fixed_corrections_subtract_what_the_jax_package_does():
    from beat_tpu.heart.corrections import RampCorrection as JRamp
    from beat_tpu.heart.geodesy import GeodeticDataset as JDataset
    from beat_tpu_torch.heart.corrections import RampCorrection
    from beat_tpu_torch.heart.geodesy import GeodeticDataset

    rng = np.random.default_rng(2)
    coords, disp = rng.uniform(-1e4, 1e4, (30, 2)), rng.normal(size=30)
    los = np.tile([0.0, 0.0, 1.0], (30, 1))
    point = {"scene_azimuth_ramp": 2e-7, "scene_range_ramp": -3e-7, "scene_offset": 0.01}
    got = [GeodeticDataset("scene", "SAR", coords, disp.copy(), los)]
    want = [JDataset("scene", "SAR", coords, disp.copy(), los)]
    assert pcfg._apply_fixed_corrections(got, [RampCorrection("scene")], point) == ["scene"]
    jcfg._apply_fixed_corrections(want, [JRamp("scene")], point)
    np.testing.assert_allclose(got[0].displacement, want[0].displacement, rtol=1e-6,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the host pieces the config path calls
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    dict(type="butterworth", lower_corner=0.02, upper_corner=0.5, order=3),
    dict(type="bandstop", lower_corner=0.12, upper_corner=0.25, order=4),
    dict(type="frequency", freqlimits=(0.01, 0.02, 0.3, 0.5)),
    [dict(type="butterworth", lower_corner=0.01, upper_corner=0.8, order=2),
     dict(type="bandstop", lower_corner=0.2, upper_corner=0.3, order=2)]],
    ids=["butterworth", "bandstop", "frequency", "chain"])
def test_filters_respond_as_the_jax_package_does(spec):
    def build(package):
        specs = spec if isinstance(spec, list) else [spec]
        cfgs = [package.FilterConfig(**s) for s in specs]
        return package.build_filterer(cfgs if isinstance(spec, list) else cfgs[0])

    got, want = build(pcfg), build(jcfg)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(got.response(512, 0.25), want.response(512, 0.25))


def test_parameter_records_as_the_jax_package_keeps_them():
    from beat_tpu.parameter import Parameter as JParameter
    from beat_tpu.parameter import PriorSet as JPriorSet
    from beat_tpu_torch.parameter import Parameter, PriorSet

    d = {"depth": {"name": "depth", "form": "Uniform", "lower": [1.0, 2.0], "upper": [5.0, 6.0],
                   "testvalue": [2.0, 3.0]},
         "strike": {"name": "strike", "lower": [0.0], "upper": [90.0]}}
    got, want = PriorSet.from_dict(d), JPriorSet.from_dict(d)
    assert got.to_dict() == want.to_dict() and got.names == want.names
    np.testing.assert_array_equal(got["strike"].testvalue, [45.0])
    for bad in (dict(name="depth", lower=[0.0], upper=[2000.0]),
                dict(name="dip", lower=[50.0], upper=[10.0]),
                dict(name="h_SAR", lower=[0.0], upper=[1.0], testvalue=[2.0])):
        for cls in (Parameter, JParameter):
            with pytest.raises(ValueError):
                cls.from_dict(bad).validate_bounds()
    Parameter.from_dict(dict(name="h_any_P_0", lower=[-1.0], upper=[1.0])).validate_bounds()


def test_adjust_point_units_and_stencils_as_in_the_jax_package():
    from beat_tpu import utility as jutility
    from beat_tpu_torch import utility

    point = {"depth": 3.0, "east_shift_1": np.array([1.0, 2.0]), "strike": 40.0, "length": 5}
    got, want = utility.adjust_point_units(point), jutility.adjust_point_units(point)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for order, st in jutility.STENCILS.items():
        np.testing.assert_array_equal(utility.STENCILS[order]["coefficients"],
                                      st["coefficients"])
        assert utility.STENCILS[order]["denominator"] == st["denominator"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_seismic_data_files_cross_read(tmp_path, writer):
    from beat_tpu import inputf as jinputf
    from beat_tpu.heart.seismic import SeismicDataset as JDataset
    from beat_tpu_torch import inputf
    from beat_tpu_torch.heart.seismic import SeismicDataset

    rng = np.random.default_rng(4)
    cls, mod = (SeismicDataset, inputf) if writer == "port" else (JDataset, jinputf)
    datasets = [cls(station=f"ST{i}", channel=ch, east=float(rng.normal()),
                    north=float(rng.normal()), ydata=rng.normal(size=64))
                for i in range(3) for ch in "ZT"]
    mod.save_seismic_datasets(datasets, str(tmp_path), "data")
    got = inputf.load_seismic_datasets(str(tmp_path), "data")
    want = jinputf.load_seismic_datasets(str(tmp_path), "data")
    assert [(d.station, d.channel, d.east, d.north) for d in got] == [
        (d.station, d.channel, d.east, d.north) for d in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ydata, b.ydata)
    csv = tmp_path / "arrivals.csv"
    csv.write_text("station,time_s\n# picked\nST0, 12.5\nST1,13.25\nbad line\n")
    assert inputf.load_arrivals_csv(str(csv)) == jinputf.load_arrivals_csv(str(csv))


def test_geometry_composite_refuses_a_meshed_source_naming_the_bem_composite():
    from beat_tpu_torch.bem import DiskBEMSource
    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.heart.geodesy import GeodeticDataset
    from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite

    ds = GeodeticDataset("s", "SAR", np.zeros((4, 2)), np.zeros(4), np.tile([0, 0, 1.0], (4, 1)),
                         covariance=Covariance(data=np.eye(4)))
    with pytest.raises(NotImplementedError, match="models/bem.py::GeodeticBEMComposite"):
        GeodeticGeometryComposite([ds], [DiskBEMSource()], device="cpu")


# ---------------------------------------------------------------------------
# the store conversion through a stub pyrocko.gf
# ---------------------------------------------------------------------------


def _stub_pyrocko():
    """``pyrocko.gf`` with the calls ``greens_table_from_store`` makes: a
    store whose traces are a Gaussian pulse at the straight-ray P time,
    scaled by the source's moment-tensor components and the channel."""
    gf = types.ModuleType("pyrocko.gf")

    class MTSource:
        def __init__(self, north_shift, east_shift, depth, **m6):
            self.depth = depth
            self.m6 = np.array([m6.get(k, 0.0) for k in ("mnn", "mee", "mdd", "mne", "mnd",
                                                         "med")])

    class Target:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    class Trace:
        def __init__(self, ydata, tmin, deltat):
            self.ydata, self.tmin, self.deltat = ydata, tmin, deltat

    class Response:
        def __init__(self, traces):
            self._traces = traces

        def pyrocko_traces(self):
            return self._traces

    class Model:
        def profile(self, name):
            return np.array({"vp": [5800.0, 6500.0], "vs": [3300.0, 3700.0],
                             "rho": [2600.0, 2900.0]}[name])

    class Store:
        config = types.SimpleNamespace(earthmodel_1d=Model())

    class LocalEngine:
        def __init__(self, store_superdirs):
            self.dirs = store_superdirs

        def get_store(self, store_id):
            return Store()

        def process(self, source, targets):
            out = []
            for i, t in enumerate(targets):
                r = math.hypot(t.north_shift, source.depth)
                tmin = r / 6000.0 - 3.0
                time = tmin + 0.1 * np.arange(120)
                pulse = np.exp(-0.5 * ((time - r / 6000.0) / 0.4) ** 2)
                weight = (np.arange(6) + 1.0 + i) @ source.m6 / (1.0 + r / 1e4)
                out.append(Trace(weight * pulse, tmin, 0.1))
            return Response(out)

    gf.MTSource, gf.Target, gf.LocalEngine = MTSource, Target, LocalEngine
    pyrocko = types.ModuleType("pyrocko")
    pyrocko.gf = gf
    return {"pyrocko": pyrocko, "pyrocko.gf": gf}


def test_store_conversion_matches_the_jax_package(monkeypatch):
    from beat_tpu.heart.store_convert import greens_table_from_store as jax_from_store
    from beat_tpu_torch.heart.store_convert import greens_table_from_store

    for name, module in _stub_pyrocko().items():
        monkeypatch.setitem(sys.modules, name, module)
    args = ("store", "/nowhere", np.linspace(10e3, 40e3, 3), np.linspace(2e3, 8e3, 2), 128,
            0.25)
    got = greens_table_from_store(*args, device="cpu")
    want = jax_from_store(*args)
    ref = np.asarray(want.spectra)
    np.testing.assert_allclose(got.spectra.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert (got.vp, got.vs, got.rho) == (want.vp, want.vs, want.rho) == (5800.0, 3300.0, 2600.0)
    np.testing.assert_array_equal(got.depths, want.depths)


def test_config_copies_keep_the_dataclass_schema():
    """The port's config classes hold the JAX package's fields, defaults
    and nested types, so a config's dict is the same in both."""
    for name in ("EventConfig", "NoiseEstimatorConfig", "RampConfig", "EulerPoleConfig",
                 "StrainRateConfig", "GeodeticCorrectionsConfig", "GeodeticConfig",
                 "ArrivalTaperConfig", "FilterConfig", "WaveformFitConfig", "SeismicConfig",
                 "PolarityFitConfig", "PolarityConfig", "BoundaryConditionConfig", "BEMConfig",
                 "ProblemConfig", "SamplerConfig", "BEATconfig"):
        assert asdict(getattr(pcfg, name)()) == asdict(getattr(jcfg, name)()), name
    assert pcfg.source_geometry_vars == jcfg.source_geometry_vars
    assert pcfg.bem_source_geometry_vars == jcfg.bem_source_geometry_vars
    cfg = pcfg.BEATconfig()
    cfg.sampler_config = pcfg.SamplerConfig(name="PT", parameters={"n_chains": 8})
    assert type(cfg.sampler_config.get_params()).__name__ == "PTParams"
    assert copy.deepcopy(cfg) == cfg
