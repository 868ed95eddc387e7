"""
The port's interop with original-BEAT project files
(``beat_tpu_torch.interop``) against the JAX package's, on the same
synthetic files: a guts-YAML config with ``!beat.*``/``!pf.*`` tags, the
pyrocko data pickles (stations and traces; InSAR and GNSS datasets) read
through the shim unpickler, a basic station file, snuffler phase markers
(point and span forms), the raw seismic files and their gridding onto a
table, the seismic table grid of an import, and ``import_beat_project``.
The reference's own example projects are not in the repository (the
JAX package's tests of them skip), so these files are written here.
"""

import os
import pickle
import sys
import types
from dataclasses import asdict

import numpy as np
import pytest
import yaml

import beat_tpu.interop as jint
import beat_tpu_torch.interop as pint
from test_torch_common import THREADS  # noqa: F401  (thread policy)


GUTS = """--- !beat.BEATconfig
name: synth
date: '2020-09-12'
event: !pf.Event
  lat: 42.3
  lon: 13.4
  time: 2020-09-11 22:37:26.5
  depth: 9000.0
  name: ev
  magnitude: 5.8
  duration: 2.0
project_dir: /somewhere/synth
problem_config: !beat.ProblemConfig
  mode: geometry
  source_types: [MTSource]
  n_sources: [1]
  datatypes: [geodetic, seismic, polarity]
  stf_type: HalfSinusoid
  decimation_factors: {geodetic: 2, seismic: 1}
  priors:
    depth: !beat.heart.Parameter
      name: depth
      form: Uniform
      lower: [2.0]
      upper: [15.0]
      testvalue: [9.0]
    east_shift: !beat.heart.Parameter
      name: east_shift
      form: Uniform
      lower: [-5.0]
      upper: [5.0]
      testvalue: [0.0]
  hyperparameters:
    h_any_P_0_Z: !beat.heart.Parameter
      name: h_any_P_0_Z
      form: Uniform
      lower: [-2.0]
      upper: [4.0]
      testvalue: [0.0]
geodetic_config: !beat.GeodeticConfig
  types:
    SAR: !beat.SARDatasetConfig
      names: [asc]
    GNSS: !beat.GNSSDatasetConfig
      names: [gnss_east]
  noise_estimator: !beat.GeodeticNoiseAnalyserConfig
    structure: import
    max_dist_perc: 0.3
  interpolation: multilinear
  corrections_config: !beat.GeodeticCorrectionsConfig
    euler_poles:
    - !beat.EulerPoleConfig
      enabled: true
      station_whitelist: [AAAA]
      dataset_names: [gnss_east]
    ramp: !beat.RampConfig
      enabled: true
      dataset_names: [asc]
  gf_config: !beat.GeodeticGFConfig
    earth_model_name: ak135-f-continental.m
    n_variations: [0, 2]
seismic_config: !beat.SeismicConfig
  station_corrections: true
  noise_estimator: !beat.SeismicNoiseAnalyserConfig
    structure: variance
    pre_arrival_time: 3.0
  waveforms:
  - !beat.WaveformFitConfig
    include: true
    name: any_P
    channels: [Z]
    arrival_taper: !beat.heart.ArrivalTaper
      a: -15.0
      b: -10.0
      c: 40.0
      d: 55.0
    filterer:
    - !beat.heart.Filter
      lower_corner: 0.01
      upper_corner: 0.2
      order: 3
    distances: [0.0, 10.0]
    interpolation: multilinear
    arrivals_marker_path: ./markers.pf
  - !beat.WaveformFitConfig
    name: any_S
    channels: [T]
    filterer: !beat.heart.FrequencyFilter
      freqlimits: [0.005, 0.01, 0.1, 0.2]
  gf_config: !beat.SeismicGFConfig
    sample_rate: 2.0
    earth_model_name: ak135-f-continental.m
    custom_velocity_model: |2
          0.             5.8           3.46           2.6         1264.           600.
         20.             5.8           3.46           2.6         1264.           600.
         20.             6.5           3.85           2.9         1283.           600.
         35.             6.5           3.85           2.9         1283.           600.
      mantle
         35.             8.04          4.48           3.58        1449.           600.
         77.5            8.045         4.49           3.5         1445.           600.
polarity_config: !beat.PolarityConfig
  waveforms:
  - !beat.PolarityFitConfig
    name: any_P
    blacklist: [XX.BAD]
    polarities_marker_path: ./polarity_markers_P.pf
  gf_config: !beat.PolarityGFConfig
    earth_model_name: local
sampler_config: !beat.SamplerConfig
  name: SMC
  backend: bin
  buffer_thinning: 5
  parameters: !beat.SMCConfig
    n_chains: 300
    n_steps: 150
    tune_interval: 10
    coef_variation: 1.0
    proposal_dist: MultivariateNormal
    rm_flag: true
    n_jobs: 4
    stage: 2
hyper_sampler_config: !beat.SamplerConfig
  name: Metropolis
  parameters: !beat.MetropolisConfig
    n_chains: 8
    n_steps: 1000
    thin: 2
    burn: 0.5
"""

STATIONS = """XX.AAAA.  42.50  13.50  100.0  0.0
  BHZ   0.0  -90.0  1.0
  BHN   0.0    0.0  1.0
XX.BBBB.00  41.90  13.10  50.0  0.0
  BHZ   0.0  -90.0  1.0
XX.CCCC.  42.10  14.00
"""

MARKERS = """# Snuffler Markers File Version 0.2
phase: 2020-09-11 22:37:31.90353  0 XX.AAAA..BHZ R6VDO9K= 2020-09-11 22:37:26.00000 P 1 False
phase: 2020-09-11 22:37:33.34316 2020-09-11 22:37:35.34316 2.0 0 XX.BBBB.00.BHZ R6VDO9K= 2020-09-11 22:37:26.00000 P -1 False
phase: 2020-09-11 22:37:34.00000  0 XX.CCCC..BHZ R6VDO9K= 2020-09-11 22:37:26.00000 P 0 False
phase: 2020-09-11 22:37:34.50000  0 XX.GONE..BHZ R6VDO9K= 2020-09-11 22:37:26.00000 P 1 False
"""


def _pyrocko_classes():
    """Classes pickled under pyrocko's and BEAT's module names, as the
    reference's data pickles name them; returns {name: class} and the
    modules to register while pickling."""
    mods = {n: types.ModuleType(n) for n in ("pyrocko", "pyrocko.model", "pyrocko.model.station",
                                             "beat", "beat.heart", "beat.covariance")}

    def make(module, name, reduce_tuple=False):
        def __reduce_ex__(self, protocol):
            if reduce_tuple:
                return (cls, (), self.state)
            return (cls, (), self.__dict__)
        cls = type(name, (), {"__module__": module, "__reduce_ex__": __reduce_ex__,
                              "__setstate__": lambda self, s: None})
        setattr(mods[module], name, cls)
        return cls

    classes = {n: make("pyrocko.model.station", n) for n in ("Station", "Channel")}
    classes["SeismicDataset"] = make("beat.heart", "SeismicDataset", reduce_tuple=True)
    for n in ("DiffIFG", "GNSSCompoundComponent", "GNSSStation", "GNSSComponent"):
        classes[n] = make("beat.heart", n)
    classes["Covariance"] = make("beat.covariance", "Covariance")
    return classes, mods


def _obj(cls, **attrs):
    o = cls.__new__(cls)
    o.__dict__.update(attrs)
    return o


def _write_pickles(src, monkeypatch):
    C, mods = _pyrocko_classes()
    for n, m in mods.items():
        monkeypatch.setitem(sys.modules, n, m)
    rng = np.random.default_rng(2)
    stations, traces = [], []
    for i, (lat, lon) in enumerate(((42.5, 13.5), (41.9, 13.1), (42.8, 14.2))):
        stations.append(_obj(C["Station"], network="XX", station=f"S{i}", location="",
                             lat=lat, lon=lon, elevation=10.0 * i, depth=0.0,
                             channels=[_obj(C["Channel"], name=c, azimuth=a, dip=d)
                                       for c, a, d in (("Z", 0.0, -90.0), ("N", 0.0, 0.0))]))
        for ch in ("Z", "N"):
            t = _obj(C["SeismicDataset"])
            t.state = ("XX", f"S{i}", "", ch, 1.6e9 + i, 1.6e9 + 200.0, 0.5, None,
                       rng.normal(size=400), None, "any_P", None)
            traces.append(t)
    with open(os.path.join(src, "seismic_data.pkl"), "wb") as f:
        pickle.dump([stations, traces], f, protocol=4)
    n = 25
    ifg = _obj(C["DiffIFG"], name="asc", lats=42.3 + rng.uniform(-0.1, 0.1, n),
               lons=13.4 + rng.uniform(-0.1, 0.1, n), displacement=rng.normal(0, 0.01, n),
               incidence=np.full(n, 34.0), heading=np.full(n, -166.0), odw=np.ones(n),
               mask=rng.uniform(size=n) > 0.7,
               covariance=_obj(C["Covariance"], data=np.eye(n) * 1e-5))
    gnss = _obj(C["GNSSCompoundComponent"], component="E", covariance=None, stations=[
        _obj(C["GNSSStation"], network="XX", station=f"G{i}", lat=42.0 + 0.1 * i,
             lon=13.0 + 0.1 * i, east=_obj(C["GNSSComponent"], shift=0.01 * i))
        for i in range(4)])
    other = _obj(C["GNSSStation"], network="XX", station="skip", lat=0.0, lon=0.0)
    with open(os.path.join(src, "geodetic_data.pkl"), "wb") as f:
        pickle.dump([ifg, gnss, other], f, protocol=4)
    for n in mods:
        monkeypatch.delitem(sys.modules, n)


@pytest.fixture
def source_project(tmp_path, monkeypatch):
    src = tmp_path / "beat_project"
    src.mkdir()
    (src / "config_geometry.yaml").write_text(GUTS)
    (src / "stations.txt").write_text(STATIONS)
    (src / "polarity_markers_P.pf").write_text(MARKERS)
    _write_pickles(str(src), monkeypatch)
    return str(src)


def test_guts_config_equals_the_jax_package(source_project):
    path = os.path.join(source_project, "config_geometry.yaml")
    assert pint.load_guts_yaml(path) == jint.load_guts_yaml(path)
    got, got_notes = pint.beat_config_from_guts(path)
    want, want_notes = jint.beat_config_from_guts(path)
    assert got_notes == want_notes and len(got_notes) >= 3
    assert asdict(got) == asdict(want)
    assert got._custom_velocity_models == want._custom_velocity_models
    for value in ("2020-09-11 22:37:26.5", 1.6e9, "2020-09-11 22:37:26.123456789"):
        assert pint.guts_time_to_epoch(value) == jint.guts_time_to_epoch(value)


def test_data_pickles_equal_the_jax_package(source_project):
    from test_torch_inputf import assert_same_datasets

    spath = os.path.join(source_project, "seismic_data.pkl")
    (gs, gt), (ws, wt) = pint.seismic_arrays_from_pickle(spath), jint.seismic_arrays_from_pickle(spath)
    assert gs == ws and len(gs) == 3 and gs[0]["channels"] == {"Z": (0.0, -90.0), "N": (0.0, 0.0)}
    assert len(gt) == len(wt) == 6
    for a, b in zip(gt, wt):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    gpath = os.path.join(source_project, "geodetic_data.pkl")
    event = types.SimpleNamespace(lat=42.3, lon=13.4)
    got = pint.geodetic_datasets_from_pickle(gpath, event=event)
    assert [d.name for d in got] == ["asc", "gnss_east"]
    assert_same_datasets(got, jint.geodetic_datasets_from_pickle(gpath, event=event))


def test_station_and_marker_files_equal_the_jax_package(source_project, tmp_path):
    spath = os.path.join(source_project, "stations.txt")
    mpath = os.path.join(source_project, "polarity_markers_P.pf")
    assert pint.load_pyrocko_stations(spath) == jint.load_pyrocko_stations(spath)
    markers = pint.load_snuffler_markers(mpath)
    assert markers == jint.load_snuffler_markers(mpath)
    assert [m["polarity"] for m in markers] == [1, -1, 0, 1]
    for m, name in ((pint, "p.csv"), (jint, "j.csv")):
        m.snuffler_markers_to_arrivals_csv(mpath, str(tmp_path / name))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()
    event = types.SimpleNamespace(lat=42.3, lon=13.4)
    got = pint.polarity_targets_from_markers(mpath, spath, event)
    want = jint.polarity_targets_from_markers(mpath, spath, event)
    assert [asdict(t) for t in got] == [asdict(t) for t in want] and len(got) == 2


def test_import_beat_project_writes_what_the_jax_package_writes(source_project, tmp_path):
    """The whole migration without the GF build: the configs, the raw
    traces, the geodetic data, the velocity model and the polarity data
    of both packages' imports are equal."""
    out = {}
    for name, m in (("port", pint), ("jax", jint)):
        dest = str(tmp_path / name)
        config, notes = m.import_beat_project(source_project, dest, build=False)
        files = {}
        for fname in sorted(os.listdir(dest)):
            path = os.path.join(dest, fname)
            if fname.endswith(".npz"):
                with np.load(path) as z:
                    files[fname] = {k: z[k] for k in z.files}
            elif fname.endswith(".yaml"):
                d = yaml.safe_load(open(path))
                d.pop("project_dir")
                files[fname] = d
            else:
                files[fname] = open(path).read()
        out[name] = notes, files
    assert out["port"][0] == out["jax"][0]
    got, want = out["port"][1], out["jax"][1]
    assert sorted(got) == sorted(want) == ["config_geometry.yaml", "geodetic_data.npz",
                                           "polarity_data.npz", "seismic_data_raw.npz",
                                           "velocity_model.nd"]
    for fname in want:
        if isinstance(want[fname], dict) and fname.endswith(".npz"):
            assert sorted(got[fname]) == sorted(want[fname])
            for k in want[fname]:
                np.testing.assert_array_equal(got[fname][k], want[fname][k], err_msg=k)
        else:
            assert got[fname] == want[fname], fname
    grid = got["config_geometry.yaml"]["seismic_config"]["gf_config"]
    assert grid["nt"] >= 64 and grid["fmax"] == pytest.approx(0.4)


def test_raw_seismic_gridding_equals_the_jax_package(source_project, tmp_path):
    """``save_raw_seismic`` → ``load_raw_seismic`` → the traces gridded
    onto a project's table (``prepare_imported_seismic``), the table
    built and read by each package."""
    from beat_tpu.config import EventConfig as JEvent
    from beat_tpu.heart.gftable import build_homogeneous_table as jax_table
    from beat_tpu_torch.config import EventConfig, dump_config, init_config
    from beat_tpu_torch.heart.gftable import build_homogeneous_table

    stations, traces = pint.seismic_arrays_from_pickle(os.path.join(source_project,
                                                                    "seismic_data.pkl"))
    grid = dict(distances=np.linspace(10e3, 120e3, 5), depths=np.array([5e3, 15e3]), nt=256,
                dt=0.5)
    results = {}
    for name, m, table, event in (
            ("port", pint, build_homogeneous_table(**grid, device="cpu"), EventConfig),
            ("jax", jint, jax_table(**grid), JEvent)):
        dest = str(tmp_path / name)
        cfg = init_config("raw", dest, datatypes=("seismic",))
        cfg.event.lat, cfg.event.lon, cfg.event.time = 42.3, 13.4, 1.6e9 - 20.0
        dump_config(cfg, dest)
        m.save_raw_seismic(stations, traces, dest,
                           event=event(lat=42.3, lon=13.4, time=1.6e9 - 20.0))
        back = m.load_raw_seismic(dest)
        table.save(os.path.join(dest, "gf_table.npz"))
        kw = {"device": "cpu"} if m is pint else {}
        results[name] = back, m.prepare_imported_seismic(dest, **kw)
    (gs, gt), gd = results["port"]
    (ws, wt), wd = results["jax"]
    assert gs == ws and [t.keys() for t in gt] == [t.keys() for t in wt]
    for a, b in zip(gt, wt):
        np.testing.assert_array_equal(a["ydata"], b["ydata"])
    assert [(d.station, d.channel) for d in gd] == [(d.station, d.channel) for d in wd]
    for a, b in zip(gd, wd):
        np.testing.assert_array_equal(a.ydata, b.ydata)
        assert (a.east, a.north) == (b.east, b.north)


@pytest.mark.parametrize("phase", ["any_P", "any_S"])
def test_seismic_table_grid_equals_the_jax_package(source_project, phase):
    path = os.path.join(source_project, "config_geometry.yaml")
    pcfg, _ = pint.beat_config_from_guts(path)
    jcfg, _ = jint.beat_config_from_guts(path)
    for cfg in (pcfg, jcfg):
        for w in cfg.seismic_config.waveforms:
            w.name = phase
    stations, _ = pint.seismic_arrays_from_pickle(os.path.join(source_project,
                                                               "seismic_data.pkl"))
    got = pint._seismic_gf_grid(pcfg, stations, {"dt": 0.5})
    assert got == jint._seismic_gf_grid(jcfg, stations, {"dt": 0.5})
    assert got["nt"] * got["dt"] >= got["distance_max"] / (3000.0 if phase == "any_S"
                                                           else 5500.0)


def test_shim_unpickler_reads_unknown_classes_as_attribute_bags(tmp_path, monkeypatch):
    C, mods = _pyrocko_classes()
    for n, m in mods.items():
        monkeypatch.setitem(sys.modules, n, m)
    path = tmp_path / "x.pkl"
    with open(path, "wb") as f:
        pickle.dump({"st": _obj(C["Station"], network="XX", lat=1.5), "n": np.arange(3)}, f)
    for n in mods:
        monkeypatch.delitem(sys.modules, n)
    got, want = pint.load_pyrocko_pickle(str(path)), jint.load_pyrocko_pickle(str(path))
    assert type(got["st"]).__name__ == type(want["st"]).__name__ == "Station"
    assert got["st"].__dict__ == want["st"].__dict__ == {"network": "XX", "lat": 1.5}
    np.testing.assert_array_equal(got["n"], want["n"])


@pytest.mark.parametrize("name", ["FullMT", "Laquila", "MTQT_polarity", "Fernandina",
                                  "dc_teleseismic"])
def test_reference_example_projects_import_as_in_the_jax_package(name, tmp_path):
    """The reference's own example projects, where they are present (the
    JAX package's ``tests/test_interop.py`` reads them from the same
    place and skips without them): the guts config, the data pickles and
    the whole import without the GF build give what the JAX package's
    give."""
    from test_interop import EXAMPLES, HAVE_EXAMPLES

    if not HAVE_EXAMPLES:
        pytest.skip("reference example data not present")
    src = os.path.join(EXAMPLES, name)
    got, got_notes = pint.beat_config_from_guts(os.path.join(src, "config_geometry.yaml"))
    want, want_notes = jint.beat_config_from_guts(os.path.join(src, "config_geometry.yaml"))
    assert asdict(got) == asdict(want) and got_notes == want_notes
    out = {}
    for label, m in (("port", pint), ("jax", jint)):
        dest = str(tmp_path / label)
        m.import_beat_project(src, dest, build=False)
        out[label] = {}
        for fname in sorted(os.listdir(dest)):
            if fname.endswith(".npz"):
                with np.load(os.path.join(dest, fname)) as z:
                    out[label][fname] = {k: z[k] for k in z.files}
    assert sorted(out["port"]) == sorted(out["jax"])
    for fname, arrays in out["jax"].items():
        for k, v in arrays.items():
            np.testing.assert_array_equal(out["port"][fname][k], v, err_msg=f"{fname}:{k}")
