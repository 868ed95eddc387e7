"""
The port's importers (``beat_tpu_torch.inputf``) and its waveform
acquisition (``beat_tpu_torch.apps.beatdown``) against the JAX
package's, on the same files: every geodetic importer (SAR CSV, GNSS
CSV, matlab scenes, GLOBK, an in-memory kite scene with its polygon
mask), the GlobalCMT NDK reader, ``import`` through both CLIs, and the
obspy paths (download, restitution, weeding, cut windows, gridding onto
the table, ``beat-tpu-torch-down``) through ``tests/fake_obspy.py`` —
nothing is downloaded.  Arrays are equal to the JAX package's (the same
numpy code), the gridded traces within float32 roundoff of the table.
"""

import os
import shutil
import sys
import types

import numpy as np
import pytest
import scipy.io

import beat_tpu.apps.beatdown as jdown
import beat_tpu.inputf as jin
import beat_tpu_torch.apps.beatdown as pdown
import beat_tpu_torch.inputf as pin
import fake_obspy
from test_torch_cli import run_jax, run_port
from test_torch_common import THREADS  # noqa: F401  (thread policy)

EVENT_TIME = 1.6e9

GNSS_CSV = ("station,lat,lon,east,north,up,sigma_east,sigma_north,sigma_up\n"
            "AAAA,10.0,20.0,0.01,-0.02,0.005,0.001,0.002,0.003\n"
            "BBBB,10.1,20.1,0.03,0.01,-0.001,0.001,0.002,0.003\n"
            "CCCC,9.9,20.2,-0.01,0.02,0.002,0.0005,0.002,0.001\n")
GLOBK = ("h1\nh2\nh3\n"
         "30.1 40.2 12.0 -3.0 0 0 1.0 1.2 0 5.0 0 2.0 AAAA\n"
         "31.5 41.0 -6.0  8.0 0 0 0.8 0.9 0 -2.0 0 1.5 BBBB\n"
         "32.2 39.5  4.0  1.0 0 0 0.5 0.6 0 1.0 0 1.0 CCCC\n")
NDK = (
    "PDE  2005/01/01 01:20:05.4  13.78  -88.78 193.1 5.0 5.0 EL SALVADOR\n"
    "B010105A         B:  4    4  40 S: 27   33  95 M:  0    0   0 CMT: 1 TRIHD: 0.6\n"
    "CENTROID:     -0.3 0.9  13.76 0.06  -89.08 0.09 162.8 12.5 FREE S-20050322125201\n"
    "24  0.838 0.201  0.005 0.231 -0.843 0.270  1.050 0.121 -0.369 0.161  0.044 0.240\n"
    "V10   1.581 56  12  -0.537 23 140  -1.044 24 241   1.312  9 29  142 133 66  80\n"
    "PDE  2005/01/02 13:58:23.3  -5.55  151.20  38.0 6.4 6.1 NEW BRITAIN REGION, P\n"
    "C200501021358A   B: 80  141  17 S:123  240  96 M:  0    0   0 CMT: 1 TRIHD: 0.7\n"
    "CENTROID:      2.8 0.1  -5.62 0.01  151.12 0.01  41.4  0.7 FREE S-20050322130importa\n"
    "25  1.250 0.011 -0.306 0.012 -0.944 0.012  0.470 0.206  2.600 0.262 -0.867 0.009\n"
    "V10   3.197 45 136   0.288 3 232  -3.484 45 325   3.340 100 21  70 278 69  97\n")

DATASET_FIELDS = ("name", "typ", "coords", "displacement", "los_vector", "odw", "mask",
                  "lats", "lons", "stations")


def assert_same_datasets(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in DATASET_FIELDS:
            a, b = getattr(g, field, None), getattr(w, field, None)
            if b is None:
                assert a is None, field
            elif isinstance(b, str):
                assert a == b, field
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)
        np.testing.assert_array_equal(g.covariance.data, w.covariance.data)


def _files(tmp_path):
    (tmp_path / "scene.csv").write_text(
        "east,north,displacement,incidence,heading\n0,0,0.01,34,-166\n"
        "1000,0,0.02,35,-165\n0,1500,-0.004,36,-164\n")
    (tmp_path / "plain.csv").write_text("east,north,displacement\n0,0,0.01\n1000,0,0.02\n")
    (tmp_path / "gnss.csv").write_text(GNSS_CSV)
    (tmp_path / "gps.txt").write_text(GLOBK)
    n, rng = 12, np.random.default_rng(0)
    scipy.io.savemat(tmp_path / "quad_asc.mat", {
        "cfoc": np.column_stack([np.linspace(0, 5e3, n), np.linspace(0, 8e3, n)]),
        "sqval": rng.normal(0, 0.01, n), "lvQT": {"inci": 34.0, "head": -166.0},
        "ODW_sub": rng.uniform(0.5, 1.0, n)})
    scipy.io.savemat(tmp_path / "CovMatrix_asc.mat", {"Cov": np.eye(n) * 1e-6})
    return str(tmp_path)


IMPORTERS = {
    "sar_csv_columns": lambda m, d: [m.load_sar_csv(os.path.join(d, "scene.csv"))],
    "sar_csv_defaults": lambda m, d: [m.load_sar_csv(os.path.join(d, "plain.csv"), name="x",
                                                     incidence=30.0, heading=190.0)],
    "gnss_csv": lambda m, d: m.load_gnss_csv(os.path.join(d, "gnss.csv")),
    "gnss_csv_blacklist": lambda m, d: m.load_gnss_csv(os.path.join(d, "gnss.csv"),
                                                       components=("east", "up"),
                                                       blacklist=("BBBB",)),
    "sar_matlab": lambda m, d: m.load_sar_matlab(d, ["asc", "missing"]),
    "globk": lambda m, d: m.load_ascii_gnss_globk(d, "gps.txt", blacklist=("BBBB",)),
}


@pytest.mark.parametrize("importer", list(IMPORTERS))
def test_importer_equals_the_jax_package(tmp_path, importer):
    d = _files(tmp_path)
    assert_same_datasets(IMPORTERS[importer](pin, d), IMPORTERS[importer](jin, d))


def _kite_scene(polygons):
    """An in-memory stand-in of a kite ``Scene``: a quadtree of leaves
    with look angles, a covariance and user-drawn polygons."""
    rng = np.random.default_rng(3)
    n = 30
    qt = types.SimpleNamespace(
        leaf_focal_points=rng.uniform(0, 2e4, (n, 2)), leaf_thetas=rng.uniform(0.6, 1.0, n),
        leaf_phis=rng.uniform(-2.0, 2.0, n), leaf_means=rng.normal(0, 0.01, n),
        leaf_northings=rng.uniform(0, 2e4, n), leaf_eastings=rng.uniform(0, 2e4, n))
    return types.SimpleNamespace(
        quadtree=qt, covariance=types.SimpleNamespace(covariance_matrix=np.eye(n) * 4e-6),
        frame=types.SimpleNamespace(dN=100.0, dE=80.0),
        polygon_mask=types.SimpleNamespace(polygons=polygons))


@pytest.mark.parametrize("polygons", [{0: [[0, 0], [150, 0], [150, 120], [0, 120]]}, {}],
                         ids=["polygon", "none"])
def test_kite_scene_equals_the_jax_package(polygons):
    scene = _kite_scene(polygons)
    got = pin.kite_scene_to_dataset(scene, "kite")
    assert_same_datasets([got], [jin.kite_scene_to_dataset(scene, "kite")])
    assert (got.mask is None) == (not polygons)
    if "kite" not in sys.modules:
        for m in (pin, jin):
            with pytest.raises(ImportError, match="kite is required"):
                m.load_kite_scene("scene.yml")


def test_gcmt_ndk_equals_the_jax_package(tmp_path):
    path = tmp_path / "cat.ndk"
    path.write_text(NDK)
    got, want = pin.read_gcmt_ndk(str(path)), jin.read_gcmt_ndk(str(path))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for kw in (dict(name="c2005"), dict(date="2005-01-01"), {}):
        assert pin.select_gcmt_event(got, **kw)["name"] == jin.select_gcmt_event(want, **kw)["name"]
    with pytest.raises(ValueError, match="No NDK event"):
        pin.select_gcmt_event(got, name="nowhere")
    (tmp_path / "bad.ndk").write_text(NDK.split("\n", 1)[1])
    with pytest.raises(ValueError, match="5 lines per event"):
        pin.read_gcmt_ndk(str(tmp_path / "bad.ndk"))


def test_import_and_init_from_ndk_through_both_clis(tmp_path):
    """``init --gcmt_ndk`` and ``import`` (GLOBK, matlab, GNSS and SAR CSV)
    write the same config and ``geodetic_data.npz`` through both CLIs."""
    import yaml

    d = _files(tmp_path)
    (tmp_path / "cat.ndk").write_text(NDK)
    out = {}
    for name, run in (("port", run_port), ("jax", run_jax)):
        proj = str(tmp_path / name)
        assert run("init", "p", proj, "--datatypes", "geodetic", "--source_types", "MTSource",
                   "--gcmt_ndk", os.path.join(d, "cat.ndk"), "--event_name", "B010105A") == 0
        assert run("import", proj, "--gnss_globk", os.path.join(d, "gps.txt"),
                   "--sar_matlab", d, "--scenes", "asc", "--sar_csv",
                   os.path.join(d, "scene.csv"), "--gnss_csv", os.path.join(d, "gnss.csv"),
                   "--blacklist", "BBBB") == 0
        with open(os.path.join(proj, "config_geometry.yaml")) as f:
            cfg = yaml.safe_load(f)
        cfg.pop("project_dir")
        with np.load(os.path.join(proj, "geodetic_data.npz")) as z:
            out[name] = cfg, {k: z[k] for k in z.files}
    assert out["port"][0] == out["jax"][0]
    got, want = out["port"][1], out["jax"][1]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# obspy paths, through the in-repo stand-in
# ---------------------------------------------------------------------------


@pytest.fixture
def obspy_env(monkeypatch):
    for name, mod in fake_obspy.build_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    for registry in (fake_obspy.CATALOG, fake_obspy.DOWNLOAD_STATIONS, fake_obspy.LAST_DOWNLOAD,
                     fake_obspy.DEAD_SITES, fake_obspy.CLIENTS_MADE):
        registry.clear()
    return fake_obspy


def _same_traces(got, want):
    assert sorted(got) == sorted(want)
    for sta in want:
        assert sorted(got[sta]) == sorted(want[sta])
        for ch in want[sta]:
            for a, b in zip(got[sta][ch], want[sta][ch]):
                np.testing.assert_array_equal(a, b)


def test_acquisition_chain_equals_the_jax_package(obspy_env, tmp_path):
    """download → restitution → weeding → table-grid preparation, each
    step in both packages on the same files."""
    import torch

    from beat_tpu.heart.gftable import build_homogeneous_table as jax_table
    from beat_tpu_torch.heart.gftable import build_homogeneous_table

    obspy_env.DOWNLOAD_STATIONS.extend([
        dict(station="AAA", lon=0.4, lat=0.2, gain=2.0e9),
        dict(station="BBB", lon=-0.3, lat=0.5, gain=5.0e8),
        dict(station="DEAD", lon=0.1, lat=-0.4, gain=1.0e9, amp=0.0)])
    event = dict(time=EVENT_TIME, lat=0.0, lon=0.0)
    wf_dir, inv_dir = pdown.download_waveforms(event, str(tmp_path / "port"))
    jwf_dir, _ = jdown.download_waveforms(event, str(tmp_path / "jax"))
    assert sorted(os.listdir(wf_dir)) == sorted(os.listdir(jwf_dir))
    inv = os.path.join(inv_dir, "inventory.json")
    got, want = pin.load_obspy_traces(wf_dir, inv), jin.load_obspy_traces(wf_dir, inv)
    _same_traces(got[0], want[0])
    assert got[1] == want[1]
    got = pdown.weed_stations(*got, EVENT_TIME, snr_min=20.0, blacklist=("XXX",))
    want = jdown.weed_stations(*want, EVENT_TIME, snr_min=20.0, blacklist=("XXX",))
    _same_traces(got[0], want[0])
    assert sorted(got[0]) == ["AAA", "BBB"] and got[1] == want[1]

    stations = {s: (lon * 111e3, lat * 111e3) for s, (lon, lat) in got[1].items()}
    grid = dict(distances=np.array([30e3, 90e3]), depths=np.array([5e3, 15e3]), nt=128, dt=0.5)
    ptab, jtab = build_homogeneous_table(**grid, device="cpu"), jax_table(**grid)
    for window in (None, ("velocity", 3000.0, 6000.0, 2.0), ("fixed", 10.0, 40.0)):
        cut = {}
        if window and window[0] == "velocity":
            cut = {m: m.VelocityWindow(*window[1:]) for m in (pdown, jdown)}
        elif window:
            cut = {m: m.FixedWindow(EVENT_TIME + window[1], EVENT_TIME + window[2])
                   for m in (pdown, jdown)}
        pd = pdown.prepare_local_traces(got[0], stations, dict(time=EVENT_TIME, depth=8e3), ptab,
                                        str(tmp_path / "pp"), cut_window=cut.get(pdown))
        jd = jdown.prepare_local_traces(want[0], stations, dict(time=EVENT_TIME, depth=8e3), jtab,
                                        str(tmp_path / "jp"), cut_window=cut.get(jdown))
        assert [(d.station, d.channel) for d in pd] == [(d.station, d.channel) for d in jd]
        for a, b in zip(pd, jd):
            np.testing.assert_array_equal(a.ydata, b.ydata)
    back = pin.load_seismic_datasets(str(tmp_path / "pp"))
    assert len(back) == 6 and all(d.ydata.shape == (128,) for d in back)
    assert torch.is_tensor(ptab.packed)


def test_phase_window_and_helpers_equal_the_jax_package():
    from beat_tpu.heart.velocity_model import LayeredModel as JModel
    from beat_tpu_torch.heart.velocity_model import LayeredModel

    pw = pdown.PhaseWindow(LayeredModel.homogeneous(vp=6000.0, vs=3464.0), "p", -1.0, 20.0)
    jw = jdown.PhaseWindow(JModel.homogeneous(vp=6000.0, vs=3464.0), "p", -1.0, 20.0)
    assert pw(EVENT_TIME, 100e3, 8e3) == pytest.approx(jw(EVENT_TIME, 100e3, 8e3), abs=1e-9)
    rng = np.random.default_rng(5)
    n, e = rng.normal(size=50), rng.normal(size=50)
    for got, want in zip(pdown.rotate_to_rtz(n, e, 0.7), jdown.rotate_to_rtz(n, e, 0.7)):
        np.testing.assert_array_equal(got, want)
    sig = rng.normal(size=2400)
    np.testing.assert_array_equal(pdown.bandpass_and_decimate(sig, 0.05, 0.25, lower=0.02),
                                  jdown.bandpass_and_decimate(sig, 0.05, 0.25, lower=0.02))
    assert pdown._to_epoch("2020-09-13T12:00:00") == jdown._to_epoch("2020-09-13T12:00:00")


def test_event_lookup_equals_the_jax_package(obspy_env, tmp_path):
    def events_fn(time_range, magmin, catalog):
        if catalog == "IRIS":
            return []
        return [dict(time=time_range[0] + 50.0, lat=1.0, lon=2.0, depth=9e3, magnitude=6.1),
                dict(time=time_range[0] + 70.0, lat=1.5, lon=2.5, depth=5e3, magnitude=5.1)]

    args = (["2009_laquila", "2020-01-01 00:00:00"],)
    assert (pdown.get_events_by_name_or_date(*args, events_fn=events_fn)
            == jdown.get_events_by_name_or_date(*args, events_fn=events_fn))
    obspy_env.CATALOG.append(dict(time=EVENT_TIME, lat=42.3, lon=13.4, depth=9e3,
                                  magnitude=6.3))
    assert (pdown.get_events((EVENT_TIME - 10, EVENT_TIME + 10))
            == jdown.get_events((EVENT_TIME - 10, EVENT_TIME + 10)))


def test_beatdown_cli_download_and_prepare(obspy_env, tmp_path):
    obspy_env.DOWNLOAD_STATIONS.append(dict(station="AAA", lon=0.4, lat=0.2, gain=1.0))
    assert pdown.main(["download", str(tmp_path), "--time", "2020-09-13T12:00:00",
                       "--lat", "42.3", "--lon", "13.4"]) == 0
    t0 = obspy_env.UTCDateTime("2020-09-13T12:00:00").timestamp
    assert pdown.main(["prepare", str(tmp_path), "--inventory",
                       os.path.join(str(tmp_path), "raw", "stations", "inventory.json"),
                       "--event-time", str(t0)]) == 0


def test_obspy_paths_gated_without_obspy(tmp_path):
    if "obspy" in sys.modules:
        pytest.skip("an obspy module is loaded")
    with pytest.raises(ImportError, match="native"):
        pin.load_obspy_traces(str(tmp_path))
    with pytest.raises(ImportError, match="obspy"):
        pdown.download_waveforms({"time": 0.0, "lat": 0.0, "lon": 0.0}, str(tmp_path))
    assert pdown.main(["prepare", str(tmp_path), "--event-time", "0"]) == 1
    shutil.rmtree(tmp_path, ignore_errors=True)
