"""
The port's layered table builders against the JAX package on the CPU, in
float64 on both sides: the Bessel functions, the static solver and its
table (``heart/layered_statics.py``, ``heart/statictable.py``), the
Kennett recursion and its precision escalation (``heart/reflectivity.py``,
``heart/layered_waveforms.py``), the tail's spline matrix, the waveform
table by each of its three methods, the trace store both ways
(``heart/store_convert.py``, with the analytic full-space oracle of
``heart/analytic.py`` as a source that shares no code with the
solvers), the tables' ``.npz`` files, and the FullMT likelihood on a
layered table built by each package (the slice as a whole).

Bars, as stated per test: spectra and static tables of float32 storage
1e-6 of their max; the Bessel functions 1e-12 of max|J|; the spline
matrix 1e-12 of max|y|; the escalated (clongdouble) bins 1e-12 of each
bin's max.  Where a quantity is a centred difference of solves (the
static moment-tensor responses, the Kennett kernels near |ω| = 0.06) the
JAX reference carries roundoff of its own above those bars (its
static global matrix mixes rows of 1 and of µ ≈ 3e10: condition ≈ 1.7e11,
and the P-SV basis degenerates as ω → 0): those tests add twice the
reference's own spread, measured by evaluating it again with vp scaled
by 1 + 3e-16, to the bar (1e-9 of max for the statics, 1e-10 of each
bin's max for the kernels).  The port's own spread is ≈ 1e-13 (its
stress rows are equilibrated).
"""

import sys

import numpy as np
import pytest
import scipy.special
import torch
from scipy.interpolate import CubicSpline

from beat_tpu.heart import layered_statics as jls
from beat_tpu.heart import layered_waveforms as jlw
from beat_tpu.heart import reflectivity as jrefl
from beat_tpu.heart import store_convert as jsc
from beat_tpu.heart import velocity_model as jvm
from beat_tpu.heart.gftable import GreensTable as JaxTable
from beat_tpu.heart.statictable import build_static_table as jax_build_static
from beat_tpu_torch import flagship
from beat_tpu_torch.heart import analytic, layered_statics, layered_waveforms, reflectivity
from beat_tpu_torch.heart import store_convert, velocity_model
from beat_tpu_torch.heart.gftable import GreensTable
from beat_tpu_torch.heart.statictable import build_static_table
from beat_tpu_torch.ops.bessel import bessel_j0, bessel_j1
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_geometry import _chains, _jax_llk, _jax_twin, _jax_wavemap, _port_llk

TABLE_RTOL = 1e-6          # float32 storage, of max
BESSEL_RTOL = 1e-12
STATIC_RTOL = 1e-9         # plus twice the reference's spread (module docstring)
KERNEL_RTOL = 1e-10        # of each bin's max, plus twice the reference's spread
ESCALATED_RTOL = 1e-12
SPLINE_RTOL = 1e-12
LLK_RTOL = 2e-5
SPREAD = 1 + 3e-16

TWO_LAYERS = dict(tops=[0.0, 3e3], vp=[5500.0, 6500.0], vs=[3200.0, 3700.0],
                  rho=[2600.0, 2800.0])
OBS = np.stack([np.zeros(4), np.linspace(2e3, 18e3, 4)], axis=-1)       # ≤ 20 km, due north
OBS_OFF_AXIS = np.array([[3e3, 4e3], [-5e3, 12e3], [9e3, -7e3]])
DEPTHS = (4e3, 7e3)
#: the waveform tables: nt 64, 3 distances, 2 depths, fmax cut
WAVE = dict(distances=np.array([30e3, 50e3, 70e3]), depths=np.array([6e3, 9e3]), nt=64,
            dt=1.0, fmax=0.4)


def _models(**scale):
    """(port, JAX) two-layer models; ``vp_scale`` perturbs the JAX one."""
    vp = np.asarray(TWO_LAYERS["vp"]) * scale.get("vp_scale", 1.0)
    p = velocity_model.LayeredModel(**TWO_LAYERS)
    j = jvm.LayeredModel(tops=TWO_LAYERS["tops"], vp=vp, vs=TWO_LAYERS["vs"],
                         rho=TWO_LAYERS["rho"])
    return p, j


def _spread_bar(fn, rtol):
    """``(reference, bar)``: the JAX function on the model, and rtol · its
    max plus twice its change under vp · (1 + 3e-16)."""
    want = fn(_models()[1])
    again = fn(_models(vp_scale=SPREAD)[1])
    return want, rtol * np.abs(want).max() + 2 * np.abs(want - again).max()


# -- Bessel functions ----------------------------------------------------------


@pytest.mark.parametrize("name", ["j0", "j1"])
def test_bessel_matches_scipy(name):
    x = np.concatenate([np.linspace(-40.0, 40.0, 40001), np.linspace(40.0, 2e4, 40001),
                        np.geomspace(1e-12, 1e-2, 200)])
    ours = {"j0": bessel_j0, "j1": bessel_j1}[name](torch.as_tensor(x)).numpy()
    want = getattr(scipy.special, name)(x)
    assert np.abs(ours - want).max() <= BESSEL_RTOL * np.abs(want).max()


# -- static solver and table ---------------------------------------------------------


@pytest.mark.parametrize("zs", DEPTHS)
def test_point_force_tensor_matches_jax(zs):
    p, j = _models()
    want = jls.point_force_surface_displacement(j, zs, OBS_OFF_AXIS)
    got = layered_statics.point_force_surface_displacement(p, zs, OBS_OFF_AXIS,
                                                           device="cpu").numpy()
    assert np.abs(got - want).max() <= STATIC_RTOL * np.abs(want).max()


@pytest.mark.parametrize("zs", DEPTHS)
def test_elementary_mt_statics_match_jax(zs):
    p, _ = _models()
    want, bar = _spread_bar(lambda m: jls.elementary_mt_surface_displacements(m, zs, OBS),
                            STATIC_RTOL)
    got = layered_statics.elementary_mt_surface_displacements(p, zs, OBS, device="cpu")
    assert np.abs(got.numpy() - want).max() <= bar


def test_mt_statics_off_axis_match_jax():
    p, _ = _models()
    m6 = np.array([1.0, -0.5, -0.5, 0.3, 0.2, -0.1]) * 1e15
    want, bar = _spread_bar(
        lambda m: jls.mt_surface_displacement_layered(m, 5e3, OBS_OFF_AXIS, m6), STATIC_RTOL)
    got = layered_statics.mt_surface_displacement_layered(p, 5e3, OBS_OFF_AXIS, m6,
                                                          device="cpu").numpy()
    assert np.abs(got - want).max() <= bar


def test_static_table_matches_jax():
    """The float32 table at 1e-6 of its max; the profile equal."""
    p, j = _models()
    distances = OBS[:, 1]
    got = build_static_table(p, distances, np.array(DEPTHS), device="cpu")
    want = jax_build_static(j, distances, np.array(DEPTHS))
    v = np.asarray(want.values)
    assert np.abs(got.values.numpy() - v).max() <= TABLE_RTOL * np.abs(v).max()
    np.testing.assert_array_equal(got.depths, want.depths)
    for attr in ("mu_tops", "mus", "lams"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


def test_static_batch_of_models_equals_one_by_one():
    """Models sharing interfaces solve as one batch, each as it would alone."""
    p, _ = _models()
    stiff = velocity_model.LayeredModel(tops=p.tops, vp=p.vp * 1.1, vs=p.vs * 1.05, rho=p.rho)
    both = layered_statics.elementary_mt_displacements([p, stiff], [5e3], OBS, device="cpu")
    for i, m in enumerate((p, stiff)):
        one = layered_statics.elementary_mt_surface_displacements(m, 5e3, OBS, device="cpu")
        assert torch.allclose(both[i, 0], one, rtol=0, atol=1e-12 * float(one.abs().max()))


# -- Kennett recursion ---------------------------------------------------------------


def _lattice(w):
    k = (np.arange(300) + 0.5) * 2e-5
    return (w * w)[:, None], k[None, :]


def test_reflectivity_kernels_match_jax():
    w = 2 * np.pi * np.array([0.01, 0.02, 0.05, 0.1, 0.3, 1.0]) - 0.02j
    w2, k2 = _lattice(w)
    got = reflectivity.ReflectivitySolver(_models()[0], w2, k2, device="cpu").force_kernels(6.5e3)

    def kernels(m):
        return jrefl.ReflectivitySolver(m, w2, k2).force_kernels(6.5e3)

    want, again = kernels(_models()[1]), kernels(_models(vp_scale=SPREAD)[1])
    for name, v in want.items():
        bar = (KERNEL_RTOL * np.abs(v).max(axis=1)
               + 2 * np.abs(v - again[name]).max(axis=1))
        assert (np.abs(got[name].numpy() - v).max(axis=1) <= bar).all(), name


def test_reflectivity_one_shot_kernels_and_source_gradient_match_jax():
    """The convenience entries: one complex frequency's kernels, and the
    static source-gradient tensor (the horizontal derivatives, whose
    receiver shifts share their kernels, at the static bar)."""
    k = (np.arange(300) + 0.5) * 2e-5
    w_c = 2 * np.pi * 0.3 - 0.02j
    want = jrefl.reflectivity_force_kernels(_models()[1], 6.5e3, w_c, k)
    got = reflectivity.reflectivity_force_kernels(_models()[0], 6.5e3, w_c, k, device="cpu")
    for name, v in want.items():
        assert np.abs(got[name].numpy() - v).max() <= KERNEL_RTOL * np.abs(v).max()
    want = jls.source_gradient_tensor(_models()[1], 5e3, OBS_OFF_AXIS)
    got = layered_statics.source_gradient_tensor(_models()[0], 5e3, OBS_OFF_AXIS,
                                                 device="cpu").numpy()
    scale = np.abs(want).max()
    assert np.abs(got[..., :2] - want[..., :2]).max() <= STATIC_RTOL * scale


def test_reflectivity_host_clongdouble_path_equals_jax():
    """The numpy path is the JAX package's code: equal in clongdouble."""
    w = 2 * np.pi * np.array([1e-3, 5e-3]) - 0.006j
    w2, k2 = _lattice(w)
    w2 = w2.astype(np.clongdouble)
    got = reflectivity.ReflectivitySolver(_models()[0], w2, k2, dtype=np.clongdouble,
                                          backend="numpy")
    want = jrefl.ReflectivitySolver(_models()[1], w2, k2, dtype=np.clongdouble)
    for name, v in want.force_kernels(6.5e3).items():
        g = got.force_kernels(6.5e3)[name]
        assert g.dtype == np.clongdouble
        assert np.abs(g - v).max() <= ESCALATED_RTOL * np.abs(v).max()


def test_reflectivity_solver_needs_a_device_or_the_numpy_backend():
    """The torch backend refuses a missing device (``device.resolve``); the
    host numpy path is chosen only by ``backend="numpy"``, which takes no
    device."""
    w2, k2 = _lattice(2 * np.pi * np.array([0.1]) - 0.02j)
    with pytest.raises(ValueError, match="explicit device"):
        reflectivity.ReflectivitySolver(_models()[0], w2, k2)
    with pytest.raises(ValueError, match="takes no device"):
        reflectivity.ReflectivitySolver(_models()[0], w2, k2, device="cpu", backend="numpy")
    with pytest.raises(ValueError, match="backend must be"):
        reflectivity.ReflectivitySolver(_models()[0], w2, k2, device="cpu", backend="cupy")


def test_band_safe_escalation_matches_jax(monkeypatch):
    """A lattice holding bins with |ω| < 0.06: the escalated bins to 1e-12
    of each bin's max, the others at the kernels' bar; the global-matrix
    fallback taken for the same bins."""
    model_p, model_j = _models()
    zeta = np.pi / 64.0
    w = 2 * np.pi * np.fft.rfftfreq(64, 1.0)[:8] - 1j * zeta
    k = (np.arange(200) + 0.5) * 3e-5
    fallbacks = []
    orig = jlw.dynamic_force_kernels

    def counting(model, zs, w_c, k_grid):
        fallbacks.append((zs, complex(w_c)))
        return orig(model, zs, w_c, k_grid)

    monkeypatch.setattr(jlw, "dynamic_force_kernels", counting)
    zs_set = [6e3, 6.006e3]
    want = jlw._kernels_band_safe(model_j, zs_set, w, k)
    stats = {}
    got = layered_waveforms._kernels_band_safe(model_p, zs_set, w, k, device="cpu",
                                               stats=stats)
    low = np.abs(w) < layered_waveforms.W_ESCALATE
    assert low.sum() == stats["host_bins"] > 0
    assert stats["fallback_bins"] == len(fallbacks)
    for zs in zs_set:
        for name, v in want[zs].items():
            err = np.abs(got[zs][name].numpy() - v).max(axis=1)
            scale = np.abs(v).max(axis=1)
            assert (err[low] <= ESCALATED_RTOL * scale[low]).all(), (zs, name)
            assert (err[~low] <= 1e-8 * scale[~low]).all(), (zs, name)


def test_spline_matrix_matches_scipy():
    rng = np.random.default_rng(0)
    x = np.log(np.geomspace(1e-3, 0.05, 40))
    xo = np.log(np.linspace(1.2e-3, 0.05, 700))
    y = rng.normal(size=(40, 5)) + 1j * rng.normal(size=(40, 5))
    S = layered_waveforms.spline_matrix(x, xo)
    want = CubicSpline(x, y, axis=0)(xo)
    assert np.abs(S @ y - want).max() <= SPLINE_RTOL * np.abs(y).max()


def test_host_grids_equal_jax():
    p, j = _models()
    args = (8e3, 70e3, 64.0, 2.5)
    kp = layered_waveforms.dynamic_integration_grid(p, *args)
    kj = jlw.dynamic_integration_grid(j, *args)
    np.testing.assert_array_equal(kp, kj)
    for a, b in zip(layered_waveforms._hybrid_solve_grid(p, kp, 2.5),
                    jlw._hybrid_solve_grid(j, kj, 2.5)):
        np.testing.assert_array_equal(a, b)
    depths = np.linspace(1e3, 29e3, 15)
    assert (layered_waveforms._depth_buckets(p, depths, 215e3, 512.0, 6.3, 1.2, 50.0)
            == jlw._depth_buckets(j, depths, 215e3, 512.0, 6.3, 1.2, 50.0))
    np.testing.assert_array_equal(
        layered_waveforms.nudge_depths_off_interfaces(p, [2.999e3, 5e3]),
        jlw.nudge_depths_off_interfaces(j, [2.999e3, 5e3]))


# -- the waveform table ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tables():
    _, j = _models()
    return {m: jlw.build_layered_waveform_table(j, method=m, **WAVE)
            for m in ("kennett", "band", "perfreq")}


@pytest.mark.parametrize("method", ["kennett", "band", "perfreq"])
def test_layered_waveform_table_matches_jax(method, jax_tables):
    p, _ = _models()
    got = layered_waveforms.build_layered_waveform_table(p, method=method, device="cpu", **WAVE)
    want = jax_tables[method]
    s = np.asarray(want.spectra)
    assert np.abs(got.spectra.numpy() - s).max() <= TABLE_RTOL * np.abs(s).max()
    np.testing.assert_allclose(got.tt_p, want.tt_p, rtol=1e-12)
    np.testing.assert_allclose(got.tt_s, want.tt_s, rtol=1e-12)
    assert (got.vp, got.vs, got.rho) == pytest.approx((want.vp, want.vs, want.rho), rel=1e-15)


def test_waveform_table_refuses_a_node_on_an_interface():
    with pytest.raises(ValueError, match="interface"):
        layered_waveforms.build_layered_waveform_table(
            _models()[0], [30e3], [2.999e3], nt=32, dt=1.0, device="cpu")


# -- trace stores and files ------------------------------------------------------------


def test_trace_to_spectrum_batched_matches_jax():
    rng = np.random.default_rng(1)
    traces = rng.normal(size=(5, 200))
    tmins = np.array([-3.3, 0.0, 2.25, 7.9, 40.1])
    for dt_in in (0.5, 0.25, 1.0):
        got = store_convert.trace_to_spectrum(torch.as_tensor(traces), torch.as_tensor(tmins),
                                              dt_in, 128, 0.5, t0=1.2).numpy()
        want = np.stack([jsc.trace_to_spectrum(tr, t, dt_in, 128, 0.5, t0=1.2)
                         for tr, t in zip(traces, tmins)])
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def _analytic_store():
    """Elementary traces of the full-space oracle at a 2 × 2 grid (dt 0.25)."""
    stf = analytic.smoothed_step(1.0)
    t = -2.0 + 0.25 * np.arange(240)
    distances, depths = np.array([20e3, 30e3]), np.array([8e3, 10e3])
    traces = np.zeros((6, 3, 2, 2, t.size))
    for i, d in enumerate(distances):
        for jz, z in enumerate(depths):
            for kk, m6 in enumerate(np.eye(6)):
                u = analytic.fullspace_mt_displacement(m6, [d, 0.0, 0.0], [0.0, 0.0, z], t,
                                                       6000.0, 3464.0, 2700.0, stf=stf)
                traces[kk, :, i, jz] = np.stack([-u[:, 2], u[:, 0], u[:, 1]])   # Z, R, T
    return traces, np.full((2, 2), t[0]), distances, depths


def test_trace_store_both_ways(tmp_path):
    traces, tmins, distances, depths = _analytic_store()
    jsc.write_trace_store(str(tmp_path / "jax.npz"), traces, tmins, distances, depths, 0.25)
    store_convert.write_trace_store(str(tmp_path / "port.npz"), torch.as_tensor(traces), tmins,
                                    distances, depths, 0.25)
    for path in ("jax.npz", "port.npz"):
        want = np.asarray(jsc.greens_table_from_traces(str(tmp_path / path), nt=128, dt=0.5,
                                                       t0=0.0).spectra)
        got = store_convert.greens_table_from_traces(str(tmp_path / path), nt=128, dt=0.5,
                                                     t0=0.0, device="cpu")
        assert np.abs(got.spectra.numpy() - want).max() <= TABLE_RTOL * np.abs(want).max()


def test_store_import_needs_pyrocko(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrocko", None)        # the import fails
    with pytest.raises(ImportError, match="pyrocko"):
        store_convert.greens_table_from_store("id", "/nonexistent", [1e3], [1e3], 32, 1.0,
                                              device="cpu")


def test_greens_table_files_read_by_either_package(tmp_path, jax_tables):
    want = jax_tables["kennett"]
    want.save(str(tmp_path / "jax.npz"))
    port = GreensTable.load(str(tmp_path / "jax.npz"), device="cpu")
    port.save(str(tmp_path / "port.npz"))
    back = JaxTable.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.spectra), np.asarray(want.spectra))
    np.testing.assert_array_equal(back.tt_p, want.tt_p)
    assert (back.dt, back.nt, back.t0, back.vp, back.vs, back.rho) == (
        want.dt, want.nt, want.t0, want.vp, want.vs, want.rho)


# -- the slice as a whole ---------------------------------------------------------------


def test_fullmt_llk_on_layered_tables_matches_jax(tmp_path):
    """The FullMT problem on a layered table built by the port and the
    same problem on the JAX package's table of that model and grid."""
    crust_p = velocity_model.LayeredModel.default_crust()
    size = dict(n_stations=3, n_distances=4, n_depths=2, nt=64)
    port = flagship.build_layered_flagship(**size, seed=3, device="cpu", model=crust_p,
                                           fmax=0.3, outfolder=str(tmp_path / "layered"))
    table = port.composites["seismic"].tables[0]
    jtable = jlw.build_layered_waveform_table(
        jvm.LayeredModel.default_crust(), table.distances, table.depths, nt=table.nt,
        dt=table.dt, fmax=0.3)
    tables = {id(table): jtable}
    jx = _jax_twin(port, [_jax_wavemap(pw, tables) for pw in port.composites["seismic"].wavemaps])
    q = _chains(port)
    np.testing.assert_allclose(_port_llk(port, q), _jax_llk(jx, q), rtol=LLK_RTOL)
