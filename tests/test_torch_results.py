"""
The port's results layer against the JAX package's: the stage readers
and the posterior summary (``beat_tpu_torch.backend``) on stage files
written once by each package; the moment-tensor utilities
(``beat_tpu_torch.mt_utils``);
``Problem.derived_samples``, ``summarize``, ``get_synthetics`` and
``get_variance_reductions`` of projects loaded by both packages;
``seis_derivative`` by forward mode (through K1c's forward-mode rule)
against ``jax.jacfwd`` and by the finite-difference stencils; the rule
itself on the plain version; the composites' default diagnostics.  The
reference cases of ``tests/test_backend.py`` and
``tests/test_mt_utils.py`` are mirrored against the port.
"""

import math

import jax
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import beat_tpu.backend as jbackend
import beat_tpu.config as jcfg
import beat_tpu.mt_utils as jmt
import beat_tpu.utility as jutility
import beat_tpu_torch.backend as pbackend
import beat_tpu_torch.mt_utils as pmt
import beat_tpu_torch.utility as putility
from beat_tpu.sources import sdr_to_m6 as jax_sdr_to_m6
from beat_tpu_torch.models.problem import load_model
from beat_tpu_torch.ops import bilgather
from test_torch_common import counters, launches, spy
from test_torch_config import jax_projects, seismic_project  # noqa: F401  (fixture)

#: the stage readers and summaries are the same numpy code: equal to 1e-12
RESULTS_RTOL = 1e-12
#: derived samples: float32 moment tensors of either package's forward
DERIVED_TOL = 1e-5
#: seis_derivative against jax.jacfwd, of max|J|
JACOBIAN_RTOL = 1e-4

# ---------------------------------------------------------------------------
# stage files and summaries
# ---------------------------------------------------------------------------

NAMES = [("x", (3,)), ("depth", ())]


def _write_stages(package, homepath, seed=0) -> np.ndarray:
    ordering = (putility if package is pbackend else jutility).Ordering(NAMES)
    handler = package.SampleStage(homepath, ordering=ordering)
    rng = np.random.default_rng(seed)
    qs = []
    for stage in (0, 1, -1):
        q = rng.normal(size=(9, 6, 4)).astype(np.float32)
        q[..., 3] += 5.0 * rng.uniform()
        handler.save_stage(stage, {"q": q, "llk": rng.normal(size=(9, 6)).astype(np.float32)},
                           {"beta": 0.5})
        qs.append(q)
    return np.stack(qs)


def _results(package, utility, homepath) -> dict:
    """Everything the results functions of ``package`` read from the
    stages at ``homepath``."""
    handler = package.SampleStage(homepath, ordering=utility.Ordering(NAMES))
    trace = handler.load_trace(-1)
    out = {"x": trace.get_values("x"), "x_split": trace.get_values("x", combine=False),
           "x_burn": trace.get_values("x", burn=2, thin=3), "depth": trace.get_values("depth"),
           "end": trace.end_points(), "n": (trace.n_chains, trace.n_records)}
    block = trace.q_trace[:, :, 3]
    out["hdi"] = package.hdi(block, 0.9)
    out["ess"] = package.effective_sample_size(block)
    out["rhat"] = [package.rhat(block), package.rhat(block[:, :1]), package.rhat(block[:3])]
    out["summary"] = package.summarize_trace(trace)
    out["bounds"] = [package.extract_bounds_from_summary(out["summary"], "x", shape=(3,)),
                     package.extract_bounds_from_summary(out["summary"], "depth", roundto=1)]
    return out


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        np.testing.assert_allclose(got, want, rtol=RESULTS_RTOL, atol=0, err_msg=path)


@pytest.mark.parametrize("writer", [pbackend, jbackend], ids=["port_writes", "jax_writes"])
def test_results_functions_equal_on_the_same_stage_files(tmp_path, writer):
    qs = _write_stages(writer, str(tmp_path))
    got = _results(pbackend, putility, str(tmp_path))
    want = _results(jbackend, jutility, str(tmp_path))
    _assert_same(got, want)
    np.testing.assert_array_equal(got["end"][0], qs[2][-1])
    assert math.isnan(got["rhat"][2])


def _handler(tmp_path):
    ordering = putility.Ordering([("x", (2,)), ("y", ())])
    return pbackend.SampleStage(str(tmp_path), ordering=ordering), ordering


def test_backend_save_load_round_trip(tmp_path):
    handler, _ = _handler(tmp_path)
    q = np.random.default_rng(0).normal(size=(5, 10, 3)).astype(np.float32)
    llk = np.random.default_rng(1).normal(size=(5, 10)).astype(np.float32)
    handler.save_stage(0, {"q": q, "llk": llk}, {"beta": 0.25, "cov": np.eye(3),
                                                 "population": q[-1]})
    np.testing.assert_allclose(handler.load_trace(0).q_trace, q)
    state = handler.load_state(0)
    assert state["beta"] == 0.25
    np.testing.assert_allclose(state["cov"], np.eye(3))


def test_backend_get_values_and_endpoints(tmp_path):
    handler, _ = _handler(tmp_path)
    q = np.arange(5 * 10 * 3, dtype=np.float32).reshape(5, 10, 3)
    handler.save_stage(1, {"q": q, "llk": np.zeros((5, 10), dtype=np.float32)}, {"beta": 0.5})
    trace = handler.load_trace(1)
    assert trace.get_values("x", combine=False).shape == (5, 10, 2)
    assert trace.get_values("y", combine=True).shape == (50,)
    np.testing.assert_allclose(trace.end_points()[0], q[-1])
    with pytest.raises(KeyError):
        trace.get_values("z")


def test_backend_corruption_detection(tmp_path):
    handler, _ = _handler(tmp_path)
    q = np.zeros((2, 4, 3), dtype=np.float32)
    handler.save_stage(0, {"q": q, "llk": np.zeros((2, 4))}, {"beta": 0.1})
    handler.save_stage(1, {"q": q, "llk": np.zeros((2, 4))}, {"beta": 0.2})
    assert handler.highest_sampled_stage() == 1
    with open(handler._trace_file(1), "wb") as f:
        f.write(b"garbage")
    assert not handler.check_stage(1)
    assert handler.highest_sampled_stage() == 0


def test_backend_final_stage_priority_and_clean_directory(tmp_path):
    handler, _ = _handler(tmp_path)
    q = np.zeros((2, 4, 3), dtype=np.float32)
    handler.save_stage(0, {"q": q, "llk": np.zeros((2, 4))}, {"beta": 0.1})
    handler.save_stage(-1, {"q": q, "llk": np.zeros((2, 4))}, {"beta": 1.0})
    assert handler.highest_sampled_stage() == -1
    handler.rm_all()
    assert handler.highest_sampled_stage() == -2


def test_summary_hdi_of_normal():
    lo, hi = pbackend.hdi(np.random.default_rng(0).normal(size=20000), prob=0.94)
    assert -2.1 < lo < -1.7 and 1.7 < hi < 2.1


def test_summary_ess_iid():
    assert pbackend.effective_sample_size(np.random.default_rng(0).normal(size=(500, 4))) > 800


def test_summary_rhat_converged():
    assert abs(pbackend.rhat(np.random.default_rng(0).normal(size=(500, 4))) - 1.0) < 0.05


def test_summarize_and_extract_bounds():
    rng = np.random.default_rng(0)
    ordering = putility.Ordering([("x", (2,)), ("y", ())])
    q = rng.normal(size=(100, 8, 3)).astype(np.float32)
    q[..., 2] += 5.0
    summary = pbackend.summarize_trace(pbackend.StageTrace(
        q, np.zeros((100, 8), dtype=np.float32), ordering=ordering))
    assert abs(summary["y"]["mean"] - 5.0) < 0.1
    lo, hi = pbackend.extract_bounds_from_summary(summary, "x", shape=(2,))
    assert lo.shape == (2,) and np.all(lo < hi)
    with pytest.raises(ValueError):
        pbackend.summarize_trace(pbackend.StageTrace(q, q[..., 0]))


# ---------------------------------------------------------------------------
# moment-tensor utilities
# ---------------------------------------------------------------------------


def _m6s():
    rng = np.random.default_rng(5)
    cases = [np.asarray(jax_sdr_to_m6(*rng.uniform([0, 10, -180], [360, 90, 180]), 1e17))
             for _ in range(8)]
    return cases + [rng.normal(size=6) for _ in range(8)] + [
        np.array([1.0, 1.0, 1.0, 0, 0, 0]), np.array([2.0, -1.0, -1.0, 0, 0, 0]),
        np.zeros(6)]


@pytest.mark.parametrize("fn", ["m6_to_matrix", "scalar_moment", "decompose",
                                "both_strike_dip_rake", "hudson_coords", "lune_coords",
                                "kagan_angle", "radiation_amplitude"])
def test_mt_utils_equal_to_the_jax_package(fn):
    rng = np.random.default_rng(6)
    gammas = rng.normal(size=(7, 3))
    gammas /= np.linalg.norm(gammas, axis=1, keepdims=True)
    m6s = _m6s()
    for m6, other in zip(m6s, m6s[::-1]):
        if fn in ("both_strike_dip_rake", "kagan_angle") and not np.any(m6):
            continue
        args = {"kagan_angle": (m6, other), "radiation_amplitude": (m6, gammas)}.get(fn, (m6,))
        _assert_same(getattr(pmt, fn)(*args), getattr(jmt, fn)(*args))


def _sdr_m6(s, d, r, moment=1.0):
    from beat_tpu_torch.sources import sdr_to_m6

    return sdr_to_m6(s, d, r, moment).double().numpy()


@pytest.mark.parametrize("sdr", [(30.0, 60.0, 90.0), (120.0, 45.0, 0.0), (200.0, 80.0, -45.0),
                                 (0.0, 90.0, 0.0), (75.0, 30.0, 135.0)])
def test_mt_nodal_planes_reproduce_the_tensor(sdr):
    m6 = _sdr_m6(*sdr)
    for s, d, r in pmt.both_strike_dip_rake(m6):
        np.testing.assert_allclose(_sdr_m6(s, d, r), m6, atol=1e-6)


def test_mt_decomposition_cases():
    d = pmt.decompose(_sdr_m6(30, 60, 90))
    assert d["dc"] > 99.0 and abs(d["iso"]) < 1e-6
    assert abs(pmt.decompose(np.array([1.0, 1.0, 1.0, 0, 0, 0]))["iso"]) > 99.0
    np.testing.assert_allclose(pmt.scalar_moment(_sdr_m6(10, 50, 20, 3.5e17)), 3.5e17,
                               rtol=1e-6)


def test_mt_source_type_coordinates():
    u, v = pmt.hudson_coords(_sdr_m6(30, 60, 90))
    assert abs(u) < 1e-6 and abs(v) < 1e-6
    u, v = pmt.hudson_coords(np.array([1.0, 1.0, 1.0, 0, 0, 0]))
    assert abs(u) < 1e-6 and v == pytest.approx(1.0)
    g, d = pmt.lune_coords(_sdr_m6(30, 60, 90))
    assert abs(g) < 1e-5 and abs(d) < 1e-5
    assert pmt.lune_coords(np.array([1.0, 1.0, 1.0, 0, 0, 0]))[1] == pytest.approx(90.0)


def test_mt_kagan_angle_cases():
    a = _sdr_m6(0.0, 90.0, 0.0)
    assert pmt.kagan_angle(a, a) < 1e-4
    np.testing.assert_allclose(pmt.kagan_angle(a, _sdr_m6(30.0, 90.0, 0.0)), 30.0, atol=1e-3)
    assert pmt.kagan_angle(a, _sdr_m6(90.0, 90.0, 180.0)) < 1e-3
    np.testing.assert_allclose(pmt.kagan_angle(_sdr_m6(45.0, 90.0, 0.0),
                                               _sdr_m6(45.0, 60.0, 0.0)), 30.0, atol=1e-3)
    np.testing.assert_allclose(pmt.kagan_angle(a, -a), 90.0, atol=1e-3)
    rng = np.random.default_rng(3)
    for _ in range(10):
        x = _sdr_m6(*rng.uniform([0, 10, -180], [360, 90, 180]))
        y = _sdr_m6(*rng.uniform([0, 10, -180], [360, 90, 180]))
        np.testing.assert_allclose(pmt.kagan_angle(x, y), pmt.kagan_angle(y, x), atol=1e-6)
        assert 0.0 <= pmt.kagan_angle(x, y) <= 120.0 + 1e-9


@pytest.fixture(scope="module")
def mt_project(tmp_path_factory):
    pdir = str(tmp_path_factory.mktemp("mt"))
    seismic_project(pdir, source="MTSource")
    return pdir


@pytest.fixture(scope="module")
def loaded(jax_projects, mt_project):
    """(JAX problem, port problem) of each case, built once."""
    made = {}

    def get(case):
        if case not in made:
            pdir, mode = {"mt_seismic": (mt_project, "geometry"),
                          "rectangular_geodetic": (jax_projects("geometry_geodetic"),
                                                   "geometry"),
                          "static_ffi": (jax_projects("static_ffi"), "ffi"),
                          "dc_seismic": (jax_projects("geometry_seismic"), "geometry")}[case]
            made[case] = (jcfg.problem_from_config(jcfg.load_config(pdir, mode), pdir),
                          load_model(pdir, mode, device="cpu"))
        return made[case]

    return get


def _write_final_stage(package, utility, problem, seed):
    lo, hi = problem.priors.bounds_arrays()
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (5, 8, lo.size)).astype(np.float32)
    handler = package.SampleStage(problem.outfolder,
                                  ordering=utility.Ordering(
                                      [(v.name, v.shape) for v in problem.ordering.vmap]))
    handler.save_stage(-1, {"q": q, "llk": rng.normal(size=(5, 8)).astype(np.float32)},
                       {"beta": 1.0})


@pytest.mark.parametrize("case", ["mt_seismic", "rectangular_geodetic", "static_ffi"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_derived_samples_equal_to_the_jax_package(loaded, case, writer):
    jp, pp = loaded(case)
    package, utility = (pbackend, putility) if writer == "port" else (jbackend, jutility)
    _write_final_stage(package, utility, pp, seed=len(case))
    got, want = pp.derived_samples(-1, max_samples=24), jp.derived_samples(-1, max_samples=24)
    assert got.keys() == want.keys() and got
    for name in want:
        assert got[name].shape == want[name].shape == (24,)
        delta = got[name] - want[name]
        if name[:3] in ("str", "dip", "rak"):          # angles: modulo 360°
            delta = ((delta + 180.0) % 360.0 - 180.0) / 360.0
        assert np.abs(delta).max() <= DERIVED_TOL * max(1.0, float(np.abs(want[name]).max())
                                                        if name[:3] not in ("str", "dip", "rak")
                                                        else 1.0), name
    if case == "mt_seismic":
        assert {"strike1", "rake2", "mnn_derived"} <= got.keys()


@pytest.mark.parametrize("case", ["rectangular_geodetic", "static_ffi", "dc_seismic"])
def test_problem_results_equal_to_the_jax_package(loaded, case):
    jp, pp = loaded(case)
    point = jp.priors.test_point()
    got_vr, want_vr = pp.get_variance_reductions(point), jp.get_variance_reductions(point)
    assert got_vr.keys() == want_vr.keys()
    for comp in want_vr:
        assert got_vr[comp].keys() == want_vr[comp].keys()
        for k, v in want_vr[comp].items():
            np.testing.assert_allclose(got_vr[comp][k], float(v), rtol=1e-4, atol=1e-5)
    got_s, want_s = pp.get_synthetics(point), jp.get_synthetics(point)
    for comp in want_s:
        for k, v in want_s[comp].items():
            v = np.asarray(v)
            np.testing.assert_allclose(got_s[comp][k], v, rtol=0, atol=1e-4 * np.abs(v).max())
    if case == "static_ffi":                          # the Laplacian prior holds no data
        lap = pp.composites["laplacian"]
        assert lap.get_synthetics(point) == lap.get_variance_reductions(point) == {}
        assert lap.get_standardized_residuals(point) == {}
        assert lap.update_weights(point) is None
    _write_final_stage(pbackend, putility, pp, seed=9)
    _assert_same(pp.summarize(-1), jp.summarize(-1))


# ---------------------------------------------------------------------------
# seis_derivative and K1c's forward-mode rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parameter", ["depth", "strike", "magnitude", "time", "east_shift"])
def test_seis_derivative_matches_jax_jacfwd(loaded, parameter, monkeypatch):
    jp, pp = loaded("dc_seismic")
    point = dict(jp.priors.test_point(), depth=8.3e3, strike=37.0, dip=52.0, rake=15.0)
    jcomp, pcomp = jp.composites["seismic"], pp.composites["seismic"]
    want = np.asarray(jcomp.seis_derivative(point, parameter))
    k1c = spy(monkeypatch, bilgather, "_k1c")
    got = pcomp.seis_derivative(point, parameter)
    # the forward, and its rule on the tangent — but the onset time moves
    # only the phasors, so no tangent reaches K1c's coefficients
    assert k1c == ["cpu"] * (1 if parameter == "time" else 2)
    assert got.shape == want.shape == pcomp.get_synthetics(point)[
        pcomp.wavemaps[0].mapid].shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=JACOBIAN_RTOL * scale)


@pytest.mark.parametrize("order", [3, 5])
def test_seis_derivative_fd_mode_agrees(loaded, order):
    """The stencil of ``mode="fd"`` against the port's forward mode, and
    against the JAX package's own ``fd``: within 1e-2 of max|J| (float32
    forwards over a 1e-3 relative step)."""
    jp, pp = loaded("dc_seismic")
    point = dict(jp.priors.test_point(), depth=8.3e3, strike=37.0)
    pcomp = pp.composites["seismic"]
    auto = pcomp.seis_derivative(point, "strike")
    fd = pcomp.seis_derivative(point, "strike", mode="fd", stencil_order=order)
    jfd = np.asarray(jp.composites["seismic"].seis_derivative(point, "strike", mode="fd",
                                                              stencil_order=order))
    scale = np.abs(auto).max()
    np.testing.assert_allclose(fd, auto, rtol=0, atol=1e-2 * scale)
    np.testing.assert_allclose(fd, jfd, rtol=0, atol=1e-2 * scale)


def test_seis_derivative_refuses_what_the_jax_package_refuses(loaded):
    _, pp = loaded("dc_seismic")
    comp = pp.composites["seismic"]
    point = pp.priors.test_point()
    with pytest.raises(AttributeError, match="derivatives are available for"):
        comp.seis_derivative(point, "slip")
    with pytest.raises(ValueError, match="autodiff"):
        comp.seis_derivative(point, "depth", mode="complex-step")


def test_seis_derivative_of_a_vector_parameter_has_a_column_per_component():
    """Two events: ``depth`` is (2,); each column is the derivative with
    respect to one component (the other event's windows do not move)."""
    from beat_tpu_torch.flagship import TEST_SIZE, build_flagship

    problem = build_flagship(**TEST_SIZE, device="cpu", n_events=2)
    comp = problem.composites["seismic"]
    point = dict(problem.priors.test_point(), mnn=0.3, mee=-0.2, mdd=0.5, depth=np.array(
        [8e3, 9e3]))
    J = comp.seis_derivative(point, "depth", wmap_idx=2)       # a wavemap of event 1
    assert J.shape == comp.get_synthetics(point)[comp.wavemaps[2].mapid].shape + (2,)
    assert np.abs(J[..., 0]).max() == 0.0 and np.abs(J[..., 1]).max() > 0.0
    one = comp.seis_derivative(dict(point, depth=9e3), "depth", wmap_idx=2)
    np.testing.assert_allclose(J[..., 1], one, rtol=1e-6, atol=1e-6 * np.abs(one).max())


def _queries(shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    tbl = torch.randn((6, 5, 12 * 4), generator=gen, dtype=torch.float64)
    cd = torch.randint(-1, 7, shape, generator=gen)         # clamped on both sides
    z0 = torch.randint(0, 5, shape, generator=gen)
    return tbl, cd, z0, gen


@pytest.mark.parametrize("shape", [(7,), (3, 4), (2, 3, 5)])
def test_forward_mode_rule_is_the_kernel_on_the_tangent(shape):
    tbl, cd, z0, gen = _queries(shape)
    A = torch.randn(shape + (4, 6), generator=gen, dtype=torch.float64)
    tA = torch.randn(shape + (4, 6), generator=gen, dtype=torch.float64)
    G = torch.randn(shape + (8,), generator=gen, dtype=torch.float64)
    tG = torch.randn(shape + (8,), generator=gen, dtype=torch.float64)
    with counters() as counts, fwAD.dual_level():
        out = fwAD.unpack_dual(bilgather.bilinear_contract(tbl, cd, z0, fwAD.make_dual(A, tA)))
        back = fwAD.unpack_dual(bilgather.contract_corner_dot(tbl, cd, z0,
                                                              fwAD.make_dual(G, tG)))
    cdc, z0c = cd.clamp(0, 4), z0.clamp(0, 3)
    torch.testing.assert_close(out.primal, bilgather.bilinear_contract_reference(tbl, cdc, z0c, A))
    torch.testing.assert_close(out.tangent,
                               bilgather.bilinear_contract_reference(tbl, cdc, z0c, tA))
    torch.testing.assert_close(back.tangent,
                               bilgather.contract_corner_dot_reference(tbl, cdc, z0c, tG))
    assert launches(counts) == {}                        # the CPU takes the plain versions


def test_forward_mode_rule_passes_gradcheck_and_refuses_a_table_tangent():
    tbl, cd, z0, gen = _queries((3, 4), seed=1)
    A = torch.randn((3, 4, 4, 6), generator=gen, dtype=torch.float64, requires_grad=True)
    G = torch.randn((3, 4, 8), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: bilgather.bilinear_contract(tbl, cd, z0, a) ** 2,
                                    (A,), check_forward_ad=True)
    assert torch.autograd.gradcheck(
        lambda g: bilgather.contract_corner_dot(tbl, cd, z0, g) ** 2, (G,),
        check_forward_ad=True)
    with fwAD.dual_level(), pytest.raises(RuntimeError, match="GF table"):
        bilgather.bilinear_contract(fwAD.make_dual(tbl, torch.ones_like(tbl)), cd, z0,
                                    A.detach())
