"""
The port's static finite-fault inversion against the JAX package's: the
static GF library (``geo_construct_gf_linear``, ``GeodeticGFLibrary`` and
its ``.npz`` files both ways), the distributer + Laplacian llk per chain,
``lsq_solution`` against the JAX NNLS, the lsq start population, the
``fault.py`` leftovers (``point2sources``, ``euler_pole2slips``,
``backslip2coupling``, ``write_fault_to_pscmp``), the resolution-based
discretization, and a small static FFI SMC to β = 1.

The JAX side runs in float64 where its float32 Okada would set the bar
(``tests/test_torch_okada.py``); the port builds its library in float64
and stores it in float32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_tpu.covariance import Covariance as JCovariance
from beat_tpu.ffi import discretization as jdisc
from beat_tpu.ffi import fault as jfault
from beat_tpu.ffi.gflibrary import GeodeticGFLibrary as JLibrary
from beat_tpu.ffi.gflibrary import geo_construct_gf_linear as jax_construct
from beat_tpu.heart.geodesy import GeodeticDataset as JDataset
from beat_tpu.models.distributer import GeodeticDistributerComposite as JComposite
from beat_tpu.models.laplacian import LaplacianDistributerComposite as JLaplacian
from beat_tpu.models.problem import Problem as JProblem
from beat_tpu.parameter import Parameter as JParameter
from beat_tpu.parameter import PriorSet as JPriorSet
from beat_tpu.sources import RectangularSource as JRectangle
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.ffi import discretization
from beat_tpu_torch.ffi.fault import write_fault_to_pscmp
from beat_tpu_torch.ffi.gflibrary import GeodeticGFLibrary, geo_construct_gf_linear
from beat_tpu_torch.heart.geodesy import los_vectors
from beat_tpu_torch.samplers import SMCParams
from beat_tpu_torch.sources import RectangularSource
from beat_tpu_torch.utility import find_elbow
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_okada import jax_x64

LLK_RTOL = 2e-5
COMPONENTS = ("uparr", "uperp", "utens")


def jax_fault(port_fault, components=("uparr", "uperp")):
    """The JAX twin of a port fault of regular subfaults."""
    planes = [JRectangle(**{k: v for k, v in sf.plane.to_dict().items() if k != "type"})
              for sf in port_fault.subfaults]
    sf0 = port_fault.subfaults[0]
    return jfault.discretize_sources(planes, sf0.patch_length, sf0.patch_width,
                                     components=components)


@pytest.fixture(scope="module")
def static():
    """The port's static FFI problem at test size and its JAX twin, the
    port rebuilt from the JAX arrays through the converters."""
    port = flagship.build_static_ffi_flagship(**flagship.STATIC_FFI_TEST_SIZE, seed=2,
                                              device="cpu")
    comp = port.composites["geodetic"]
    jdatasets = [JDataset(name=ds.name, typ=ds.typ, coords=ds.coords, displacement=ds.displacement,
                          los_vector=ds.los_vector, odw=ds.odw,
                          covariance=JCovariance(data=ds.covariance.data))
                 for ds in comp.datasets]
    jlib = JLibrary(gfs={c: jnp.asarray(comp.gflibrary.gf(c).numpy()) for c in
                         ("uparr", "uperp")}, component_names=["uparr", "uperp"])
    jf = jax_fault(comp.fault)
    jcomp = JComposite(jdatasets, jlib, jf)
    jlap = JLaplacian(jf, slip_varnames=("uparr", "uperp"))
    jpriors = JPriorSet()
    for p in port.source_priors.parameters.values():
        jpriors.add(JParameter(p.name, p.lower, p.upper))
    jprob = JProblem(jpriors, {"geodetic": jcomp, "laplacian": jlap}, initialization="lsq")
    lib = convert.geodetic_gflibrary_from_numpy(
        {c: np.asarray(g) for c, g in jlib.gfs.items()}, jlib.component_names, device="cpu")
    datasets = [convert.geodetic_dataset_from_numpy(ds.name, ds.typ, ds.coords, ds.displacement,
                                                    ds.los_vector, ds.odw, ds.covariance)
                for ds in jdatasets]
    from beat_tpu_torch.models.distributer import GeodeticDistributerComposite
    from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite
    from beat_tpu_torch.models.problem import Problem

    pcomp = GeodeticDistributerComposite(datasets, lib, comp.fault, device="cpu")
    plap = LaplacianDistributerComposite(comp.fault, slip_varnames=("uparr", "uperp"),
                                         device="cpu")
    pprob = Problem(port.source_priors, {"geodetic": pcomp, "laplacian": plap}, device="cpu",
                    initialization="lsq")
    assert pprob.ordering.names == jprob.ordering.names
    return pprob, jprob


@pytest.fixture(scope="module")
def libraries():
    """The port's library and the JAX package's (float64) of one fault."""
    rng = np.random.default_rng(1)
    ref = RectangularSource(depth=1.5e3, strike=135.0, dip=50.0, rake=-90.0, length=8e3,
                            width=4e3)
    fault = flagship.discretize_sources([ref], 2e3, 2e3, components=COMPONENTS)
    coords = rng.uniform(-20e3, 20e3, (80, 2))
    los = los_vectors(80, 23.0, -13.0)
    got = geo_construct_gf_linear(fault, coords, los, components=COMPONENTS, device="cpu")
    with jax_x64():
        want = jax_construct(jax_fault(fault, COMPONENTS), coords, los, components=COMPONENTS)
        want = {c: np.asarray(g) for c, g in want.gfs.items()}
    return got, want


@pytest.mark.parametrize("component", COMPONENTS)
def test_library_matches_jax(component, libraries):
    """Every patch column of each component against the JAX build in
    float64, within 1e-5 · max|G| (the float32 storage)."""
    got, want = libraries
    assert got.gf(component).dtype == torch.float32
    np.testing.assert_allclose(got.gf(component).numpy(), want[component], rtol=0,
                               atol=1e-5 * np.abs(want[component]).max())


def test_library_files_read_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    gfs = {c: rng.normal(size=(6, 40)).astype(np.float32) for c in ("uparr", "uperp")}
    port = GeodeticGFLibrary(gfs, device="cpu")
    port.save(str(tmp_path / "port.npz"))
    back = JLibrary.load(str(tmp_path / "port.npz"))
    assert sorted(back.gfs) == ["uparr", "uperp"]
    np.testing.assert_array_equal(np.asarray(back.gfs["uperp"]), gfs["uperp"])
    JLibrary(gfs={c: jnp.asarray(g) for c, g in gfs.items()}).save(str(tmp_path / "jax.npz"))
    ported = GeodeticGFLibrary.load(str(tmp_path / "jax.npz"), device="cpu")
    assert (ported.npatches, ported.nsamples) == (6, 40)
    np.testing.assert_array_equal(ported.gf("uparr").numpy(), gfs["uparr"])
    slips = torch.as_tensor(rng.normal(size=(3, 6)), dtype=torch.float32)
    np.testing.assert_allclose(ported.stack_all(uparr=slips, uperp=2 * slips).numpy(),
                               slips.numpy() @ (gfs["uparr"] + 2 * gfs["uperp"]), rtol=1e-5,
                               atol=1e-5)


def _llk_scale(pprob, q):
    """Σ |log det| + n · |2h + log 2π| of the datasets and the Laplacian."""
    point = pprob.ordering.to_point(q)
    total = 0.0
    comp, lap = pprob.composites["geodetic"], pprob.composites["laplacian"]
    for ds in comp.datasets:
        total = total + abs(ds.covariance.log_pdet) + ds.samples * np.abs(
            2.0 * point["h_SAR"] + math.log(2 * math.pi))
    return total + 2 * (abs(lap.slog_det) + lap.npatches * np.abs(
        2.0 * point["h_laplacian"] + math.log(2 * math.pi)))


def test_llk_matches_jax(static):
    """The distributer + Laplacian llk of 64 chains per chain, the JAX
    side in float64 on its float32 device data."""
    pprob, jprob = static
    lo, hi = pprob.priors.bounds_arrays()
    q = np.random.default_rng(4).uniform(lo, hi, size=(64, lo.size))
    logp, data = pprob.make_logp_fn()
    with torch.no_grad():
        got = logp(torch.as_tensor(q, dtype=torch.float32), data).double().numpy()
    with jax_x64():
        jlogp, jdata = jprob.make_logp_fn()
        want = np.asarray(jax.jit(jax.vmap(jlogp, in_axes=(0, None)))(jnp.asarray(q), jdata))
    bar = LLK_RTOL * (np.abs(want) + _llk_scale(pprob, q))
    assert np.isfinite(got).all() and (np.abs(got - want) <= bar).all()


def test_lsq_solution_matches_jax_nnls(static):
    pprob, jprob = static
    got = pprob.composites["geodetic"].lsq_solution()
    want = jprob.composites["geodetic"].lsq_solution()
    for c in ("uparr", "uperp"):
        np.testing.assert_allclose(got[c], want[c], rtol=1e-6, atol=1e-9)
    ridge = pprob.composites["geodetic"].lsq_solution(ridge=0.5)
    np.testing.assert_allclose(ridge["uparr"],
                               jprob.composites["geodetic"].lsq_solution(ridge=0.5)["uparr"],
                               rtol=1e-6, atol=1e-9)


def test_lsq_start_bounds_and_centring(static):
    """``initialization='lsq'``: the start population lies in the bounds,
    is centred on the NNLS solution and jittered by 10 % of the prior
    range, as ``tests/test_ffi.py`` checks for the JAX package; the same
    seed gives the JAX package's population."""
    pprob, jprob = static
    lo, hi = pprob.priors.bounds_arrays()
    start = pprob._lsq_start(256, lo, hi, seed=1)
    assert start.shape == (256, lo.size)
    assert (start >= lo).all() and (start <= hi).all()
    sol = pprob.composites["geodetic"].lsq_solution()
    for c in ("uparr", "uperp"):
        sl = pprob.ordering[c].slc
        span = hi[sl] - lo[sl]
        # clipping at the bounds pulls the mean of patches with slip near
        # them inwards (the JAX test allows 0.2 m on a 3 m range)
        assert (np.abs(start[:, sl].mean(axis=0) - sol[c]) <= 0.07 * span).all()
        assert (start[:, sl].std(axis=0) <= 0.12 * span).all()
    np.testing.assert_allclose(start, jprob._lsq_start(256, lo, hi, seed=1), rtol=0,
                               atol=1e-6)


def test_smc_start_population_validated(static):
    from beat_tpu_torch.samplers.smc import smc_sample

    pprob, _ = static
    lo, hi = pprob.priors.bounds_arrays()
    logp, data = pprob.make_logp_fn()
    bad = np.tile(hi + 1.0, (8, 1))
    with pytest.raises(ValueError, match="outside prior bounds"):
        smc_sample(logp, lo, hi, SMCParams(n_chains=8, n_steps=2), device="cpu",
                   logp_args=(data,), start=bad)
    with pytest.raises(ValueError, match="start population"):
        smc_sample(logp, lo, hi, SMCParams(n_chains=8, n_steps=2), device="cpu",
                   logp_args=(data,), start=np.tile(lo, (4, 1)))


def _pscmp_fault():
    ref = RectangularSource(east_shift=2e3, north_shift=-1e3, depth=1e3, strike=30.0, dip=60.0,
                            rake=-80.0, length=6e3, width=4e3)
    return ref, flagship.discretize_sources([ref], 2e3, 2e3,
                                            components=("uparr", "uperp", "utens"))


def test_fault_leftovers_match_jax(tmp_path):
    ref, fault = _pscmp_fault()
    jf = jax_fault(fault, ("uparr", "uperp", "utens"))
    rng = np.random.default_rng(0)
    point = {"uparr": rng.uniform(0, 2, fault.npatches),
             "uperp": rng.uniform(-0.5, 0.5, fault.npatches),
             "utens": np.where(np.arange(fault.npatches) % 2, 0.3, 0.0)}
    for got, want in zip(fault.point2sources(point), jf.point2sources(point)):
        for k in ("east_shift", "north_shift", "depth", "strike", "dip", "rake", "length",
                  "width", "slip", "opening_fraction"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-12,
                                       atol=1e-12, err_msg=k)
    with jax_x64():
        want = np.asarray(jf.euler_pole2slips(50.0, 5.0, 0.3, event_lat=42.3, event_lon=13.4))
    got = fault.euler_pole2slips(50.0, 5.0, 0.3, event_lat=42.3, event_lon=13.4)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    inter = rng.uniform(-0.01, 0.05, fault.npatches)
    with jax_x64():
        want = np.asarray(jf.backslip2coupling(jnp.asarray(got), jnp.asarray(inter)))
    np.testing.assert_allclose(fault.backslip2coupling(torch.as_tensor(got), inter).numpy(),
                               want, rtol=1e-12)
    port_file, jax_file = str(tmp_path / "port.pscmp"), str(tmp_path / "jax.pscmp")
    write_fault_to_pscmp(port_file, fault, point, lat0=10.0, lon0=20.0)
    jfault.write_fault_to_pscmp(jax_file, jf, point, lat0=10.0, lon0=20.0)
    assert open(port_file).read() == open(jax_file).read()
    with pytest.raises(IOError):
        write_fault_to_pscmp(port_file, fault, point)
    write_fault_to_pscmp(port_file, fault, point, force=True)


@pytest.fixture(scope="module")
def scene():
    """``tests/test_discretization.py``'s scene."""
    g = 14
    e = np.linspace(-15e3, 15e3, g)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    los = np.tile([0.4, -0.1, 0.91], (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    kw = dict(depth=500.0, strike=0.0, dip=60.0, rake=90.0, length=16e3, width=12e3)
    return RectangularSource(**kw), JRectangle(**kw), coords, los


def test_model_resolution_matches_jax(scene):
    src, jsrc, coords, los = scene
    G = discretization._build_G(src.patches(4, 3), coords, los, device="cpu")
    with jax_x64():
        want_G = jdisc._build_G(jsrc.patches(4, 3), coords, los)
    np.testing.assert_allclose(G, want_G, rtol=0, atol=1e-10 * np.abs(want_G).max())
    centers = np.stack([p.center() for p in src.patches(4, 3)]) / 1e3
    for eps in (1e-4, 0.01, 10.0):
        R = discretization.model_resolution(G, centers, eps)
        np.testing.assert_allclose(R, jdisc.model_resolution(want_G, centers, eps), rtol=1e-8,
                                   atol=1e-10)
        assert discretization.normalized_resolution_spread(R) == pytest.approx(
            jdisc.normalized_resolution_spread(R))
    curve = np.column_stack([np.logspace(-2, 0, 6), [1.0, 0.5, 0.3, 0.25, 0.22, 0.21]])
    assert find_elbow(curve) == jdisc.find_elbow(curve)
    p = RectangularSource(depth=2e3, strike=37.0, dip=53.0, length=4e3, width=2e3)
    jp = JRectangle(depth=2e3, strike=37.0, dip=53.0, length=4e3, width=2e3)
    for got, want in zip(discretization._divide_patch(p), jdisc._divide_patch(jp)):
        np.testing.assert_allclose([got.east_shift, got.north_shift, got.depth, got.length],
                                   [want.east_shift, want.north_shift, want.depth, want.length])


def test_optimize_discretization_matches_jax(scene, monkeypatch):
    """Both packages' generations from the same coarse start: the same
    patches, the same diag(R); the port's irregular fault takes the
    smoothing operator, areas and moment.  The JAX side builds G with the
    port's ``_build_G`` (held against the JAX one above), so the test
    holds the division and ranking against each other and does not
    compile the JAX Okada once for every generation's patch count."""
    src, jsrc, coords, los = scene
    config = discretization.ResolutionDiscretizationConfig(
        epsilon=0.05, patch_lengths_min=3e3, patch_widths_min=3e3, patch_lengths_max=8e3,
        patch_widths_max=8e3)
    jconfig = jdisc.ResolutionDiscretizationConfig(**config.__dict__)
    fault, r_diag, quality = discretization.optimize_discretization(
        src, coords, los, config, max_generations=3, device="cpu")
    monkeypatch.setattr(jdisc, "_build_G", lambda patches, c, l, nu=0.25: discretization._build_G(
        patches, c, l, nu, device="cpu"))
    jf, jr, jq = jdisc.optimize_discretization(jsrc, coords, los, jconfig, max_generations=3)
    assert fault.npatches == jf.npatches > 4
    np.testing.assert_allclose(r_diag, jr, rtol=1e-7, atol=1e-9)
    assert quality == pytest.approx(jq)
    for p, q in zip(fault.get_all_patches(), jf.get_all_patches()):
        np.testing.assert_allclose([p.east_shift, p.north_shift, p.depth, p.length, p.width],
                                   [q.east_shift, q.north_shift, q.depth, q.length, q.width])
    np.testing.assert_allclose(fault.get_smoothing_operator("nearest_neighbor"),
                               jf.get_smoothing_operator("nearest_neighbor"), atol=1e-12)
    np.testing.assert_allclose(fault.patch_areas().sum(), src.length * src.width, rtol=1e-9)


def test_small_static_ffi_smc(tmp_path):
    """The static FFI problem at test size from the lsq start to β = 1:
    the posterior's moment within 0.1 of the slip behind the data, the
    best sample's variance reduction ≥ 0.9 per scene."""
    problem = flagship.build_static_ffi_flagship(**flagship.STATIC_FFI_TEST_SIZE, seed=0,
                                                 device="cpu",
                                                 outfolder=str(tmp_path / "static"))
    comp = problem.composites["geodetic"]
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=128, n_steps=20, seed=0))
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    assert float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()
    mean = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    best = problem.ordering.to_point(q_tr[-1][int(np.argmax(llk_tr[-1]))])

    def mw(p):
        return comp.fault.magnitude(np.hypot(p["uparr"], p["uperp"]))

    assert abs(mw(mean) - mw(problem.true_point)) < 0.1
    assert min(comp.get_variance_reductions(best).values()) >= 0.9
