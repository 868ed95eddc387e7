"""
The port's geodetic geometry composite (``beat_tpu_torch.models.geodetic``)
against the JAX package's (``beat_tpu.models.geodetic``): both built from
the same arrays (the port's hermetic scenes, carried into the JAX package
and back through ``beat_tpu_torch.convert``), the llk of a 64-chain batch
for every source type on the analytic halfspace and through a JAX-built
static table, the corrections, ``hp_specific``, the hyper-only posterior,
``update_weights`` (non-Toeplitz, ensemble Poisson ratios and tables),
the diagnostics and a small SMC recovery.

The JAX side runs in float64 (``jax_enable_x64`` for the block; its device
data stay the float32 arrays it stores): its float32 moment-tensor
expansion is off float64 by a few parts in 1e3 of max|u|
(``tests/test_torch_okada.py``), the port's runs in float64.  The llk bar
is rtol 2e-5 of |llk| plus the scale of its residual-free terms (the
float32 log-determinants are rounded to 6e-8 of themselves, and at a large
noise hyperparameter those terms cancel the llk to a few units).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_tpu.covariance import Covariance as JCovariance
from beat_tpu.covariance import GeodeticNoiseAnalyser as JNoiseAnalyser
from beat_tpu.heart import corrections as jcorr
from beat_tpu.heart import okada as jokada
from beat_tpu.heart.geodesy import GeodeticDataset as JDataset
from beat_tpu.models.geodetic import GeodeticGeometryComposite as JComposite
from beat_tpu.models.problem import Problem as JProblem
from beat_tpu.parameter import Parameter as JParameter
from beat_tpu.parameter import PriorSet as JPriorSet
from beat_tpu import sources as jsources
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.covariance import GeodeticNoiseAnalyser
from beat_tpu_torch.heart import corrections
from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.samplers import SMCParams
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_okada import jax_x64

N_POINTS = 50              # per scene
N_CHAINS = 64
LLK_RTOL = 2e-5
SOURCES = ("RectangularSource", "ExplosionSource", "MTSource", "MTQTSource", "DCSource",
           "CLVDSource", "DoubleDCSource", "RingfaultSource")


def jax_dataset(ds):
    cov = ds.covariance
    return JDataset(name=ds.name, typ=ds.typ, coords=ds.coords.copy(),
                    displacement=ds.displacement.copy(), los_vector=ds.los_vector.copy(),
                    odw=ds.odw.copy(), lats=ds.lats, lons=ds.lons, stations=ds.stations,
                    covariance=JCovariance(data=cov.data.copy(), pred_g=cov.pred_g,
                                           pred_v=cov.pred_v))


def jax_correction(c):
    if isinstance(c, corrections.RampCorrection):
        return jcorr.RampCorrection(c.dataset_name)
    if isinstance(c, corrections.EulerPoleCorrection):
        return jcorr.EulerPoleCorrection(c.number, c.lats, c.lons, c.time_span,
                                         dataset_name=c.dataset_name, mask=c.mask)
    return jcorr.StrainRateCorrection(c.number, c.norths, c.easts, dataset_name=c.dataset_name,
                                      mask=c.mask)


def twins(source="RectangularSource", gnss=0, jtable=None, **options):
    """(port problem, JAX problem) of the same scenes: the port's hermetic
    problem at test size, its datasets carried into the JAX package, and
    the port composite rebuilt from the JAX datasets through the
    converters.  ``jtable``: a JAX static table, carried across."""
    port = flagship.build_geodetic_flagship(N_POINTS, seed=3, device="cpu", source=source,
                                            gnss_stations=gnss)
    comp = port.composites["geodetic"]
    jdatasets = [jax_dataset(ds) for ds in comp.datasets]
    template = comp.sources[0]
    jtemplate = getattr(jsources, type(template).__name__)(**{
        k: v for k, v in template.to_dict().items() if k != "type"})
    jcorrections = [jax_correction(c) for c in comp.corrections]
    jcomp = JComposite(jdatasets, [jtemplate], static_table=jtable, corrections=jcorrections,
                       **options)
    jpriors = JPriorSet()
    for p in port.source_priors.parameters.values():
        jpriors.add(JParameter(p.name, p.lower, p.upper))
    jprob = JProblem(jpriors, {"geodetic": jcomp})
    table = None if jtable is None else convert.static_table_from_numpy(
        np.asarray(jtable.values), jtable.distances, jtable.depths, jtable.mu_tops, jtable.mus,
        jtable.lams, jtable.name, device="cpu")
    datasets = [convert.geodetic_dataset_from_numpy(
        ds.name, ds.typ, ds.coords, ds.displacement, ds.los_vector, ds.odw, ds.covariance,
        lats=ds.lats, lons=ds.lons, stations=ds.stations) for ds in jdatasets]
    pcomp = GeodeticGeometryComposite(datasets, [template], static_table=table,
                                      corrections=comp.corrections, device="cpu", **options)
    pprob = Problem(port.source_priors, {"geodetic": pcomp}, device="cpu")
    pprob.true_point = port.true_point
    assert pprob.ordering.names == jprob.ordering.names
    return pprob, jprob


def batch(problem, n=N_CHAINS, seed=5):
    lo, hi = problem.priors.bounds_arrays()
    span = hi - lo
    return np.random.default_rng(seed).uniform(lo + 0.01 * span, hi - 0.01 * span,
                                               size=(n, lo.size))


def scale_of(problem, q):
    """Σ |log det C| + n · |2h + log 2π| over the datasets, per chain."""
    comp = problem.composites["geodetic"]
    point = problem.ordering.to_point(q)
    total = 0.0
    for i, ds in enumerate(comp.datasets):
        h = point.get(comp._hypername(i, ds), 0.0)
        total = total + abs(ds.covariance.log_pdet) + ds.samples * np.abs(
            2.0 * h + math.log(2 * math.pi))
    return total


def jax_llk(jprob, q):
    with jax_x64():
        logp, data = jprob.make_logp_fn()
        return np.asarray(jax.jit(jax.vmap(logp, in_axes=(0, None)))(jnp.asarray(q), data))


def jpoint(point: dict) -> dict:
    """A point for the JAX package in float64: numpy arrays, which JAX
    types strongly (a Python float is weakly typed and would leave the
    float32 device data in float32)."""
    return {k: jnp.asarray(np.asarray(v, dtype=np.float64)) for k, v in point.items()}


def port_llk(pprob, q):
    logp, data = pprob.make_logp_fn()
    with torch.no_grad():
        return logp(torch.as_tensor(q, dtype=torch.float32), data).double().numpy()


def assert_llk_close(pprob, q, got, want):
    assert np.isfinite(got).all()
    bar = LLK_RTOL * (np.abs(want) + scale_of(pprob, q))
    worst = int(np.argmax(np.abs(got - want) / bar))
    assert (np.abs(got - want) <= bar).all(), (worst, got[worst], want[worst], bar[worst])


@pytest.mark.parametrize("source", SOURCES)
def test_llk_matches_jax(source):
    pprob, jprob = twins(source)
    q = batch(pprob)
    assert_llk_close(pprob, q, port_llk(pprob, q), jax_llk(jprob, q))


@jax.jit
def _jax_unit_tensor_fields(obs, depths, nu, shear_modulus):
    """(6, nz, nd, 3 = E, N, up): the JAX moment-tensor expansion of the six
    unit tensors at every depth, observed due north."""
    def one(m6, z):
        return jokada.mt_surface_displacement(obs, m6, depth=z, nu=nu,
                                              shear_modulus=shear_modulus)

    return jax.vmap(jax.vmap(one, in_axes=(None, 0)), in_axes=(0, None))(jnp.eye(6), depths)


def jax_homogeneous_table(distances, depths, nu=0.25, shear_modulus=33e9):
    """The JAX package's ``build_homogeneous_static_table``, its loop of
    eager ``mt_surface_displacement`` calls (one per depth and unit
    tensor, seconds each) replaced by one jitted ``vmap`` of the same
    function, in float64: the same values to the float32 storage, laid
    out as the builder lays them."""
    from beat_tpu.heart.statictable import StaticGFTable as JTable

    with jax_x64():        # one compile for every table of a grid, whatever its ν
        obs = jnp.asarray(np.stack([np.zeros_like(distances), distances], axis=-1))
        u = _jax_unit_tensor_fields(obs, jnp.asarray(depths), jnp.float64(nu),
                                    jnp.float64(shear_modulus))
        vals = jnp.stack([u[..., 2], u[..., 1], u[..., 0]], axis=1).transpose(0, 1, 3, 2)
    lam = 2.0 * shear_modulus * nu / (1.0 - 2.0 * nu)
    return JTable(values=vals.astype(jnp.float32), distances=np.asarray(distances),
                  depths=np.asarray(depths), mu_tops=np.array([0.0]),
                  mus=np.array([shear_modulus]), lams=np.array([lam]), name="homogeneous")


@pytest.fixture(scope="module")
def jtable():
    """A JAX-built homogeneous static table over the test scenes."""
    return jax_homogeneous_table(np.linspace(0.0, 60e3, 61), np.linspace(0.5e3, 16e3, 32))


@pytest.mark.parametrize("source", SOURCES)
def test_table_llk_matches_jax(source, jtable):
    pprob, jprob = twins(source, jtable=jtable)
    q = batch(pprob)
    assert_llk_close(pprob, q, port_llk(pprob, q), jax_llk(jprob, q))


def test_static_table_builder_and_files(tmp_path, jtable):
    """The port's homogeneous table against the JAX builder's values (in
    float64, stored as float32); the ``.npz`` files read both ways; µ and
    λ per depth."""
    from beat_tpu.heart.statictable import StaticGFTable as JTable
    from beat_tpu_torch.heart.statictable import (StaticGFTable,
                                                  build_homogeneous_static_table)

    d, z = jtable.distances, jtable.depths
    want = np.asarray(jtable.values)
    got = build_homogeneous_static_table(d, z, device="cpu")
    np.testing.assert_allclose(got.values.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    got.save(str(tmp_path / "port.npz"))
    back = JTable.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.values), got.values.numpy())
    jtable.save(str(tmp_path / "jax.npz"))
    ported = StaticGFTable.load(str(tmp_path / "jax.npz"), device="cpu")
    np.testing.assert_array_equal(ported.values.numpy(), np.asarray(jtable.values))
    layered = StaticGFTable(got.values, d, z, mu_tops=[0.0, 4e3], mus=[20e9, 40e9],
                            lams=[25e9, 45e9], device="cpu")
    depth = torch.tensor([0.0, 3999.0, 4000.0, 9e3])
    np.testing.assert_allclose(layered.shear_modulus(depth).numpy(), [20e9, 20e9, 40e9, 40e9],
                               rtol=1e-7)
    np.testing.assert_allclose(layered.lame_lambda(depth).numpy(), [25e9, 25e9, 45e9, 45e9],
                               rtol=1e-7)


def test_static_table_gather_at_grid_nodes(jtable):
    """Queries on the top distance and depth nodes are exact (the cell is
    clamped to the last one), and per-chain depths gather per chain."""
    from beat_tpu_torch.heart.statictable import bilinear_cell

    table = convert.static_table_from_numpy(np.asarray(jtable.values), jtable.distances,
                                            jtable.depths, device="cpu")
    d0, z0, fd, fz = bilinear_cell(table.distances, table.depths,
                                   torch.tensor([[60e3, 0.0, 59e3]]), torch.tensor([16e3]))
    assert d0.tolist() == [[59, 0, 59]] and z0.tolist() == [30]
    np.testing.assert_allclose(fd.numpy(), [[1.0, 0.0, 0.0]])
    np.testing.assert_allclose(fz.numpy(), [1.0])
    m6 = torch.tensor([[1e17, -1e17, 0.0, 2e16, 0.0, 3e16]] * 2)
    obs = torch.tensor([5e3, 20e3]), torch.tensor([-3e3, 11e3])
    both = table.synthesize_enu(m6, torch.zeros(2), torch.zeros(2),
                                torch.tensor([3e3, 7.25e3]), *obs)
    with jax_x64():
        for i, depth in enumerate((3e3, 7.25e3)):
            want = np.asarray(jtable.synthesize_enu(jnp.asarray(m6[i].numpy()), 0.0, 0.0, depth,
                                                    jnp.asarray(obs[0].numpy()),
                                                    jnp.asarray(obs[1].numpy())))
            np.testing.assert_allclose(both[i].numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max())


def test_corrections_match_jax():
    """Ramps, Euler-pole and strain-rate displacements per chain against
    the JAX corrections (vmapped), and the station mask."""
    pprob, _ = twins(gnss=12)
    comp = pprob.composites["geodetic"]
    q = batch(pprob, n=8)
    point = pprob.ordering.to_point(torch.as_tensor(q))
    data = {k: v.double() if torch.is_tensor(v) else v for k, v in comp.device_data().items()}
    for c in comp.corrections:
        ds_i = next(i for i, ds in enumerate(comp.datasets) if ds.name == c.dataset_name)
        slc = comp.stack.slices[ds_i]
        arg = data["coords"][slc] if isinstance(c, corrections.RampCorrection) \
            else data["los"][slc]
        got = c.displacement(point, arg).numpy()
        jc = jax_correction(c)
        with jax_x64():
            want = np.stack([np.asarray(jc.displacement(
                {n: jnp.float64(point[n][i]) for n in c.parameter_names},
                jnp.asarray(arg.numpy()))) for i in range(8)])
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    stations = np.array(["A", "B", "C", "D"])
    for wl, bl in (((), ()), (("A", "C"), ()), ((), ("B",)), (("A", "B"), ("B",))):
        np.testing.assert_array_equal(corrections.station_mask(stations, wl, bl),
                                      jcorr.station_mask(stations, wl, bl))


def test_gnss_llk_and_hp_specific_match_jax():
    """InSAR and GNSS with ramps, an Euler pole and a strain rate, one
    noise hyperparameter per dataset."""
    pprob, jprob = twins(gnss=12, hp_specific=True)
    names = pprob.composites["geodetic"].get_hypernames()
    assert names == jprob.composites["geodetic"].get_hypernames() and len(names) == 5
    q = batch(pprob)
    assert_llk_close(pprob, q, port_llk(pprob, q), jax_llk(jprob, q))


def test_hyper_posterior_matches_direct_and_jax():
    """``make_hyper_logp_fn`` (the precomputed ``hyper_data``) against
    ``hyper_loglike`` at the same fixed point, and ``hyper_data`` against
    the JAX package's."""
    pprob, jprob = twins(gnss=12)
    comp, jcomp = pprob.composites["geodetic"], jprob.composites["geodetic"]
    fixed = pprob.priors.test_point()
    logp, data = pprob.make_hyper_logp_fn(fixed)
    q = torch.as_tensor(batch(pprob, n=8, seed=2), dtype=torch.float32)
    got = logp(q, data)
    direct = comp.hyper_loglike(pprob.ordering.to_point(q), fixed)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=1e-5)
    wrw, pds, ns, names = comp.hyper_data(fixed)
    with jax_x64():
        jw, jp, jn, jnames = jcomp.hyper_data(jpoint(fixed))
    assert names == jnames
    np.testing.assert_allclose(wrw.numpy(), np.asarray(jw), rtol=1e-4)
    np.testing.assert_allclose(pds.numpy(), np.asarray(jp), rtol=1e-6)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jn))


@pytest.mark.parametrize("ensemble", ["nus", "tables"])
def test_update_weights_matches_jax(ensemble, jtable):
    """Non-Toeplitz data covariances of the residuals and the ensemble's
    prediction covariance, against the JAX package's at the same point;
    the port's buffers take the new weights in place."""
    if ensemble == "nus":
        opts = dict(noise_structure="non-toeplitz", ensemble_nus=(0.22, 0.25, 0.28))
        pprob, jprob = twins(**opts)
    else:
        tables = [jax_homogeneous_table(np.linspace(0.0, 60e3, 61),
                                        np.linspace(0.5e3, 16e3, 32), nu=nu)
                  for nu in (0.22, 0.28)]
        pprob, jprob = twins(noise_structure="non-toeplitz", jtable=jtable)
        jprob.composites["geodetic"].ensemble_tables = tables
        pprob.composites["geodetic"].ensemble_tables = [convert.static_table_from_numpy(
            np.asarray(t.values), t.distances, t.depths, device="cpu") for t in tables]
    comp, jcomp = pprob.composites["geodetic"], jprob.composites["geodetic"]
    point = dict(pprob.true_point, depth=1.8e3, slip=0.55)
    point = {k: v for k, v in point.items() if k in pprob.ordering.names}
    logp, data = pprob.make_logp_fn()
    before = data[0]["weights"][0].clone()
    comp.update_weights(point)
    with jax_x64():
        jcomp.update_weights(jpoint(point))
    for ds, jds in zip(comp.datasets, jcomp.datasets):
        scale = np.abs(jds.covariance.data).max()
        np.testing.assert_allclose(ds.covariance.data, jds.covariance.data, rtol=1e-4,
                                   atol=1e-5 * scale)
        pv, jpv = ds.covariance.pred_v, jds.covariance.pred_v
        np.testing.assert_allclose(pv, jpv, rtol=1e-3, atol=1e-4 * np.abs(jpv).max())
    assert not torch.equal(before, data[0]["weights"][0])
    q = batch(pprob, n=8)
    assert np.isfinite(port_llk(pprob, q)).all()


def test_diagnostics_match_jax():
    pprob, jprob = twins(gnss=12)
    comp, jcomp = pprob.composites["geodetic"], jprob.composites["geodetic"]
    point = {k: v for k, v in dict(pprob.true_point, depth=1.7e3).items()
             if k in pprob.ordering.names}
    with jax_x64():
        want_syn = jcomp.get_synthetics(jpoint(point))
        want_res = jcomp.get_standardized_residuals(jpoint(point))
        want_vr = jcomp.get_variance_reductions(jpoint(point))
    got_syn = comp.get_synthetics(point)
    got_res = comp.get_standardized_residuals(point)
    got_vr = comp.get_variance_reductions(point)
    for name in want_syn:
        scale = np.abs(want_syn[name]).max()
        np.testing.assert_allclose(got_syn[name], want_syn[name], rtol=1e-5, atol=1e-6 * scale)
        np.testing.assert_allclose(got_res[name], want_res[name], rtol=1e-3,
                                   atol=1e-3 * np.abs(want_res[name]).max())
        np.testing.assert_allclose(got_vr[name], want_vr[name], rtol=1e-5, atol=1e-6)


def test_small_smc_recovery(tmp_path):
    """The sizes of ``tests/test_geodetic_inversion.py``: a 144-point scene
    of one rectangle, east_shift, depth and slip sampled (96 chains, 40
    steps), recovered within the JAX test's bounds."""
    from beat_tpu_torch.covariance import Covariance
    from beat_tpu_torch.heart.geodesy import GeodeticDataset
    from beat_tpu_torch.parameter import Parameter, PriorSet
    from beat_tpu_torch.sources import RectangularSource

    true = dict(east_shift=1500.0, depth=2000.0, slip=1.2)
    fixed = dict(north_shift=0.0, strike=30.0, dip=60.0, rake=90.0, length=8000.0,
                 width=4000.0)
    rng = np.random.default_rng(0)
    e = np.linspace(-15e3, 15e3, 12)
    coords = np.stack(np.meshgrid(e, e), axis=-1).reshape(-1, 2)
    disp = flagship.rectangle_displacement(coords, **true, **fixed)
    los = np.tile(np.array([-0.6, 0.1, 0.79]), (len(coords), 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    ds = GeodeticDataset(name="scene_asc", typ="SAR", coords=coords,
                         displacement=(disp * los).sum(axis=1) + rng.normal(0, 0.002, len(coords)),
                         los_vector=los, covariance=Covariance(data=np.eye(len(coords)) * 4e-6))
    priors = (PriorSet().add(Parameter("east_shift", [-5e3], [5e3]))
              .add(Parameter("depth", [500.0], [5e3])).add(Parameter("slip", [0.1], [3.0])))
    comp = GeodeticGeometryComposite([ds], [RectangularSource(**true, **fixed)], device="cpu")
    problem = Problem(priors, {"geodetic": comp}, device="cpu", outfolder=str(tmp_path / "out"))
    q_tr, _ = problem.sample(SMCParams(n_chains=96, n_steps=40, seed=5))
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    assert abs(est["east_shift"] - true["east_shift"]) < 300.0
    assert abs(est["depth"] - true["depth"]) < 500.0
    assert abs(est["slip"] - true["slip"]) < 0.25
    assert comp.get_variance_reductions({k: est[k] for k in true})["scene_asc"] > 0.9
