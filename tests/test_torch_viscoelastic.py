"""
The port's viscoelastic tables (``beat_tpu_torch/heart/viscoelastic.py``)
against the JAX package on the CPU: the Burgers rheology and its
effective models, the Gaver–Stehfest weights, the Prony fit, the
time-dependent table (a 3 × 2 grid at two epochs: at each epoch and
between them), its ``.npz`` files read by either package, the epoch
table's gather and a geodetic composite's likelihood on it, and the
wiring of the datasets' acquisition times (``beat_tpu/config.py:1190-1215``).

Bars: the host copies (rheology, Stehfest, Prony) run the same float64
code, 1e-12; the time table 1e-5 of its max plus twice the JAX table's
own roundoff spread (see the test); the build's Laplace-domain values at
its s nodes 1e-9 of each node's max plus twice the JAX solver's spread
over the build, and the epochs the JAX Prony fit makes of the port's s-node values
1e-5 of max with no spread; the gather rtol 1e-5 (float32 tables); the
llk the JAX package's per-chain float32 bar, 2e-5 of |llk| plus the
scale of its residual-free terms (``tests/test_torch_geodetic.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from beat_tpu.heart import layered_statics as jls
from beat_tpu.heart import velocity_model as jvm
from beat_tpu.heart import viscoelastic as jve
from beat_tpu.models.geodetic import GeodeticGeometryComposite as JComposite
from beat_tpu.models.problem import Problem as JProblem
from beat_tpu.parameter import Parameter as JParameter
from beat_tpu.parameter import PriorSet as JPriorSet
from beat_tpu import sources as jsources
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.heart import velocity_model, viscoelastic
from beat_tpu_torch.heart.statictable import static_table_values
from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite
from beat_tpu_torch.models.problem import Problem
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_geodetic import (N_POINTS, assert_llk_close, batch, jax_correction, jax_dataset,
                                 jax_llk, port_llk)

HOST_RTOL = 1e-12
TABLE_RTOL = 1e-5
S_NODE_RTOL = 1e-9
GATHER_RTOL = 1e-5
DAY = 86400.0
EPOCHS = (30 * DAY, 365 * DAY)
GRID = dict(distances=np.linspace(2e3, 30e3, 3), depths=np.array([3e3, 8e3]))
ETA2 = (0.0, 1e19, 1e18)
SPREAD = 1 + 3e-16


def _crust():
    return velocity_model.LayeredModel.default_crust(), jvm.LayeredModel.default_crust()


def _rheologies():
    return (viscoelastic.BurgersRheology(np.zeros(3), ETA2, np.ones(3)),
            jve.BurgersRheology(np.zeros(3), ETA2, np.ones(3)))


def _jax_time_table(vp_scale=1.0):
    j, rj = _crust()[1], _rheologies()[1]
    j = jvm.LayeredModel(tops=j.tops, vp=j.vp * vp_scale, vs=j.vs, rho=j.rho, name=j.name)
    return jve.build_viscoelastic_static_table(j, rj, times=EPOCHS, s_per_decade=4, **GRID)


@pytest.fixture(scope="module")
def builds():
    """(port, JAX) time tables of the default crust with Maxwell layers, and
    what each build gave its Prony fit, ``{"port" | "jax": (s nodes, u_s)}``
    (u_s (n_s, 6, 3, nd, nz), the static tables at the s nodes), caught on
    the way in."""
    fits = {}

    def catch(key, fit):
        def wrapped(s_nodes, u_s, *args, **kwargs):
            fits[key] = (np.array(s_nodes), np.array(u_s))
            return fit(s_nodes, u_s, *args, **kwargs)
        return wrapped

    p, rp = _crust()[0], _rheologies()[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(viscoelastic, "prony_fit", catch("port", viscoelastic.prony_fit))
        mp.setattr(jve, "prony_fit", catch("jax", jve.prony_fit))
        port = viscoelastic.build_viscoelastic_static_table(p, rp, times=EPOCHS, s_per_decade=4,
                                                            device="cpu", **GRID)
        jax_t = _jax_time_table()
    return port, jax_t, fits


@pytest.fixture(scope="module")
def tables(builds):
    """(port, JAX) time tables of the default crust with Maxwell layers."""
    return builds[:2]


def test_rheology_and_effective_models_equal_jax():
    (p, j), (rp, rj) = _crust(), _rheologies()
    burgers = dict(eta1=[1e18, 0.0, 5e17], eta2=[0.0, 1e19, 1e18], alpha=[0.5, 1.0, 0.3])
    mu = p.rho * p.vs**2
    for a, b in ((rp, rj), (viscoelastic.BurgersRheology(**burgers),
                            jve.BurgersRheology(**burgers))):
        np.testing.assert_array_equal(a.relaxation_times(mu), b.relaxation_times(mu))
        for s in (1e-9, 1e-6, 1e-3):
            np.testing.assert_array_equal(a.mu_of_s(mu, s), b.mu_of_s(mu, s))
            ep, ej = viscoelastic.effective_model(p, a, s), jve.effective_model(j, b, s)
            np.testing.assert_array_equal(ep.vp, ej.vp)
            np.testing.assert_array_equal(ep.vs, ej.vs)


def test_stehfest_and_prony_equal_jax():
    np.testing.assert_array_equal(viscoelastic.stehfest_weights(16), jve.stehfest_weights(16))

    def F(s):
        return 1.0 / (s * (1.0 + 3.0 * s))

    assert viscoelastic.stehfest_invert(F, 2.0) == pytest.approx(jve.stehfest_invert(F, 2.0),
                                                                 rel=HOST_RTOL)
    rng = np.random.default_rng(2)
    s = np.geomspace(1e-8, 1e-4, 20)
    u = 1.0 + rng.normal(size=(1, 4, 3)) / (1.0 + s[:, None, None] * 1e6) \
        + 1e-3 / (s[:, None, None] * 1e5)
    for secular in (True, False):
        a, b = viscoelastic.prony_fit(s, u, secular=secular), jve.prony_fit(s, u,
                                                                            secular=secular)
        for attr in ("c", "d", "a", "taus"):
            np.testing.assert_allclose(getattr(a, attr), getattr(b, attr), rtol=HOST_RTOL,
                                       atol=HOST_RTOL * np.abs(getattr(b, attr)).max())
        assert a.at_time(3e5) == pytest.approx(b.at_time(3e5), rel=1e-9)


def test_time_table_matches_jax_at_and_between_epochs(tables):
    """1e-5 of max plus twice the JAX table's own spread: its static builds
    at the s nodes carry roundoff up to 1.4e-5 of their max (measured by
    vp · (1 + 3e-16); the port's ≈ 1e-13), which the Prony fit carries
    into the epochs' tables at ≈ 2e-4 of max."""
    port, jax_t = tables
    again = _jax_time_table(SPREAD)
    np.testing.assert_array_equal(port.times, jax_t.times)
    np.testing.assert_array_equal(port.depths, jax_t.depths)
    scale = np.abs(jax_t.values).max()
    for t in (0.0, 10 * DAY, EPOCHS[0], 100 * DAY, EPOCHS[1], 2 * 365 * DAY):
        got = port.at_time(t, device="cpu").values.numpy()
        want = np.asarray(jax_t.at_time(t).values, dtype=np.float64)
        spread = np.abs(want - np.asarray(again.at_time(t).values)).max()
        assert np.abs(got - want).max() <= TABLE_RTOL * scale + 2 * spread, t
    assert port.prony.max_resid <= 1e-3 and jax_t.prony.max_resid <= 1e-3


def _jax_s_node_values(s_nodes, depths, vp_scale=1.0):
    """(n_s, 6, 3, nd, nz) float64: the JAX static solver's responses of the
    effective models at ``s_nodes``, depth by depth (what its
    ``build_static_table`` computes before the float32 cast)."""
    j, rj = _crust()[1], _rheologies()[1]
    j = jvm.LayeredModel(tops=j.tops, vp=j.vp * vp_scale, vs=j.vs, rho=j.rho, name=j.name)
    obs = np.stack([np.zeros_like(GRID["distances"]), GRID["distances"]], axis=-1)
    out = np.empty((s_nodes.size, 6, 3, obs.shape[0], depths.size))
    for i, s in enumerate(s_nodes):
        m = jve.effective_model(j, rj, s)
        for iz, zs in enumerate(depths):
            u6 = jls.elementary_mt_surface_displacements(m, zs, obs)
            out[i, :, :, :, iz] = np.moveaxis(u6[..., [2, 1, 0]], -1, 1)
    return out


def test_s_node_values_match_jax(builds):
    """The build's Laplace-domain step on its own: the same s nodes as the
    JAX build, the same float32 values handed to the fit, and the port's
    float64 responses of the effective models at 1e-9 of each node's max
    plus twice the JAX solver's spread over the build (vp · (1 + 3e-16):
    the worst node's, relative to its max, 2.5e-5; the port's own spread
    is ≤ 4e-12 and it lies within 2.1e-5 of JAX at every node).  One
    perturbation samples JAX's roundoff: at a single node it may read a
    few times below the difference (3e-8 against 1e-8 at the smallest s),
    so the spread is taken over all nodes."""
    port, jax_t, fits = builds
    (s_port, u_port), (s_jax, u_jax) = fits["port"], fits["jax"]
    np.testing.assert_array_equal(s_port, s_jax)
    assert u_port.shape == u_jax.shape
    models = [viscoelastic.effective_model(_crust()[0], _rheologies()[0], s) for s in s_port]
    got = static_table_values(models, GRID["distances"], port.depths, device="cpu").numpy()
    np.testing.assert_array_equal(got.astype(np.float32).astype(np.float64), u_port)
    want = _jax_s_node_values(s_jax, jax_t.depths)
    scale = np.abs(want).max(axis=(1, 2, 3, 4))
    spread = (np.abs(want - _jax_s_node_values(s_jax, jax_t.depths, SPREAD)).max(axis=(1, 2, 3, 4))
              / scale).max()
    err = np.abs(got - want).max(axis=(1, 2, 3, 4))
    assert (err <= (S_NODE_RTOL + 2 * spread) * scale).all(), (err / scale, spread)


def test_epochs_of_the_port_s_node_values_match_jax_prony(builds):
    """The epochs' reconstruction without the JAX solver's roundoff: the
    JAX Prony fit of the port's own s-node values, evaluated at and between
    the epochs, against the port's table at 1e-5 of max (no spread)."""
    port, _, fits = builds
    s_port, u_port = fits["port"]
    fit = jve.prony_fit(s_port, u_port, secular=True)
    assert port.prony.max_resid == pytest.approx(fit.max_resid, rel=HOST_RTOL)
    for t in (10 * DAY, EPOCHS[0], 100 * DAY, EPOCHS[1], 2 * 365 * DAY):
        got = port.at_time(t, device="cpu").values.numpy().astype(np.float64)
        want = fit.at_time(t).astype(np.float32).astype(np.float64)
        assert np.abs(got - want).max() <= TABLE_RTOL * np.abs(want).max(), t


def test_time_table_at_zero_is_the_elastic_build(tables):
    from beat_tpu_torch.heart.statictable import build_static_table

    elastic = build_static_table(_crust()[0], GRID["distances"], GRID["depths"], device="cpu")
    assert torch.equal(tables[0].at_time(0.0, device="cpu").values, elastic.values)


def test_elastic_rheology_replicates_the_table():
    p, _ = _crust()
    t = viscoelastic.build_viscoelastic_static_table(
        p, viscoelastic.BurgersRheology.elastic(3), times=[DAY], device="cpu", **GRID)
    np.testing.assert_array_equal(t.values[0], t.values[1])
    with pytest.raises(ValueError, match="layers"):
        viscoelastic.build_viscoelastic_static_table(
            p, viscoelastic.BurgersRheology([0.0], [1e18], [1.0]), times=[DAY], device="cpu",
            **GRID)


def test_time_table_files_read_by_either_package(tmp_path, tables):
    port, jax_t = tables
    jax_t.save(str(tmp_path / "jax.npz"))
    port.save(str(tmp_path / "port.npz"))
    for ours, theirs in ((viscoelastic.TimeDependentStaticGFTable.load(str(tmp_path / "jax.npz")),
                          jax_t),
                         (port, jve.TimeDependentStaticGFTable.load(str(tmp_path / "port.npz")))):
        for attr in ("values", "times", "distances", "depths", "mu_tops", "mus", "lams"):
            np.testing.assert_array_equal(np.asarray(getattr(ours, attr)),
                                          np.asarray(getattr(theirs, attr)))
        for attr in ("c", "d", "a", "taus"):
            np.testing.assert_array_equal(getattr(ours.prony, attr), getattr(theirs.prony, attr))
    carried = convert.time_table_from_numpy(jax_t.values, jax_t.times, jax_t.distances,
                                            jax_t.depths, jax_t.mu_tops, jax_t.mus, jax_t.lams,
                                            jax_t.name, jax_t.prony)
    np.testing.assert_array_equal(carried.at_time(50 * DAY, device="cpu").values.numpy(),
                                  np.asarray(jax_t.at_time(50 * DAY).values))


def _epoch_twins(jax_t, obs_times):
    jep = jve.EpochStaticGFTable.from_time_table(jax_t, obs_times)
    port_t = convert.time_table_from_numpy(jax_t.values, jax_t.times, jax_t.distances,
                                           jax_t.depths, jax_t.mu_tops, jax_t.mus, jax_t.lams,
                                           jax_t.name, jax_t.prony)
    return viscoelastic.EpochStaticGFTable.from_time_table(port_t, obs_times, device="cpu"), jep


def test_epoch_gather_matches_jax(tables):
    obs_times = np.repeat([0.0, EPOCHS[0], 200 * DAY], 4)
    ours, theirs = _epoch_twins(tables[1], obs_times)
    rng = np.random.default_rng(4)
    obs_e, obs_n = rng.uniform(-25e3, 25e3, (2, obs_times.size))
    m6 = np.array([1.0, -0.4, -0.6, 0.3, 0.5, -0.2]) * 1e16
    want = np.asarray(theirs.synthesize_enu(jnp.asarray(m6), 800.0, -300.0,
                                            jnp.asarray(5.2e3), jnp.asarray(obs_e),
                                            jnp.asarray(obs_n)))
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)  # noqa: E731
    got = ours.synthesize_enu(t(m6)[None], t([800.0]), t([-300.0]), t([5.2e3]), t(obs_e),
                              t(obs_n))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=GATHER_RTOL, atol=GATHER_RTOL * np.abs(want).max())
    # each observation reads its own epoch's slab
    for epoch in np.unique(obs_times):
        sel = obs_times == epoch
        single = tables[1].at_time(float(epoch))
        one = np.asarray(single.synthesize_enu(jnp.asarray(m6), 800.0, -300.0,
                                               jnp.asarray(5.2e3), jnp.asarray(obs_e[sel]),
                                               jnp.asarray(obs_n[sel])))
        np.testing.assert_allclose(got[sel], one, rtol=GATHER_RTOL,
                                   atol=GATHER_RTOL * np.abs(one).max())


def test_epoch_composite_llk_matches_jax(tables):
    """The rectangle's geodetic llk through the epoch table, one scene at
    30 days and one at 365, against the JAX composite on its own."""
    port = flagship.build_geodetic_flagship(N_POINTS, seed=3, device="cpu")
    comp = port.composites["geodetic"]
    jdatasets = [jax_dataset(ds) for ds in comp.datasets]
    times = {ds.name: days for ds, days in zip(comp.datasets, (30.0, 365.0))}
    jtimes = np.concatenate([np.full(ds.samples, times[ds.name] * DAY) for ds in jdatasets])
    jep = jve.EpochStaticGFTable.from_time_table(tables[1], jtimes)
    template = comp.sources[0]
    jtemplate = jsources.RectangularSource(**{k: v for k, v in template.to_dict().items()
                                             if k != "type"})
    jcomp = JComposite(jdatasets, [jtemplate], static_table=jep,
                       corrections=[jax_correction(c) for c in comp.corrections])
    jpriors = JPriorSet()
    for p in port.source_priors.parameters.values():
        jpriors.add(JParameter(p.name, p.lower, p.upper))
    jprob = JProblem(jpriors, {"geodetic": jcomp})

    port_t = convert.time_table_from_numpy(tables[1].values, tables[1].times,
                                           tables[1].distances, tables[1].depths,
                                           tables[1].mu_tops, tables[1].mus, tables[1].lams,
                                           prony=tables[1].prony)
    datasets = [convert.geodetic_dataset_from_numpy(ds.name, ds.typ, ds.coords, ds.displacement,
                                                    ds.los_vector, ds.odw, ds.covariance)
                for ds in jdatasets]
    table = viscoelastic.epoch_table_for_datasets(port_t, datasets, times, device="cpu")
    assert [ds.time for ds in datasets] == [30.0 * DAY, 365.0 * DAY]
    np.testing.assert_array_equal(table.epoch_idx.numpy(),
                                  np.asarray(jep.epoch_idx, dtype=np.int64))
    pcomp = GeodeticGeometryComposite(datasets, [template], static_table=table,
                                      corrections=comp.corrections, device="cpu")
    pprob = Problem(port.source_priors, {"geodetic": pcomp}, device="cpu")
    q = batch(pprob, n=16)
    assert_llk_close(pprob, q, port_llk(pprob, q), jax_llk(jprob, q))


def test_composite_refuses_a_misaligned_epoch_table(tables):
    port = flagship.build_geodetic_flagship(N_POINTS, seed=3, device="cpu")
    comp = port.composites["geodetic"]
    ours, _ = _epoch_twins(tables[1], np.zeros(comp.stack.samples + 1))
    with pytest.raises(ValueError, match="observations"):
        GeodeticGeometryComposite(comp.datasets, comp.sources, static_table=ours, device="cpu")


def test_visco_flagship_data_read_each_scenes_epoch(tables, tmp_path):
    """The post-seismic problem's data: each scene's LOS through its own
    epoch (the truth's llk above a draw's), on the module's small table."""
    problem = flagship.build_visco_flagship(**flagship.VISCO_TEST_SIZE, device="cpu",
                                            outfolder=str(tmp_path / "visco"), ttable=tables[0])
    comp = problem.composites["geodetic"]
    assert comp.static_table.values.shape[0] == 2
    assert sorted(int(i) for i in comp.static_table.epoch_idx.unique()) == [0, 1]
    logp, data = problem.make_logp_fn()
    true = torch.as_tensor(problem.point_to_array(problem.true_point), dtype=torch.float32)
    q = torch.as_tensor(batch(problem, n=8), dtype=torch.float32)
    with torch.no_grad():
        llk = logp(torch.cat([true[None], q]), data)
    assert torch.isfinite(llk).all() and bool((llk[0] > llk[1:]).all())
