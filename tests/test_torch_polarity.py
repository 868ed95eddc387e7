"""
The port's first-motion polarities against the JAX package on the CPU:
the ray tracer's copy, the P/SH/SV radiation weights, the takeoff table
and its bilinear gather, the polarity likelihood, the composite's
batched ``loglike`` and ``hyper_loglike`` against ``jax.vmap`` of the JAX
composite over the chains (one map, two maps, two events, the takeoff
table with and without a sampled location), the joint FullMT + polarity
``Problem`` and a small SMC to β = 1.

Bars: the ray tracer runs the same float64 host code, so its outputs are
equal; the weights rtol 1e-6 of the largest weight (float32 products of
float32 sines and cosines); the gather and the per-target likelihood
rtol 1e-5 (float32); the summed llk the JAX package's per-chain float32
bar, rtol 2e-5 (``tests/test_float32_llk.py:101``).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.distributions import polarity_llk as jax_polarity_llk
from beat_tpu.heart import polarity as jhp
from beat_tpu.heart import velocity_model as jvm
from beat_tpu.models.polarity import PolarityComposite as JaxPolarity
from beat_tpu.models.polarity import PolarityMapping as JaxMapping
from beat_tpu.models.problem import Problem as JaxProblem
from beat_tpu.sources import DCSource as JaxDC
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.distributions import polarity_llk
from beat_tpu_torch.heart import polarity as hp
from beat_tpu_torch.heart import velocity_model as vm
from beat_tpu_torch.models.polarity import PolarityComposite, PolarityMapping
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.parameter import Parameter, PriorSet
from beat_tpu_torch.samplers import SMCParams
from beat_tpu_torch.sources import DCSource, sdr_to_m6
from test_torch_geometry import _chains, _jax_twin

WEIGHT_RTOL = 1e-6
F32_RTOL = 1e-5
LLK_RTOL = 2e-5
N_CHAINS = 8
MECH = dict(strike=40.0, dip=55.0, rake=-100.0, magnitude=5.0)
#: the sampled ranges of the composite cases
PRIORS = dict(strike=(0.0, 180.0), dip=(10.0, 90.0), rake=(-150.0, -30.0),
              depth=(4e3, 20e3), east_shift=(-20e3, 20e3), north_shift=(-20e3, 20e3),
              h=(-3.0, 1.0))


def _models():
    return [(vm.LayeredModel.default_crust(), jvm.LayeredModel.default_crust()),
            (vm.LayeredModel.homogeneous(), jvm.LayeredModel.homogeneous())]


@pytest.mark.parametrize("phase", ["p", "s"])
def test_first_arrival_equals_jax(phase):
    depths = [1.5e3, 9e3, 19.9e3, 20e3, 27e3, 38e3]
    distances = [0.0, 5e3, 40e3, 95e3, 120e3, 215e3]
    for model, jmodel in _models():
        for z in depths:
            for r in distances:
                assert vm.first_arrival(model, z, r, phase) == \
                    jvm.first_arrival(jmodel, z, r, phase)
            np.testing.assert_array_equal(vm.takeoff_angles(model, z, distances, phase),
                                          jvm.takeoff_angles(jmodel, z, distances, phase))


@pytest.mark.parametrize("wavename", ["any_P", "any_SH", "any_SV"])
def test_radiation_weights_match_jax(wavename):
    rng = np.random.default_rng(1)
    az = rng.uniform(0, 2 * np.pi, (3, 40)).astype(np.float32)
    to = rng.uniform(0, np.pi, (3, 40)).astype(np.float32)
    taz, tto = torch.as_tensor(az), torch.as_tensor(to)
    got = hp.radiation_weights(wavename, hp.takeoff_vector(taz, tto), taz, tto).numpy()
    jaz, jto = jnp.asarray(az), jnp.asarray(to)
    want = np.asarray(jhp.radiation_weights(wavename, jhp.takeoff_vector(jaz, jto), jaz, jto))
    np.testing.assert_allclose(got, want, rtol=WEIGHT_RTOL, atol=WEIGHT_RTOL * np.abs(want).max())
    m6 = rng.normal(size=(3, 6)).astype(np.float32)
    amps = hp.pol_synthetics(torch.as_tensor(m6), torch.as_tensor(got)).numpy()
    jamps = np.stack([np.asarray(jhp.pol_synthetics(jnp.asarray(m), jnp.asarray(w)))
                      for m, w in zip(m6, want)])
    np.testing.assert_allclose(amps, jamps, rtol=F32_RTOL, atol=F32_RTOL * np.abs(jamps).max())


@pytest.fixture(scope="module")
def tables():
    """The JAX package's takeoff tables (P and S, default crust) and the
    port's own builds of the same grids."""
    model, jmodel = _models()[0]
    depths, dists = np.linspace(2e3, 24e3, 9), np.linspace(10e3, 215e3, 16)
    out = {}
    for phase in ("p", "s"):
        jt = jhp.build_takeoff_table(jmodel, depths, dists, phase)
        pt = hp.build_takeoff_table(model, depths, dists, phase, device="cpu")
        out[phase] = (pt, jt)
    return out


def test_takeoff_table_and_interp_match_jax(tables):
    rng = np.random.default_rng(2)
    for pt, jt in tables.values():
        np.testing.assert_array_equal(pt.angles_rad.numpy(), np.asarray(jt.angles_rad))
        ported = convert.takeoff_table_from_numpy(jt.depth_grid, jt.dist_grid, jt.angles_rad,
                                                  device="cpu")
        # off-grid on both sides: the clipped cell weights take the edge values
        depth = rng.uniform(0.0, 30e3, N_CHAINS).astype(np.float32)
        dist = rng.uniform(0.0, 240e3, (N_CHAINS, 25)).astype(np.float32)
        want = np.asarray(jax.vmap(jt.interp)(jnp.asarray(depth), jnp.asarray(dist)))
        for table in (pt, ported):
            got = table.interp(torch.as_tensor(depth), torch.as_tensor(dist)).numpy()
            np.testing.assert_allclose(got, want, rtol=F32_RTOL)


def test_polarity_llk_matches_jax():
    rng = np.random.default_rng(3)
    obs = np.sign(rng.normal(size=(N_CHAINS, 30))).astype(np.float32)
    amps = rng.normal(size=(N_CHAINS, 30)).astype(np.float32)
    sigma = np.exp(rng.uniform(-3, 1, (N_CHAINS, 1))).astype(np.float32)
    got = polarity_llk(torch.as_tensor(obs), torch.as_tensor(amps), 0.01,
                       torch.as_tensor(sigma)).numpy()
    want = np.asarray(jax_polarity_llk(jnp.asarray(obs), jnp.asarray(amps), 0.01,
                                       jnp.asarray(sigma)))
    # p_i is rounded to float32 before its logarithm: one ulp of p_i near 1
    # is an absolute error of eps in log(p_i), whatever the relative one
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=2 * np.finfo(np.float32).eps)
    np.testing.assert_allclose(got.sum(-1), want.sum(-1), rtol=F32_RTOL)


def _targets(n, seed, depth=9e3, phase="p", wavename="any_P", amplitudes=False):
    """Targets with distances (for the table), the first motions of MECH
    at ``depth`` through the ray tracer (and their amplitudes)."""
    model = vm.LayeredModel.default_crust()
    rng = np.random.default_rng(seed)
    dist = rng.uniform(20e3, 200e3, n)
    az = rng.uniform(0, 2 * np.pi, n)
    to = vm.takeoff_angles(model, depth, dist, phase)
    w = hp.radiation_weights(wavename, hp.takeoff_vector(torch.as_tensor(az),
                                                         torch.as_tensor(to)),
                             torch.as_tensor(az), torch.as_tensor(to))
    amps = (w @ sdr_to_m6(MECH["strike"], MECH["dip"], MECH["rake"], 1.0).double()).numpy()
    targets = convert.polarity_targets_from_numpy([f"S{i}" for i in range(n)], az, to,
                                                  np.sign(amps).astype(int), dist)
    return (targets, amps) if amplitudes else targets


def _jax_targets(targets):
    return [jhp.PolarityTarget(**dataclasses.asdict(t)) for t in targets]


#: case: (maps as (wavename, phase, event_idx), sources, sampled names, table)
CASES = {
    "one_map": ([("any_P", "p", 0)], 1, ("strike", "dip", "rake"), False),
    "two_maps": ([("any_P", "p", 0), ("any_SH", "s", 0)], 1, ("strike", "dip", "rake"), False),
    "two_events": ([("any_P", "p", 0), ("any_SV", "s", 1)], 2, ("strike", "dip", "rake"),
                   False),
    "table_fixed_location": ([("any_P", "p", 0), ("any_SH", "s", 0)], 1,
                             ("strike", "dip", "rake"), True),
    "table_sampled_location": ([("any_P", "p", 0), ("any_SH", "s", 0)], 1,
                               ("strike", "dip", "depth", "east_shift", "north_shift"), True),
    "table_two_events": ([("any_P", "p", 0), ("any_SH", "s", 1)], 2,
                         ("strike", "rake", "depth", "north_shift"), True),
}


def _composites(case, tables):
    spec, n_sources, _, with_table = CASES[case]
    maps, jmaps = [], []
    for i, (wavename, phase, event) in enumerate(spec):
        targets = _targets(14 + 3 * i, seed=10 + i, phase=phase, wavename=wavename)
        pt, jt = tables[phase] if with_table else (None, None)
        maps.append(PolarityMapping(wavename, targets, event_idx=event, mapnumber=i,
                                    takeoff_table=pt, device="cpu"))
        jmaps.append(JaxMapping(wavename, _jax_targets(targets), event_idx=event, mapnumber=i,
                                takeoff_table=jt))
    src = dict(MECH, depth=9e3)
    port = PolarityComposite(sources=[DCSource(**src)] * n_sources, maps=maps, device="cpu")
    jx = JaxPolarity(sources=[JaxDC(**src)] * n_sources, maps=jmaps)
    return port, jx


def _points(case, port, seed):
    """Chains (numpy) of the sampled names, vectors for two events, and
    of each map's hyperparameter."""
    _, n_sources, names, _ = CASES[case]
    rng = np.random.default_rng(seed)
    pts = {}
    for name in names + tuple(port.get_hypernames()):
        lo, hi = PRIORS["h" if name.startswith("h_") else name]
        shape = (N_CHAINS, n_sources) if n_sources > 1 and not name.startswith("h_") \
            else (N_CHAINS,)
        pts[name] = rng.uniform(lo, hi, shape).astype(np.float32)
    return pts


def _port_point(pts):
    return {k: torch.as_tensor(v) for k, v in pts.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_composite_llk_matches_jax(case, tables):
    port, jx = _composites(case, tables)
    assert port.get_hypernames() == jx.get_hypernames()
    pts = _points(case, port, seed=4)
    with torch.no_grad():
        got = port.loglike(_port_point(pts)).numpy()
    jdata = jx.device_data()
    want = np.asarray(jax.jit(jax.vmap(lambda p: jx.loglike(p, jdata)))(
        {k: jnp.asarray(v) for k, v in pts.items()}))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)

    # the hyper-only likelihood: the chains' hyperparameters, amplitudes at one point
    fixed = {k: v[0] for k, v in pts.items() if not k.startswith("h_")}
    hyper = {k: v for k, v in pts.items() if k.startswith("h_")}
    with torch.no_grad():
        got = port.hyper_loglike(_port_point(hyper), fixed).numpy()
    jfixed = {k: jnp.asarray(v) for k, v in fixed.items()}
    want = np.asarray(jax.jit(jax.vmap(lambda p: jx.hyper_loglike(p, jfixed, jdata)))(
        {k: jnp.asarray(v) for k, v in hyper.items()}))
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_sampled_location_moves_the_llk_only_with_a_table(tables):
    port, _ = _composites("table_sampled_location", tables)
    frozen, _ = _composites("two_maps", tables)
    pts = _points("table_sampled_location", port, seed=5)
    moved = dict(pts, depth=pts["depth"] + 3e3)
    with torch.no_grad():
        assert not np.allclose(port.loglike(_port_point(pts)).numpy(),
                               port.loglike(_port_point(moved)).numpy())
        np.testing.assert_array_equal(frozen.loglike(_port_point(pts)).numpy(),
                                      frozen.loglike(_port_point(moved)).numpy())


def test_composite_validation(tables):
    targets = _targets(5, seed=1)
    with pytest.raises(ValueError, match="event_idx"):
        PolarityComposite(sources=[DCSource()], device="cpu",
                          maps=[PolarityMapping("any_P", targets, event_idx=1, device="cpu")])
    no_dist = [dataclasses.replace(t, distance_m=None) for t in targets]
    with pytest.raises(ValueError, match="distance_m"):
        PolarityMapping("any_P", no_dist, takeoff_table=tables["p"][0], device="cpu")
    with pytest.raises(ValueError, match="explicit device"):
        PolarityMapping("any_P", targets, device=None)


@pytest.fixture(scope="module")
def joint():
    """The polarity flagship at test size and its JAX twin: the FullMT
    twin of ``test_torch_geometry`` plus the JAX polarity composite on the
    port's targets and takeoff tables."""
    port = flagship.build_polarity_flagship(**flagship.POLARITY_TEST_SIZE, seed=3,
                                            device="cpu")
    jx = _jax_twin(port)
    pol = port.composites["polarity"]
    jmaps = [JaxMapping(m.wavename, _jax_targets(m.targets), event_idx=m.event_idx,
                        mapnumber=m.mapnumber,
                        takeoff_table=jhp.TakeoffTable(
                            depth_grid=jnp.asarray(m.takeoff_table.depth_grid.numpy()),
                            dist_grid=jnp.asarray(m.takeoff_table.dist_grid.numpy()),
                            angles_rad=jnp.asarray(m.takeoff_table.angles_rad.numpy())))
             for m in pol.maps]
    jsources = jx.composites["seismic"].sources
    jprob = JaxProblem(jx.source_priors, {"seismic": jx.composites["seismic"],
                                          "polarity": JaxPolarity(sources=jsources,
                                                                  maps=jmaps)})
    return port, jprob


def test_joint_problem_logp_matches_jax(joint):
    port, jprob = joint
    assert port.ordering.names == jprob.ordering.names
    assert {"h_any_P_pol_0", "h_any_SH_pol_1"} <= set(port.ordering.names)
    q = _chains(port)
    logp, data = port.make_logp_fn()
    with torch.no_grad():
        got = logp(torch.as_tensor(q), data).numpy()
    jlogp, jdata = jprob.make_logp_fn()
    want = np.asarray(jax.jit(jax.vmap(lambda x: jlogp(x, jdata)))(jnp.asarray(q)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    # the polarity composite alone, on the same chains
    pol = port.composites["polarity"]
    with torch.no_grad():
        got = pol.loglike(port.ordering.to_point(torch.as_tensor(q)), data[1]).numpy()
    jpol = jprob.composites["polarity"]
    jpdata = jpol.device_data()
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: jpol.loglike(jprob.ordering.to_point(x), jpdata)))(jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_polarity_smc_reaches_beta_one(tmp_path, tables):
    """A DC mechanism and its depth from first motions alone, through the
    takeoff tables: SMC to β = 1, and the best draw predicts every first
    motion whose true amplitude exceeds 0.1 of the largest."""
    data = {w: _targets(30, seed=20 + i, depth=12e3, phase=ph, wavename=w, amplitudes=True)
            for i, (w, ph) in enumerate((("any_P", "p"), ("any_SH", "s")))}
    maps = [PolarityMapping(w, t, mapnumber=i, takeoff_table=tables["p" if i == 0 else "s"][0],
                            device="cpu")
            for i, (w, (t, _)) in enumerate(data.items())]
    comp = PolarityComposite(sources=[DCSource(**MECH)], maps=maps, device="cpu")
    priors = PriorSet()
    for name in ("strike", "dip", "rake", "depth"):
        priors.add(Parameter(name, [PRIORS[name][0]], [PRIORS[name][1]]))
    problem = Problem(priors, {"polarity": comp}, device="cpu", outfolder=str(tmp_path))
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=64, n_steps=20, seed=3))
    q, llk = q_tr.reshape(-1, q_tr.shape[-1]), llk_tr.reshape(-1)
    assert np.isfinite(llk).all()
    syn = comp.get_synthetics(problem.ordering.to_point(q[np.argmax(llk)]))
    for i, (w, (t, amps)) in enumerate(data.items()):
        clear = np.abs(amps) > 0.1 * np.abs(amps).max()
        np.testing.assert_array_equal(syn[f"{w}_pol_{i}"][clear],
                                      np.array([x.polarity for x in t])[clear])


def test_joint_hyper_posterior_matches_jax(joint):
    """The hyper-only posterior of the joint problem at one fixed point:
    the waveforms through their precomputed residual norms, the polarity
    composite through its ``hyper_loglike``."""
    port, jprob = joint
    q = _chains(port, n=N_CHAINS + 1, seed=13)
    fixed = port.ordering.to_point(q[0].astype(np.float64))
    logp, data = port.make_hyper_logp_fn(fixed)
    with torch.no_grad():
        got = logp(torch.as_tensor(q[1:]), data).numpy()
    jlogp, jdata = jprob.make_hyper_logp_fn(fixed)
    want = np.asarray(jax.jit(jax.vmap(lambda x: jlogp(x, jdata)))(jnp.asarray(q[1:])))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_polarity_problem_runs_every_sampler(tmp_path, tables):
    """A polarity-only problem: ``update_weights`` leaves it as it is,
    ``estimate_hypers`` bounds both hyperparameters, and Metropolis and PT
    run to finite llks."""
    from beat_tpu_torch.samplers import MetropolisParams, PTParams

    maps = [PolarityMapping("any_P", _targets(20, seed=30), takeoff_table=tables["p"][0],
                            device="cpu"),
            PolarityMapping("any_SH", _targets(12, seed=31, phase="s", wavename="any_SH"),
                            mapnumber=1, takeoff_table=tables["s"][0], device="cpu")]
    comp = PolarityComposite(sources=[DCSource(**MECH)], maps=maps, device="cpu")
    priors = PriorSet()
    for name in ("strike", "dip", "rake", "depth"):
        priors.add(Parameter(name, [PRIORS[name][0]], [PRIORS[name][1]]))
    problem = Problem(priors, {"polarity": comp}, device="cpu", outfolder=str(tmp_path))
    assert problem.hypernames == ["h_any_P_pol_0", "h_any_SH_pol_1"]
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(6).uniform(lo, hi, (8, lo.size)),
                        dtype=torch.float32)
    before = logp(q, data)
    problem.update_weights(problem.priors.test_point())
    torch.testing.assert_close(logp(q, problem.logp_data()), before, rtol=0, atol=0)
    bounds = problem.estimate_hypers(n_steps=200, n_chains=8)
    assert set(bounds) == set(problem.hypernames)
    q_tr, llk_tr = problem.sample(MetropolisParams(n_chains=8, n_steps=60, burn=0.5, seed=1))
    assert np.isfinite(llk_tr).all() and q_tr.shape[-1] == lo.size
    q_tr, llk_tr, _ = problem.sample(PTParams(n_chains=8, n_chains_posterior=2, n_samples=60,
                                              swap_interval=(5, 10), beta_tune_interval=30,
                                              seed=2))
    assert np.isfinite(llk_tr).all()
