"""
The rest of the port's geometry mode against the JAX package on the CPU:
the composite's log-likelihood and its gradient for every source type
(finite rectangle, DoubleDC and Ringfault sub-sources on one more query
axis of K1c), station corrections, one hyperparameter per target, the
``spectrum`` domain, two events, ``quantity``, picked arrivals,
unfiltered observations and station weeding; the hyper-only posterior,
``update_weights`` (non-Toeplitz covariances and the ensemble tables'
prediction covariance), the bounds ``estimate_hypers`` writes, SMC's
``update_weights`` callback and the diagnostics.

Each case builds the small flagship (``beat_tpu_torch.flagship``, test
size) through the port and a JAX twin from the same numpy observations
and options, then compares on chains drawn 2 % inside every prior bound,
away from the points where the two packages' clamps pass different
gradients and from the lune's singular edges (``v_to_gamma`` at
v = ±1/3), with durations off the STF's removable poles.

Bars: the JAX package's per-chain float32 llk bar, rtol 2e-5
(``tests/test_float32_llk.py:101``); the per-parameter gradient bar of
``test_torch_grad.py``, rtol 1e-3 and atol 1e-4 · that parameter's
max|grad|; covariances and weights, float32 synthetics through float64
host algebra, rtol 1e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.covariance import SeismicNoiseAnalyser as JaxAnalyser
from beat_tpu.heart.gftable import build_homogeneous_table as jax_build_table
from beat_tpu.heart.seismic import SeismicDataset as JaxDataset
from beat_tpu.heart.seismic import WaveformMapping as JaxWavemap
from beat_tpu.heart.taper import ArrivalTaper as JaxTaper
from beat_tpu.heart.taper import Filter as JaxFilter
from beat_tpu.models.problem import Problem as JaxProblem
from beat_tpu.models.seismic import SeismicGeometryComposite as JaxComposite
from beat_tpu.models.seismic import recommended_finite_patches as jax_recommended_patches
from beat_tpu.parameter import Parameter as JaxParameter
from beat_tpu.parameter import PriorSet as JaxPriorSet
from beat_tpu.sources import source_catalog as jax_sources
from beat_tpu_torch import flagship
from beat_tpu_torch.convert import source_from_numpy, wavemap_from_jax
from beat_tpu_torch.covariance import SeismicNoiseAnalyser
from beat_tpu_torch.heart.seismic import WaveformMapping
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.models.seismic import (SeismicGeometryComposite,
                                           recommended_finite_patches)
from beat_tpu_torch.ops import bilgather
from beat_tpu_torch.samplers import SMCParams, value_and_grad
from test_torch_common import assert_grad_close, spy

N_CHAINS = 6
LLK_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4
COV_RTOL = 1e-4

#: the composite variants: (source, build_flagship options)
CASES = {
    **{src: (src, {}) for src in flagship.SOURCE_PRIORS},
    "station_corrections": ("DCSource", dict(station_corrections=True)),
    "hp_specific": ("DCSource", dict(hp_specific=True)),
    "spectrum": ("DCSource", dict(domain="spectrum")),
    "two_events": ("DCSource", dict(n_events=2)),
}
GRAD_CASES = ["MTQTSource", "DCSource", "DoubleDCSource", "RingfaultSource",
              "RectangularSource", "station_corrections", "spectrum", "two_events"]

_cache = {}


def _jax_table(table, cache):
    key = id(table)
    if key not in cache:
        cache[key] = jax_build_table(distances=table.distances, depths=table.depths,
                                     nt=table.nt, dt=table.dt, vp=table.vp, vs=table.vs,
                                     rho=table.rho)
    return cache[key]


def _jax_wavemap(pw, tables):
    dsets = [JaxDataset(station=d.station, channel=d.channel, east=d.east, north=d.north,
                        ydata=d.ydata) for d in pw.datasets]
    return JaxWavemap(name=pw.name, datasets=dsets, table=_jax_table(pw.table, tables),
                      taper=JaxTaper(**flagship.TAPER), filterer=JaxFilter(**flagship.FILTER),
                      domain=pw.domain, quantity=pw.quantity,
                      station_corrections=pw.station_corrections,
                      arrival_overrides=pw.arrival_overrides, event_idx=pw.event_idx,
                      event_offset=pw.event_offset, mapnumber=pw.mapnumber,
                      preprocess_data=pw.preprocess_data)


def _jax_twin(port, wavemaps=None):
    """The port problem through ``beat_tpu``: its observations (numpy),
    options, templates and priors."""
    comp = port.composites["seismic"]
    tables = {}
    if wavemaps is None:
        wavemaps = [_jax_wavemap(pw, tables) for pw in comp.wavemaps]
    sources = []
    for s in comp.sources:
        d = s.to_dict()
        sources.append(jax_sources[d.pop("type")](**d))
    analyser = (None if comp.noise_analyser is None
                else JaxAnalyser(structure=comp.noise_analyser.structure))
    jcomp = JaxComposite(wavemaps, sources, stf_type=comp.stf_type,
                         hp_specific=comp.hp_specific, noise_analyser=analyser,
                         finite_patches=comp.finite_patches, n_events=comp.n_events,
                         ensemble_tables=[_jax_table(t, tables) for t in comp.ensemble_tables])
    priors = JaxPriorSet()
    for p in port.source_priors.parameters.values():
        priors.add(JaxParameter(p.name, p.lower, p.upper))
    return JaxProblem(priors, {"seismic": jcomp})


def _case(name):
    if name not in _cache:
        source, options = CASES[name]
        port = flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device="cpu",
                                       source=source, **options)
        _cache[name] = (port, _jax_twin(port))
    return _cache[name]


def _chains(problem, n=N_CHAINS, seed=11):
    lower, upper = problem.priors.bounds_arrays()
    span = upper - lower
    rng = np.random.default_rng(seed)
    q = rng.uniform(lower + 0.02 * span, upper - 0.02 * span, size=(n, lower.size))
    # durations off the half-sinusoid STF's removable poles (w·d = π at a
    # frequency of the table), where the float32 cancellation of its
    # denominator differs between the packages
    freqs = problem.composites["seismic"].tables[0].freqs.numpy()
    d = q[:, problem.ordering["duration"].slc]
    near = (np.abs(2.0 * freqs * d[..., None] - 1.0) < 2e-3).any(-1)
    q[:, problem.ordering["duration"].slc] = np.where(near, d * 1.005, d)
    return q.astype(np.float32)


def _jax_llk(problem, q):
    logp, data = problem.make_logp_fn()
    return np.asarray(jax.jit(jax.vmap(lambda x: logp(x, data)))(jnp.asarray(q)))


def _port_llk(problem, q):
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        return logp(torch.as_tensor(q), data).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_llk_matches_jax(case, monkeypatch):
    port, jx = _case(case)
    assert port.ordering.names == jx.ordering.names
    np.testing.assert_array_equal(port.priors.bounds_arrays()[0], jx.priors.bounds_arrays()[0])
    q = _chains(port)
    k1c = spy(monkeypatch, bilgather, "_k1c")
    got = _port_llk(port, q)
    # one fused gather per table and event, whatever the source is made of
    assert k1c == ["cpu"] * port.composites["seismic"].n_events
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_llk(jx, q), rtol=LLK_RTOL)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradient_matches_jax(case):
    port, jx = _case(case)
    q = _chains(port, seed=12)
    jlogp, jdata = jx.make_logp_fn()
    want = np.asarray(jax.jit(jax.vmap(jax.grad(lambda x: jlogp(x, jdata))))(jnp.asarray(q)))
    logp, data = port.make_logp_fn()
    _, got = value_and_grad(logp, torch.as_tensor(q), (data,))
    assert_grad_close(got.numpy(), want, GRAD_RTOL, GRAD_ATOL_REL)


def test_rectangle_patch_grid_is_recommended():
    port, jx = _case("RectangularSource")
    comp = port.composites["seismic"]
    assert comp.finite_patches == (8, 5)
    for args in [(10e3, 6e3, 0.5), (2e3, 1e3, 0.1, 3000.0), (50e3, 20e3, 1.0, 2500.0)]:
        assert recommended_finite_patches(*args) == jax_recommended_patches(*args)


def _hand_built(options, weeding=None):
    """Both packages' composites built by hand from the flagship's
    observations with wavemap ``options`` (and ``station_weeding``
    arguments) applied before the composites are made."""
    table = flagship.flagship_table(flagship.TEST_SIZE["n_distances"],
                                    flagship.TEST_SIZE["n_depths"], flagship.TEST_SIZE["nt"],
                                    device="cpu")
    rng = np.random.default_rng(3)
    st_e, st_n = flagship.flagship_stations(flagship.TEST_SIZE["n_stations"], rng)
    raw = flagship.flagship_observations(table, st_e, st_n, rng)
    port_maps, jax_maps, tables = [], [], {}
    for i, (name, dsets) in enumerate(flagship.flagship_datasets(st_e, st_n, raw).items()):
        pw = WaveformMapping(name=name, datasets=dsets, table=table,
                             taper=ArrivalTaper(**flagship.TAPER),
                             filterer=Filter(**flagship.FILTER), mapnumber=i, **options)
        jw = _jax_wavemap(pw, tables)
        if weeding is not None:
            assert pw.station_weeding(**weeding) == jw.station_weeding(**weeding) > 0
        port_maps.append(pw)
        jax_maps.append(jw)
    comp = SeismicGeometryComposite(port_maps, [flagship.source_template("DCSource")],
                                    device="cpu")
    port = Problem(flagship.source_priors("DCSource"), {"seismic": comp}, device="cpu")
    return port, _jax_twin(port, jax_maps)


@pytest.mark.parametrize("options,weeding", [
    (dict(quantity="velocity"), None),
    (dict(quantity="acceleration", preprocess_data=False), None),
    (dict(arrival_overrides={"ST01": 30.0, "ST03": 25.5}), None),
    ({}, dict(blacklist=["ST00", "ST02.T"], distances=(0.0, 140e3))),
], ids=["velocity", "acceleration_unfiltered", "arrival_overrides", "station_weeding"])
def test_wavemap_options_match_jax(options, weeding):
    port, jx = _hand_built(options, weeding)
    for pw, jw in zip(port.composites["seismic"].wavemaps, jx.composites["seismic"].wavemaps):
        assert pw.get_station_names() == jw.get_station_names()
        np.testing.assert_array_equal(pw.window_starts, jw.window_starts)
        np.testing.assert_allclose(pw.data_windows, jw.data_windows, rtol=1e-6,
                                   atol=1e-6 * np.abs(jw.data_windows).max())
    q = _chains(port)
    np.testing.assert_allclose(_port_llk(port, q), _jax_llk(jx, q), rtol=LLK_RTOL)


def test_composite_from_converted_jax_wavemaps():
    """``convert``: the JAX twin's wavemaps and templates carried into the
    port give the JAX llk."""
    port, jx = _case("station_corrections")
    jcomp = jx.composites["seismic"]
    table = port.composites["seismic"].tables[0]
    comp = SeismicGeometryComposite([wavemap_from_jax(w, table) for w in jcomp.wavemaps],
                                    [source_from_numpy(s.to_dict()) for s in jcomp.sources],
                                    device="cpu")
    rebuilt = Problem(port.source_priors, {"seismic": comp}, device="cpu")
    assert rebuilt.ordering.names == jx.ordering.names
    q = _chains(port)
    np.testing.assert_allclose(_port_llk(rebuilt, q), _jax_llk(jx, q), rtol=LLK_RTOL)


def test_multi_event_validation():
    port, _ = _case("two_events")
    comp = port.composites["seismic"]
    with pytest.raises(ValueError, match="one source per event"):
        SeismicGeometryComposite(comp.wavemaps, comp.sources[:1], n_events=2, device="cpu")
    comp.wavemaps[-1].event_idx = 5
    try:
        with pytest.raises(ValueError, match="event_idx 5"):
            SeismicGeometryComposite(comp.wavemaps, comp.sources, n_events=2, device="cpu")
    finally:
        comp.wavemaps[-1].event_idx = 1


@pytest.mark.parametrize("case", ["DCSource", "hp_specific"])
def test_hyper_posterior_matches_jax(case):
    """``hyper_loglike`` and the precomputed ``hyper_data`` path of
    ``make_hyper_logp_fn`` against the JAX package's, residuals fixed at
    the prior test point."""
    port, jx = _case(case)
    fixed = port.priors.test_point()
    q = _chains(port)
    logp, data = port.make_hyper_logp_fn(fixed)
    jlogp, jdata = jx.make_hyper_logp_fn(jx.priors.test_point())
    want = np.asarray(jax.vmap(lambda x: jlogp(x, jdata))(jnp.asarray(q)))
    got = logp(torch.as_tensor(q), data).numpy()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    comp, jcomp = port.composites["seismic"], jx.composites["seismic"]
    point = port.ordering.to_point(torch.as_tensor(q))
    jfixed = {k: jnp.asarray(v) for k, v in jx.priors.test_point().items()}
    want = np.asarray(jax.vmap(lambda x: jcomp.hyper_loglike(jx.ordering.to_point(x), jfixed))(
        jnp.asarray(q)))
    np.testing.assert_allclose(comp.hyper_loglike(point, fixed).numpy(), want, rtol=LLK_RTOL)
    wrw, pds, ns, names = comp.hyper_data(fixed)
    jwrw, jpds, jns, jnames = jcomp.hyper_data(jfixed)
    assert names == jnames
    np.testing.assert_allclose(wrw.numpy(), np.asarray(jwrw), rtol=LLK_RTOL)
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))


def _weights_case():
    """DC problems of both packages with a non-Toeplitz analyser and two
    ensemble tables (velocities ±3 %)."""
    t = flagship.TEST_SIZE
    ens = [flagship.flagship_table(t["n_distances"], t["n_depths"], t["nt"], device="cpu",
                                   vp=6000.0 * f, vs=3500.0 * f) for f in (0.97, 1.03)]
    port = flagship.build_flagship(**t, seed=3, device="cpu", source="DCSource",
                                   noise_analyser=SeismicNoiseAnalyser("non-toeplitz"),
                                   ensemble_tables=ens)
    return port, _jax_twin(port)


def test_update_weights_matches_jax():
    """Non-Toeplitz data covariances from the residuals at a point and
    the ensemble tables' prediction covariances: the same covariances,
    weights written into the buffers the logp's data already hold (in
    place), and the same llk afterwards."""
    port, jx = _weights_case()
    comp, jcomp = port.composites["seismic"], jx.composites["seismic"]
    point = port.ordering.to_point(_chains(port, n=1, seed=5)[0].astype(np.float64))
    logp, data = port.make_logp_fn()
    held = data[0][0]["weights"]
    before = held.clone()
    port.update_weights(point)
    jx.update_weights(point)
    for pw, jw in zip(comp.wavemaps, jcomp.wavemaps):
        for pd, jd in zip(pw.datasets, jw.datasets):
            for part in ("data", "pred_v"):
                got, want = getattr(pd.covariance, part), getattr(jd.covariance, part)
                np.testing.assert_allclose(got, want, rtol=COV_RTOL,
                                           atol=COV_RTOL * np.abs(want).max())
    assert data[0][0]["weights"] is held and not torch.equal(held, before)
    np.testing.assert_allclose(held.numpy(), np.asarray(jcomp._device[0]["weights"]),
                               rtol=COV_RTOL, atol=COV_RTOL * float(held.abs().max()))
    q = _chains(port)
    np.testing.assert_allclose(logp(torch.as_tensor(q), data).detach().numpy(),
                               _jax_llk(jx, q), rtol=1e-4)


def test_estimate_hypers_writes_the_bounds_of_jax():
    """The hyper-only Metropolis at the test point: both packages write
    integer bounds that bracket the sampled hyperparameters, clipped to
    the registry's physical bounds; the two packages' random draws
    differ, so their bounds may differ by the rounding step, 1."""
    port = flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device="cpu",
                                   source="DCSource")
    jx = _jax_twin(port)
    got = port.estimate_hypers(n_steps=300, n_chains=8)
    want = jx.estimate_hypers(n_steps=300, n_chains=8)
    assert list(got) == list(want) == port.hypernames
    for name in got:
        for g, w in zip(got[name], want[name]):
            assert np.array_equal(g, np.round(g)) and np.abs(g - np.asarray(w)).max() <= 1.0
        assert (got[name][0] < got[name][1]).all() and (got[name][0] >= -20.0).all()
        assert port.priors.parameters[name].lower is got[name][0]


def test_smc_update_weights_callback(tmp_path):
    """SMC with ``update_weights=True`` re-estimates the covariances at
    every stage but the last and still reaches β = 1 with finite llks."""
    port, _ = _weights_case()
    port.outfolder = str(tmp_path)
    calls = []
    update = port.update_weights

    def counting(point):
        calls.append(point)
        update(point)

    port.update_weights = counting
    held = port.composites["seismic"].wavemap0_weights.clone()
    q_tr, llk_tr = port.sample(SMCParams(n_chains=16, n_steps=6, seed=0), update_weights=True)
    assert np.isfinite(llk_tr).all() and len(calls) >= 1
    assert set(calls[0]) == set(port.ordering.names)
    assert not torch.equal(held, port.composites["seismic"].wavemap0_weights)


@pytest.mark.parametrize("case", ["RectangularSource", "spectrum"])
def test_diagnostics_match_jax(case):
    port, jx = _case(case)
    point = port.ordering.to_point(_chains(port, n=1, seed=6)[0].astype(np.float64))
    comp, jcomp = port.composites["seismic"], jx.composites["seismic"]
    got, want = comp.get_synthetics(point), jcomp.get_synthetics(point)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[key]).max())
    vr, jvr = comp.get_variance_reductions(point), jcomp.get_variance_reductions(point)
    for key in jvr:
        np.testing.assert_allclose(vr[key], jvr[key], rtol=1e-4)
    res, jres = comp.get_standardized_residuals(point), jcomp.get_standardized_residuals(point)
    for key in jres:
        np.testing.assert_allclose(res[key], jres[key], rtol=1e-4,
                                   atol=1e-5 * np.abs(jres[key]).max())
