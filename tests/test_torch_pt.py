"""
The port's parallel tempering against the JAX package on the CPU: the β
ladder and its tuning table, the exchange step on the JAX package's own
uniforms, the per-chain β of the Metropolis, MALA and HMC steps and the
tuning across segments, PT on the two-Gaussian target of
tests/test_samplers.py, the joint seismic + geodetic likelihood that PT
samples in BASELINE config 3, and PT's stage files read both ways.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beat_tpu.backend
import beat_tpu.samplers.pt as jpt
import beat_tpu.utility
import beat_tpu_torch.backend
import beat_tpu_torch.utility
from beat_tpu.covariance import Covariance as JCovariance
from beat_tpu.heart.geodesy import GeodeticDataset as JDataset
from beat_tpu.heart.gftable import build_homogeneous_table as jax_build_table
from beat_tpu.models.geodetic import GeodeticGeometryComposite as JGeoComposite
from beat_tpu.models.problem import Problem as JProblem
from beat_tpu.models.seismic import SeismicGeometryComposite as JSeisComposite
from beat_tpu.parameter import Parameter as JParameter
from beat_tpu.parameter import PriorSet as JPriorSet
from beat_tpu.sources import DCSource as JDCSource
from beat_tpu.sources import RectangularSource as JRectangularSource
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.models.geodetic import GeodeticGeometryComposite
from beat_tpu_torch.models.problem import Problem
from beat_tpu_torch.models.seismic import SeismicGeometryComposite
from beat_tpu_torch.parameter import Parameter, PriorSet
from beat_tpu_torch.samplers import (MetropolisState, PTParams, hmc_step, make_betas,
                                     mala_step, metropolis_step, pt_sample,
                                     run_metropolis_stage, swap_step, tune_temp_scale)
from beat_tpu_torch.sources import DCSource, RectangularSource
from test_torch_geodetic import jax_correction, jax_dataset
from test_torch_geometry import _jax_wavemap
from test_torch_okada import jax_x64

# the JAX package's per-chain llk bar (tests/test_float32_llk.py:101), on
# the joint llk (its JAX side in float64 where the points are, as
# tests/test_torch_geodetic.py evaluates the geodetic forward)
LLK_RTOL = 2e-5
# tests/test_samplers.py::TestPT: PT with few chains, posterior mean |x|
MOMENT_ATOL = 0.08

N_DIM = 4
MU1 = np.ones(N_DIM) * 0.5
STDEV = 0.1
LOWER, UPPER = -2.0 * np.ones(N_DIM), 2.0 * np.ones(N_DIM)


def torch_mixture(x):
    """tests/test_samplers.py's 4-D two-Gaussian mixture (weights 0.1/0.9),
    batched over chains."""
    mu1 = torch.as_tensor(MU1, dtype=x.dtype)
    log_norm = -0.5 * N_DIM * math.log(2 * math.pi) - 0.5 * N_DIM * math.log(STDEV**2)
    l1 = log_norm - 0.5 * ((x - mu1) ** 2).sum(-1) / STDEV**2
    l2 = log_norm - 0.5 * ((x + mu1) ** 2).sum(-1) / STDEV**2
    return torch.logaddexp(math.log(STDEV) + l1, math.log(1.0 - STDEV) + l2)


def jax_mixture(x):
    mu1 = jnp.asarray(MU1, dtype=jnp.float32)
    log_norm = -0.5 * N_DIM * jnp.log(2 * jnp.pi) - 0.5 * N_DIM * jnp.log(STDEV**2)
    l1 = log_norm - 0.5 * jnp.sum((x - mu1) ** 2) / STDEV**2
    l2 = log_norm - 0.5 * jnp.sum((x + mu1) ** 2) / STDEV**2
    return jnp.logaddexp(jnp.log(STDEV) + l1, jnp.log(1.0 - STDEV) + l2)


# -- the ladder and the exchange --------------------------------------------------


@pytest.mark.parametrize("n,n_post,scale", [(8, 2, 1.2), (64, 16, 1.7), (5, 4, 2.0)])
def test_betas_match_jax(n, n_post, scale):
    np.testing.assert_array_equal(make_betas(n, n_post, scale), jpt.make_betas(n, n_post, scale))


def test_temperature_tuning_matches_jax():
    for acc in (0.0, 0.0005, 0.001, 0.03, 0.05, 0.1, 0.2, 0.35, 0.5, 0.6, 0.75, 0.8, 0.95, 0.99):
        assert tune_temp_scale(1.3, acc) == jpt.tune_temp_scale(1.3, acc), acc


@pytest.mark.parametrize("n", [7, 8])
@pytest.mark.parametrize("parity", [0, 1])
def test_swap_matches_jax_on_its_uniforms(n, parity):
    """The exchange on the uniforms ``_swap_step`` draws from its key:
    the same permutation and bookkeeping, exactly."""
    rng = np.random.default_rng(10 * n + parity)
    n_post = 2
    for trial in range(6):
        q = rng.normal(size=(n, 3)).astype(np.float32)
        llk = (rng.normal(size=n) * 2.0).astype(np.float32)
        betas = make_betas(n, n_post, 1.3).astype(np.float32)
        key = jax.random.PRNGKey(trial)
        log_u = np.asarray(jnp.log(jax.random.uniform(key, (n,))))
        want = [np.asarray(x) for x in jpt._swap_step(
            jnp.asarray(q), jnp.asarray(llk), jnp.asarray(betas), key, parity, n_post)]
        got = [x.numpy() for x in swap_step(torch.as_tensor(q), torch.as_tensor(llk),
                                            torch.as_tensor(betas), torch.tensor(log_u),
                                            parity)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert want[3].any()


# -- per-chain β and tuning across segments ------------------------------------------


def _state(n, seed=0):
    q = torch.as_tensor(np.random.default_rng(seed).uniform(-1, 1, (n, N_DIM)),
                        dtype=torch.float32)
    return MetropolisState(q=q, llk=torch_mixture(q), scaling=torch.full((n,), 0.3),
                           accepted=torch.zeros(n), acc_total=torch.zeros(n))


@pytest.mark.parametrize("proposal", ["MultivariateNormal", "MALA", "HMC"])
def test_beta_vector_of_ones_is_the_scalar_path(proposal):
    """A β vector of ones gives the scalar β = 1 path's draws bit for bit."""
    n = 6
    chol = torch.eye(N_DIM) * 0.5
    lo, hi = torch.as_tensor(LOWER, dtype=torch.float32), torch.as_tensor(UPPER,
                                                                           dtype=torch.float32)
    runs = []
    for beta in (1.0, torch.ones(n)):
        final, (q_tr, llk_tr) = run_metropolis_stage(
            torch_mixture, _state(n), beta, chol, lo, hi, n_steps=12,
            generator=torch.Generator().manual_seed(3), proposal_name=proposal,
            tune_interval=5, n_leapfrog=3)
        runs.append((q_tr, llk_tr, final.scaling))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", ["random_walk", "mala", "hmc"])
def test_beta_vector_rows_are_their_scalar_paths(kernel):
    """Each chain of a mixed β vector moves as a scalar-β step of the same
    injected noise moves it: the vector broadcasts per chain, never
    across chains."""
    n = 6
    betas = torch.tensor([1.0, 1.0, 0.5, 0.25, 0.125, 0.0625])
    chol = torch.eye(N_DIM) * 0.5
    lo, hi = torch.as_tensor(LOWER, dtype=torch.float32), torch.as_tensor(UPPER,
                                                                           dtype=torch.float32)
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.normal(size=(n, N_DIM)), dtype=torch.float32)
    u = torch.as_tensor(rng.uniform(size=n), dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    state = _state(n, seed=1)
    grad = torch.autograd.functional.jacobian(lambda x: torch_mixture(x).sum(), state.q)

    def step(beta):
        if kernel == "random_walk":
            return metropolis_step(torch_mixture, state, 1, beta, chol, lo, hi, gen,
                                   noise=(z, u)), None
        fn = mala_step if kernel == "mala" else hmc_step
        kw = {} if kernel == "mala" else dict(n_leapfrog=3)
        return fn(torch_mixture, state, grad, 1, beta, chol, lo, hi, gen, noise=(z, u), **kw)

    got, got_grad = step(betas)
    if kernel != "random_walk":         # the drift and the kicks see β
        assert not torch.equal(got.q, step(1.0)[0].q)
    for b in torch.unique(betas):
        rows = betas == b
        want, want_grad = step(float(b))
        assert torch.equal(got.q[rows], want.q[rows]) and torch.equal(got.llk[rows],
                                                                      want.llk[rows])
        if got_grad is not None:
            assert torch.equal(got_grad[rows], want_grad[rows])


def test_step_offset_tunes_across_segments():
    """tests/test_samplers.py::test_step_offset_enables_segmented_tuning:
    3 segments of 4 steps cross global step 10 of a 10-step interval."""
    n = 8
    state = _state(n)
    chol = torch.eye(N_DIM) * 100.0                # acceptance ~0: the factor is 0.1
    lo, hi = torch.as_tensor(LOWER, dtype=torch.float32), torch.as_tensor(UPPER,
                                                                           dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for tune, offsets in ((False, (0, 4, 8)), (True, (0, 0, 0)), (True, (0, 4, 8))):
        s = state
        for offset in offsets:
            s, _ = run_metropolis_stage(torch_mixture, s, 1.0, chol, lo, hi, n_steps=4,
                                        generator=gen, tune_interval=10, tune=tune,
                                        step_offset=offset)
        tuned = bool((s.scaling < 0.3).all())
        assert tuned == (tune and offsets[-1] == 8), (tune, offsets)


# -- PT as a whole ----------------------------------------------------------------------


def test_two_gaussians_match_jax():
    """tests/test_samplers.py::TestPT in both packages: the posterior mean
    of |x| at the modes' 0.5, within that test's atol."""
    params = dict(n_chains=8, n_chains_posterior=2, n_samples=12000, swap_interval=(10, 16),
                  beta_tune_interval=2000, seed=11)
    q_tr, llk_tr, history = pt_sample(torch_mixture, LOWER, UPPER, PTParams(**params),
                                      device="cpu")
    jq, _, jhistory = jpt.pt_sample(jax_mixture, LOWER, UPPER, jpt.PTParams(**params))
    assert q_tr.shape == jq.shape and np.isfinite(llk_tr).all()
    for q in (q_tr, jq):
        x = q[q.shape[0] // 2:].reshape(-1, N_DIM)
        np.testing.assert_allclose(np.abs(x).mean(axis=0), MU1, rtol=0.0, atol=MOMENT_ATOL)
    for h in (history, jhistory):
        assert h["betas"][0] == 1.0 and np.all(np.diff(h["betas"]) <= 0)
    assert len(history["scale_history"]) == len(jhistory["scale_history"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_stage_files_read_both_ways(tmp_path, writer):
    params = dict(n_chains=6, n_chains_posterior=2, n_samples=120, swap_interval=(10, 16),
                  beta_tune_interval=40, record_worker_chains=True, seed=2)
    names = [("x", (N_DIM,))]
    if writer == "port":
        pt_sample(torch_mixture, LOWER, UPPER, PTParams(**params), device="cpu",
                  homepath=str(tmp_path), ordering=beat_tpu_torch.utility.Ordering(names))
        reader = beat_tpu.backend.SampleStage(str(tmp_path),
                                              ordering=beat_tpu.utility.Ordering(names))
    else:
        jpt.pt_sample(jax_mixture, LOWER, UPPER, jpt.PTParams(**params), homepath=str(tmp_path),
                      ordering=beat_tpu.utility.Ordering(names))
        reader = beat_tpu_torch.backend.SampleStage(
            str(tmp_path), ordering=beat_tpu_torch.utility.Ordering(names))
    trace, state = reader.load_trace(-1), reader.load_state(-1)
    n_draws = trace.q_trace.shape[0]
    assert trace.q_trace.shape == (n_draws, 2, N_DIM) and trace.varnames == ["x"]
    assert state["beta"] == 1.0 and state["betas"].shape == (6,)
    assert state["betas"][1] == 1.0 and state["betas"][2] < 1.0
    assert len(state["scale_history"]) == len(state["swap_acceptance"]) + 1 > 1
    assert state["worker_q"].shape == (n_draws, 4, N_DIM)
    assert state["worker_llk"].shape == (n_draws, 4)
    assert state["population"].shape == (6, N_DIM)


# -- the joint likelihood ----------------------------------------------------------------


def _assert_joint_llk_close(pprob, jprob, n=16, seed=4):
    lo, hi = pprob.priors.bounds_arrays()
    span = hi - lo
    q = np.random.default_rng(seed).uniform(lo + 0.02 * span, hi - 0.02 * span,
                                            size=(n, lo.size))
    # durations off the half-sinusoid STF's removable poles (w·d = π at a
    # table frequency), where float32 cancellation differs between the packages
    if "duration" in pprob.ordering.names:
        freqs = pprob.composites["seismic"].tables[0].freqs.numpy()
        d = q[:, pprob.ordering["duration"].slc]
        near = (np.abs(2.0 * freqs * d[..., None] - 1.0) < 2e-3).any(-1)
        q[:, pprob.ordering["duration"].slc] = np.where(near, d * 1.005, d)
    q = q.astype(np.float32)
    logp, data = pprob.make_logp_fn()
    with torch.no_grad():
        got = logp(torch.as_tensor(q), data).double().numpy()
    with jax_x64():
        jlogp, jdata = jprob.make_logp_fn()
        want = np.asarray(jax.jit(jax.vmap(jlogp, in_axes=(0, None)))(
            jnp.asarray(q.astype(np.float64)), jdata))
    seis, jseis = pprob.composites["seismic"], jprob.composites["seismic"]
    assert pprob.ordering.names == jprob.ordering.names
    assert seis.get_hypernames() == jseis.get_hypernames()
    assert np.isfinite(got).all()
    bar = LLK_RTOL * np.abs(want)
    worst = int(np.argmax(np.abs(got - want) / bar))
    assert (np.abs(got - want) <= bar).all(), (worst, got[worst], want[worst], bar[worst])


def test_joint_llk_of_test_joint_problem_matches_jax():
    """tests/test_joint.py:27-64's problem: a DCSource waveform composite
    and a RectangularSource InSAR composite sharing strike and slip."""
    from tests.test_joint import TRUE_SLIP
    from tests.test_seismic import TRUE_DEPTH, TRUE_MAG, TRUE_SDR, make_wavemap

    jtable = jax_build_table(distances=np.linspace(20e3, 120e3, 11),
                             depths=np.linspace(2e3, 20e3, 5), nt=256, dt=0.25)
    jwmap = make_wavemap(jtable, seed=1)
    rng = np.random.default_rng(2)
    e = np.linspace(-15e3, 15e3, 10)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    rect = dict(depth=TRUE_DEPTH, **TRUE_SDR, length=8e3, width=4e3, slip=TRUE_SLIP)
    disp = np.asarray(JRectangularSource(**rect).surface_displacement(jnp.asarray(coords)))
    los = np.tile([-0.6, 0.1, 0.79], (coords.shape[0], 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    obs = (disp * los).sum(1)
    sd = 0.01 * max(np.abs(obs).max(), 1e-9)
    obs = obs + rng.normal(0, sd, obs.shape)
    scene = JDataset(name="ifg", typ="SAR", coords=coords, displacement=obs, los_vector=los,
                     covariance=JCovariance(data=np.eye(obs.size) * sd**2))
    dc = dict(depth=TRUE_DEPTH, **TRUE_SDR, magnitude=TRUE_MAG, duration=1.5)
    jpriors = JPriorSet()
    jpriors.add(JParameter("strike", [10.0], [70.0]))
    jpriors.add(JParameter("slip", [0.2], [3.0]))
    jprob = JProblem(jpriors, {"seismic": JSeisComposite([jwmap], [JDCSource(**dc)]),
                               "geodetic": JGeoComposite([scene], [JRectangularSource(**rect)])})

    ptable = convert.greens_table_from_numpy(
        np.asarray(jtable.spectra), jtable.distances, jtable.depths, jtable.dt, jtable.nt,
        jtable.t0, jtable.vp, jtable.vs, jtable.rho, jtable.tt_p, jtable.tt_s, device="cpu")
    pwmap = convert.wavemap_from_jax(jwmap, ptable)
    pscene = convert.geodetic_dataset_from_numpy("ifg", "SAR", coords, obs, los,
                                                 covariance=np.eye(obs.size) * sd**2)
    priors = PriorSet().add(Parameter("strike", [10.0], [70.0])).add(
        Parameter("slip", [0.2], [3.0]))
    pprob = Problem(priors, {
        "seismic": SeismicGeometryComposite([pwmap], [DCSource(**dc)], device="cpu"),
        "geodetic": GeodeticGeometryComposite([pscene], [RectangularSource(**rect)],
                                              device="cpu")}, device="cpu")
    assert {"h_any_P_0", "h_SAR"} <= set(pprob.ordering.names)
    _assert_joint_llk_close(pprob, jprob)


def test_joint_flagship_llk_matches_jax():
    """The flagship's joint problem (JOINT_TEST_SIZE): the rectangle behind
    both data types, its patches in the waveform composite."""
    pprob = flagship.build_joint_flagship(**flagship.JOINT_TEST_SIZE, seed=3, device="cpu")
    seis, geo = pprob.composites["seismic"], pprob.composites["geodetic"]
    tables = {}
    jwmaps = [_jax_wavemap(w, tables) for w in seis.wavemaps]
    jrect = {k: v for k, v in seis.sources[0].to_dict().items() if k != "type"}
    jgeo_rect = {k: v for k, v in geo.sources[0].to_dict().items() if k != "type"}
    jpriors = JPriorSet()
    for p in pprob.source_priors.parameters.values():
        jpriors.add(JParameter(p.name, p.lower, p.upper))
    jprob = JProblem(jpriors, {
        "seismic": JSeisComposite(jwmaps, [JRectangularSource(**jrect)],
                                  finite_patches=seis.finite_patches),
        "geodetic": JGeoComposite([jax_dataset(ds) for ds in geo.datasets],
                                  [JRectangularSource(**jgeo_rect)],
                                  corrections=[jax_correction(c) for c in geo.corrections])})
    _assert_joint_llk_close(pprob, jprob)
    # the rectangle behind the data beats one moved by 2 km
    logp, data = pprob.make_logp_fn()
    true = pprob.point_to_array(pprob.true_point)
    moved = pprob.point_to_array(dict(pprob.true_point,
                                      east_shift=pprob.true_point["east_shift"] + 2e3))
    with torch.no_grad():
        llk = logp(torch.as_tensor(np.stack([true, moved]), dtype=torch.float32), data)
    assert llk[0] > llk[1]
