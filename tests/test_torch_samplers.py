"""
The port's samplers (``beat_tpu_torch.samplers``) against the JAX
package's: the tuning table, the host float64 SMC transitions, one
lockstep Metropolis, MALA and HMC step under the same injected random
numbers, the stationary distributions of MALA and HMC, and SMC (random
walk, MALA, HMC) on a Gaussian-mixture toy with stages the JAX package's
backend reads.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.backend import SampleStage
from beat_tpu.samplers import smc as jsmc
from beat_tpu.samplers.base import mv_normal_proposal as jax_mv_normal
from beat_tpu.samplers.metropolis import MetropolisState as JaxState
from beat_tpu.samplers.metropolis import _make_hmc_step as jax_make_hmc_step
from beat_tpu.samplers.metropolis import _make_mala_step as jax_make_mala_step
from beat_tpu.samplers.metropolis import _make_step as jax_make_step
from beat_tpu.samplers.metropolis import tune_scale as jax_tune_scale
from beat_tpu_torch.samplers import (MetropolisParams, MetropolisState, SMCParams, calc_beta,
                                     calc_covariance, hmc_step, mala_step, metropolis_step,
                                     run_metropolis_stage, smc_sample, systematic_resample,
                                     tune_scale)
import test_torch_common  # noqa: F401  (the tests' thread policy)

N_DIM = 4
MU1 = np.full(N_DIM, 0.5)
STDEV = 0.1
LOWER, UPPER = -2.0 * np.ones(N_DIM), 2.0 * np.ones(N_DIM)


def mixture_logp(x):
    """Batched 4-D two-Gaussian mixture (weights 0.1/0.9, modes ±0.5),
    the reference SMC test's target (tests/test_samplers.py:32)."""
    mu = torch.as_tensor(MU1, dtype=x.dtype)
    log_norm = -0.5 * N_DIM * np.log(2 * np.pi) - N_DIM * np.log(STDEV)
    l1 = log_norm - 0.5 * torch.sum((x - mu) ** 2, dim=-1) / STDEV**2
    l2 = log_norm - 0.5 * torch.sum((x + mu) ** 2, dim=-1) / STDEV**2
    return torch.logaddexp(np.log(STDEV) + l1, np.log(1 - STDEV) + l2)


def test_tune_scale_table_matches_jax():
    acc = np.array([0.0, 0.0005, 0.001, 0.03, 0.05, 0.1, 0.2, 0.3, 0.5, 0.6, 0.75, 0.8,
                    0.95, 0.99, 1.0], dtype=np.float32)
    scale = np.linspace(0.5, 2.0, acc.size).astype(np.float32)
    got = tune_scale(torch.as_tensor(scale), torch.as_tensor(acc)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_tune_scale(jnp.asarray(scale),
                                                                 jnp.asarray(acc))))


def test_smc_host_transitions_are_bit_identical():
    rng = np.random.default_rng(0)
    llks = rng.normal(-500, 40, 64)
    pop = rng.normal(size=(64, 5))
    assert calc_beta(0.1, llks, 1.0)[0] == jsmc.calc_beta(0.1, llks, 1.0)[0]
    _, _, w = calc_beta(0.1, llks, 1.0)
    np.testing.assert_array_equal(w, jsmc.calc_beta(0.1, llks, 1.0)[2])
    np.testing.assert_array_equal(calc_covariance(pop, w), jsmc.calc_covariance(pop, w))
    np.testing.assert_array_equal(systematic_resample(w, np.random.default_rng(3)),
                                  jsmc.systematic_resample(w, np.random.default_rng(3)))


@pytest.mark.parametrize("step_idx", [3, 10])   # 10 retunes (tune_interval 5)
def test_metropolis_step_matches_jax_under_injected_noise(step_idx):
    n, beta, tune_interval = 32, 0.37, 5
    rng = np.random.default_rng(step_idx)
    q = rng.uniform(-1, 1, (n, N_DIM)).astype(np.float32)
    q[:3] = [1.95, -1.95, 0.0, 1.99]                    # steps out of the box
    cov_chol = np.linalg.cholesky(np.diag([0.3, 0.2, 0.25, 0.4]) + 0.01).astype(np.float32)
    scaling = rng.uniform(0.5, 2, n).astype(np.float32)
    accepted = rng.integers(0, tune_interval + 1, n).astype(np.float32)
    acc_total = rng.integers(0, 9, n).astype(np.float32)
    lo, hi = LOWER.astype(np.float32), UPPER.astype(np.float32)

    llk = mixture_logp(torch.as_tensor(q)).numpy()
    key = jax.random.PRNGKey(42)
    # the JAX step's own draws, split exactly as metropolis.py:119,132,142
    _, k_prop, k_acc = jax.random.split(key, 3)
    z = np.array(jax.random.normal(k_prop, (n, N_DIM)))
    u = np.array(jax.random.uniform(k_acc, (n,)))

    def jlogp(x):   # the same mixture written in jnp
        mu = jnp.asarray(MU1, dtype=jnp.float32)
        log_norm = -0.5 * N_DIM * np.log(2 * np.pi) - N_DIM * np.log(STDEV)
        l1 = log_norm - 0.5 * jnp.sum((x - mu) ** 2) / STDEV**2
        l2 = log_norm - 0.5 * jnp.sum((x + mu) ** 2) / STDEV**2
        return jnp.logaddexp(np.log(STDEV) + l1, np.log(1 - STDEV) + l2)

    step = jax_make_step(jlogp, jnp.asarray(lo), jnp.asarray(hi), jax_mv_normal,
                         tune_interval, True)
    jstate = JaxState(q=jnp.asarray(q), llk=jnp.asarray(llk), scaling=jnp.asarray(scaling),
                      accepted=jnp.asarray(accepted), acc_total=jnp.asarray(acc_total),
                      key=key)
    jnew, _ = jax.jit(step)(jstate, step_idx, jnp.float32(beta), jnp.asarray(cov_chol))

    t = torch.as_tensor
    state = MetropolisState(q=t(q), llk=t(llk), scaling=t(scaling), accepted=t(accepted),
                            acc_total=t(acc_total))
    new = metropolis_step(mixture_logp, state, step_idx, beta, t(cov_chol), t(lo), t(hi),
                          generator=None, tune_interval=tune_interval, noise=(t(z), t(u)))
    accept = (new.acc_total - state.acc_total).numpy()
    np.testing.assert_array_equal(accept, np.asarray(jnew.acc_total) - acc_total)
    assert 0 < accept.sum() < n
    np.testing.assert_array_equal(new.scaling.numpy(), np.asarray(jnew.scaling))
    np.testing.assert_array_equal(new.accepted.numpy(), np.asarray(jnew.accepted))
    # positions and llks: equal up to one float32 ulp of the two
    # frameworks' (n, 4) @ (4, 4) proposal matmul and mixture arithmetic
    np.testing.assert_allclose(new.q.numpy(), np.asarray(jnew.q), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new.llk.numpy(), np.asarray(jnew.llk), rtol=1e-6, atol=1e-5)


def test_thinned_stage_records_and_runs_every_step():
    gen = torch.Generator().manual_seed(0)
    q0 = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (8, N_DIM)),
                         dtype=torch.float32)
    state = MetropolisState(q=q0, llk=mixture_logp(q0), scaling=torch.ones(8),
                            accepted=torch.zeros(8), acc_total=torch.zeros(8))
    final, (q_tr, llk_tr) = run_metropolis_stage(
        mixture_logp, state, 1.0, torch.eye(N_DIM) * 0.1, torch.as_tensor(LOWER).float(),
        torch.as_tensor(UPPER).float(), n_steps=7, generator=gen, record_every=3)
    assert q_tr.shape == (3, 8, N_DIM) and llk_tr.shape == (3, 8)   # steps 3, 6, 7
    torch.testing.assert_close(q_tr[-1], final.q, rtol=0, atol=0)
    torch.testing.assert_close(llk_tr[-1], mixture_logp(final.q))


def test_smc_recovers_mixture_and_writes_jax_readable_stages(tmp_path):
    from beat_tpu.utility import Ordering

    ordering = Ordering([("x", (N_DIM,))])
    home = str(tmp_path / "smc")
    params = SMCParams(n_chains=100, n_steps=100, tune_interval=25, seed=123)
    q_tr, llk_tr = smc_sample(lambda q: mixture_logp(q), LOWER, UPPER, params,
                              device="cpu", homepath=home, ordering=ordering)
    x = q_tr[-1]
    # the reference SMC bar (BASELINE.md, tests/test_samplers.py:64)
    np.testing.assert_allclose(np.abs(x).mean(axis=0), MU1, rtol=0, atol=0.03)
    trace = SampleStage(home, ordering=ordering).load_trace(-1)
    np.testing.assert_array_equal(trace.q_trace, q_tr)
    np.testing.assert_array_equal(trace.llk_trace, llk_tr)
    state = SampleStage(home, ordering=ordering).load_state(-1)
    assert state["beta"] == 1.0 and np.isfinite(state["log_evidence"])
    # a resumed run finds the final stage and returns it
    q2, _ = smc_sample(lambda q: mixture_logp(q), LOWER, UPPER,
                       SMCParams(n_chains=100, n_steps=100, seed=123, stage=-1),
                       device="cpu", homepath=home, ordering=ordering)
    np.testing.assert_array_equal(q2, q_tr)


GAUSS_COV = np.array([[0.04, 0.018], [0.018, 0.02]])
GAUSS_MU = np.array([0.7, -0.4])


def _gauss_logp(mu, cov):
    """Batched Gaussian log-density (unnormalised) in torch and, per
    chain, in jnp: the same target in both frameworks."""
    icov = np.linalg.inv(cov).astype(np.float32)
    t_mu, t_icov = torch.as_tensor(mu, dtype=torch.float32), torch.as_tensor(icov)

    def logp(x):
        d = x - t_mu
        return -0.5 * torch.einsum("ni,ij,nj->n", d, t_icov, d)

    def jlogp(x):
        d = x - jnp.asarray(mu, dtype=jnp.float32)
        return -0.5 * d @ jnp.asarray(icov) @ d

    return logp, jlogp


@pytest.mark.parametrize("kernel", ["MALA", "HMC"])
@pytest.mark.parametrize("step_idx", [3, 10])   # 10 retunes (tune_interval 5)
def test_gradient_step_matches_jax_under_injected_noise(kernel, step_idx):
    n, beta, tune_interval, n_leapfrog = 48, 0.6, 5, 3
    rng = np.random.default_rng(step_idx)
    mu = np.array([0.3, -0.2, 0.1, 0.5])
    cov = np.diag([0.05, 0.08, 0.04, 0.06]) + 0.01
    logp, jlogp = _gauss_logp(mu, cov)
    q = rng.uniform(-1, 1, (n, N_DIM)).astype(np.float32)
    q[:3] = [1.9, -1.9, 0.0, 1.95]                       # steps out of the box
    cov_chol = np.linalg.cholesky(np.diag([0.05, 0.04, 0.03, 0.06]) + 0.005).astype(np.float32)
    # HMC conserves energy on a Gaussian: only long steps make it reject
    scaling = rng.uniform(0.3, 1.5 if kernel == "MALA" else 4.0, n).astype(np.float32)
    accepted = rng.integers(0, tune_interval + 1, n).astype(np.float32)
    acc_total = rng.integers(0, 9, n).astype(np.float32)
    lo, hi = LOWER.astype(np.float32), UPPER.astype(np.float32)
    t = torch.as_tensor
    q_t = t(q).requires_grad_()
    llk_t = logp(q_t)
    (grad,) = torch.autograd.grad(llk_t.sum(), q_t)
    llk, grad = llk_t.detach().numpy(), grad.numpy()

    key = jax.random.PRNGKey(7)
    # the JAX step's own draws, split exactly as metropolis.py:195,214,224
    # (MALA) and :283,301,327 (HMC)
    _, k_noise, k_acc = jax.random.split(key, 3)
    xi = np.array(jax.random.normal(k_noise, (n, N_DIM), jnp.float32))
    u = np.array(jax.random.uniform(k_acc, (n,)))
    if kernel == "MALA":
        jstep, _ = jax_make_mala_step(jlogp, jnp.asarray(lo), jnp.asarray(hi), tune_interval,
                                      True)
    else:
        jstep, _ = jax_make_hmc_step(jlogp, jnp.asarray(lo), jnp.asarray(hi), tune_interval,
                                     True, n_leapfrog=n_leapfrog)
    jstate = JaxState(q=jnp.asarray(q), llk=jnp.asarray(llk), scaling=jnp.asarray(scaling),
                      accepted=jnp.asarray(accepted), acc_total=jnp.asarray(acc_total),
                      key=key)
    (jnew, jgrad), _ = jax.jit(jstep)((jstate, jnp.asarray(grad)), step_idx,
                                      jnp.float32(beta), jnp.asarray(cov_chol))

    state = MetropolisState(q=t(q), llk=t(llk), scaling=t(scaling), accepted=t(accepted),
                            acc_total=t(acc_total))
    args = (logp, state, t(grad), step_idx, beta, t(cov_chol), t(lo), t(hi), None,
            tune_interval)
    if kernel == "MALA":
        new, new_grad = mala_step(*args, noise=(t(xi), t(u)))
    else:
        new, new_grad = hmc_step(*args, n_leapfrog=n_leapfrog, noise=(t(xi), t(u)))
    accept = (new.acc_total - state.acc_total).numpy()
    np.testing.assert_array_equal(accept, np.asarray(jnew.acc_total) - acc_total)
    assert 0 < accept.sum() < n
    np.testing.assert_array_equal(new.accepted.numpy(), np.asarray(jnew.accepted))
    # float32 arithmetic in two frameworks (matmul order, exp of the retune)
    np.testing.assert_allclose(new.scaling.numpy(), np.asarray(jnew.scaling), rtol=1e-6)
    np.testing.assert_allclose(new.q.numpy(), np.asarray(jnew.q), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new.llk.numpy(), np.asarray(jnew.llk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(new_grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kernel,n_steps,burn,acc_range", [("MALA", 400, 200, (0.3, 0.9)),
                                                           ("HMC", 200, 100, (0.35, 0.95))])
def test_gradient_kernel_targets_the_gaussian(kernel, n_steps, burn, acc_range):
    """The stationary distribution is right: both moments of a correlated
    2-D Gaussian (tests/test_samplers.py:219-249, 297-328, half the steps)."""
    logp, _ = _gauss_logp(GAUSS_MU, GAUSS_COV)
    n = 256
    q0 = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (n, 2)), dtype=torch.float32)
    state = MetropolisState(q=q0, llk=logp(q0), scaling=torch.ones(n),
                            accepted=torch.zeros(n), acc_total=torch.zeros(n))
    final, (q_tr, _) = run_metropolis_stage(
        logp, state, 1.0, torch.eye(2) * 0.2, torch.full((2,), -3.0), torch.full((2,), 3.0),
        n_steps=n_steps, generator=torch.Generator().manual_seed(1), proposal_name=kernel,
        tune_interval=50, n_leapfrog=5)
    draws = q_tr[burn:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(draws.mean(axis=0), GAUSS_MU, atol=0.02)
    np.testing.assert_allclose(np.cov(draws.T), GAUSS_COV, atol=0.01)
    acc = final.acc_total.numpy() / n_steps
    assert acc_range[0] < acc.mean() < acc_range[1]          # retuned toward the optimum


def _lag1(logp, q0, chol, lo, hi, name, n_steps, coord, n_leapfrog=8):
    """Mean lag-1 autocorrelation of one coordinate over the second half."""
    state = MetropolisState(q=q0, llk=logp(q0), scaling=torch.ones(q0.shape[0]),
                            accepted=torch.zeros(q0.shape[0]),
                            acc_total=torch.zeros(q0.shape[0]))
    _, (q_tr, _) = run_metropolis_stage(
        logp, state, 1.0, chol, lo, hi, n_steps=n_steps,
        generator=torch.Generator().manual_seed(3), proposal_name=name, tune_interval=50,
        n_leapfrog=n_leapfrog)
    x = q_tr[n_steps // 2:, :, coord].numpy()
    x = x - x.mean(axis=0)
    return float(np.mean((x[1:] * x[:-1]).sum(axis=0) / (x * x).sum(axis=0)))


def test_mala_beats_random_walk_and_hmc_beats_mala():
    """Why gradients at all: in a 32-D Gaussian MALA's draws decorrelate
    faster than the random walk's, and in a badly scaled 16-D Gaussian an
    8-step HMC transition faster than MALA's (tests/test_samplers.py:251-
    279, 330-362, fewer steps)."""
    rng = np.random.default_rng(2)
    q0 = torch.as_tensor(rng.normal(0, 0.1, (64, 32)), dtype=torch.float32)
    box = torch.full((32,), 2.0)

    def iso(x):
        return -0.5 * torch.sum(x * x, dim=-1) / 0.01

    args = (iso, q0, torch.eye(32) * 0.1, -box, box)
    r_mala, r_rw = _lag1(*args, "MALA", 400, 0), _lag1(*args, "MultivariateNormal", 400, 0)
    assert r_mala < r_rw - 0.05, (r_mala, r_rw)

    scales = torch.as_tensor(np.geomspace(0.05, 0.5, 16), dtype=torch.float32)

    def skewed(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    q0 = torch.as_tensor(rng.normal(0, 0.05, (64, 16)), dtype=torch.float32)
    box = torch.full((16,), 4.0)
    args = (skewed, q0, torch.eye(16) * 0.1, -box, box)
    r_hmc, r_mala = _lag1(*args, "HMC", 300, -1), _lag1(*args, "MALA", 300, -1)
    assert r_hmc < r_mala - 0.05, (r_hmc, r_mala)


@pytest.mark.parametrize("kernel,n_chains,seed", [("MALA", 100, 5), ("HMC", 128, 9)])
def test_smc_with_gradient_kernel_recovers_mixture(tmp_path, kernel, n_chains, seed):
    """Staged SMC runs MALA and HMC end to end (tests/test_samplers.py:281-
    291, 364-374): the mixture's mode location within the reference bar."""
    params = SMCParams(n_chains=n_chains, n_steps=60, tune_interval=20, seed=seed,
                       proposal_name=kernel, n_leapfrog=5)
    q_tr, _ = smc_sample(mixture_logp, LOWER, UPPER, params, device="cpu",
                         homepath=str(tmp_path / kernel))
    np.testing.assert_allclose(np.abs(q_tr[-1]).mean(axis=0), MU1, rtol=0, atol=0.03)


@pytest.mark.parametrize("kernel", ["MultivariateNormal", "MALA"])
def test_metropolis_sample_through_problem(tmp_path, kernel):
    """``Problem.sample(MetropolisParams)`` runs the single-stage sampler on
    the flagship, burns in, thins, and saves the final stage in the JAX
    package's format."""
    from beat_tpu_torch.flagship import TEST_SIZE, build_flagship

    problem = build_flagship(**TEST_SIZE, seed=1, device="cpu",
                             outfolder=str(tmp_path / "metropolis"))
    q_tr, llk_tr = problem.sample(MetropolisParams(n_chains=8, n_steps=20, burn=0.1, thin=2,
                                                   tune_interval=5, proposal_name=kernel))
    dim = len(problem.ordering.names)
    assert q_tr.shape == (9, 8, dim) and llk_tr.shape == (9, 8)     # steps 2, 4, ..., 18
    assert np.isfinite(llk_tr).all()
    lower, upper = problem.priors.bounds_arrays()
    assert ((q_tr >= lower) & (q_tr <= upper)).all()
    trace = SampleStage(problem.outfolder, ordering=problem.ordering).load_trace(-1)
    np.testing.assert_array_equal(trace.q_trace, q_tr)
