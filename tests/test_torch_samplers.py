"""
The port's samplers (``beat_tpu_torch.samplers``) against the JAX
package's: the tuning table, the host float64 SMC transitions, one
lockstep Metropolis step under the same injected random numbers, and SMC
on a Gaussian-mixture toy with stages the JAX package's backend reads.
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
from beat_tpu.samplers.metropolis import _make_step as jax_make_step
from beat_tpu.samplers.metropolis import tune_scale as jax_tune_scale
from beat_tpu_torch.samplers import (MetropolisState, SMCParams, calc_beta, calc_covariance,
                                     metropolis_step, run_metropolis_stage, smc_sample,
                                     systematic_resample, tune_scale)

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
