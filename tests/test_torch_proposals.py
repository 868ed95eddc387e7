"""
The port's proposal catalog against the JAX package's on the CPU.

torch's generator cannot reproduce JAX's random bits, so each proposal
is held two ways: its transform of standard draws, fed the draws the
JAX proposal makes from its key (the same ``split`` of the key, the
same distributions), must give the JAX proposal's steps; and its own
draws must have the statistics ``tests/test_proposals.py`` asserts of
the JAX catalog: shape, zero centre, the requested covariance, heavier
tails than the normal, integer steps, determinism by seed.  A lockstep
Metropolis stage then takes each of them by name.

Bars: the transforms are a few float32 operations, rtol 1e-6 (Cauchy
and Laplace draws pass through ``tan`` and ``log1p`` in the JAX package
only, so they are injected as such); the integer steps are equal
exactly; the statistics are those of ``tests/test_proposals.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.samplers.base import proposal_catalog as jax_catalog
from beat_tpu_torch.samplers.base import choose_proposal, proposal_catalog
from beat_tpu_torch.samplers.metropolis import init_metropolis_state, run_metropolis_stage
import test_torch_common  # noqa: F401  (the tests' thread policy)

DIM = 3
N = 20000


@pytest.fixture(scope="module")
def cov_chol():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(DIM, DIM)) * 0.3
    cov = A @ A.T + np.eye(DIM)
    return np.linalg.cholesky(cov).astype(np.float32), cov


def _jax_noise(name, key, n, chol):
    """The standard draws the JAX proposal ``name`` makes from ``key``."""
    if name in ("Normal", "MultivariateNormal"):
        return jax.random.normal(key, (n, DIM))
    if name == "Cauchy":
        return jax.random.cauchy(key, (n, DIM))
    if name == "Laplace":
        return jax.random.laplace(key, (n, DIM))
    if name == "DiscreteBoundedUniform":
        return jax.random.uniform(key, (n, DIM))
    kz, kg = jax.random.split(key)
    if name == "MultivariateCauchy":
        return jax.random.normal(kz, (n, DIM)), jax.random.normal(kg, (n, 1))
    if name == "MultivariateStudentT":
        return jax.random.normal(kz, (n, DIM)), jax.random.gamma(kg, 5.0 / 2.0, (n, 1))
    lam = jnp.maximum(jnp.sqrt(jnp.sum(jnp.asarray(chol) ** 2, axis=1)), 1e-6)
    return jax.random.poisson(kz, lam, (n, DIM)), jax.random.poisson(kg, lam, (n, DIM))


def test_catalog_knows_every_jax_proposal():
    assert set(proposal_catalog) == set(jax_catalog)
    for name in jax_catalog:
        assert choose_proposal(name) is proposal_catalog[name]
    with pytest.raises(ValueError, match="MultivariateNormal"):
        choose_proposal("nope")


@pytest.mark.parametrize("name", sorted(jax_catalog))
def test_transform_of_injected_draws_matches_jax(name, cov_chol):
    chol, _ = cov_chol
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_catalog[name](key, 257, jnp.asarray(chol)))
    noise = jax.tree_util.tree_map(lambda x: torch.as_tensor(np.array(x, dtype=np.float32)),
                                   _jax_noise(name, key, 257, chol))
    got = choose_proposal(name)(None, 257, torch.as_tensor(chol), noise).numpy()
    if name in ("Poisson", "DiscreteBoundedUniform"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _draw(name, chol, seed, n=N):
    return choose_proposal(name)(torch.Generator().manual_seed(seed), n,
                                 torch.as_tensor(chol)).numpy()


@pytest.mark.parametrize("name", sorted(proposal_catalog))
def test_shape_symmetry_and_determinism(name, cov_chol):
    chol, _ = cov_chol
    d = _draw(name, chol, 1)
    assert d.shape == (N, DIM) and d.dtype == np.float32 and np.isfinite(d).all()
    assert np.abs(np.median(d, axis=0)).max() < 0.2
    np.testing.assert_array_equal(_draw(name, chol, 7, 16), _draw(name, chol, 7, 16))
    assert not np.array_equal(_draw(name, chol, 7, 16), _draw(name, chol, 8, 16))


def test_mv_normal_covariance(cov_chol):
    chol, cov = cov_chol
    np.testing.assert_allclose(np.cov(_draw("MultivariateNormal", chol, 2), rowvar=False),
                               cov, atol=0.12)


def test_univariate_normal_ignores_correlations(cov_chol):
    chol, cov = cov_chol
    got = np.cov(_draw("Normal", chol, 3), rowvar=False)
    np.testing.assert_allclose(np.diag(got), np.diag(cov), rtol=0.1)
    assert np.abs(got[~np.eye(DIM, dtype=bool)]).max() < 0.1 * np.diag(cov).min()


@pytest.mark.parametrize("name", ["Cauchy", "Laplace", "MultivariateCauchy",
                                  "MultivariateStudentT"])
def test_heavy_tails(name, cov_chol):
    chol, _ = cov_chol

    def q999(x):
        return np.quantile(np.abs(x[:, 0]), 0.999)

    assert q999(_draw(name, chol, 4)) > 1.2 * q999(_draw("MultivariateNormal", chol, 4))


@pytest.mark.parametrize("name", ["Poisson", "DiscreteBoundedUniform"])
def test_discrete_steps_are_integers(name, cov_chol):
    chol, _ = cov_chol
    d = _draw(name, chol, 5, 2000)
    np.testing.assert_array_equal(d, np.round(d))
    assert np.abs(d).max() > 0
    std = np.sqrt(np.sum(chol.astype(np.float64) ** 2, axis=1))
    if name == "Poisson":       # a difference of two Poisson(σ) draws: variance 2σ
        np.testing.assert_allclose(d.var(axis=0), 2 * std, rtol=0.15)
    else:                       # integers uniform in [-w, w], w = round(3σ)
        w = np.maximum(np.round(3 * std), 1)
        assert (np.abs(d) <= w).all()
        assert (d.min(axis=0) == -w).all() and (d.max(axis=0) == w).all()


@pytest.mark.parametrize("name", sorted(proposal_catalog))
def test_metropolis_stage_takes_each_proposal_by_name(name):
    """A standard normal target in a box: every proposal moves the chains
    and keeps them in the box, with finite llks."""
    def logp(q):
        return -0.5 * torch.sum(q * q, dim=-1)

    lo, hi = torch.full((DIM,), -4.0), torch.full((DIM,), 4.0)
    q0 = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (64, DIM)),
                         dtype=torch.float32)
    state = init_metropolis_state(logp, q0)
    final, (q_tr, llk_tr) = run_metropolis_stage(
        logp, state, 1.0, torch.eye(DIM) * 0.8, lo, hi, n_steps=40,
        generator=torch.Generator().manual_seed(0), proposal_name=name, tune_interval=10)
    assert 0 < float(final.acc_total.mean()) / 40 <= 1
    assert torch.isfinite(llk_tr).all() and (q_tr >= lo).all() and (q_tr <= hi).all()
    assert not torch.equal(final.q, q0)
