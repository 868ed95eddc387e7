"""
MAP estimation and the Laplace approximation of the port
(``beat_tpu_torch/optimize.py``): the JAX package's toy tests
(``tests/test_optimize.py:14-96``) at the same bars, the Laplace
covariance and evidence against ``beat_tpu.optimize`` at one common
point of the small flagship, and MAP on that flagship.

The port's L-BFGS line search is not optax's, so iterates differ and
only outcomes are compared.
"""

import numpy as np

import jax
import torch

from beat_tpu.optimize import laplace_approximation as jax_laplace
from beat_tpu_torch import flagship
from beat_tpu_torch.optimize import laplace_approximation, map_estimate
from beat_tpu_torch.sources import sdr_to_m6
from test_torch_seismic_llk import _jax_flagship
import test_torch_common  # noqa: F401  (the tests' thread policy)

CPU = "cpu"


def test_map_and_laplace_gaussian():
    """Correlated Gaussian: MAP == mean, Laplace cov == cov, Laplace
    evidence == analytic box evidence."""
    cov = np.array([[0.04, 0.018], [0.018, 0.02]])
    icov = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    mu = torch.tensor([0.7, -0.4])

    def logp(x):
        d = x - mu
        return -0.5 * torch.einsum("ni,ij,nj->n", d, icov, d)

    lo, hi = np.full(2, -2.0), np.full(2, 2.0)
    q_map, llk, _ = map_estimate(logp, lo, hi, n_restarts=8, n_steps=100, seed=0, device=CPU)
    np.testing.assert_allclose(q_map, mu.numpy(), atol=1e-3)
    assert llk > -1e-4
    lap = laplace_approximation(logp, q_map, lo, hi, device=CPU)
    np.testing.assert_allclose(lap["cov"], cov, rtol=0.02, atol=2e-4)
    # analytic: Z = 2π·sqrt(det(cov)) / vol
    want = float(np.log(2 * np.pi * np.sqrt(np.linalg.det(cov)) / 16.0))
    assert abs(lap["log_evidence"] - want) < 0.02, (lap["log_evidence"], want)
    assert lap["curvature_ok"]


def test_fixed_dims_held_constant():
    """lower == upper pins a parameter: it stays exactly at the pin,
    carries sd 0, and does not enter the evidence volume."""
    def logp(x):
        return -0.5 * torch.sum((x - 0.5) ** 2, dim=-1) / 0.01

    lo, hi = np.array([-2.0, 1.25, -2.0]), np.array([2.0, 1.25, 2.0])
    q_map, _, _ = map_estimate(logp, lo, hi, n_restarts=4, n_steps=80, device=CPU)
    assert q_map[1] == 1.25
    np.testing.assert_allclose(q_map[[0, 2]], 0.5, atol=1e-3)
    lap = laplace_approximation(logp, q_map, lo, hi, device=CPU)
    assert lap["sd"][1] == 0.0
    assert lap["cov"].shape == (2, 2)
    np.testing.assert_allclose(lap["sd"][[0, 2]], 0.1, rtol=0.02)


def test_multimodal_restarts_find_global_mode():
    """Multi-restart escapes the local mode of an asymmetric mixture."""
    def logp(x):
        a = -0.5 * torch.sum((x - 0.8) ** 2, dim=-1) / 0.005
        b = -0.5 * torch.sum((x + 0.8) ** 2, dim=-1) / 0.005 + 3.0
        return torch.logaddexp(a, b)

    lo, hi = np.full(1, -2.0), np.full(1, 2.0)
    q_map, _, all_llks = map_estimate(logp, lo, hi, n_restarts=16, n_steps=100, seed=1,
                                      device=CPU)
    np.testing.assert_allclose(q_map, [-0.8], atol=1e-2)
    assert all_llks.max() - all_llks.min() > 1.0      # restarts report both basins


def test_laplace_matches_jax_at_a_common_point():
    """Both packages' Laplace at one q_map of the small flagship, with the
    moment tensor pinned at the truth: the llk is invariant to the
    moment tensor's scale, so with it free the curvature has a null
    direction whose float32 noise each package floors differently.
    The JAX side runs its default gather (its DMA gather's custom_vjp
    does not admit ``jax.hessian``)."""
    port = flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device=CPU)
    lower, upper = port.priors.bounds_arrays()
    for name, value in zip(("mnn", "mee", "mdd", "mne", "mnd", "med"),
                           sdr_to_m6(*flagship.TRUE_SDR).numpy()):
        sl = port.ordering[name].slc
        lower[sl] = upper[sl] = value
    logp, data = port.make_logp_fn()
    q_map, _, _ = map_estimate(logp, lower, upper, n_restarts=8, n_steps=60, seed=0,
                               logp_args=(data,), device=CPU)
    lap = laplace_approximation(logp, q_map, lower, upper, logp_args=(data,), device=CPU)
    jlogp, jdata = _jax_flagship(port).make_logp_fn()
    want = jax_laplace(jax.jit(jlogp), q_map, lower, upper, logp_args=(jdata,))
    assert lap["curvature_ok"] and want["curvature_ok"]
    np.testing.assert_array_equal(lap["free"], want["free"])
    # float32 Hessians by two autodiff orders; the bars are tightened from
    # rtol 1e-2 on the covariance and atol 0.1 on log Z to what was
    # measured: max |Δsd|/sd 3.5e-4, |Δcorrelation| 6.9e-4, |Δlog Z| 7.1e-4
    np.testing.assert_allclose(lap["sd"], want["sd"], rtol=5e-3)
    sd = np.sqrt(np.diag(want["cov"]))
    np.testing.assert_allclose(lap["cov"] / np.outer(sd, sd), want["cov"] / np.outer(sd, sd),
                               rtol=0, atol=5e-3)
    assert abs(lap["log_evidence"] - want["log_evidence"]) < 0.01


def test_map_on_flagship_problem():
    """MAP through the Problem surface recovers the planted source
    (the bars of tests/test_optimize.py:115-116).  24 restarts of 150
    steps find the global mode from every seed tried (0-3: depth 350 m
    off, Mw 0.006)."""
    problem = flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device=CPU)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q_map, _, _ = map_estimate(logp, lower, upper, n_restarts=24, n_steps=150, seed=2,
                               logp_args=(data,), start=problem.priors.test_array()[None],
                               device=CPU)
    point = problem.ordering.to_point(q_map)
    assert abs(float(point["depth"]) - flagship.TRUE_DEPTH) < 600
    assert abs(float(point["magnitude"]) - flagship.TRUE_MAGNITUDE) < 0.15
    lap = laplace_approximation(logp, q_map, lower, upper, logp_args=(data,), device=CPU)
    assert np.isfinite(lap["log_evidence"])
