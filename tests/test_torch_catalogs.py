"""
The catalogs the port keeps beside its samplers, against the JAX
package's: the source-time functions (``beat_tpu/sources.py:523-547``),
the a-priori noise structures (``beat_tpu/covariance.py:108-123``) and
the tempered sample covariance (``covariance.py:378``).
"""

import numpy as np
import pytest
import torch

import beat_tpu.covariance as jax_cov
import beat_tpu.sources as jax_sources
from beat_tpu_torch import covariance, sources

# float32 on both sides; the functions are a few operations deep
STF_RTOL = 1e-6


def test_catalogs_name_the_same_entries():
    assert sorted(sources.stf_catalog) == sorted(jax_sources.stf_catalog)
    assert sorted(covariance.noise_structure_catalog) == sorted(
        jax_cov.noise_structure_catalog)


@pytest.mark.parametrize("name", sorted(jax_sources.stf_catalog))
@pytest.mark.parametrize("duration", [0.0, 0.7, 2.5])
def test_stf_equals_jax(name, duration):
    """On a grid from before the onset to past the end, through the
    peak and both edges; a zero duration is floored alike."""
    t = np.linspace(-0.5, 3.5, 161).astype(np.float32)
    want = np.asarray(jax_sources.stf_catalog[name](t, np.float32(duration)))
    got = sources.stf_catalog[name](torch.as_tensor(t), duration).numpy()
    np.testing.assert_allclose(got, want, rtol=STF_RTOL, atol=STF_RTOL * np.abs(want).max())


@pytest.mark.parametrize("ratio", [0.2, 0.8])
def test_triangular_stf_peak_ratio_and_unit_area(ratio):
    t = np.linspace(0.0, 2.0, 2001).astype(np.float32)
    want = np.asarray(jax_sources.triangular_stf(t, np.float32(2.0), peak_ratio=ratio))
    got = sources.triangular_stf(torch.as_tensor(t), 2.0, peak_ratio=ratio).numpy()
    np.testing.assert_allclose(got, want, rtol=STF_RTOL, atol=STF_RTOL * want.max())
    t64 = torch.linspace(0.0, 2.0, 20001, dtype=torch.float64)
    area = torch.trapezoid(sources.triangular_stf(t64, 2.0, peak_ratio=ratio), t64)
    assert abs(float(area) - 1.0) < 1e-6


@pytest.mark.parametrize("name", sorted(jax_cov.noise_structure_catalog))
def test_noise_structure_equals_jax(name):
    np.testing.assert_array_equal(covariance.noise_structure_catalog[name](7, 0.5, 2.0),
                                  jax_cov.noise_structure_catalog[name](7, 0.5, 2.0))


@pytest.mark.parametrize("beta,prev_beta", [(0.3, 0.0), (1.0, 0.6), (0.05, 0.01)])
def test_calc_sample_covariance_equals_jax(beta, prev_beta):
    rng = np.random.default_rng(4)
    population = rng.normal(size=(200, 3)) @ np.array([[1.0, 0.3, 0.0], [0.0, 2.0, 0.5],
                                                       [0.0, 0.0, 0.1]])
    likelihoods = -0.5 * np.sum(population**2, axis=1) * 40.0
    np.testing.assert_allclose(
        covariance.calc_sample_covariance(population, likelihoods, beta, prev_beta),
        jax_cov.calc_sample_covariance(population, likelihoods, beta, prev_beta),
        rtol=1e-12)


def test_calc_sample_covariance_refuses_a_non_finite_population():
    population = np.array([[0.0, 1.0], [np.inf, 2.0], [1.0, 0.0]])
    with np.errstate(invalid="ignore"), pytest.raises(ValueError, match="NaN/Inf"):
        covariance.calc_sample_covariance(population, np.zeros(3), 1.0)
