"""
The port's batched Jacobi eikonal solver against the JAX package's
under ``vmap`` and against the numpy Gauss-Seidel fast-sweeping
reference, on the CPU.

``epsilon = 0.1`` on a sum of squared seconds stops before full
convergence, and under ``vmap`` each chain stops at its own iteration:
the batch below mixes chains that converge early (fast medium, central
nucleation) with chains that converge late (slow medium, corner
nucleation), so a solver that iterated all chains together would differ.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.ops.eikonal import eikonal_rupture_times as jax_eikonal
from beat_tpu.ops.eikonal import eikonal_rupture_times_numpy as jax_eikonal_numpy
from beat_tpu_torch.ops import eikonal as port
import test_torch_common  # noqa: F401  (the tests' thread policy)

# the same float32 operations in the same order, except the order of the
# convergence sum
VMAP_RTOL = 1e-6


def mixed_batch(n_dip, n_strike, n_chains, seed):
    rng = np.random.default_rng(seed)
    vel = rng.uniform(2000.0, 4000.0, size=(n_chains, n_dip, n_strike))
    vel[0] = 4000.0                                    # fast and uniform
    vel[1] = rng.uniform(500.0, 700.0, size=(n_dip, n_strike))   # slow: late convergence
    nuc_d = rng.integers(0, n_dip, n_chains)
    nuc_s = rng.integers(0, n_strike, n_chains)
    nuc_d[0], nuc_s[0] = n_dip // 2, n_strike // 2
    nuc_d[1], nuc_s[1] = 0, 0
    return (1.0 / vel).astype(np.float32), nuc_d, nuc_s


def port_solve(slowness, patch_size, nuc_d, nuc_s, **kw):
    return port.eikonal_rupture_times(torch.as_tensor(slowness), patch_size,
                                      torch.as_tensor(nuc_d), torch.as_tensor(nuc_s),
                                      **kw).numpy()


@pytest.mark.parametrize("n_dip,n_strike", [(5, 12), (10, 50)])
def test_batched_matches_vmapped_jax(n_dip, n_strike):
    slowness, nuc_d, nuc_s = mixed_batch(n_dip, n_strike, 9, seed=n_strike)
    want = np.asarray(jax.vmap(lambda s, d, k: jax_eikonal(s, 2000.0, d, k))(
        jnp.asarray(slowness), jnp.asarray(nuc_d), jnp.asarray(nuc_s)))
    got = port_solve(slowness, 2000.0, nuc_d, nuc_s)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=VMAP_RTOL)
    assert (got[np.arange(9), nuc_d, nuc_s] == 0.0).all()


def test_each_chain_stops_at_its_own_iteration(monkeypatch):
    """A chain solved in a batch equals the chain solved alone, whatever
    the others need, and whenever the host looks at the mask."""
    slowness, nuc_d, nuc_s = mixed_batch(6, 14, 5, seed=3)
    batched = port_solve(slowness, 2000.0, nuc_d, nuc_s)
    for c in range(5):
        alone = port_solve(slowness[c:c + 1], 2000.0, nuc_d[c:c + 1], nuc_s[c:c + 1])
        np.testing.assert_array_equal(batched[c], alone[0])
    # the early chain really stops early: iterated on with the late one it
    # would move further (epsilon stops short of convergence)
    converged = port_solve(slowness[2:3], 2000.0, nuc_d[2:3], nuc_s[2:3], epsilon=0.0)
    assert np.abs(converged[0] - batched[2]).max() > 0
    monkeypatch.setattr(port, "CHECK_EVERY", 1)
    np.testing.assert_array_equal(port_solve(slowness, 2000.0, nuc_d, nuc_s), batched)


@pytest.mark.parametrize("shape,patch_size,nuc,tol", [
    ((6, 10), 1.0, (2, 3), dict(rtol=1e-5, atol=1e-4)),     # tests/test_ffi.py:41
    ((8, 8), 2.0, (0, 0), dict(rtol=1e-4, atol=1e-3)),      # tests/test_ffi.py:49
])
def test_matches_numpy_gauss_seidel(shape, patch_size, nuc, tol):
    """At the bars of the JAX package's own test against its host
    reference; the port's copy of that reference is the same function."""
    if shape == (6, 10):
        slowness = np.full(shape, 1.0 / 3.5)
    else:
        slowness = 1.0 / np.random.default_rng(0).uniform(1.0, 5.0, size=shape)
    want = port.eikonal_rupture_times_numpy(slowness, patch_size, *nuc)
    np.testing.assert_array_equal(want, jax_eikonal_numpy(slowness, patch_size, *nuc))
    got = port_solve(slowness[None].astype(np.float32), patch_size, np.array([nuc[0]]),
                     np.array([nuc[1]]))[0]
    np.testing.assert_allclose(got, want, **tol)


def test_max_iter_bounds_the_solve():
    slowness, nuc_d, nuc_s = mixed_batch(5, 12, 3, seed=1)
    one = port_solve(slowness, 2000.0, nuc_d, nuc_s, max_iter=1)
    # one iteration reaches the nucleation patch's neighbours only
    assert (one < 1e7).sum() <= 3 * 5
