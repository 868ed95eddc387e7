"""
The port's batched Jacobi eikonal solver against the JAX package's
under ``vmap`` and against the numpy Gauss-Seidel fast-sweeping
reference, on the CPU.

``epsilon = 0.1`` on a sum of squared seconds stops before full
convergence, and under ``vmap`` each chain stops at its own iteration:
the mixed batch (``test_torch_common.mixed_batch``) holds chains that
converge early (fast medium, central nucleation) and chains that
converge late (slow medium, corner nucleation), so a solver that
iterated all chains together would differ.  The routing between the
card's kernel and the plain version is checked here as a function of
what a call shows; the kernel itself is checked on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.ops.eikonal import eikonal_rupture_times as jax_eikonal
from beat_tpu.ops.eikonal import eikonal_rupture_times_numpy as jax_eikonal_numpy
from beat_tpu_torch.ops import eikonal as port
from test_torch_common import mixed_batch, plain_chain_iterations

# the same float32 operations in the same order, except the order of the
# convergence sum
VMAP_RTOL = 1e-6


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


@pytest.mark.parametrize("device,dtype,requires_grad,shape,fused", [
    ("cuda", torch.float32, False, (5000, 10, 50), True),        # the main path
    ("cuda:1", torch.float32, False, (3, 5, 12), True),
    ("cuda", torch.float32, False, (1, 64, 64), True),           # 4096 cells: the edge
    ("cuda", torch.float32, False, (1, 4096, 1), True),
    ("cuda", torch.float32, False, (1, 4097, 1), False),         # one cell beyond it
    ("cuda", torch.float32, False, (2, 65, 64), False),
    ("cuda", torch.float32, False, (0, 10, 50), True),           # no chains: nothing to launch
    ("cuda", torch.float32, False, (4, 0, 50), False),           # no cells
    ("cuda", torch.float64, False, (5000, 10, 50), False),
    ("cuda", torch.bfloat16, False, (5000, 10, 50), False),
    ("cuda", torch.float32, True, (5000, 10, 50), False),
    ("cpu", torch.float32, False, (5000, 10, 50), False),
    ("cpu", torch.float64, False, (9, 5, 12), False),
])
def test_fused_route_is_a_function_of_what_the_call_shows(device, dtype, requires_grad, shape,
                                                          fused):
    """The kernel takes CUDA float32 solves that need no gradient on grids
    of at most ``FUSED_MAX_CELLS`` cells (48 KiB of shared memory at 12
    bytes a cell); everything else runs the plain version."""
    assert port.FUSED_MAX_CELLS == 4096
    assert port.fused_route(torch.device(device), dtype, requires_grad, shape) is fused


def test_kernel_entry_is_declared():
    import ctypes

    from beat_tpu_torch.kernels.build import SIGNATURES

    restype, args = SIGNATURES["eikonal"]["beat_eikonal_f32"]
    assert restype is ctypes.c_int
    assert args == ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                    + [ctypes.c_int, ctypes.c_void_p])


def test_cpu_solves_take_the_plain_version(monkeypatch):
    """A CPU solve never reaches the kernel's wrapper, and the wrapper
    refuses host tensors."""
    from test_torch_common import counters, launches, spy

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(port, "eikonal_rupture_times_fused", refuse)
    plain = spy(monkeypatch, port, "eikonal_rupture_times_plain")
    slowness, nuc_d, nuc_s = mixed_batch(5, 12, 4, seed=7)
    with counters() as counts:
        port_solve(slowness, 2000.0, nuc_d, nuc_s)
        port_solve(slowness.astype(np.float64), 2000.0, nuc_d, nuc_s)
    assert plain == ["cpu", "cpu"]
    assert launches(counts) == {} and counts["eikonal.solves"] == 2
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA float32"):
        port.eikonal_rupture_times_fused(torch.as_tensor(slowness), 2000.0,
                                         torch.as_tensor(nuc_d), torch.as_tensor(nuc_s))


@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_plain_chain_iterations_follow_the_stopping_rule(epsilon):
    """The per-chain counts that the card tests hold the kernel's
    against, derived from the plain update iterated without
    stopping: capped at its count n a chain solves to the plain loop's
    onsets; the n-th update changed it by at most ``epsilon`` and the one
    before by more."""
    slowness, nuc_d, nuc_s = mixed_batch(6, 14, 5, seed=4)
    args = (torch.as_tensor(slowness), 2000.0, torch.as_tensor(nuc_d), torch.as_tensor(nuc_s))
    times = port.eikonal_rupture_times_plain(*args, epsilon=epsilon)
    runs, changes = plain_chain_iterations(args[0], args[2], args[3], 2000.0, epsilon=epsilon)
    assert runs.dtype == torch.int32 and runs.shape == (5,)
    assert changes.shape == (5, int(runs.max()))
    assert len(set(runs.tolist())) > 1          # the chains stop at their own iterations

    def change(a, b):
        return float(torch.sum((a - b) ** 2))

    for c in range(5):
        one = (args[0][c:c + 1], 2000.0, args[2][c:c + 1], args[3][c:c + 1])
        n = int(runs[c])
        capped = [port.eikonal_rupture_times_plain(*one, epsilon=epsilon, max_iter=m)
                  for m in (n, n - 1, n - 2)]
        np.testing.assert_array_equal(capped[0][0].numpy(), times[c].numpy())
        assert change(capped[0], capped[1]) <= epsilon < change(capped[1], capped[2])
        assert float(changes[c, n - 1]) == pytest.approx(change(capped[0], capped[1]), rel=1e-5)
