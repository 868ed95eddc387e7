"""
The port's kinematic GF stack (plain versions of kernels K3 and K4, the
index quantisation) and its plain row gather (K5) against the JAX
package on the same numpy inputs, on the CPU.

The JAX side runs three ways: the XLA gather ``SeismicGFLibrary.stack_all``
under ``vmap``, the Pallas kernel in interpret mode with the exact
selection matmul (``mode="highest"``), and the float64 host loop.  The
inputs have ragged chain and patch counts (not multiples of the TPU's
128 / 8 tiles) and durations and starttimes off the grid and beyond it
on both sides, where the floor-cell weights leave [0, 1] and the stack
extrapolates.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.ffi import SeismicGFLibrary as JaxLibrary
from beat_tpu.ffi.gflibrary import stack_all_numpy as jax_stack_all_numpy
from beat_tpu.ops.gfstack import stack_batched_pallas
from beat_tpu.ops.rowgather import gather_rows_pallas
from beat_tpu.ops.rowgather import gather_rows_reference as jax_gather_rows_reference
from beat_tpu_torch.convert import seismic_gflibrary_from_numpy
from beat_tpu_torch.ffi import stack_all_numpy
from beat_tpu_torch.ops.gfstack import stack_batched, stack_batched_reference
from beat_tpu_torch.ops.rowgather import gather_rows, gather_rows_reference
import test_torch_common  # noqa: F401  (the tests' thread policy)

INTERPOLATIONS = ["nearest_neighbor", "multilinear"]
GRID = dict(duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
            starttime_sampling=0.25)
# against the XLA gather: the same float32 products summed over the
# patches in another order
XLA_RTOL, XLA_ATOL_REL = 1e-5, 1e-6
# against the interpret-mode kernel: the bar of the JAX package's own
# exact-algorithm test (tests/test_gfstack_pallas.py:213)
PALLAS_TOL = dict(rtol=2e-5, atol=2e-5)
# against the float64 host loop: float32 rounding of P·4 products
F64_RTOL, F64_ATOL_REL = 1e-5, 2e-6


def make_libs(nt=3, npch=11, nd=4, nst=9, ns=100, seed=0):
    data = np.random.default_rng(seed).normal(size=(nt, npch, nd, nst, ns)).astype(np.float32)
    jlib = JaxLibrary(data=jnp.asarray(data), **GRID).with_stacking_layout()
    return seismic_gflibrary_from_numpy(data, **GRID, device="cpu"), jlib


def rand_chains(lib, seed, nchains):
    """Durations and starttimes off the grid and beyond it on both sides
    (the grids span 0.5–2.0 s and 0–2.0 s)."""
    rng = np.random.default_rng(seed)
    durations = rng.uniform(0.2, 2.3, (nchains, lib.npatches)).astype(np.float32)
    starttimes = rng.uniform(-0.3, 2.4, (nchains, lib.ntargets, lib.npatches)).astype(np.float32)
    slips = rng.uniform(0, 3, (nchains, lib.npatches)).astype(np.float32)
    return durations, starttimes, slips


def port_stack(lib, durations, starttimes, slips, interpolation):
    return lib.stack_all(torch.as_tensor(durations), torch.as_tensor(starttimes),
                         torch.as_tensor(slips), interpolation).numpy()


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_index_quantisation_matches_jax(interpolation):
    lib, jlib = make_libs()
    durations, starttimes, _ = rand_chains(lib, 1, 7)
    # on-grid and far-out values among them
    durations[0, :4] = [0.5, 1.0, 2.0, 9.0]
    starttimes[0, 0, :4] = [0.0, 0.25, 2.0, 50.0]
    for mine, theirs, x in ((lib.durations2idxs, jlib.durations2idxs, durations),
                            (lib.starttimes2idxs, jlib.starttimes2idxs, starttimes)):
        idx, fac = mine(torch.as_tensor(x), interpolation)
        jidx, jfac = theirs(jnp.asarray(x), interpolation)
        assert idx.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        if interpolation == "nearest_neighbor":
            assert fac is None and jfac is None
        else:
            # the same IEEE operations: equal to one ulp
            np.testing.assert_array_almost_equal_nulp(fac.numpy(), np.asarray(jfac), nulp=1)
    # a starttime far beyond the grid keeps its factor: extrapolation, not clamping
    if interpolation == "multilinear":
        _, fac = lib.starttimes2idxs(torch.as_tensor(starttimes), interpolation)
        assert float(fac[0, 0, 3]) == pytest.approx(8 - 200.0)


@pytest.mark.parametrize("nchains,npch", [(5, 11), (1, 3), (130, 9)])
@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_plain_stack_matches_xla_gather(interpolation, nchains, npch):
    lib, jlib = make_libs(npch=npch, ns=40 if nchains > 100 else 100)
    durations, starttimes, slips = rand_chains(lib, 2, nchains)
    want = np.asarray(jax.vmap(lambda d, s, w: jlib.stack_all(d, s, w, interpolation))(
        jnp.asarray(durations), jnp.asarray(starttimes), jnp.asarray(slips)))
    got = port_stack(lib, durations, starttimes, slips, interpolation)
    assert got.shape == (nchains, lib.ntargets, lib.nsamples)
    np.testing.assert_allclose(got, want, rtol=XLA_RTOL, atol=XLA_ATOL_REL * np.abs(want).max())


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_plain_stack_matches_interpret_mode_kernel(interpolation):
    lib, jlib = make_libs()
    durations, starttimes, slips = rand_chains(lib, 3, 5)
    didx, rtf = jlib.durations2idxs(jnp.asarray(durations), interpolation)
    sidx, stf = jlib.starttimes2idxs(jnp.asarray(starttimes), interpolation)
    want = np.asarray(stack_batched_pallas(
        jnp.asarray(jlib.data_tr), jlib.nstarttimes, didx, sidx, jnp.asarray(slips), rtf, stf,
        interpret=True, mode="highest"))
    got = port_stack(lib, durations, starttimes, slips, interpolation)
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_plain_stack_matches_float64_host_loop(interpolation):
    lib, jlib = make_libs(nt=2, npch=6, ns=32)
    durations, starttimes, slips = rand_chains(lib, 4, 3)
    got = port_stack(lib, durations, starttimes, slips, interpolation)
    for c in range(3):
        args = (durations[c].astype(np.float64), starttimes[c].astype(np.float64),
                slips[c].astype(np.float64), interpolation)
        want = stack_all_numpy(lib, *args)
        # the port's copy of the host loop is the JAX package's
        np.testing.assert_array_equal(want, jax_stack_all_numpy(jlib, *args))
        np.testing.assert_allclose(got[c], want, rtol=F64_RTOL,
                                   atol=F64_ATOL_REL * np.abs(want).max())


def test_shared_onsets_broadcast_over_targets():
    """(C, 1, P) starttimes mean every target sees the same onsets."""
    lib, _ = make_libs()
    durations, starttimes, slips = rand_chains(lib, 5, 4)
    shared = starttimes[:, :1]
    got = port_stack(lib, durations, shared, slips, "multilinear")
    want = port_stack(lib, durations, np.broadcast_to(shared, starttimes.shape).copy(), slips,
                      "multilinear")
    np.testing.assert_array_equal(got, want)


def test_plain_stack_chunks_agree(monkeypatch):
    """The plain version's chain chunks (which bound its gathered
    intermediate at real size) change only the order of the patch sum."""
    import beat_tpu_torch.ops.gfstack as mod

    lib, _ = make_libs()
    durations, starttimes, slips = rand_chains(lib, 6, 7)
    whole = port_stack(lib, durations, starttimes, slips, "multilinear")
    monkeypatch.setattr(mod, "_PLAIN_CHUNK_ELEMS", 2 * lib.ntargets * lib.npatches * lib.nsamples)
    np.testing.assert_allclose(
        port_stack(lib, durations, starttimes, slips, "multilinear"), whole,
        rtol=XLA_RTOL, atol=XLA_ATOL_REL * np.abs(whole).max())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    lib, _ = make_libs(nt=2, npch=3, ns=8)
    C, T, P = 2, 2, 3
    didx = torch.ones((C, P), dtype=torch.int32)
    sidx = torch.ones((C, T, P), dtype=torch.int32)
    slips = torch.ones((C, P))
    assert stack_batched(lib.data, didx, sidx, slips).shape == (C, T, 8)
    with pytest.raises(ValueError):
        stack_batched(lib.data, didx, sidx[:, :, :2], slips)              # patch count
    with pytest.raises(ValueError):
        stack_batched(lib.data, didx.float(), sidx, slips)                # float indices
    with pytest.raises(ValueError):
        stack_batched(lib.data, didx, sidx, slips, rtf=torch.ones((C, P)))   # rtf without stf
    with pytest.raises(ValueError):
        stack_batched(lib.data.transpose(0, 1), didx, sidx, slips)        # not contiguous
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        stack_batched(lib.data, didx, sidx, slips.requires_grad_())
    # indices beyond the grid are clamped, not read out of bounds
    far = stack_batched_reference(lib.data, didx * 99, sidx * 99, slips.detach())
    edge = stack_batched_reference(lib.data, torch.full_like(didx, 3), torch.full_like(sidx, 8),
                                   slips.detach())
    np.testing.assert_array_equal(far.numpy(), edge.numpy())


class TestRowGather:
    """Plain K5 against the JAX package's numpy reference and its Pallas
    kernel in interpret mode: a copy, so equal exactly."""

    @pytest.mark.parametrize("R,M,n", [(500, 1548, 700), (97, 333, 41)])
    def test_matches_reference_and_interpret_kernel(self, R, M, n):
        rng = np.random.default_rng(R)
        tbl = rng.normal(size=(R, M)).astype(np.float32)
        idx = rng.integers(0, R, n).astype(np.int32)
        got = gather_rows(torch.as_tensor(tbl), torch.as_tensor(idx)).numpy()
        np.testing.assert_array_equal(got, jax_gather_rows_reference(tbl, idx))
        np.testing.assert_array_equal(got, np.asarray(gather_rows_pallas(
            jnp.asarray(tbl), jnp.asarray(idx), block_rows=64, interpret=True)))

    def test_clips_indices_and_checks_input(self):
        tbl = torch.arange(12.0).reshape(4, 3)
        idx = torch.tensor([-2, 0, 3, 7])
        np.testing.assert_array_equal(gather_rows(tbl, idx).numpy(),
                                      tbl[[0, 0, 3, 3]].numpy())
        np.testing.assert_array_equal(gather_rows_reference(tbl, idx).numpy(),
                                      tbl[[0, 0, 3, 3]].numpy())
        assert gather_rows(tbl, idx[:0]).shape == (0, 3)
        with pytest.raises(ValueError):
            gather_rows(tbl, idx.float())
        with pytest.raises(ValueError):
            gather_rows(tbl.T, idx)

    def test_smc_resamples_through_the_gather(self, monkeypatch, tmp_path):
        """Each SMC stage starts from rows of the previous stage's final
        population, gathered at the stage file's resampling indexes."""
        from beat_tpu_torch.backend import SampleStage
        from beat_tpu_torch.samplers import SMCParams, smc
        from beat_tpu_torch.utility import Ordering

        calls = []

        def recording(tbl, idx):
            calls.append((tbl.clone(), idx.clone()))
            return gather_rows(tbl, idx)

        monkeypatch.setattr(smc, "gather_rows", recording)
        lower, upper = np.full(3, -4.0), np.full(3, 4.0)
        ordering = Ordering([("x", (3,))])
        smc.smc_sample(lambda q: -0.5 * torch.sum((q - 1.0) ** 2, dim=-1) / 0.09, lower, upper,
                       SMCParams(n_chains=64, n_steps=5, seed=3), device="cpu",
                       homepath=str(tmp_path), ordering=ordering)
        handler = SampleStage(str(tmp_path), ordering=ordering)
        stages = sorted(s for s in range(1, len(calls) + 1)
                        if (tmp_path / f"stage_{s}").exists()) + [-1]
        assert len(calls) == len(stages) >= 2
        previous = handler.load_state(0)["population"]
        for (tbl, idx), stage in zip(calls, stages):
            state = handler.load_state(stage)
            np.testing.assert_array_equal(idx.numpy(), state["resampling_indexes"])
            np.testing.assert_array_equal(tbl.numpy(), previous.astype(np.float32))
            previous = state["population"]
