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
from beat_tpu_torch.ops import gfstack as gfstack_mod
from beat_tpu_torch.ops.gfstack import (REGISTERS_PER_SM, SMEM_PER_BLOCK, plan_stack,
                                        stack_batched, stack_batched_reference, stack_operands)
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


LAQUILA = (12, 500, 10, 32, 512)       # (T, P, D, S, N) of examples/laquila_scale_ffi.py
BENCH = (8, 12, 6, 16, 256)            # tools/bench_gfstack.py
SMALL_FFI = (12, 18, 10, 32, 96)       # the small FFI problem of chip_smoke.py


@pytest.mark.parametrize("dims,C,corners,variant,lanes", [
    (LAQUILA, 2000, 4, "tiled", 16),
    (LAQUILA, 2000, 1, "tiled", 16),           # 1.6 reads a staged row, but a long walk
    (LAQUILA, 2001, 4, "tiled", 16),           # ragged C: a fifth chain tile of one chain
    (LAQUILA, 37, 4, "gather", 0),             # too few chains to reuse a staged row
    (BENCH, 2000, 4, "tiled", 16),
    (BENCH, 2000, 1, "gather", 0),             # a short walk needs 6 reads a staged row
    (SMALL_FFI, 2000, 4, "tiled", 16),
    (SMALL_FFI, 2000, 1, "gather", 0),
    ((12, 500, 40, 64, 512), 2000, 4, "gather", 0),    # D·S too large for two cell tiles
    ((12, 500, 20, 32, 512), 2000, 4, "tiled", 8),     # fits only with the narrow n tile
    ((3, 50, 4, 9, 101), 2000, 4, "gather", 0),        # N % 4 != 0: rows not 16-byte aligned
    ((3, 50, 4, 9, 24), 2000, 4, "tiled", 8),          # N <= 32: the narrow n tile
])
def test_plan_stack_picks_variant_and_tiles_within_budget(dims, C, corners, variant, lanes):
    T, P, D, S, N = dims
    plan = plan_stack(T, P, D, S, N, C, corners)
    assert (plan.variant, plan.lanes) == (variant, lanes), plan.why
    assert plan.smem_bytes <= SMEM_PER_BLOCK
    # the sums of all threads of a block fit half of the SM's registers
    assert plan.threads * plan.sum_registers <= REGISTERS_PER_SM // 2
    assert plan.patch_chunk == 1 << plan.chunk_shift
    tiles_c, tiles_n, tiles_t = plan.grid
    assert tiles_t == T and max(tiles_n, tiles_t) <= 65535
    assert (tiles_c - 1) * plan.chain_tile < C <= tiles_c * plan.chain_tile
    assert (tiles_n - 1) * plan.n_tile < N <= tiles_n * plan.n_tile
    if variant == "tiled":
        entry_bytes = 16 if corners == 4 else 8
        assert plan.stages == 2 and plan.n_tile == 4 * lanes and N % 4 == 0
        assert plan.chain_tile == plan.threads // lanes * plan.chains_per_thread
        assert plan.smem_bytes == (plan.stages * D * S * plan.n_tile * 4
                                   + plan.chain_tile * plan.patch_chunk * entry_bytes)
        # the next larger chunk of folded operands would not fit (or is the largest)
        assert plan.patch_chunk == 8 or (
            plan.smem_bytes + plan.chain_tile * plan.patch_chunk * entry_bytes > SMEM_PER_BLOCK)


def test_plan_stack_at_the_laquila_shape_is_the_design():
    plan = plan_stack(*LAQUILA, 2000)
    assert (plan.chain_tile, plan.n_tile, plan.patch_chunk, plan.grid) == (512, 64, 8, (4, 8, 12))
    assert plan.smem_bytes == 2 * 320 * 64 * 4 + 512 * 8 * 16 == 229376
    assert plan.sum_registers == 64


def test_plan_stack_forced_variants_and_alignment():
    assert plan_stack(*BENCH, 2000, 1, variant="tiled").variant == "tiled"
    assert plan_stack(*LAQUILA, 2000, 4, variant="gather").variant == "gather"
    assert plan_stack(*LAQUILA, 2000, 4, aligned=False).variant == "gather"
    with pytest.raises(ValueError, match="16-byte"):
        plan_stack(3, 50, 4, 9, 101, 2000, variant="tiled")
    with pytest.raises(ValueError, match="do not fit"):
        plan_stack(12, 500, 40, 64, 512, 2000, variant="tiled")
    with pytest.raises(ValueError, match="unknown variant"):
        plan_stack(*BENCH, 2000, variant="fast")


def test_operands_pass_as_they_come():
    """(C, 1, P) onsets go on with a target stride of 0, a column slice of
    the sample matrix with its row stride: nothing is expanded or copied."""
    C, T, P = 5, 3, 7
    q = torch.rand(C, 40)
    slips = q[:, 3:3 + P]                                  # as Ordering.to_point slices it
    didx = torch.ones((C, P), dtype=torch.int32)
    sidx = torch.ones((C, 1, P), dtype=torch.int32)
    rtf, stf = torch.rand(C, P), torch.rand(C, 1, P)
    tensors, strides = stack_operands(didx, sidx, slips, rtf, stf)
    assert [x.data_ptr() for x in tensors] == [x.data_ptr() for x in (didx, sidx, slips, rtf, stf)]
    assert strides == (P, P, 0, 40, P, P, 0)
    full_sidx, full_stf = sidx.expand(C, T, P).contiguous(), stf.expand(C, T, P).contiguous()
    _, strides = stack_operands(didx, full_sidx, slips, rtf, full_stf)
    assert strides == (P, T * P, P, 40, P, T * P, P)
    tensors, strides = stack_operands(didx, sidx, slips)   # K4: no weights
    assert len(tensors) == 3 and strides == (P, P, 0, 40)
    # what the kernels cannot address is converted: int64 indices, a strided patch axis
    tensors, strides = stack_operands(didx.long(), sidx, q[:, ::2][:, :P])
    assert tensors[0].dtype == torch.int32 and tensors[2].stride() == (P, 1)
    assert strides == (P, P, 0, P)


def test_launch_hands_the_callers_buffers_to_the_kernel(monkeypatch):
    """On the main path's call (int32 indices, (C, 1, P) onsets, slips a
    slice of the samples) the wrapper allocates the output and nothing
    else: every pointer the C entry gets is the caller's own buffer."""
    calls = []

    class FakeLib:
        @staticmethod
        def beat_gf_stack_multilinear_f32(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(gfstack_mod, "load", lambda name: (FakeLib, None))
    monkeypatch.setattr(gfstack_mod, "launch", lambda device, entry, *args: entry(*args, 0))
    T, P, D, S, N = 3, 7, 4, 9, 16
    C = 5
    data = torch.rand(T, P, D, S, N)
    q = torch.rand(C, 40)
    didx = torch.ones((C, P), dtype=torch.int32)
    sidx = torch.ones((C, 1, P), dtype=torch.int32)
    rtf, stf = torch.rand(C, P), torch.rand(C, 1, P)
    plan = plan_stack(T, P, D, S, N, C)
    out = gfstack_mod._launch(data, didx, sidx, q[:, 2:2 + P], rtf, stf, plan)
    (args,) = calls
    assert list(args[:6]) == [x.data_ptr() for x in (data, didx, sidx, q[:, 2:2 + P], rtf, stf)]
    assert args[6] == out.data_ptr() and out.shape == (C, T, N)
    assert args[7:13] == (C, T, P, D, S, N)
    assert args[13:20] == (P, P, 0, 40, P, P, 0)
    assert args[20:23] == (int(plan.variant == "tiled"), plan.lanes, plan.chunk_shift)


@pytest.mark.parametrize("interpolation", INTERPOLATIONS)
def test_shared_onsets_equal_their_expansion(interpolation):
    """(C, 1, P) operands and their (C, T, P) expansion (a stride-0 view or a
    copy) give identical plain results."""
    lib, _ = make_libs()
    durations, starttimes, slips = rand_chains(lib, 7, 6)
    didx, rtf = lib.durations2idxs(torch.as_tensor(durations), interpolation)
    sidx, stf = lib.starttimes2idxs(torch.as_tensor(starttimes[:, :1]), interpolation)
    C, T, P = 6, lib.ntargets, lib.npatches
    slips = torch.as_tensor(slips)
    shared = stack_batched(lib.data, didx, sidx, slips, rtf, stf)
    for expand in (lambda x: x.expand(C, T, P), lambda x: x.expand(C, T, P).contiguous()):
        full = stack_batched(lib.data, didx, expand(sidx), slips, rtf,
                             None if stf is None else expand(stf))
        assert torch.equal(shared, full)


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

    @pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
    def test_plain_version_clips_in_64_bits(self, dtype):
        """An int64 index of ±2^40 clips to [0, R-1]; it does not wrap through
        int32 (2^40 mod 2^32 = 0 would pick row 0 for both).  The JAX entry
        casts to int32 before it clips, so the two are held together only
        within the int32 range."""
        R, M = 9, 5
        tbl = torch.arange(float(R * M)).reshape(R, M)
        far = 2**40 if dtype == torch.int64 else 2**31 - 1
        idx = torch.tensor([far, -far, 3, R, -1, R - 1], dtype=dtype)
        want = tbl[[R - 1, 0, 3, R - 1, 0, R - 1]].numpy()
        np.testing.assert_array_equal(gather_rows_reference(tbl, idx).numpy(), want)
        np.testing.assert_array_equal(gather_rows(tbl, idx).numpy(), want)
        # a strided index view goes on as it is
        np.testing.assert_array_equal(
            gather_rows(tbl, torch.stack([idx, idx], 1)[:, 0]).numpy(), want)
        if dtype == torch.int32:
            # the JAX package's numpy reference does not clip; its kernel entry does
            np.testing.assert_array_equal(
                want, jax_gather_rows_reference(tbl.numpy(), np.clip(idx.numpy(), 0, R - 1)))
            np.testing.assert_array_equal(want, np.asarray(gather_rows_pallas(
                jnp.asarray(tbl.numpy()), jnp.asarray(idx.numpy()), block_rows=8,
                interpret=True)))

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
