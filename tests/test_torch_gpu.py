"""
Tests of the port that need an NVIDIA GPU: kernels K1, K2, K1c and K2c
(``beat_tpu_torch/csrc/bilgather.cu``), K3 and K4 (``gfstack.cu``) and
K5 (``rowgather.cu``) against their plain PyTorch versions (K1c and K2c
also on the query layouts of sources made of K point sources: a finite
rectangle's patches as (C, K, T) and (K, C, T), a ring), the
log-likelihoods and the gradient through the kernels against the same
through the plain versions, and Hessians whose double backward launches
the kernels (K1 and K2; K1c and K2c, the Laplace Hessian of the
forward); the geodetic slice's plain-torch forwards, static table
and library build and its llk and gradient on the card against float64
on the host; K3 and K4 on a bfloat16 library against their plain
version on it, and parallel tempering's exchange step and the
trans-dimensional sampler's masked nearest-node slips on the card
against the CPU; the polarity llk (per-draw takeoffs) and the BEM
matrices (float64) on the card against the host, and the refusal of host
tensors by composites on the card; the table builders (Bessel functions,
layered static values, the Kennett kernels, layered waveform tables, the
viscoelastic table and its epoch gather) on the card against the host;
K1c's forward-mode rule against the plain version's JVP, ``seis_derivative``
on the card against the CPU, and a project loaded and sampled on the card;
two gloo ranks sharing the card, each its block of chains through K1c.  They skip without a card (the check
that nothing falls back to the CPU without one runs everywhere); run
them on one with

    python -m pytest tests -m gpu -q
"""

import numpy as np
import pytest
import torch

from beat_tpu_torch.ffi import SeismicGFLibrary
from beat_tpu_torch.flagship import (FFI_TEST_SIZE, TEST_SIZE, TRUE_DEPTH, TRUE_DURATION,
                                     TRUE_MAGNITUDE, TRUE_SDR, build_ffi_flagship,
                                     build_flagship)
from beat_tpu_torch.ops import bilgather
from beat_tpu_torch.ops.bilgather import (bilinear_contract, bilinear_contract_reference,
                                          bilinear_rows, bilinear_rows_reference,
                                          contract_corner_dot, contract_corner_dot_reference,
                                          corner_dot, corner_dot_reference, corner_rows_reference)
from beat_tpu_torch.ops.gfstack import plan_stack, stack_batched, stack_batched_reference
from beat_tpu_torch.ops.rowgather import gather_rows, gather_rows_reference
from beat_tpu_torch.optimize import laplace_approximation
from beat_tpu_torch.samplers import value_and_grad
from beat_tpu_torch.sources import sdr_to_m6
from test_torch_common import assert_grad_close

pytestmark = pytest.mark.gpu

# K1 blends in the plain version's order with explicitly rounded ops:
# the bar is the chip smoke run's 1e-6 of the largest row value
K1_RTOL = 1e-6
# the JAX package's per-chain float32 llk bar (tests/test_float32_llk.py:101)
LLK_RTOL = 2e-5
# K2 sums M products in another order than the plain einsum: per query
# |err| <= K2_RTOL · Σ_j |g_ij| · max_c |row_cj|
K2_RTOL = 1e-5
# K1c and K2c sum 24 and L products in another order than the plain
# einsums: per query |err| <= CONTRACT_RTOL · Σ|A_i| · max|rows_i| (K1c)
# and CONTRACT_RTOL · Σ|G_i| · max|rows_i| (K2c)
CONTRACT_RTOL = 1e-5
# the JAX package's bar between its gather paths' gradients
# (tests/test_bilgather.py:219-221): rtol, and atol as a share of each
# parameter's max|grad|
GRAD_RTOL = 5e-3
# K3/K4 sum P · corners products in another order than the plain einsum:
# per (chain, target) |err| <= STACK_RTOL · Σ_p |slip_p| · Σ_corners |w| · max|data|
STACK_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cd_rows,nz,m,n", [(3 * 11, 5, 12 * 65, 1001),
                                            (3 * 206, 15, 12 * 513, 60000)])
def test_k1_matches_plain(cuda, cd_rows, nz, m, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    tbl = torch.randn((cd_rows, nz, m), generator=gen, device=cuda)
    cd = torch.randint(0, cd_rows - 1, (n,), generator=gen, device=cuda)
    z0 = torch.randint(0, nz - 1, (n,), generator=gen, device=cuda)
    z0[::5] = nz - 2                                     # top-edge queries
    w4 = torch.rand((n, 4), generator=gen, device=cuda)
    before = bilinear_rows.launches
    got = bilinear_rows(tbl, cd, z0, w4)
    torch.cuda.synchronize()
    assert bilinear_rows.launches == before + 1
    ref = bilinear_rows_reference(tbl, cd, z0, w4)
    assert float((got - ref).abs().max()) <= K1_RTOL * float(ref.abs().max())


def test_k1_rejects_bad_input(cuda):
    tbl = torch.zeros((6, 4, 12 * 3), device=cuda)
    cd = torch.zeros(3, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bilinear_rows(tbl, cd, cd, torch.zeros((3, 4)))             # w4 on the CPU
    with pytest.raises(ValueError):
        bilinear_rows(tbl[:, :, :-2].contiguous(), cd, cd, torch.zeros((3, 4), device=cuda))


def test_llk_parity_on_card(cuda):
    problem = build_flagship(**TEST_SIZE, seed=5, device=cuda)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q = np.random.default_rng(0).uniform(lower, upper, size=(64, lower.size))
    q = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    before = bilinear_contract.launches
    llk = logp(q, data)
    assert bilinear_contract.launches == before + 1
    table = problem.composites["seismic"].tables[0]
    table.rows_fn = bilinear_rows_reference
    table.contract_fn = bilinear_contract_reference
    llk_plain = logp(q, data)
    assert torch.isfinite(llk).all()
    np.testing.assert_allclose(llk.cpu().numpy(), llk_plain.cpu().numpy(), rtol=LLK_RTOL)


@pytest.mark.parametrize("cd_rows,nz,m,n", [(3 * 11, 5, 12 * 65, 1001),
                                            (3 * 206, 15, 12 * 513, 60000)])
def test_k2_matches_plain(cuda, cd_rows, nz, m, n):
    gen = torch.Generator(device=cuda).manual_seed(n + 1)
    tbl = torch.randn((cd_rows, nz, m), generator=gen, device=cuda)
    cd = torch.randint(0, cd_rows - 1, (n,), generator=gen, device=cuda)
    z0 = torch.randint(0, nz - 1, (n,), generator=gen, device=cuda)
    z0[::5] = nz - 2
    g = torch.randn((n, m), generator=gen, device=cuda)
    before = corner_dot.launches
    got = corner_dot(tbl, cd, z0, g)
    torch.cuda.synchronize()
    assert corner_dot.launches == before + 1
    ref = corner_dot_reference(tbl, cd, z0, g)
    rows = corner_rows_reference(tbl, cd, z0)
    bar = K2_RTOL * g.abs().sum(-1) * rows.abs().amax(dim=(1, 2))
    assert bool(((got - ref).abs().amax(-1) <= bar).all())


def test_grad_parity_on_card(cuda):
    problem = build_flagship(**TEST_SIZE, seed=5, device=cuda)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    span = upper - lower
    q = np.random.default_rng(1).uniform(lower + 0.01 * span, upper - 0.01 * span,
                                         size=(64, lower.size))
    q = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    k1c, k2c = bilinear_contract.launches, contract_corner_dot.launches
    llk, grad = value_and_grad(logp, q, (data,))
    assert bilinear_contract.launches == k1c + 1 and contract_corner_dot.launches == k2c + 1
    table = problem.composites["seismic"].tables[0]
    table.rows_fn = bilinear_rows_reference
    table.contract_fn = bilinear_contract_reference
    llk_plain, grad_plain = value_and_grad(logp, q, (data,))
    assert torch.isfinite(grad).all()
    np.testing.assert_allclose(llk.cpu().numpy(), llk_plain.cpu().numpy(), rtol=LLK_RTOL)
    assert_grad_close(grad.cpu().numpy(), grad_plain.cpu().numpy(), GRAD_RTOL, GRAD_RTOL)


def test_hessian_double_backward_launches_k1(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    tbl = torch.randn((3 * 6, 4, 12 * 9), generator=gen, device=cuda)
    n = 5
    cd = torch.randint(0, 3 * 6 - 1, (n,), generator=gen, device=cuda)
    z0 = torch.randint(0, 3, (n,), generator=gen, device=cuda)
    w = torch.rand((n * 4,), generator=gen, device=cuda)

    def f(rows_fn):
        return lambda x: torch.sum(torch.tanh(rows_fn(tbl, cd, z0, x.reshape(n, 4))) ** 2)

    k1, k2 = bilinear_rows.launches, corner_dot.launches
    hess = torch.autograd.functional.hessian(f(bilinear_rows), w)
    torch.cuda.synchronize()
    # forward K1, one K2 per Hessian row's first backward, and K1 again in
    # every row's double backward (CornerDot.backward)
    assert corner_dot.launches - k2 >= n * 4
    assert bilinear_rows.launches - k1 > n * 4
    want = torch.autograd.functional.hessian(f(bilinear_rows_reference), w)
    torch.testing.assert_close(hess, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def _contract_queries(layout, CD, NZ, C, T, gen, dev):
    """(cd, z0) of C chains × T targets, (C, T) as the forward issues
    them (flat (C,) where T is 1): every chain of a target on one cell, on
    three cells (the depth cells of the main path's prior), or anywhere
    (top-edge indices among them, which the wrapper clamps)."""
    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    if layout == "random":
        cd, z0 = ints(CD - 1, (C, T)), ints(NZ, (C, T))
        cd[::7] = CD - 1
    else:
        cd = ints(CD - 1, (1, T)).expand(C, T)
        z0 = ints(NZ - 3, (1, T)) + (0 if layout == "one_cell" else ints(3, (C, 1)))
    lead = (C, T) if T > 1 else (C,)
    return cd.reshape(lead).contiguous(), z0.expand(C, T).reshape(lead).contiguous()


def _at_odd_offset(shape, gen, dev):
    """A contiguous float32 tensor whose storage starts 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.randn(n + 1, generator=gen, device=dev)[1:].view(shape)


CONTRACT_SHAPES = [(3 * 11, 5, 65, 37, 3),          # the test size, a ragged chain tile
                   (3 * 6, 4, 9, 5, 2),             # fewer chains than a tile
                   (3 * 11, 5, 64, 300, 1),         # L ≡ 0 (mod 4), (n,) queries
                   (3 * 206, 15, 513, 2000, 30),    # the main path: 60,000 queries
                   (3 * 12, 8, 1201, 40, 12)]       # L = 2402 > one staging chunk


@pytest.mark.parametrize("layout", ["one_cell", "three_cells", "random"])
@pytest.mark.parametrize("CD,NZ,nf,C,T", CONTRACT_SHAPES)
def test_k1c_matches_plain(cuda, CD, NZ, nf, C, T, layout):
    gen = torch.Generator(device=cuda).manual_seed(C * T + nf)
    tbl = torch.randn((CD, NZ, 12 * nf), generator=gen, device=cuda)
    cd, z0 = _contract_queries(layout, CD, NZ, C, T, gen, cuda)
    A = _at_odd_offset(cd.shape + (4, 6), gen, cuda)
    before = bilinear_contract.launches
    got = bilinear_contract(tbl, cd, z0, A)
    torch.cuda.synchronize()
    assert bilinear_contract.launches == before + 1
    assert torch.equal(got, bilinear_contract(tbl, cd, z0, A))   # no atomics
    cd, z0 = cd.clamp(max=CD - 2), z0.clamp(max=NZ - 2)      # the plain versions do not clamp
    ref = bilinear_contract_reference(tbl, cd, z0, A)
    rows = corner_rows_reference(tbl, cd.reshape(-1), z0.reshape(-1))
    bar = CONTRACT_RTOL * A.abs().sum((-2, -1)).reshape(-1) * rows.abs().amax(dim=(1, 2))
    assert bool(((got - ref).abs().amax(-1).reshape(-1) <= bar).all())


@pytest.mark.parametrize("layout", ["one_cell", "three_cells", "random"])
@pytest.mark.parametrize("CD,NZ,nf,C,T", CONTRACT_SHAPES)
def test_k2c_matches_plain(cuda, CD, NZ, nf, C, T, layout):
    gen = torch.Generator(device=cuda).manual_seed(C * T + nf + 1)
    tbl = torch.randn((CD, NZ, 12 * nf), generator=gen, device=cuda)
    cd, z0 = _contract_queries(layout, CD, NZ, C, T, gen, cuda)
    G = _at_odd_offset(cd.shape + (2 * nf,), gen, cuda)
    before = contract_corner_dot.launches
    got = contract_corner_dot(tbl, cd, z0, G)
    torch.cuda.synchronize()
    assert contract_corner_dot.launches == before + 1
    assert torch.equal(got, contract_corner_dot(tbl, cd, z0, G))
    cd, z0 = cd.clamp(max=CD - 2), z0.clamp(max=NZ - 2)      # the plain versions do not clamp
    ref = contract_corner_dot_reference(tbl, cd, z0, G)
    rows = corner_rows_reference(tbl, cd.reshape(-1), z0.reshape(-1))
    bar = CONTRACT_RTOL * G.abs().sum(-1).reshape(-1) * rows.abs().amax(dim=(1, 2))
    assert bool(((got - ref).abs().amax(dim=(-2, -1)).reshape(-1) <= bar).all())


def test_hessian_double_backward_launches_k1c_and_k2c(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    tbl = torch.randn((3 * 6, 4, 12 * 9), generator=gen, device=cuda)
    n = 6
    cd = torch.randint(0, 3 * 6 - 1, (2, n // 2), generator=gen, device=cuda)
    z0 = torch.randint(0, 3, (2, n // 2), generator=gen, device=cuda)
    a = torch.rand((n * 24,), generator=gen, device=cuda)

    def f(contract_fn):
        return lambda x: torch.sum(torch.tanh(contract_fn(tbl, cd, z0,
                                                          x.reshape(2, n // 2, 4, 6))) ** 2)

    k1c, k2c = bilinear_contract.launches, contract_corner_dot.launches
    hess = torch.autograd.functional.hessian(f(bilinear_contract), a)
    torch.cuda.synchronize()
    # forward K1c, K2c in the first backward, K1c in every row's double backward
    assert contract_corner_dot.launches - k2c >= 1
    assert bilinear_contract.launches - k1c > n * 24
    want = torch.autograd.functional.hessian(f(bilinear_contract_reference), a)
    torch.testing.assert_close(hess, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_laplace_hessian_on_card_launches_the_pair_and_no_plain_version(cuda, monkeypatch):
    """Laplace at the true source, moment tensor pinned (its scale is a
    null direction of the curvature): K1c forward and in every Hessian
    row, K2c in the backward, and neither K1, K2 nor a plain version."""
    problem = build_flagship(**TEST_SIZE, seed=5, device=cuda)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    m6 = dict(zip(("mnn", "mee", "mdd", "mne", "mnd", "med"), sdr_to_m6(*TRUE_SDR).numpy()))
    for name, value in m6.items():
        lower[problem.ordering[name].slc] = upper[problem.ordering[name].slc] = value
    q_true = problem.ordering.to_array(dict(
        m6, magnitude=TRUE_MAGNITUDE, depth=TRUE_DEPTH, time=0.0, duration=TRUE_DURATION,
        h_any_P_0=0.0, h_any_S_1=0.0))
    plain = []
    for name in ("bilinear_contract_reference", "contract_corner_dot_reference",
                 "bilinear_rows_reference", "corner_dot_reference"):
        monkeypatch.setattr(bilgather, name, lambda *a, _n=name, **k: plain.append(_n))
    counts = (bilinear_contract.launches, contract_corner_dot.launches,
              bilinear_rows.launches, corner_dot.launches)
    lap = laplace_approximation(logp, q_true, lower, upper, logp_args=(data,), device=cuda)
    torch.cuda.synchronize()
    launched = [now - before for now, before in zip(
        (bilinear_contract.launches, contract_corner_dot.launches, bilinear_rows.launches,
         corner_dot.launches), counts)]
    assert launched[0] > 1 and launched[1] >= 1 and launched[2:] == [0, 0]
    assert not plain and np.isfinite(lap["log_evidence"]) and lap["curvature_ok"]


KERNEL_OPS = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
{setup}
{call}                                  # builds the kernel and warms up
torch.cuda.synchronize()
before = {counter}
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    {call}
    torch.cuda.synchronize()
ops = [e.key for e in prof.key_averages()
       if e.device_type == torch.autograd.DeviceType.CUDA for _ in range(e.count)]
print(json.dumps({{"ops": ops, "launches": {counter} - before}}))
"""


def _kernel_ops(setup: str, call: str, counter: str) -> list:
    """Names of the device operations one ``call`` makes, read by the
    first ``torch.profiler`` session of a fresh process (a later session
    in one process can record no device event at all).  ``setup`` makes
    the inputs; ``counter`` is the wrapper's launch counter, which must
    count exactly one launch of the profiled call.  A profile without a
    device record fails: it cannot tell how many kernels ran."""
    import json
    import os
    import subprocess
    import sys

    code = KERNEL_OPS.format(setup=setup, call=call, counter=counter)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches"] == 1, out
    assert out["ops"], "the profile holds no device record: the kernel count is unknown"
    return out["ops"]


@pytest.mark.parametrize("variant", [None, "tiled", "gather"])
@pytest.mark.parametrize("interpolation", ["multilinear", "nearest_neighbor"])
@pytest.mark.parametrize("C,T,P,D,S,N", [
    (37, 3, 11, 4, 9, 100),        # ragged tiles, float4 rows, a half-used n tile
    (5, 2, 33, 2, 2, 101),         # N % 4 != 0: the plan keeps the gather variant
    (1030, 2, 45, 3, 5, 72),       # three chain tiles, the last ragged; 6 chunks of patches
    (300, 3, 20, 3, 4, 24),        # N <= 32: the narrow n tile
    (600, 2, 9, 20, 32, 64),       # D·S = 640: only the narrow n tile fits
    (2000, 8, 12, 6, 16, 256)])    # the GF-stack bench shape
def test_k3_k4_match_plain(cuda, interpolation, variant, C, T, P, D, S, N):
    gen = torch.Generator(device=cuda).manual_seed(C + N)
    lib = SeismicGFLibrary(torch.randn((T, P, D, S, N), generator=gen, device=cuda),
                           duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                           starttime_sampling=0.25, device=cuda)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=cuda)

    # on the grids and beyond them on both sides: the weights leave [0, 1]
    durations = uniform((C, P), 0.0, 0.5 * (D + 1))
    starttimes = uniform((C, T, P), -0.5, 0.25 * (S + 2))
    # slips as the sampler hands them on: a column slice of a wider matrix
    slips = uniform((C, P + 5), 0.0, 3.0)[:, 2:2 + P]
    didx, rtf = lib.durations2idxs(durations, interpolation)
    sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
    if variant == "tiled" and N % 4 != 0:
        with pytest.raises(ValueError, match="16-byte"):
            stack_batched(lib.data, didx, sidx, slips, rtf, stf, variant=variant)
        return
    name = "launches_multilinear" if rtf is not None else "launches_nearest"
    before = getattr(stack_batched, name)
    got = stack_batched(lib.data, didx, sidx, slips, rtf, stf, variant=variant)
    torch.cuda.synchronize()
    assert getattr(stack_batched, name) == before + 1
    ref = stack_batched_reference(lib.data, didx, sidx, slips, rtf, stf)
    wabs = 1.0
    if rtf is not None:
        wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
    bar = STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1) * lib.data.abs().max()
    assert bool(((got - ref).abs().amax(-1) <= bar).all())
    # both variants add the same products in the same order
    assert torch.equal(got, stack_batched(lib.data, didx, sidx, slips, rtf, stf,
                                          variant="gather"))
    # shared onsets, (C, 1, P), are every target's onsets
    shared = stack_batched(lib.data, didx, sidx[:, :1], slips, rtf,
                           None if stf is None else stf[:, :1], variant=variant)
    assert torch.equal(shared, stack_batched(
        lib.data, didx, sidx[:, :1].expand(C, T, P), slips, rtf,
        None if stf is None else stf[:, :1].expand(C, T, P), variant=variant))


def test_k3_plan_covers_both_variants_on_the_card(cuda):
    """The shapes above reach the tiled kernel with both n tiles and the
    gather kernel by the plan's own choice."""
    chosen = {(plan_stack(T, P, D, S, N, C, corners).variant,
               plan_stack(T, P, D, S, N, C, corners).lanes)
              for corners in (4, 1)
              for C, T, P, D, S, N in [(37, 3, 11, 4, 9, 100), (5, 2, 33, 2, 2, 101),
                                       (1030, 2, 45, 3, 5, 72), (300, 3, 20, 3, 4, 24),
                                       (600, 2, 9, 20, 32, 64), (2000, 8, 12, 6, 16, 256)]}
    assert chosen == {("tiled", 16), ("tiled", 8), ("gather", 0)}


def test_k3_main_path_call_is_one_kernel_and_one_allocation(cuda):
    """int32 indices, (C, 1, P) onsets and a slice of the samples go to the
    kernel as they are: one device operation, the output the only allocation."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    C, T, P, D, S, N = 2000, 12, 18, 10, 32, 96
    data = torch.randn((T, P, D, S, N), generator=gen, device=cuda)
    didx = torch.randint(1, D, (C, P), generator=gen, device=cuda, dtype=torch.int32)
    sidx = torch.randint(1, S, (C, 1, P), generator=gen, device=cuda, dtype=torch.int32)
    slips = torch.rand((C, 3 * P + 4), generator=gen, device=cuda)[:, P:2 * P]
    rtf = torch.rand((C, P), generator=gen, device=cuda)
    stf = torch.rand((C, 1, P), generator=gen, device=cuda)
    stack_batched(data, didx, sidx, slips, rtf, stf)            # builds and warms
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = stack_batched(data, didx, sidx, slips, rtf, stf)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= out.numel() * 4 + 2**21
    ops = _kernel_ops(f"""
from beat_tpu_torch.ops.gfstack import stack_batched
gen = torch.Generator(device="cuda").manual_seed(0)
C, T, P, D, S, N = {(C, T, P, D, S, N)}
data = torch.randn((T, P, D, S, N), generator=gen, device="cuda")
didx = torch.randint(1, D, (C, P), generator=gen, device="cuda", dtype=torch.int32)
sidx = torch.randint(1, S, (C, 1, P), generator=gen, device="cuda", dtype=torch.int32)
slips = torch.rand((C, 3 * P + 4), generator=gen, device="cuda")[:, P:2 * P]
rtf = torch.rand((C, P), generator=gen, device="cuda")
stf = torch.rand((C, 1, P), generator=gen, device="cuda")
""", "stack_batched(data, didx, sidx, slips, rtf, stf)", "stack_batched.launches_multilinear")
    assert len(ops) == 1 and "gf_stack" in ops[0]


def test_k3_rejects_bad_input(cuda):
    data = torch.zeros((2, 3, 2, 2, 8), device=cuda)
    didx = torch.ones((4, 3), dtype=torch.int32, device=cuda)
    sidx = torch.ones((4, 2, 3), dtype=torch.int32, device=cuda)
    slips = torch.ones((4, 3), device=cuda)
    with pytest.raises(ValueError):
        stack_batched(data, didx, sidx, slips.cpu())                  # slips on the CPU
    with pytest.raises(ValueError):
        stack_batched(data.double(), didx, sidx, slips.double())      # float64 on the card
    with pytest.raises(NotImplementedError):
        stack_batched(data, didx, sidx, slips.requires_grad_())


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("R,M,n", [(500, 1548, 700), (97, 333, 41), (9270, 6156, 60000),
                                   (50, 8, 3000), (7, 1, 5000),     # rows shorter than a block
                                   (2000, 1504, 2000)])             # the FFI population
def test_k5_matches_plain(cuda, R, M, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(R)
    tbl = torch.randn((R, M), generator=gen, device=cuda)
    # clipped at both ends
    idx = torch.randint(-3, R + 3, (n,), generator=gen, device=cuda).to(dtype)
    far = 2**40 if dtype == torch.int64 else 2**31 - 1
    idx[::7], idx[1::7] = far, -far
    before = gather_rows.launches
    got = gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_reference(tbl, idx))
    # a strided index view goes to the kernel as it is
    assert torch.equal(gather_rows(tbl, torch.stack([idx, idx], 1)[:, 1]), got)


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_k5_call_is_one_kernel(cuda, dtype):
    ops = _kernel_ops(f"""
from beat_tpu_torch.ops.rowgather import gather_rows
tbl = torch.randn((2000, 1504), device="cuda")
idx = torch.randint(0, 2000, (2000,), device="cuda").to({dtype})
""", "gather_rows(tbl, idx)", "gather_rows.launches")
    assert len(ops) == 1 and "gather_rows_kernel" in ops[0]


@pytest.mark.parametrize("interpolation", ["multilinear", "nearest_neighbor"])
def test_ffi_llk_parity_on_card(cuda, interpolation):
    problem = build_ffi_flagship(**FFI_TEST_SIZE, seed=5, device=cuda,
                                 interpolation=interpolation)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q = np.random.default_rng(0).uniform(lower, upper, size=(64, lower.size))
    q = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    before = stack_batched.launches_multilinear + stack_batched.launches_nearest
    llk = logp(q, data)
    assert stack_batched.launches_multilinear + stack_batched.launches_nearest == before + 1
    problem.composites["seismic"].libs[0]["uparr"].stack_fn = stack_batched_reference
    llk_plain = logp(q, data)
    assert torch.isfinite(llk).all()
    # the llk is the difference of its residual-free part llk0 and the
    # whitened misfit and passes through 0: the bar is on |llk| + |llk0|
    h = problem.ordering.to_point(q)["h_any_P_0"]
    llk0 = -0.5 * (data[0][0]["slog_pdets"].sum()
                   + data[0][0]["nsamples"].sum() * (2.0 * h + np.log(2.0 * np.pi)))
    bar = LLK_RTOL * (llk_plain.abs() + llk0.abs())
    assert bool(((llk - llk_plain).abs() <= bar).all())


def _subsource_queries(table, layout, C, gen):
    """K1c queries of sources made of K point sources, on a real table:
    the 8 × 5 patches of rectangles (or a ring of 8 sub-sources) of C
    random chains, laid out (C, K, T) or (K, C, T)."""
    from beat_tpu_torch.sources import rectangular_patch_grid

    dev = table.freqs.device

    def u(lo, hi, shape=(C,)):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    if layout == "ring":
        phi = torch.arange(8, device=dev) * (2 * np.pi / 8)
        r = u(500.0, 2500.0)[:, None]
        east, north = r * torch.cos(phi), r * torch.sin(phi)
        depth = u(3e3, 18e3)[:, None].expand(C, 8)
    else:
        east, north, depth, _, _ = rectangular_patch_grid(
            u(0.0, 180.0), u(20.0, 80.0), u(6e3, 10e3), u(3e3, 6e3), u(-3e3, 3e3),
            u(-3e3, 3e3), u(4e3, 10e3), 8, 5)
    if layout == "patches_first":
        east, north, depth = (x.transpose(0, 1).contiguous() for x in (east, north, depth))
    n_st = 10
    az = torch.arange(n_st, device=dev) * (2 * np.pi / n_st)
    st_e, st_n = (100e3 * torch.sin(az)).repeat(3), (100e3 * torch.cos(az)).repeat(3)
    comp = torch.arange(3, device=dev).repeat_interleave(n_st)
    distance = torch.sqrt((st_e - east[..., None]) ** 2 + (st_n - north[..., None]) ** 2)
    cd, z0, w4 = table._corner_queries(distance, depth, comp)
    m6 = torch.randn(cd.shape + (6,), generator=gen, device=dev)
    return cd, z0, w4[..., :, None] * m6[..., None, :]


@pytest.mark.parametrize("layout", ["chains_first", "patches_first", "ring"])
def test_k1c_k2c_match_plain_on_subsource_layouts(cuda, layout):
    """K1c and K2c against their plain versions on the query layouts of the
    finite rectangle ((C, K, T) and (K, C, T), K = 40) and of a ring of
    sub-sources, on the real-size table's grid."""
    from beat_tpu_torch.flagship import REAL_SIZE, flagship_table

    table = flagship_table(REAL_SIZE["n_distances"], REAL_SIZE["n_depths"], 256, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    cd, z0, A = _subsource_queries(table, layout, 64, gen)
    tbl = table.packed
    k1c, k2c = bilinear_contract.launches, contract_corner_dot.launches
    got = bilinear_contract(tbl, cd, z0, A)
    G = torch.randn(got.shape, generator=gen, device=cuda)
    got_p = contract_corner_dot(tbl, cd, z0, G)
    torch.cuda.synchronize()
    assert (bilinear_contract.launches, contract_corner_dot.launches) == (k1c + 1, k2c + 1)
    rows = corner_rows_reference(tbl, cd.reshape(-1), z0.reshape(-1)).abs().amax(dim=(1, 2))
    ref = bilinear_contract_reference(tbl, cd, z0, A)
    bar = CONTRACT_RTOL * A.abs().sum((-2, -1)).reshape(-1) * rows
    assert bool(((got - ref).abs().amax(-1).reshape(-1) <= bar).all())
    ref_p = contract_corner_dot_reference(tbl, cd, z0, G)
    bar = CONTRACT_RTOL * G.abs().sum(-1).reshape(-1) * rows
    assert bool(((got_p - ref_p).abs().amax(dim=(-2, -1)).reshape(-1) <= bar).all())


@pytest.mark.parametrize("source", ["RectangularSource", "DoubleDCSource", "RingfaultSource"])
def test_subsource_llk_and_grad_parity_on_card(cuda, source):
    """A source made of K point sources on the card: one K1c launch per
    likelihood, one K2c per value-and-grad, the same llk and gradient as
    through the plain versions."""
    problem = build_flagship(**TEST_SIZE, seed=5, device=cuda, source=source)
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    span = upper - lower
    q = torch.as_tensor(np.random.default_rng(2).uniform(
        lower + 0.01 * span, upper - 0.01 * span, size=(64, lower.size)), dtype=torch.float32,
        device=cuda)
    k1c, k2c = bilinear_contract.launches, contract_corner_dot.launches
    llk, grad = value_and_grad(logp, q, (data,))
    assert (bilinear_contract.launches, contract_corner_dot.launches) == (k1c + 1, k2c + 1)
    table = problem.composites["seismic"].tables[0]
    table.contract_fn = bilinear_contract_reference
    llk_plain, grad_plain = value_and_grad(logp, q, (data,))
    assert torch.isfinite(llk).all() and torch.isfinite(grad).all()
    np.testing.assert_allclose(llk.cpu().numpy(), llk_plain.cpu().numpy(), rtol=LLK_RTOL)
    assert_grad_close(grad.cpu().numpy(), grad_plain.cpu().numpy(), GRAD_RTOL, GRAD_RTOL)


# -- the geodetic slice: plain torch on the card against float64 on the host --


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_okada_forwards_on_card_match_float64_host(cuda, dtype):
    """The rectangle, Mogi and the MT expansion on the card against the
    host in float64: in float64 (``okada.FORWARD_DTYPE``, as the port's
    callers evaluate them) to rounding; in float32 within what their
    Chinnery sums allow, 1e-3 · max|u| for the rectangle and 2e-2 for the
    MT expansion (the host's own float32 reads 9.3e-3 on these sources)."""
    from beat_tpu_torch.heart.okada import (mogi_surface_displacement, mt_surface_displacement,
                                            okada_surface_displacement)

    rng = np.random.default_rng(0)
    coords = rng.uniform(-30e3, 30e3, (3000, 2))
    rect = {k: rng.uniform(lo, hi, 64) for k, (lo, hi) in dict(
        east_shift=(-3e3, 3e3), north_shift=(-3e3, 3e3), depth=(500.0, 4e3),
        strike=(0.0, 360.0), dip=(30.0, 80.0), rake=(-180.0, 180.0), length=(4e3, 16e3),
        width=(3e3, 12e3), slip=(0.1, 2.0), opening=(0.0, 0.3)).items()}
    m6 = rng.normal(size=(64, 6)) * 1e17
    pos = {k: rng.uniform(lo, hi, 64) for k, (lo, hi) in dict(
        east_shift=(-3e3, 3e3), north_shift=(-3e3, 3e3), depth=(2e3, 9e3)).items()}

    def on(where, dt, x):
        return torch.as_tensor(x, dtype=dt, device=where)

    cases = [
        (okada_surface_displacement, lambda w, dt: ((on(w, dt, coords),),
                                                    {k: on(w, dt, v) for k, v in rect.items()}),
         1e-9 if dtype == torch.float64 else 1e-3),
        (mogi_surface_displacement, lambda w, dt: ((on(w, dt, coords), *(on(w, dt, v) for v in
                                                   pos.values()), on(w, dt, np.full(64, 1e6))),
                                                   {}), 1e-5),
        (mt_surface_displacement, lambda w, dt: ((on(w, dt, coords), on(w, dt, m6)),
                                                 {k: on(w, dt, v) for k, v in pos.items()}),
         1e-6 if dtype == torch.float64 else 2e-2),
    ]
    for fn, args, bar in cases:
        a, kw = args(cuda, dtype)
        got = fn(*a, **kw).double().cpu()
        a, kw = args("cpu", torch.float64)
        want = fn(*a, **kw)
        scale = want.abs().amax(dim=(1, 2), keepdim=True)
        assert torch.isfinite(got).all() and ((got - want).abs() <= bar * scale).all(), fn


def test_static_table_build_and_gather_on_card(cuda):
    from beat_tpu_torch.heart.statictable import build_homogeneous_static_table

    d, z = np.linspace(0.0, 60e3, 121), np.linspace(0.5e3, 16e3, 32)
    card = build_homogeneous_static_table(d, z, device=cuda)
    host = build_homogeneous_static_table(d, z, device="cpu")
    np.testing.assert_allclose(card.values.cpu().numpy(), host.values.numpy(), rtol=1e-6,
                               atol=1e-6 * float(host.values.abs().max()))
    rng = np.random.default_rng(1)
    m6 = rng.normal(size=(256, 6)) * 1e17
    e, n, dep = rng.uniform(-3e3, 3e3, 256), rng.uniform(-3e3, 3e3, 256), rng.uniform(1e3, 15e3,
                                                                                       256)
    obs = rng.uniform(-40e3, 40e3, (2, 500))
    args = [m6, e, n, dep, obs[0], obs[1]]
    got = card.synthesize_enu(*(torch.as_tensor(x, dtype=torch.float32, device=cuda)
                                for x in args)).double().cpu()
    want = host.to(torch.float64).synthesize_enu(*(torch.as_tensor(x) for x in args))
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() <= 1e-5 * scale).all()


def test_static_library_build_on_card_matches_host(cuda):
    """The static library of the real-size fault geometry, built on the
    card, against the host build: every column within 1e-4 · max|G|."""
    from beat_tpu_torch.ffi.gflibrary import geo_construct_gf_linear
    from beat_tpu_torch.flagship import FFI_PATCH, FFI_PLANE, discretize_sources
    from beat_tpu_torch.heart.geodesy import los_vectors
    from beat_tpu_torch.sources import RectangularSource

    ref = RectangularSource(length=20 * FFI_PATCH, width=5 * FFI_PATCH, **FFI_PLANE)
    fault = discretize_sources([ref], FFI_PATCH, FFI_PATCH, components=("uparr", "uperp"))
    rng = np.random.default_rng(2)
    coords = rng.uniform(-60e3, 60e3, (1500, 2))
    los = los_vectors(1500, 23.0, -13.0)
    card = geo_construct_gf_linear(fault, coords, los, components=("uparr", "uperp", "utens"),
                                   device=cuda)
    host = geo_construct_gf_linear(fault, coords, los, components=("uparr", "uperp", "utens"),
                                   device="cpu")
    for c in ("uparr", "uperp", "utens"):
        G, H = card.gf(c).cpu(), host.gf(c)
        assert ((G - H).abs() <= 1e-4 * H.abs().max()).all(), c


@pytest.mark.parametrize("source", ["RectangularSource", "DCSource", "gnss", "table"])
def test_geodetic_llk_and_grad_on_card_match_float64_host(cuda, source):
    """The geodetic composite's llk and gradient on the card against the
    same code in float64 on the host (the bars of ``chip_smoke.py``
    [geo_llk]: rtol 2e-5 of |llk| plus its residual-free terms' scale;
    the per-parameter gradient bar)."""
    import copy
    import math

    from beat_tpu_torch.flagship import GEO_TEST_SIZE, build_geodetic_flagship
    from beat_tpu_torch.heart.statictable import build_homogeneous_static_table

    kw = {}
    if source == "gnss":
        kw = dict(gnss_stations=20)
    elif source == "table":
        kw = dict(static_table=build_homogeneous_static_table(
            np.linspace(0.0, 80e3, 81), np.linspace(0.5e3, 20e3, 40), device=cuda))
    problem = build_geodetic_flagship(**GEO_TEST_SIZE, device=cuda, source=(
        source if source in ("RectangularSource", "DCSource") else "RectangularSource"), **kw)
    comp = problem.composites["geodetic"]
    lo, hi = problem.priors.bounds_arrays()
    q = np.random.default_rng(5).uniform(lo + 0.01 * (hi - lo), hi - 0.01 * (hi - lo),
                                         size=(64, lo.size))
    logp, data = problem.make_logp_fn()
    llk, grad = value_and_grad(logp, torch.as_tensor(q, dtype=torch.float32, device=cuda),
                               (data,))
    ref = copy.deepcopy(comp).to("cpu", torch.float64)
    llk64, grad64 = value_and_grad(lambda x: ref.loglike(problem.ordering.to_point(x)),
                                   torch.as_tensor(q))
    point = problem.ordering.to_point(q)
    scale = sum(abs(ds.covariance.log_pdet) + ds.samples * np.abs(
        2.0 * point.get(comp._hypername(i, ds), 0.0) + math.log(2 * math.pi))
        for i, ds in enumerate(comp.datasets))
    bar = LLK_RTOL * (llk64.abs().numpy() + scale)
    assert (np.abs(llk.double().cpu().numpy() - llk64.numpy()) <= bar).all()
    assert_grad_close(grad.double().cpu().numpy(), grad64.numpy(), GRAD_RTOL, GRAD_RTOL)


# -- the samplers' plain-torch steps and the bf16 library (slice 8) ------------------


def _bf16_case(cuda, C, T, P, D, S, N, interpolation, seed, spread=False):
    """A random bf16 library and the operands of one K3/K4 call: onsets on
    the grids and beyond them, or (``spread``) chains stepped over every
    (duration, starttime) cell, so a group's rows cover the whole grid."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lib = SeismicGFLibrary(torch.randn((T, P, D, S, N), generator=gen, device=cuda),
                           duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                           starttime_sampling=0.25, device=cuda, dtype=torch.bfloat16)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=cuda)

    if spread:
        cell = (torch.arange(C, device=cuda)[:, None] * 7 + torch.arange(P, device=cuda)[None, :]
                * 3) % (D * S)
        durations = 0.5 + 0.5 * (cell // S).float() + uniform((C, P), 0.0, 0.5)
        starttimes = (0.25 * (cell % S).float() + uniform((C, P), 0.0, 0.25))[:, None, :]
        starttimes = starttimes.expand(C, T, P).contiguous()
    else:
        durations = uniform((C, P), 0.0, 0.5 * (D + 1))
        starttimes = uniform((C, T, P), -0.5, 0.25 * (S + 2))
    slips = uniform((C, P), 0.0, 3.0)
    didx, rtf = lib.durations2idxs(durations, interpolation)
    sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
    return lib.data, didx, sidx, slips, rtf, stf


def _stack_bar(data, slips, rtf, stf):
    wabs = 1.0
    if rtf is not None:
        wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
    return STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1) * data.float().abs().max()


@pytest.mark.parametrize("variant", [None, "tiled", "gather", "mma"])
@pytest.mark.parametrize("interpolation", ["multilinear", "nearest_neighbor"])
@pytest.mark.parametrize("C,T,P,D,S,N", [
    (37, 3, 11, 4, 9, 64),         # ragged chain tile, N = 64: one bf16 n tile
    (600, 2, 9, 20, 32, 64),       # D·S = 640: the wide n tile fits in bf16
    (2000, 4, 40, 10, 32, 512),    # the Laquila rows, N = 512
    (5, 2, 33, 2, 2, 102),         # N % 4 != 0: gather only, scalar loads
    (1030, 2, 13, 3, 5, 40)])      # mma: three chain tiles, the last ragged; a ragged n tile
def test_k3_k4_bf16_match_plain(cuda, interpolation, variant, C, T, P, D, S, N):
    """K3 and K4 on a bfloat16 library against the plain version on the
    same bf16 tensor (its rows widened to float32); ``tiled`` and
    ``gather`` equal bit for bit, ``mma`` (K3 only) equal to itself on a
    second call."""
    data, didx, sidx, slips, rtf, stf = _bf16_case(cuda, C, T, P, D, S, N, interpolation,
                                                   C + N + 1)
    if variant == "mma" and rtf is None:
        with pytest.raises(ValueError, match="K3 only"):
            stack_batched(data, didx, sidx, slips, rtf, stf, variant=variant)
        return
    if (variant == "tiled" and N % 4 != 0) or (variant == "mma" and N % 8 != 0):
        with pytest.raises(ValueError, match="16-byte"):
            stack_batched(data, didx, sidx, slips, rtf, stf, variant=variant)
        return
    before = stack_batched.launches_bf16
    got = stack_batched(data, didx, sidx, slips, rtf, stf, variant=variant)
    torch.cuda.synchronize()
    assert stack_batched.launches_bf16 == before + 1 and got.dtype == torch.float32
    ref = stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    assert bool(((got - ref).abs().amax(-1) <= _stack_bar(data, slips, rtf, stf)).all())
    again = stack_batched(data, didx, sidx, slips, rtf, stf, variant=variant)
    assert torch.equal(got, again)
    T_, P_, D_, S_, N_ = data.shape
    chosen = plan_stack(T_, P_, D_, S_, N_, C, 4 if rtf is not None else 1, variant=variant,
                        elem_bytes=2).variant
    if chosen != "mma":
        assert torch.equal(got, stack_batched(data, didx, sidx, slips, rtf, stf,
                                              variant="gather"))


@pytest.mark.parametrize("C,T,P,D,S,N", [
    (520, 2, 7, 10, 32, 512),      # the chains cover every cell of the grid at each patch
    (9, 1, 70, 4, 5, 8)])          # one chunk of samples, a long walk, one group + 1 chain
def test_k3_bf16_mma_spread_over_every_cell(cuda, C, T, P, D, S, N):
    """K3's mma variant where the chains' cells cover the whole grid (its
    32 rows a group from all over the tile, every phase of the row gather
    at its most scattered) and on ragged chain and n tiles, at the
    stack's bar; one launch, counted once, equal on a second call."""
    data, didx, sidx, slips, rtf, stf = _bf16_case(cuda, C, T, P, D, S, N, "multilinear",
                                                   C + P, spread=True)
    counts = stack_batched.launches_mma, stack_batched.launches_bf16
    got = stack_batched(data, didx, sidx, slips, rtf, stf, variant="mma")
    torch.cuda.synchronize()
    assert (stack_batched.launches_mma, stack_batched.launches_bf16) == (counts[0] + 1,
                                                                         counts[1] + 1)
    ref = stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    assert bool(((got - ref).abs().amax(-1) <= _stack_bar(data, slips, rtf, stf)).all())
    assert torch.equal(got, stack_batched(data, didx, sidx, slips, rtf, stf, variant="mma"))


def test_k3_bf16_mma_call_is_one_kernel(cuda):
    """K3 on a bf16 library at the Laquila rows takes the mma variant by
    the plan: one device operation, one launch counted."""
    ops = _kernel_ops("""
from beat_tpu_torch.ffi import SeismicGFLibrary
from beat_tpu_torch.ops.gfstack import stack_batched
gen = torch.Generator(device="cuda").manual_seed(3)
C, T, P, D, S, N = 2000, 2, 70, 10, 32, 512
lib = SeismicGFLibrary(torch.randn((T, P, D, S, N), generator=gen, device="cuda"),
                       duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                       starttime_sampling=0.25, device="cuda", dtype=torch.bfloat16)
didx, rtf = lib.durations2idxs(0.5 + 4.5 * torch.rand((C, P), generator=gen, device="cuda"),
                               "multilinear")
sidx, stf = lib.starttimes2idxs(7.75 * torch.rand((C, 1, P), generator=gen, device="cuda"),
                                "multilinear")
slips = torch.rand((C, P), generator=gen, device="cuda")
""", "stack_batched(lib.data, didx, sidx, slips, rtf, stf)", "stack_batched.launches_mma")
    assert len(ops) == 1 and "gf_stack_mma" in ops[0]


def test_swap_on_card_matches_cpu(cuda):
    from beat_tpu_torch.samplers import make_betas, swap_step

    rng = np.random.default_rng(0)
    for n, parity in ((64, 0), (64, 1), (7, 1)):
        q = torch.as_tensor(rng.normal(size=(n, 23)), dtype=torch.float32)
        llk = torch.as_tensor(rng.normal(size=n) * 3.0, dtype=torch.float32)
        betas = torch.as_tensor(make_betas(n, 2, 1.2), dtype=torch.float32)
        log_u = torch.log(torch.as_tensor(rng.uniform(size=n), dtype=torch.float32))
        want = swap_step(q, llk, betas, log_u, parity)
        got = swap_step(q.to(cuda), llk.to(cuda), betas.to(cuda), log_u.to(cuda), parity)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_masked_voronoi_slips_on_card_equal_cpu(cuda):
    from beat_tpu_torch.ffi.transd import masked_voronoi_slips

    rng = np.random.default_rng(1)
    C, K, N = 1024, 20, 500
    args = [torch.as_tensor(x, dtype=torch.float32) for x in (
        rng.uniform(0, 100e3, (C, K)), rng.uniform(0, 20e3, (C, K)), rng.uniform(0, 2, (C, K)),
        rng.uniform(size=(C, K)) < 0.5, rng.uniform(0, 100e3, N), rng.uniform(0, 20e3, N))]
    args[3][:, 0] = 1.0
    want = masked_voronoi_slips(*args)
    got = masked_voronoi_slips(*(a.to(cuda) for a in args))
    assert torch.equal(got.cpu(), want)


# -- slice 9: polarities and BEM ----------------------------------------------------------


def test_polarity_llk_on_card_matches_float64_host(cuda):
    """The joint polarity flagship's polarity llk on the card (per-draw
    takeoffs through the tables) against the same code in float64 on the
    host, rtol 2e-5 (``chip_smoke.py`` [polarity_llk])."""
    from beat_tpu_torch.flagship import POLARITY_TEST_SIZE, build_polarity_flagship
    from beat_tpu_torch.models.polarity import PolarityComposite, PolarityMapping

    problem = build_polarity_flagship(**POLARITY_TEST_SIZE, device=cuda)
    pol = problem.composites["polarity"]
    lo, hi = problem.priors.bounds_arrays()
    q = np.random.default_rng(6).uniform(lo, hi, size=(64, lo.size))
    point = problem.ordering.to_point(torch.as_tensor(q, dtype=torch.float32, device=cuda))
    with torch.no_grad():
        got = pol.loglike(point).double().cpu()
    twin = PolarityComposite(sources=pol.sources, device="cpu", maps=[
        PolarityMapping(m.wavename, m.targets, mapnumber=m.mapnumber,
                        takeoff_table=m.takeoff_table.to("cpu"), device="cpu") for m in pol.maps])
    data64 = [{k: v.double() for k, v in d.items()} for d in twin.device_data()]
    with torch.no_grad():
        want = twin.loglike({k: v.double().cpu() for k, v in point.items()}, data64)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= LLK_RTOL * want.abs()).all()


@pytest.mark.parametrize("medium", ["halfspace", "fullspace"])
def test_bem_matrices_on_card_match_host(cuda, medium):
    """The interaction and displacement matrices of a 1 km disk assembled
    on the card against the same code on the host, both float64, rtol 1e-9
    of each column's max (``tests/test_torch_bem.py``'s bar)."""
    from beat_tpu_torch.bem import BoundaryCondition, DiskBEMSource, tde

    meshes = [DiskBEMSource(a_half_axis=1e3, depth=3e3).discretize(500.0)]
    bcs = [BoundaryCondition("normal"), BoundaryCondition("strike")]
    coords = np.random.default_rng(3).uniform(-8e3, 8e3, (300, 2))
    for fn, kw in ((tde.interaction_matrix, dict(level=2, near_level=5, medium=medium)),
                   (tde.displacement_matrix, dict(coords=coords, boundary_conditions=bcs))):
        args = (meshes,) if "coords" in kw else (meshes, bcs)
        got = fn(*args, device=cuda, **kw)
        assert got.dtype == torch.float64 and got.device.type == "cuda"
        want = fn(*args, device="cpu", **kw)
        bar = 1e-9 * want.abs().amax(dim=0, keepdim=True)
        assert ((got.cpu() - want).abs() <= bar).all()


def test_cuda_composites_refuse_cpu_tensors(cuda):
    """A composite on the card given host tensors raises instead of
    moving them; an engine on the host is refused by a composite on the
    card."""
    from beat_tpu_torch.flagship import (BEM_TEST_SIZE, POLARITY_TEST_SIZE, build_bem_flagship,
                                         build_polarity_flagship)

    pol = build_polarity_flagship(**POLARITY_TEST_SIZE, device=cuda).composites["polarity"]
    host_point = {"depth": torch.full((4,), 9e3), "mnn": torch.ones(4)}
    with pytest.raises(RuntimeError):
        pol.loglike(host_point)
    for geometry in (False, True):
        problem = build_bem_flagship(**dict(BEM_TEST_SIZE, n_points=20), device=cuda,
                                     geometry=geometry)
        comp = problem.composites["geodetic"]
        host = {"normal_traction": torch.full((2,), 20.0), "depth": torch.full((2,), 3e3)}
        with pytest.raises((RuntimeError, ValueError)):
            comp.loglike(host)
        with pytest.raises(ValueError, match="engine on"):
            type(comp)(comp.datasets, comp.sources, comp.engine, device="cpu")


def test_slice9_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """Without CUDA every slice-9 entry point asked for the card raises; none
    falls back to the CPU."""
    from beat_tpu_torch.bem import BEMEngine, BoundaryCondition, DiskBEMSource, tde
    from beat_tpu_torch.flagship import POLARITY_TEST_SIZE, build_polarity_flagship
    from beat_tpu_torch.heart.polarity import TakeoffTable
    from beat_tpu_torch.models.polarity import PolarityMapping

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = [DiskBEMSource(a_half_axis=1e3, depth=3e3).discretize(1000.0)]
    calls = [
        lambda: BEMEngine([BoundaryCondition("normal")], device="cuda"),
        lambda: tde.interaction_matrix(mesh, [BoundaryCondition("normal")], device="cuda"),
        lambda: TakeoffTable.from_numpy([0.0, 1.0], [0.0, 1.0], np.zeros((2, 2)),
                                        device="cuda"),
        lambda: PolarityMapping("any_P", [], device="cuda"),
        lambda: build_polarity_flagship(**POLARITY_TEST_SIZE, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- slice 10: the table builders (float64 / complex128 torch on the card) ----------

#: card against the host CPU: float64 solves in another order; the static
#: values 1e-9 of max, the float32 tables 1e-6 of max
BUILDER_RTOL, TABLE_RTOL = 1e-9, 1e-6
TWO_LAYERS = dict(tops=[0.0, 3e3], vp=[5500.0, 6500.0], vs=[3200.0, 3700.0],
                  rho=[2600.0, 2800.0])


def _two_layers():
    from beat_tpu_torch.heart.velocity_model import LayeredModel

    return LayeredModel(**TWO_LAYERS)


def test_bessel_on_card_matches_scipy(cuda):
    import scipy.special

    from beat_tpu_torch.ops.bessel import bessel_j0, bessel_j1

    x = np.concatenate([np.linspace(-40.0, 40.0, 80001), np.linspace(40.0, 2e4, 80001)])
    for ours, ref in ((bessel_j0, scipy.special.j0), (bessel_j1, scipy.special.j1)):
        got = ours(torch.as_tensor(x, device=cuda)).cpu().numpy()
        want = ref(x)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_layered_static_table_on_card_matches_host(cuda):
    from beat_tpu_torch.heart.statictable import static_table_values
    from beat_tpu_torch.heart.velocity_model import LayeredModel

    model = LayeredModel.default_crust()
    stiff = LayeredModel(tops=model.tops, vp=model.vp * 1.1, vs=model.vs, rho=model.rho)
    args = ([model, stiff], np.linspace(1e3, 60e3, 12), np.array([2e3, 9e3, 24e3]))
    card = static_table_values(*args, device=cuda).cpu()
    host = static_table_values(*args, device="cpu")
    assert (card - host).abs().max() <= BUILDER_RTOL * host.abs().max()


def test_reflectivity_on_card_matches_host(cuda):
    from beat_tpu_torch.heart.reflectivity import ReflectivitySolver

    w = 2 * np.pi * np.linspace(0.05, 1.0, 9) - 0.01j
    w2, k2 = (w * w)[:, None], ((np.arange(400) + 0.5) * 2e-5)[None, :]
    card = ReflectivitySolver(_two_layers(), w2, k2, device=cuda).force_kernels(6.5e3)
    host = ReflectivitySolver(_two_layers(), w2, k2, device="cpu").force_kernels(6.5e3)
    for name, v in host.items():
        err = (card[name].cpu() - v).abs().amax(dim=1)
        assert (err <= 1e-10 * v.abs().amax(dim=1)).all(), name


@pytest.mark.parametrize("method", ["kennett", "band"])
def test_layered_waveform_table_on_card_matches_host(cuda, method):
    from beat_tpu_torch.heart.layered_waveforms import build_layered_waveform_table

    kw = dict(distances=np.array([30e3, 50e3, 70e3]), depths=np.array([6e3, 9e3]), nt=64,
              dt=1.0, fmax=0.4, method=method)
    stats = {}
    card = build_layered_waveform_table(_two_layers(), device=cuda, stats=stats, **kw)
    host = build_layered_waveform_table(_two_layers(), device="cpu", **kw)
    want = host.spectra
    assert (card.spectra.cpu() - want).abs().max() <= TABLE_RTOL * want.abs().max()
    assert method != "kennett" or stats["host_bins"] > 0


def test_viscoelastic_table_and_epoch_gather_on_card_match_host(cuda):
    from beat_tpu_torch.heart.velocity_model import LayeredModel
    from beat_tpu_torch.heart.viscoelastic import (BurgersRheology, EpochStaticGFTable,
                                                   build_viscoelastic_static_table)

    model = LayeredModel.default_crust()
    rheo = BurgersRheology(np.zeros(3), [0.0, 1e19, 1e18], np.ones(3))
    kw = dict(distances=np.linspace(2e3, 30e3, 3), depths=np.array([3e3, 8e3]),
              times=[30 * 86400.0, 365 * 86400.0], s_per_decade=4)
    card = build_viscoelastic_static_table(model, rheo, device=cuda, **kw)
    host = build_viscoelastic_static_table(model, rheo, device="cpu", **kw)
    scale = np.abs(host.values).max()
    assert np.abs(card.values - host.values).max() <= 1e-5 * scale
    obs_times = np.repeat([0.0, 30 * 86400.0, 365 * 86400.0], 5)
    rng = np.random.default_rng(2)
    args = [rng.normal(size=(4, 6)) * 1e16, rng.uniform(-2e3, 2e3, 4),
            rng.uniform(-2e3, 2e3, 4), rng.uniform(3e3, 8e3, 4),
            *rng.uniform(-25e3, 25e3, (2, obs_times.size))]
    out = []
    for dev in (cuda, "cpu"):
        table = EpochStaticGFTable.from_time_table(host, obs_times, device=dev)
        out.append(table.synthesize_enu(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                                          for a in args)).cpu())
    assert torch.allclose(out[0], out[1], rtol=1e-5, atol=1e-5 * float(out[1].abs().max()))


def test_slice10_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """Without CUDA every table builder asked for the card raises; none
    falls back to the CPU."""
    from beat_tpu_torch.flagship import (LAYERED_TEST_SIZE, VISCO_TEST_SIZE,
                                         build_layered_flagship, build_visco_flagship)
    from beat_tpu_torch.heart.layered_statics import elementary_mt_surface_displacements
    from beat_tpu_torch.heart.layered_waveforms import (build_layered_waveform_table,
                                                        dynamic_force_kernels)
    from beat_tpu_torch.heart.reflectivity import ReflectivitySolver
    from beat_tpu_torch.heart.statictable import build_static_table
    from beat_tpu_torch.heart.store_convert import greens_table_from_traces
    from beat_tpu_torch.heart.viscoelastic import BurgersRheology, build_viscoelastic_static_table

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _two_layers()
    obs = np.array([[0.0, 5e3]])
    calls = [
        lambda: elementary_mt_surface_displacements(model, 5e3, obs, device="cuda"),
        lambda: build_static_table(model, [5e3], [5e3], device="cuda"),
        lambda: ReflectivitySolver(model, np.ones((1, 1)), np.ones((1, 1)), device="cuda"),
        lambda: dynamic_force_kernels(model, 5e3, 1.0 - 0.1j, [1e-4], device="cuda"),
        lambda: build_layered_waveform_table(model, [3e4], [6e3], nt=16, dt=1.0,
                                             device="cuda"),
        lambda: build_viscoelastic_static_table(model, BurgersRheology.elastic(2), [5e3],
                                                [5e3], [86400.0], device="cuda"),
        lambda: greens_table_from_traces("/nonexistent.npz", 16, 1.0, device="cuda"),
        lambda: build_layered_flagship(**LAYERED_TEST_SIZE, device="cuda"),
        lambda: build_visco_flagship(**VISCO_TEST_SIZE, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# slice 11: K1c's forward-mode rule, seis_derivative and projects on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("CD,NZ,nf,C,T", CONTRACT_SHAPES)
def test_slice11_k1c_jvp_matches_the_plain_jvp(cuda, CD, NZ, nf, C, T):
    """The tangent of K1c's output for a dual ``A`` is K1c on the tangent
    (one more launch), per query within the forward's bar of the plain
    version's JVP on the same tangent; the primal is the forward."""
    import torch.autograd.forward_ad as fwAD

    gen = torch.Generator(device=cuda).manual_seed(C * T + nf + 2)
    tbl = torch.randn((CD, NZ, 12 * nf), generator=gen, device=cuda)
    cd, z0 = _contract_queries("three_cells", CD, NZ, C, T, gen, cuda)
    A = torch.randn(cd.shape + (4, 6), generator=gen, device=cuda)
    tA = torch.randn(cd.shape + (4, 6), generator=gen, device=cuda)
    before = bilinear_contract.launches
    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(bilinear_contract(tbl, cd, z0, fwAD.make_dual(A, tA)))
    torch.cuda.synchronize()
    assert bilinear_contract.launches == before + 2
    assert torch.equal(primal, bilinear_contract(tbl, cd, z0, A))
    cd, z0 = cd.clamp(max=CD - 2), z0.clamp(max=NZ - 2)
    ref = bilinear_contract_reference(tbl, cd, z0, tA)
    rows = corner_rows_reference(tbl, cd.reshape(-1), z0.reshape(-1))
    bar = CONTRACT_RTOL * tA.abs().sum((-2, -1)).reshape(-1) * rows.abs().amax(dim=(1, 2))
    assert bool(((tangent - ref).abs().amax(-1).reshape(-1) <= bar).all())


@pytest.mark.parametrize("parameter", ["depth", "mnn", "magnitude"])
def test_slice11_seis_derivative_on_card_matches_the_cpu(cuda, parameter):
    """``seis_derivative`` by forward mode through K1c on the card against
    the same problem on the CPU (the plain versions), within 1e-4 of
    max|J|; the card's launches K1c for the primal and the tangent."""
    point = dict(mnn=0.3, mee=-0.2, mdd=0.5, mne=0.1, mnd=-0.3, med=0.2, magnitude=5.8,
                 depth=8.3e3, time=0.1, duration=1.5)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        comp = build_flagship(**TEST_SIZE, seed=5, device=dev).composites["seismic"]
        before = bilinear_contract.launches
        out[dev.type] = comp.seis_derivative(point, parameter)
        if dev.type == "cuda":
            assert bilinear_contract.launches == before + 2
    scale = np.abs(out["cpu"]).max()
    assert scale > 0
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0, atol=1e-4 * scale)


def test_slice11_project_loads_and_samples_on_card(cuda, tmp_path):
    """A project written by the port loads on the card (the default
    device), samples through K1c and K5 and reads its results back."""
    from beat_tpu_torch.config import (ArrivalTaperConfig, FilterConfig, WaveformFitConfig,
                                       dump_config, init_config)
    from beat_tpu_torch.flagship import FILTER, TAPER, WAVEMAPS, flagship_datasets
    from beat_tpu_torch.inputf import save_seismic_datasets
    from beat_tpu_torch.models.problem import load_model
    from beat_tpu_torch.samplers import SMCParams

    direct = build_flagship(**TEST_SIZE, seed=5, device=cuda)
    pdir = str(tmp_path)
    cfg = init_config("p", pdir, datatypes=("seismic",), source_types=("MTSource",))
    for name in ("east_shift", "north_shift"):
        del cfg.problem_config.priors[name]
    cfg.seismic_config.waveforms = [
        WaveformFitConfig(name=n, channels=list(ch), filterer=FilterConfig(**FILTER),
                          arrival_taper=ArrivalTaperConfig(**TAPER)) for n, ch in WAVEMAPS.items()]
    dump_config(cfg, pdir)
    save_seismic_datasets([d for ds in flagship_datasets(*direct.observations).values()
                           for d in ds], pdir)
    direct.composites["seismic"].tables[0].save(f"{pdir}/gf_table.npz")
    problem = load_model(pdir)
    assert problem.device.type == "cuda"
    before = bilinear_contract.launches, gather_rows.launches
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=64, n_steps=5, seed=0))
    assert bilinear_contract.launches > before[0] and gather_rows.launches > before[1]
    assert np.isfinite(llk_tr).all()
    assert set(problem.summarize(-1)) == set(problem.ordering.names)
    assert problem.derived_samples(-1, max_samples=10)["strike1"].shape == (10,)


def test_two_gloo_ranks_on_the_card_equal_one_process(cuda, tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device): each evaluates its block of the test-size FullMT llk through
    K1c, and the gathered llk, carried by gloo's collectives from CUDA
    tensors, equals the one-process llk."""
    import torch_parallel_ranks as ranks

    results = ranks.launch(2, ("gpu_llk",), tmp_path, device="cuda", backend="gloo",
                           deadline=300.0)
    logp, data, q = ranks.gpu_llk_inputs(cuda)
    with torch.no_grad():
        want = logp(q, data).cpu().numpy()
    for r in results:
        assert r["gpu_device"] == "cuda:0" and r["gpu_k1c_launches"] > 0
        assert r["imported_jax"] == []
        np.testing.assert_allclose(r["gpu_llk"], want, rtol=LLK_RTOL)
