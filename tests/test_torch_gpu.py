"""
Tests of the port that need an NVIDIA GPU: kernels K1 and K2
(``beat_tpu_torch/csrc/bilgather.cu``) against their plain PyTorch
versions, the log-likelihood and its gradient through the kernels
against the same through the plain gather, and a Hessian whose double
backward launches K1.  They skip without a card; run them on one with

    python -m pytest tests -m gpu -q
"""

import numpy as np
import pytest
import torch

from beat_tpu_torch.flagship import TEST_SIZE, build_flagship
from beat_tpu_torch.ops.bilgather import (bilinear_rows, bilinear_rows_reference, corner_dot,
                                          corner_dot_reference, corner_rows_reference)
from beat_tpu_torch.samplers import value_and_grad
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
# the JAX package's bar between its gather paths' gradients
# (tests/test_bilgather.py:219-221): rtol, and atol as a share of each
# parameter's max|grad|
GRAD_RTOL = 5e-3


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
    before = bilinear_rows.launches
    llk = logp(q, data)
    assert bilinear_rows.launches > before
    table = problem.composites["seismic"].tables[0]
    table.rows_fn = bilinear_rows_reference
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
    k1, k2 = bilinear_rows.launches, corner_dot.launches
    llk, grad = value_and_grad(logp, q, (data,))
    assert bilinear_rows.launches > k1 and corner_dot.launches > k2
    problem.composites["seismic"].tables[0].rows_fn = bilinear_rows_reference
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
