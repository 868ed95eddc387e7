"""
Tests of the port that need an NVIDIA GPU: kernel K1
(``beat_tpu_torch/csrc/bilgather.cu``) against its plain PyTorch
version, and the log-likelihood through K1 against the same through the
plain gather.  They skip without a card; run them on one with

    python -m pytest tests -m gpu -q
"""

import numpy as np
import pytest
import torch

from beat_tpu_torch.flagship import TEST_SIZE, build_flagship
from beat_tpu_torch.ops.bilgather import bilinear_rows, bilinear_rows_reference

pytestmark = pytest.mark.gpu

# K1 blends in the plain version's order with explicitly rounded ops:
# the bar is the chip smoke run's 1e-6 of the largest row value
K1_RTOL = 1e-6
# the JAX package's per-chain float32 llk bar (tests/test_float32_llk.py:101)
LLK_RTOL = 2e-5


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
