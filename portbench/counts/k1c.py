"""
The work of one call of K1c (``ops.bilgather.bilinear_contract``): the
bilinear gather of Green's-function rows fused with the moment-tensor
contraction, ``(table (CD, NZ, M), cd, z0, A (..., 4, 6)) -> (..., M/6)``.

Each input byte is read once and each output byte written once: the
table rows that the queries' corners select (each distinct row once),
the two int32 indices and the 24 float32 coefficients of every query,
and its M/6 float32 outputs.  Each query takes 24 multiply-adds per
output value.
"""

import torch

from portbench.counts.peaks import FP32_FLOPS_PER_S


def work(table_shape, cd: torch.Tensor, z0: torch.Tensor) -> tuple:
    """``(bytes, flops, flops_per_s)`` of one call."""
    CD, NZ, M = table_shape
    L = M // 6
    row = cd.reshape(-1).long() * NZ + z0.reshape(-1).long()
    rows_read = int(torch.unique(torch.cat([row, row + 1, row + NZ, row + NZ + 1])).numel())
    n = row.numel()
    n_bytes = rows_read * M * 4 + n * 8 + n * 24 * 4 + n * L * 4
    return n_bytes, 2.0 * 24 * L * n, FP32_FLOPS_PER_S


def call_work(args: tuple, kwargs: dict) -> tuple:
    """The work of a captured call ``bilinear_contract(table, cd, z0, A)``."""
    table, cd, z0 = args[:3]
    return work(tuple(table.shape), cd, z0)
