"""
The work of one call of the GF stack K3 (multilinear) or K4 (nearest
neighbour), ``ops.gfstack.stack_batched(data (T, P, D, S, N), didx,
sidx, slips, rt_f, st_f) -> (C, T, N)``.

Each input byte is read once and each output byte written once: the
library cells that the chains' (duration, onset) corners select (each
distinct cell once), the indices and weights as passed, the slips, and
the float32 windows out.  Each chain, target, patch and corner takes one
multiply-add per sample.  A bfloat16 library's products fit the tensor
cores (bf16 operands, float32 sums), a float32 library's the CUDA cores.
"""

import torch

from portbench.counts.peaks import BF16_FLOPS_PER_S, FP32_FLOPS_PER_S


def work(data_shape, elem_bytes: int, didx: torch.Tensor, sidx: torch.Tensor,
         multilinear: bool, bf16: bool = False) -> tuple:
    """``(bytes, flops, flops_per_s)`` of one call."""
    T, P, D, S, N = data_shape
    C = didx.shape[0]
    dev = didx.device
    touched = torch.zeros(T * P * D * S, dtype=torch.bool, device=dev)
    tp = torch.arange(T, device=dev)[:, None] * P + torch.arange(P, device=dev)[None, :]
    corners = ((0, 0), (0, 1), (1, 0), (1, 1)) if multilinear else ((0, 0),)
    for dd, ss in corners:
        touched[((tp * D + (didx.long()[:, None, :] - dd)) * S + (sidx.long() - ss))] = True
    cells = int(touched.sum())
    per_entry = 8 if multilinear else 4          # index (+ weight) per entry
    n_bytes = cells * N * elem_bytes + sidx.numel() * per_entry + C * P * (per_entry + 4) \
        + C * T * N * 4
    flops = 2.0 * len(corners) * C * T * P * N
    return n_bytes, flops, BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S


def call_work(args: tuple, kwargs: dict) -> tuple:
    """The work of a captured call ``stack_batched(data, didx, sidx,
    slips, rt_f, st_f)``."""
    data, didx, sidx, slips, rt_f = args[:5]
    return work(tuple(data.shape), data.element_size(), didx, sidx, rt_f is not None,
                data.dtype == torch.bfloat16)
