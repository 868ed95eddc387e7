"""
Plain row gather ``out[i] = tbl[idx[i]]`` — kernel K5 (port of
``beat_tpu/ops/rowgather.py``).

The JAX package keeps this gather as a measured baseline of the GF-table
lookup, superseded there by the fused bilinear gather (K1).  The port's
SMC uses it where a row gather is the operation: the resampled
population of a stage, ``population[parent_indexes]``, gathered on the
device (:mod:`beat_tpu_torch.samplers.smc`).

* :func:`gather_rows` is the kernel wrapper: on CUDA tensors it launches
  ``csrc/rowgather.cu`` (or raises), on CPU tensors it runs the plain
  version.
* :func:`gather_rows_reference` is the plain PyTorch version.

Unlike the TPU entry there is no padding of the row length to (8, L)
tiles nor of ``idx`` to a block multiple: any ``M`` and ``n`` go to the
kernel as they are.  ``idx`` is clipped to ``[0, R-1]`` as an integer of
its own width: an ``int64`` index beyond the ``int32`` range clips, where
the TPU entry (which casts to ``int32`` first, ``rowgather.py:109``)
would wrap.  An ``int32`` or ``int64`` index of any stride goes to the
kernel as it is, so one call on the card is one device kernel and no
other device operation.
"""

from __future__ import annotations

import torch

from beat_tpu_torch.kernels.build import launch, load


def gather_rows_reference(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K5: ``tbl[idx]`` with ``idx`` clipped to
    ``[0, R-1]`` in 64 bits."""
    return tbl[idx.long().clamp(0, tbl.shape[0] - 1)]


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K5: ``tbl (R, M)`` float32, ``idx (n,)`` integer → ``(n, M)``;
    ``idx`` is clipped to ``[0, R-1]``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel, and any failure raises."""
    if tbl.dim() != 2 or not tbl.is_contiguous() or not tbl.dtype.is_floating_point:
        raise ValueError(f"table must be a contiguous (R, M) float tensor, got "
                         f"{tuple(tbl.shape)} {tbl.dtype}")
    if idx.dim() != 1 or idx.dtype.is_floating_point:
        raise ValueError(f"idx must be an integer (n,) tensor, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if tbl.shape[0] == 0:
        raise ValueError("cannot gather from an empty table")
    if tbl.device != idx.device:
        raise ValueError(f"table on {tbl.device}, idx on {idx.device}")
    if tbl.device.type == "cpu":
        return gather_rows_reference(tbl, idx)
    if tbl.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA (or its plain version on the CPU), not on "
                         f"{tbl.device}")
    if tbl.dtype != torch.float32:
        raise ValueError(f"the CUDA kernel takes float32 tables, got {tbl.dtype}")
    R, M = tbl.shape
    n = idx.shape[0]
    if n > 2**31 - 1 or M > 2**31 - 1:
        raise ValueError(f"{n} rows of {M} exceed one launch grid")
    out = tbl.new_empty((n, M))
    if n == 0 or M == 0:
        return out
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.long()        # the narrow types: an index pass, off the main path
    lib, _ = load("rowgather")
    rc = launch(tbl.device, lib.beat_gather_rows_f32, tbl.data_ptr(), idx.data_ptr(),
                idx.element_size(), idx.stride(0), out.data_ptr(), R, n, M)
    if rc != 0:
        raise RuntimeError(f"beat_gather_rows_f32 kernel launch failed: cudaError {rc}")
    return out
