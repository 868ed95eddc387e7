"""
Blended bilinear row gather of the GF table — kernel K1 (port of
``beat_tpu/ops/bilgather.py``).

``out[i] = Σ_{a,b∈{0,1}} w[i,ab] · tbl[cd[i]+a, z0[i]+b]`` over a table
laid out ``(3·nd, nz, M)`` with ``M = 6·nf·2``, so the four bilinear
corners of a query are the 2×2 block ``[cd:cd+2, z0:z0+2]``.

* :func:`bilinear_rows` is the kernel wrapper: on a CUDA tensor it
  launches ``csrc/bilgather.cu`` (or raises); on a CPU tensor it runs
  :func:`bilinear_rows_reference`.  ``bilinear_rows.launches`` counts
  kernel launches.
* :func:`bilinear_rows_reference` is the plain PyTorch version, in the
  same layout and the same arithmetic order.
* :func:`pack_table` builds the layout once from the
  (6, 3, nd, nz, nf, 2) spectra.  Unlike the TPU layout there is no
  (8, L) tile padding: ``M = 12·nf`` is a multiple of 4, so every row is
  16-byte aligned for ``float4`` access as it stands.
"""

from __future__ import annotations

import torch


def pack_table(spectra: torch.Tensor) -> torch.Tensor:
    """(6, 3, nd, nz, nf, 2) spectra → (3·nd', nz', 12·nf) gather layout,
    rows in (channel, distance, depth) order (``gftable.py:366-369``).

    An axis with a single node is duplicated (nd' = max(nd, 2), likewise
    nz'): its +1 corner then has weight exactly 0, and the kernel's 2×2
    corner block stays inside the table."""
    six, three, nd, nz, nf, two = spectra.shape
    t = spectra.permute(1, 2, 3, 0, 4, 5)          # (3, nd, nz, 6, nf, 2)
    if nd == 1:
        t = torch.cat([t, t], dim=1)
    if nz == 1:
        t = torch.cat([t, t], dim=2)
    return t.reshape(3 * t.shape[1], t.shape[2], six * nf * two).contiguous()


def bilinear_rows_reference(tbl: torch.Tensor, cd: torch.Tensor,
                            z0: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: (n, M) blended rows.  Weight order (00, 01, 10,
    11) over (distance, depth) corner offsets (``gftable.py:422-424``)."""
    CD, NZ, M = tbl.shape
    flat = tbl.reshape(CD * NZ, M)
    row = cd.long() * NZ + z0.long()
    return (w4[:, 0, None] * flat[row]
            + w4[:, 1, None] * flat[row + 1]
            + w4[:, 2, None] * flat[row + NZ]
            + w4[:, 3, None] * flat[row + NZ + 1])


def _check(tbl, cd, z0, w4) -> None:
    if tbl.dtype != torch.float32 or tbl.dim() != 3 or not tbl.is_contiguous():
        raise ValueError(f"table must be a contiguous (CD, NZ, M) float32 tensor, got "
                         f"{tuple(tbl.shape)} {tbl.dtype}")
    CD, NZ, M = tbl.shape
    if CD < 2 or NZ < 2:
        raise ValueError(f"table needs >= 2 rows on both axes (pack_table "
                         f"duplicates single nodes), got {(CD, NZ)}")
    if M % 4:
        raise ValueError(f"row length {M} must be a multiple of 4 (float4 rows)")
    n = cd.shape[0] if cd.dim() == 1 else -1
    if (cd.dim() != 1 or z0.shape != cd.shape or w4.shape != (n, 4)
            or cd.dtype.is_floating_point or z0.dtype.is_floating_point
            or not w4.dtype.is_floating_point):
        raise ValueError(f"need integer cd, z0 of shape (n,) and float w4 (n, 4); got "
                         f"{tuple(cd.shape)} {cd.dtype}, {tuple(z0.shape)} {z0.dtype}, "
                         f"{tuple(w4.shape)} {w4.dtype}")
    devs = {t.device for t in (tbl, cd, z0, w4)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")


def bilinear_rows(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                  w4: torch.Tensor) -> torch.Tensor:
    """K1: blended bilinear gather on a :func:`pack_table` layout.

    tbl : (CD, NZ, M) float32, contiguous.
    cd, z0 : (n,) integer lower-corner indices, clamped here to
        ``cd <= CD-2`` and ``z0 <= NZ-2`` (``bilgather.py:144-147``).
    w4 : (n, 4) corner weights, order (00, 01, 10, 11).

    Returns (n, M) float32.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and any failure raises."""
    _check(tbl, cd, z0, w4)
    CD, NZ, M = tbl.shape
    n = cd.shape[0]
    cd = cd.clamp(0, CD - 2).to(torch.int32).contiguous()
    z0 = z0.clamp(0, NZ - 2).to(torch.int32).contiguous()
    w4 = w4.to(torch.float32).contiguous()
    if tbl.device.type == "cpu":
        return bilinear_rows_reference(tbl, cd, z0, w4)
    if tbl.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (or its plain version on the CPU), "
                         f"not on {tbl.device}")
    if tbl.data_ptr() % 16:
        raise ValueError("table storage must be 16-byte aligned for float4 rows")
    if n > 2**31 - 1:
        raise ValueError(f"{n} queries exceed one launch grid")
    out = torch.empty((n, M), dtype=torch.float32, device=tbl.device)
    if n == 0:
        return out
    from beat_tpu_torch.kernels.build import load

    lib, _ = load("bilgather")
    with torch.cuda.device(tbl.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.beat_bilinear_rows_f32(tbl.data_ptr(), cd.data_ptr(), z0.data_ptr(),
                                        w4.data_ptr(), out.data_ptr(), n, NZ, M, stream)
    if rc != 0:
        raise RuntimeError(f"bilinear_rows kernel launch failed: cudaError {rc}")
    bilinear_rows.launches += 1
    return out


bilinear_rows.launches = 0
