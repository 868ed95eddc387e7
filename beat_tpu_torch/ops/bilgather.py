"""
Blended bilinear row gather of the GF table and its transpose — kernels
K1 and K2 (port of ``beat_tpu/ops/bilgather.py``) — and the gather fused
with the moment-tensor contraction and its transpose — K1c and K2c.

K1: ``out[i] = Σ_c w4[i,c] · corner_c(i)`` over a table laid out
``(3·nd, nz, M)`` with ``M = 6·nf·2``, so the four bilinear corners of a
query, in (00, 01, 10, 11) order, are the 2×2 block
``[cd:cd+2, z0:z0+2]``.

K2: ``dw4[i,c] = Σ_j g[i,j] · corner_c(i)[j]``, the vector-Jacobian
product of K1 with respect to its weights.  The map ``w4 → out`` is
linear and K2 is its transpose, so K1 and K2 are each other's backward:

* :class:`BilinearRows` runs K1 forward and returns ``CornerDot.apply``
  (K2) as the weights' gradient;
* :class:`CornerDot` runs K2 forward and returns ``BilinearRows.apply``
  (K1, with the cotangent as the weights) as ``g``'s gradient.

Every order of derivative therefore runs through the two kernels (a
Hessian of the likelihood is K1 and K2 again).  The table is data, never
differentiated; both functions save only ``tbl``, ``cd`` and ``z0``.

* :func:`bilinear_rows` and :func:`corner_dot` are the kernel wrappers:
  on CUDA tensors they launch ``csrc/bilgather.cu`` (or raise), on CPU
  tensors they run the plain versions.  ``.launches`` on each counts its
  kernel's launches.
* :func:`bilinear_rows_reference` and :func:`corner_dot_reference` are
  the plain PyTorch versions; they also take float64 (for
  ``torch.autograd.gradcheck`` on the CPU), the kernels float32 only.
* :func:`pack_table` builds the layout once from the
  (6, 3, nd, nz, nf, 2) spectra.  Unlike the TPU layout there is no
  (8, L) tile padding: ``M = 12·nf`` is a multiple of 4, so every row is
  16-byte aligned for ``float4`` access as it stands.

K1c and K2c read a row as 6 component segments of ``L = 2·nf`` floats,
``T_c(i)[k] = corner_c(i)[k·L:(k+1)·L]``:

* K1c, :func:`bilinear_contract`: ``out[i] = Σ_c Σ_k A[i,c,k]·T_c(i)[k]``,
  (n, L) from (n, 4, 6) coefficients — K1 followed by the m6 contraction
  of ``GreensTable.point_spectra`` (``A = w4 ⊗ m6_ray``) in one pass;
* K2c, :func:`contract_corner_dot`: ``P[i,c,k] = <G[i], T_c(i)[k]>``,
  the coefficients' cotangent of K1c for an output cotangent G (n, L).

They are each other's transpose and each other's backward
(:class:`BilinearContract`, :class:`ContractCornerDot`), as K1 and K2 are,
so every order of derivative of the forward runs through K1c and K2c.
Each is linear in its operand, so its forward-mode derivative (``jvp``,
for ``torch.autograd.forward_ad`` dual tensors) is the same kernel
applied to the operand's tangent: one more K1c (or K2c) launch.
No (n, 6, L) tensor exists on their path.  Their queries come as
(..., T): the kernels group the queries of one target ``t``, which tend
to share corners in the forward's (chain, target) layout; the grouping
never changes the result.
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


def _corner_row_index(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor):
    """Flat row of each query's (00) corner, and the row count per
    distance node: the corners are ``row, row+1, row+NZ, row+NZ+1``."""
    CD, NZ, M = tbl.shape
    return tbl.reshape(CD * NZ, M), cd.long() * NZ + z0.long(), NZ


def bilinear_rows_reference(tbl: torch.Tensor, cd: torch.Tensor,
                            z0: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1: (n, M) blended rows.  Weight order (00, 01, 10,
    11) over (distance, depth) corner offsets (``gftable.py:422-424``)."""
    flat, row, NZ = _corner_row_index(tbl, cd, z0)
    return (w4[:, 0, None] * flat[row]
            + w4[:, 1, None] * flat[row + 1]
            + w4[:, 2, None] * flat[row + NZ]
            + w4[:, 3, None] * flat[row + NZ + 1])


def corner_rows_reference(tbl: torch.Tensor, cd: torch.Tensor,
                          z0: torch.Tensor) -> torch.Tensor:
    """(n, 4, M) unblended corner rows, order (00, 01, 10, 11): what the
    TPU kernel K2 (``_corner_rows_call``) writes."""
    flat, row, NZ = _corner_row_index(tbl, cd, z0)
    return torch.stack([flat[row], flat[row + 1], flat[row + NZ], flat[row + NZ + 1]],
                       dim=1)


def corner_dot_reference(tbl: torch.Tensor, cd: torch.Tensor,
                         z0: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2: (n, 4) ``dw4``, in the JAX package's structure —
    the corner rows, then ``einsum('nj,ncj->nc')`` (``bilgather.py:298-299``)."""
    return torch.einsum("nj,ncj->nc", g, corner_rows_reference(tbl, cd, z0))


def _check(tbl, cd, z0, x, x_name: str, x_tail: tuple, batched: bool = False) -> None:
    """Shapes, dtypes and devices of a K1 (``x = w4``, (n, 4)), K2 (``x =
    g``, (n, M)), K1c (``x = A``, (..., T, 4, 6)) or K2c (``x = G``, (...,
    T, L)) call; ``batched`` takes (..., T) indices in place of (n,)."""
    if tbl.dim() != 3 or not tbl.is_contiguous() or tbl.dtype not in (torch.float32,
                                                                      torch.float64):
        raise ValueError(f"table must be a contiguous (CD, NZ, M) float tensor, got "
                         f"{tuple(tbl.shape)} {tbl.dtype}")
    CD, NZ, M = tbl.shape
    if CD < 2 or NZ < 2:
        raise ValueError(f"table needs >= 2 rows on both axes (pack_table "
                         f"duplicates single nodes), got {(CD, NZ)}")
    if M % 4:
        raise ValueError(f"row length {M} must be a multiple of 4 (float4 rows)")
    lead = "(..., T" if batched else "(n"
    if ((cd.dim() < 1 if batched else cd.dim() != 1) or z0.shape != cd.shape
            or x.shape != cd.shape + tuple(x_tail)
            or cd.dtype.is_floating_point or z0.dtype.is_floating_point):
        raise ValueError(f"need integer cd, z0 of shape {lead},) and {x_name} {lead}, "
                         f"{', '.join(map(str, x_tail))}); got "
                         f"{tuple(cd.shape)} {cd.dtype}, {tuple(z0.shape)} {z0.dtype}, "
                         f"{tuple(x.shape)}")
    if x.dtype != tbl.dtype:
        raise ValueError(f"{x_name} must share the table's dtype {tbl.dtype}, got {x.dtype}")
    devs = {t.device for t in (tbl, cd, z0, x)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    if tbl.device.type == "cpu":
        return
    if tbl.device.type != "cuda":
        raise ValueError(f"the bilinear kernels run on CUDA (or their plain versions on the CPU), "
                         f"not on {tbl.device}")
    if tbl.dtype != torch.float32:
        raise ValueError(f"the CUDA kernels take float32 tables, got {tbl.dtype}")
    if tbl.data_ptr() % 16:
        raise ValueError("table storage must be 16-byte aligned for float4 rows")
    if cd.numel() > 2**31 - 1:
        raise ValueError(f"{cd.numel()} queries exceed one launch grid")


def _clamped(tbl, cd, z0):
    """int32 corner indices clamped to ``cd <= CD-2``, ``z0 <= NZ-2``
    (``bilgather.py:144-147``)."""
    CD, NZ, _ = tbl.shape
    return (cd.clamp(0, CD - 2).to(torch.int32).contiguous(),
            z0.clamp(0, NZ - 2).to(torch.int32).contiguous())


def _launch(entry: str, tbl, cd, z0, x, out, *sizes) -> None:
    """One launch of a ``csrc/bilgather.cu`` entry on the current stream:
    ``entry(tbl, cd, z0, x, out, n, *sizes, stream)``."""
    from beat_tpu_torch.kernels.build import launch, load

    lib, _ = load("bilgather")
    rc = launch(tbl.device, getattr(lib, entry), tbl.data_ptr(), cd.data_ptr(), z0.data_ptr(),
                x.data_ptr(), out.data_ptr(), cd.numel(), *sizes)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: cudaError {rc}")


def _k1(tbl, cd, z0, w4) -> torch.Tensor:
    """K1 on already checked, clamped, contiguous operands."""
    if tbl.device.type == "cpu":
        return bilinear_rows_reference(tbl, cd, z0, w4)
    out = torch.empty((cd.shape[0], tbl.shape[2]), dtype=tbl.dtype, device=tbl.device)
    if cd.shape[0]:
        _launch("beat_bilinear_rows_f32", tbl, cd, z0, w4, out, *tbl.shape[1:])
        bilinear_rows.launches += 1
    return out


def _k2(tbl, cd, z0, g) -> torch.Tensor:
    """K2 on already checked, clamped, contiguous operands."""
    if tbl.device.type == "cpu":
        return corner_dot_reference(tbl, cd, z0, g)
    out = torch.empty((cd.shape[0], 4), dtype=tbl.dtype, device=tbl.device)
    if g.data_ptr() % 16:        # a view at an odd offset: float4 rows need alignment
        g = g.clone()
    if cd.shape[0]:
        _launch("beat_corner_dot_f32", tbl, cd, z0, g, out, *tbl.shape[1:])
        corner_dot.launches += 1
    return out


class BilinearRows(torch.autograd.Function):
    """K1 with K2 as the weights' gradient."""

    @staticmethod
    def forward(ctx, tbl, cd, z0, w4):
        ctx.save_for_backward(tbl, cd, z0)
        return _k1(tbl, cd, z0, w4.contiguous())

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("bilinear_rows does not differentiate the GF table: "
                               "the table is data (pass it without requires_grad)")
        tbl, cd, z0 = ctx.saved_tensors
        dw4 = CornerDot.apply(tbl, cd, z0, g.contiguous()) if ctx.needs_input_grad[3] else None
        return None, None, None, dw4


class CornerDot(torch.autograd.Function):
    """K2 with K1 as the cotangent's gradient (K2 is linear in ``g``)."""

    @staticmethod
    def forward(ctx, tbl, cd, z0, g):
        ctx.save_for_backward(tbl, cd, z0)
        return _k2(tbl, cd, z0, g.contiguous())

    @staticmethod
    def backward(ctx, u):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("corner_dot does not differentiate the GF table")
        tbl, cd, z0 = ctx.saved_tensors
        dg = BilinearRows.apply(tbl, cd, z0, u.contiguous()) if ctx.needs_input_grad[3] else None
        return None, None, None, dg


def bilinear_rows(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                  w4: torch.Tensor) -> torch.Tensor:
    """K1: blended bilinear gather on a :func:`pack_table` layout,
    differentiable in ``w4`` to every order (through K2 and K1).

    tbl : (CD, NZ, M) float32 (float64 on the CPU), contiguous.
    cd, z0 : (n,) integer lower-corner indices, clamped here to
        ``cd <= CD-2`` and ``z0 <= NZ-2``.
    w4 : (n, 4) corner weights of the table's dtype, order (00, 01, 10, 11).

    Returns (n, M).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and any failure raises."""
    _check(tbl, cd, z0, w4, "w4", (4,))
    cd, z0 = _clamped(tbl, cd, z0)
    return BilinearRows.apply(tbl, cd, z0, w4)


def corner_dot(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
               g: torch.Tensor) -> torch.Tensor:
    """K2: ``dw4[i, c] = Σ_j g[i, j] · corner_c(i)[j]``, (n, 4) — the
    weights' cotangent of :func:`bilinear_rows` for the output cotangent
    ``g`` (n, M).  Same operands, clamping and device rule as K1;
    differentiable in ``g`` (through K1)."""
    _check(tbl, cd, z0, g, "g", (tbl.shape[2] if tbl.dim() == 3 else -1,))
    cd, z0 = _clamped(tbl, cd, z0)
    return CornerDot.apply(tbl, cd, z0, g)


# ---------------------------------------------------------------------------
# K1c and K2c: the gather fused with the m6 contraction, and its transpose
# ---------------------------------------------------------------------------


def _corner_segments(tbl, cd, z0) -> torch.Tensor:
    """(..., 4, 6, L) corner rows of (...) queries cut into their component
    segments."""
    rows = corner_rows_reference(tbl, cd.reshape(-1), z0.reshape(-1))
    return rows.reshape(cd.shape + (4, 6, rows.shape[2] // 6))


def bilinear_contract_reference(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                                A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K1c: (..., L), in the JAX package's structure — the
    corner rows, then ``einsum`` (``gftable.py:468`` on K1's blend)."""
    return torch.einsum("...ck,...ckl->...l", A, _corner_segments(tbl, cd, z0))


def contract_corner_dot_reference(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                                  G: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K2c: (..., 4, 6) — the corner rows, then ``einsum``."""
    return torch.einsum("...l,...ckl->...ck", G, _corner_segments(tbl, cd, z0))


def _check_contract(tbl, cd, z0, x, x_name: str, x_tail: tuple) -> None:
    """A K1c or K2c call: K1's checks on (..., T) queries, and even
    segments (``M = 6·L``, L even)."""
    _check(tbl, cd, z0, x, x_name, x_tail, batched=True)
    CD, NZ, M = tbl.shape
    if M % 12:
        raise ValueError(f"row length {M} must be 6 segments of an even length")
    if tbl.device.type == "cuda" and CD * NZ > 2**31 - 1:
        raise ValueError(f"{CD * NZ} table rows exceed the kernels' 32-bit row keys")


def _targets(cd) -> int:
    """The kernels' grouping stride: T for (..., T) queries, 1 for (n,)."""
    return cd.shape[-1] if cd.dim() > 1 else 1


def _k1c(tbl, cd, z0, A) -> torch.Tensor:
    """K1c on already checked, clamped, contiguous operands."""
    if tbl.device.type == "cpu":
        return bilinear_contract_reference(tbl, cd, z0, A)
    out = torch.empty(cd.shape + (tbl.shape[2] // 6,), dtype=tbl.dtype, device=tbl.device)
    if cd.numel():
        _launch("beat_bilinear_contract_f32", tbl, cd, z0, A, out, _targets(cd), tbl.shape[1],
                tbl.shape[2] // 6)
        bilinear_contract.launches += 1
    return out


def _k2c(tbl, cd, z0, G) -> torch.Tensor:
    """K2c on already checked, clamped, contiguous operands."""
    if tbl.device.type == "cpu":
        return contract_corner_dot_reference(tbl, cd, z0, G)
    out = torch.empty(cd.shape + (4, 6), dtype=tbl.dtype, device=tbl.device)
    if cd.numel():
        _launch("beat_contract_corner_dot_f32", tbl, cd, z0, G, out, _targets(cd), tbl.shape[1],
                tbl.shape[2] // 6)
        contract_corner_dot.launches += 1
    return out


def _refuse_table_tangent(t_tbl, name: str) -> None:
    if t_tbl is not None:
        raise RuntimeError(f"{name} does not differentiate the GF table: the table is data "
                           "(pass it without a tangent)")


class BilinearContract(torch.autograd.Function):
    """K1c with K2c as the coefficients' gradient and K1c on the tangent
    as its forward-mode derivative."""

    @staticmethod
    def forward(ctx, tbl, cd, z0, A):
        ctx.save_for_backward(tbl, cd, z0)
        ctx.save_for_forward(tbl, cd, z0)
        ctx.set_materialize_grads(False)     # operands without a tangent pass None to jvp
        return _k1c(tbl, cd, z0, A.contiguous())

    @staticmethod
    def jvp(ctx, t_tbl, t_cd, t_z0, tA):
        _refuse_table_tangent(t_tbl, "bilinear_contract")
        tbl, cd, z0 = ctx.saved_tensors
        return None if tA is None else _k1c(tbl, cd, z0, tA.contiguous())

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("bilinear_contract does not differentiate the GF table: "
                               "the table is data (pass it without requires_grad)")
        tbl, cd, z0 = ctx.saved_tensors
        dA = (ContractCornerDot.apply(tbl, cd, z0, g.contiguous())
              if ctx.needs_input_grad[3] and g is not None else None)
        return None, None, None, dA


class ContractCornerDot(torch.autograd.Function):
    """K2c with K1c as the cotangent's gradient (K2c is linear in ``G``)
    and K2c on the tangent as its forward-mode derivative."""

    @staticmethod
    def forward(ctx, tbl, cd, z0, G):
        ctx.save_for_backward(tbl, cd, z0)
        ctx.save_for_forward(tbl, cd, z0)
        ctx.set_materialize_grads(False)     # operands without a tangent pass None to jvp
        return _k2c(tbl, cd, z0, G.contiguous())

    @staticmethod
    def jvp(ctx, t_tbl, t_cd, t_z0, tG):
        _refuse_table_tangent(t_tbl, "contract_corner_dot")
        tbl, cd, z0 = ctx.saved_tensors
        return None if tG is None else _k2c(tbl, cd, z0, tG.contiguous())

    @staticmethod
    def backward(ctx, u):
        if ctx.needs_input_grad[0]:
            raise RuntimeError("contract_corner_dot does not differentiate the GF table")
        tbl, cd, z0 = ctx.saved_tensors
        dG = (BilinearContract.apply(tbl, cd, z0, u.contiguous())
              if ctx.needs_input_grad[3] and u is not None else None)
        return None, None, None, dG


def bilinear_contract(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                      A: torch.Tensor) -> torch.Tensor:
    """K1c: ``out[..., t, :] = Σ_c Σ_k A[..., t, c, k] · T_c(..., t)[k]``,
    (..., T, L) with ``L = M/6`` — the bilinear gather and the m6
    contraction in one pass, differentiable in ``A`` to every order
    (through K2c and K1c), in reverse mode and, for a dual ``A`` of
    ``torch.autograd.forward_ad``, in forward mode (K1c on the tangent).

    tbl : (CD, NZ, M) float32 (float64 on the CPU), contiguous, M = 6·L
        with L even.
    cd, z0 : (..., T) integer lower-corner indices, clamped here as for K1.
        The queries of one target ``t`` tend to share a corner block (the
        forward's (chain, target) layout), and the kernel groups them;
        (n,) indices are n chains of one target.
    A : (..., T, 4, 6) coefficients of the table's dtype, corners in (00,
        01, 10, 11) order, components in the table's order.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and any failure raises."""
    _check_contract(tbl, cd, z0, A, "A", (4, 6))
    cd, z0 = _clamped(tbl, cd, z0)
    return BilinearContract.apply(tbl, cd, z0, A)


def contract_corner_dot(tbl: torch.Tensor, cd: torch.Tensor, z0: torch.Tensor,
                        G: torch.Tensor) -> torch.Tensor:
    """K2c: ``P[..., t, c, k] = <G[..., t, :], T_c(..., t)[k]>``, (..., T,
    4, 6) — the coefficients' cotangent of :func:`bilinear_contract` for
    the output cotangent ``G`` (..., T, L).  Same operands, clamping,
    grouping and device rule as K1c; differentiable in ``G`` (through
    K1c)."""
    L = tbl.shape[2] // 6 if tbl.dim() == 3 else -1
    _check_contract(tbl, cd, z0, G, "G", (L,))
    cd, z0 = _clamped(tbl, cd, z0)
    return ContractCornerDot.apply(tbl, cd, z0, G)


bilinear_rows.launches = 0
corner_dot.launches = 0
bilinear_contract.launches = 0
contract_corner_dot.launches = 0
