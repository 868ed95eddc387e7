"""
The kinematic Green's-function stack — kernels K3 and K4 (port of
``beat_tpu/ops/gfstack.py``), THE hot op of kinematic FFI.

For the library ``data[target, patch, duration, starttime, sample]`` and
a lockstep batch of ``C`` chains:

    out[c, t, n] = Σ_p slips[c, p] · Σ_corner w_corner ·
        data[t, p, didx[c,p]∓, sidx[c,t,p]∓, n]

K3 (multilinear) blends the four (duration, starttime) cells around each
patch's onset, with the floor-cell weights ``rtf`` and ``stf``:
``rf·sf, rf·(1−sf), (1−rf)·sf, (1−rf)·(1−sf)`` on cells
``(d−1, s−1), (d−1, s), (d, s−1), (d, s)``.  K4 (nearest neighbour)
takes the one rounded cell ``(d, s)``.  The weights are used as given:
an onset beyond the starttime grid gives weights outside [0, 1] and the
stack extrapolates, as the JAX package's does.

* :func:`stack_batched` is the kernel wrapper: on CUDA tensors it
  launches ``csrc/gfstack.cu`` (or raises), on CPU tensors it runs the
  plain version.  ``.launches_multilinear`` and ``.launches_nearest``
  count K3's and K4's launches.
* :func:`stack_batched_reference` is the plain PyTorch version: the
  fancy gather of ``SeismicGFLibrary.stack_all`` in the JAX package,
  batched over chains and run in chain chunks so the gathered
  (chains, T, P, N) intermediate stays bounded.

The library keeps its natural (T, P, D, S, N) layout: a (d, s) cell is
one contiguous row of N floats.  Neither op is differentiable (the JAX
op has no VJP either).
"""

from __future__ import annotations

import torch

#: elements of one gathered (chains, T, P, N) corner the plain version
#: holds at a time (1 GiB of float32)
_PLAIN_CHUNK_ELEMS = 2**28


def _clamp_cells(data, didx, sidx, multilinear: bool):
    """Cell indices clamped to the grid, int64: ceil indices in
    ``[1, D-1] × [1, S-1]`` for the multilinear corners, any cell for the
    nearest one — what ``durations2idxs``/``starttimes2idxs`` give."""
    _, _, D, S, _ = data.shape
    lo = 1 if multilinear else 0
    return didx.long().clamp(lo, D - 1), sidx.long().clamp(lo, S - 1)


def stack_batched_reference(data: torch.Tensor, didx: torch.Tensor, sidx: torch.Tensor,
                            slips: torch.Tensor, rtf: torch.Tensor | None = None,
                            stf: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K3 (with ``rtf``/``stf``) or K4 (without): (C, T, N).

    Operands as :func:`stack_batched`; ``sidx``/``stf`` may be (C, 1, P)."""
    T, P, D, S, N = data.shape
    C = didx.shape[0]
    multilinear = rtf is not None
    d, s = _clamp_cells(data, didx, sidx, multilinear)
    flat = data.reshape(T * P * D * S, N)
    tp = (torch.arange(T, device=data.device)[:, None] * P
          + torch.arange(P, device=data.device)[None, :])            # (T, P)
    out = torch.empty((C, T, N), dtype=data.dtype, device=data.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMS // max(T * P * N, 1))
    for c0 in range(0, C, chunk):
        sl = slice(c0, c0 + chunk)
        d_c = d[sl, None, :]                                         # (c, 1, P)
        s_c = s[sl].expand(-1, T, -1)                                # (c, T, P)

        def cell(dd, ss):
            return flat[((tp * D + dd) * S + ss)]                    # (c, T, P, N)

        if not multilinear:
            stacked = cell(d_c, s_c)
        else:
            rt_f = rtf[sl, None, :, None]
            st_f = stf[sl].expand(-1, T, -1)[..., None]
            stacked = (cell(d_c, s_c) * ((1 - st_f) * (1 - rt_f))
                       + cell(d_c, s_c - 1) * (st_f * (1 - rt_f))
                       + cell(d_c - 1, s_c) * ((1 - st_f) * rt_f)
                       + cell(d_c - 1, s_c - 1) * (st_f * rt_f))
        out[sl] = torch.einsum("ctpn,cp->ctn", stacked, slips[sl])
    return out


def _check(data, didx, sidx, slips, rtf, stf) -> None:
    if data.dim() != 5 or not data.is_contiguous() or not data.dtype.is_floating_point:
        raise ValueError(f"library must be a contiguous (T, P, D, S, N) float tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")
    T, P, D, S, N = data.shape
    if (rtf is None) != (stf is None):
        raise ValueError("rtf and stf come together (multilinear) or not at all (nearest)")
    multilinear = rtf is not None
    if multilinear and (D < 2 or S < 2):
        raise ValueError(f"multilinear stacking needs >= 2 durations and starttimes, got "
                         f"{(D, S)}")
    C = didx.shape[0] if didx.dim() == 2 else -1
    per_patch = {"didx": didx, "slips": slips, "rtf": rtf}
    per_target = {"sidx": sidx, "stf": stf}
    if (any(x is not None and tuple(x.shape) != (C, P) for x in per_patch.values())
            or any(x is not None and (x.dim() != 3 or x.shape[0] != C
                                      or x.shape[1] not in (1, T) or x.shape[2] != P)
                   for x in per_target.values())):
        got = {k: tuple(x.shape) for k, x in {**per_patch, **per_target}.items()
               if x is not None}
        raise ValueError(f"need didx, slips (and rtf) of shape (C, {P}) and sidx (and stf) of "
                         f"shape (C, {T} or 1, {P}); got {got}")
    if didx.dtype.is_floating_point or sidx.dtype.is_floating_point:
        raise ValueError(f"didx and sidx must be integer, got {didx.dtype}, {sidx.dtype}")
    floats = [x for x in (slips, rtf, stf) if x is not None]
    if any(x.dtype != data.dtype for x in floats):
        raise ValueError(f"slips, rtf and stf must share the library's dtype {data.dtype}")
    if any(x.requires_grad for x in floats + [data]):
        raise NotImplementedError(
            "the GF stack is not differentiable (the JAX op has no VJP either): a backward "
            "kernel for K3 waits for a later port slice (ROADMAP: FFI gradient path)")
    devs = {x.device for x in (data, didx, sidx, slips) + tuple(floats)}
    if len(devs) != 1:
        raise ValueError(f"all operands must be on one device, got {devs}")
    if data.device.type == "cpu":
        return
    if data.device.type != "cuda":
        raise ValueError(f"K3 and K4 run on CUDA (or their plain version on the CPU), not on "
                         f"{data.device}")
    if data.dtype != torch.float32:
        raise ValueError(f"the CUDA kernels take float32 libraries, got {data.dtype}")
    if max(C, T, P, D, S, N) > 2**31 - 1:
        raise ValueError("a dimension exceeds the kernels' 32-bit sizes")


def _launch(data, didx, sidx, slips, rtf, stf) -> torch.Tensor:
    """One K3 or K4 launch on checked operands, on the current stream."""
    from beat_tpu_torch.kernels.build import load

    lib, _ = load("gfstack")
    T, P, D, S, N = data.shape
    C = didx.shape[0]

    def i32(x):
        return x.to(torch.int32).contiguous()

    def full(x):        # (C, 1, P) → (C, T, P), as the kernel indexes it
        return x.expand(C, T, P).contiguous()

    didx, sidx = i32(didx), full(i32(sidx))
    slips = slips.contiguous()
    out = torch.empty((C, T, N), dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rtf is not None:
            rtf, stf = rtf.contiguous(), full(stf)
            rc = lib.beat_gf_stack_multilinear_f32(
                data.data_ptr(), didx.data_ptr(), sidx.data_ptr(), slips.data_ptr(),
                rtf.data_ptr(), stf.data_ptr(), out.data_ptr(), C, T, P, D, S, N, stream)
        else:
            rc = lib.beat_gf_stack_nearest_f32(
                data.data_ptr(), didx.data_ptr(), sidx.data_ptr(), slips.data_ptr(),
                out.data_ptr(), C, T, P, D, S, N, stream)
    if rc != 0:
        raise RuntimeError(f"GF stack kernel launch failed: cudaError {rc}")
    return out


def stack_batched(data: torch.Tensor, didx: torch.Tensor, sidx: torch.Tensor,
                  slips: torch.Tensor, rtf: torch.Tensor | None = None,
                  stf: torch.Tensor | None = None) -> torch.Tensor:
    """K3 (with ``rtf`` and ``stf``) or K4 (without): the all-chain
    kinematic stack.

    data : (T, P, D, S, N) float32, contiguous — the library.
    didx : (C, P) integer duration indices (ceil index for K3).
    sidx : (C, T, P) integer starttime indices, or (C, 1, P) when every
        target sees the same onsets.
    slips : (C, P).
    rtf, stf : floor-cell weights, (C, P) and shaped like ``sidx``.
    Indices are clamped to the grid; the weights are used as given.

    Returns (C, T, N).  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and any failure raises."""
    _check(data, didx, sidx, slips, rtf, stf)
    if data.device.type == "cpu":
        return stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    if didx.shape[0] == 0 or data.shape[0] == 0 or data.shape[4] == 0:
        return torch.empty((didx.shape[0], data.shape[0], data.shape[4]),
                           dtype=data.dtype, device=data.device)
    out = _launch(data, didx, sidx, slips, rtf, stf)
    if rtf is not None:
        stack_batched.launches_multilinear += 1
    else:
        stack_batched.launches_nearest += 1
    return out


stack_batched.launches_multilinear = 0
stack_batched.launches_nearest = 0
