"""
The plain reference of the ``laquila_ffi_bf16`` configuration:
``laquila_ffi``'s kinematic finite-fault log-likelihood with the windows
stacked from a library stored in bfloat16, as the configuration states.

Everything but the stack is ``laquila_ffi``'s reference: the analytic
patch spectra, the eikonal onsets and their stopping rule, the whitened
misfit and the Laplacian prior.  The stack is the library's.  For each
target, patch, duration and onset of the configuration's grid the cell
is the tapered window of the patch spectrum times the source-time
function's spectrum times the onset phasor (``laquila_ffi``'s synthetics
of one unit-slip cell), rounded once to bfloat16; the library is built
one target at a time.  A chain's window at a target is the sum over the
patches of its slip times the multilinear blend of the four cells around
its (duration, onset), the weights quantised in float32 as the library's
grid quantises them, summed in float64.

Precisions: ``float64`` (the comparison); ``tf32`` (the control that
``portbench/control.py`` runs: the cells, the stack and the misfit with
their products' operands rounded to TF32, float32 sums); ``bf16_weights``
(float64, with each chain's folded corner weight, slip × duration weight
× onset weight in float32, rounded once to bfloat16: the stack the
program's ``mma`` K3 would give without the low half of its split
weights).
"""

from __future__ import annotations

import torch

from portbench.reference import laquila_ffi
from portbench.reference.common import einsum

#: the corners of a multilinear cell: (duration, onset) offsets below the
#: ceil indices, in the order of :meth:`Reference.folded_weights`
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Values rounded once to bfloat16's 8 significant bits (nearest, ties
    to even) from their own precision, as a bfloat16 tensor (exact)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 256.0) / 256.0, e).to(torch.bfloat16)


class Reference(laquila_ffi.Reference):
    """The log-likelihood of chains of the configuration's flat layout on
    the bfloat16 library (``library``: (T, P, D, S, W))."""

    def __init__(self, config: dict, inputs: dict, device, precision: str = "float64"):
        self.round_weights = precision == "bf16_weights"
        super().__init__(config, inputs, device,
                         "float64" if self.round_weights else precision)
        self.library = self.build_library()

    def build_library(self) -> torch.Tensor:
        """Every cell's tapered window, rounded once to bfloat16, built one
        target and one duration at a time."""
        p = self.precision
        T, P, _ = self.G.shape
        D, S = self.stf.shape[0], self.phasor.shape[0]
        lib = torch.empty((T, P, D, S, self.basis_c.shape[-1]), dtype=torch.bfloat16,
                          device=self.device)
        for t in range(T):
            for d in range(D):
                spec = self.G[t][:, None, :] * (self.stf[d] * self.phasor)[None]   # (P, S, F)
                cells = (einsum("psf,fw->psw", spec.real.contiguous(), self.basis_c[t], p)
                         + einsum("psf,fw->psw", spec.imag.contiguous(), self.basis_s[t], p))
                lib[t, :, d] = bf16_round(cells)
        return lib

    def cell_weights(self, durations: torch.Tensor, onsets: torch.Tensor) -> tuple:
        """``(dc, wd, sc, ws)`` (R, P): the ceil cell indices of float32
        durations and onsets (clipped into the grid) and their float32
        weights toward the floor cell, extrapolating outside the grid."""
        def corners(x, lo, step, n):
            xi = (x - lo) / step
            ceil = torch.clamp(torch.ceil(xi), 1, n - 1)
            return ceil.long(), ceil - xi

        dc, wd = corners(durations.to(torch.float32), float(self.durations[0]),
                         float(self.durations[1] - self.durations[0]), self.durations.size)
        sc, ws = corners(onsets.to(torch.float32), float(self.starttimes[0]),
                         float(self.starttimes[1] - self.starttimes[0]), self.starttimes.size)
        return dc, wd, sc, ws

    def folded_weights(self, slips: torch.Tensor, wd: torch.Tensor, ws: torch.Tensor) -> list:
        """Each corner's slip × weight (R, P) in the reference's type; with
        ``bf16_weights`` folded in float32 and rounded once to bfloat16."""
        rdt = self.basis_c.dtype
        if self.round_weights:
            s32 = slips.to(torch.float32)
            near, far = s32 * (1 - wd), s32 * wd
            return [bf16_round(w).to(rdt) for w in (near * (1 - ws), near * ws,
                                                     far * (1 - ws), far * ws)]
        wd, ws = wd.to(rdt), ws.to(rdt)
        return [slips * a * b for a, b in (((1 - wd), (1 - ws)), ((1 - wd), ws),
                                           (wd, (1 - ws)), (wd, ws))]

    def synthetics(self, slips: torch.Tensor, cells: tuple) -> torch.Tensor:
        """(R, T, W) windows of slips (R, P) from the library's cells."""
        dc, wd, sc, ws = cells
        T, P, D, S, W = self.library.shape
        weights = self.folded_weights(slips, wd, ws)
        patch = torch.arange(P, device=self.device)[None, :] * (D * S)
        out = torch.zeros((dc.shape[0], T, W), dtype=self.basis_c.dtype, device=self.device)
        for t in range(T):
            rows = self.library[t].reshape(P * D * S, W)
            for (dd, ss), w in zip(CORNERS, weights):
                cell = rows[patch + (dc - dd) * S + (sc - ss)].to(out.dtype)     # (R, P, W)
                out[:, t] += einsum("rpw,rp->rw", cell, w, self.precision)
        return out
