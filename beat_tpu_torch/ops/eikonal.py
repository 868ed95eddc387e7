"""
Eikonal rupture-onset solver on a regular fault-patch grid, batched over
chains (port of ``beat_tpu/ops/eikonal.py``).

First-arrival times of a rupture front from per-patch slowness and a
nucleation point: the monotone upwind update (Rouy-Tourin / Zhao 2004)
iterated in Jacobi fashion — every cell refreshed from the previous
iterate — until the summed squared change of a chain falls to
``epsilon``.  Each iteration advances the front by one cell, so a solve
takes O(grid diameter) iterations.

Under ``vmap`` the JAX solver stops each chain at its own iteration, and
``epsilon = 0.1`` on squared seconds stops short of full convergence,
so the stopping point is part of the result.

* :func:`eikonal_rupture_times` routes each solve by what the call
  shows (:func:`fused_route`): a CUDA float32 slowness that needs no
  gradient, on a grid of at most :data:`FUSED_MAX_CELLS` cells, goes to
  :func:`eikonal_rupture_times_fused`; CPU tensors, float64, a slowness
  that requires grad and larger grids go to
  :func:`eikonal_rupture_times_plain`.
* :func:`eikonal_rupture_times_fused` launches ``csrc/eikonal.cu``: the
  whole solve in one kernel, a warp per chain with its grid in shared
  memory, each chain stopping at its own iteration, and no host read.
* :func:`eikonal_rupture_times_plain` is the plain version: about thirty
  elementwise kernels an iteration over the whole batch, with a
  per-chain ``active`` mask (a chain whose change has fallen to
  ``epsilon`` is frozen while the others go on).  Whether any chain is
  still active is asked of the device only every :data:`CHECK_EVERY`
  iterations; the extra iterations are no-ops under the mask.

The kernel runs the plain version's float32 operations in its order,
unfused, so an iteration is the same bit for bit; only the order of the
convergence sum differs, which can move a chain's stop only where its
change lies within float32 rounding of ``epsilon``.

With the program's spans on each solve is an ``eikonal.solve`` span and
counts ``eikonal.solves`` (a kernel solve also counts its launch,
``launches.beat_eikonal_f32``, in the launcher).  ``eikonal.iterations``
adds the plain version's iterations run (the masked no-ops up to the
next check included); ``eikonal.kernel_max_iterations`` adds the
kernel's largest per-chain count, read from the device only while spans
are on and after the span has closed, so the span never holds a wait
for the device.

The numpy Gauss-Seidel fast-sweeping solver is kept as the
cross-validation reference.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.kernels.build import launch, load
from beat_tpu_torch.profiling import count, span, spans_enabled

_INIT_TIME = 1e8
_EPSILON = 0.1
#: iterations between two host reads of ``active.any()``
CHECK_EVERY = 8
#: the largest grid the kernel takes: a chain's two onset buffers and its
#: cell sizes, 12 bytes a cell, in the 48 KiB of shared memory that every
#: CUDA device gives a block
FUSED_MAX_CELLS = 48 * 1024 // 12


def _default_max_iter(n_dip: int, n_strike: int) -> int:
    return 4 * (n_dip + n_strike) + 16


def _upwind_update(times: torch.Tensor, fh: torch.Tensor) -> torch.Tensor:
    """One monotone upwind update of all cells of (C, n_dip, n_strike)
    grids; neighbours beyond the edge replicate the edge cell."""
    up = torch.cat([times[:, :1], times[:, :-1]], dim=1)
    down = torch.cat([times[:, 1:], times[:, -1:]], dim=1)
    left = torch.cat([times[:, :, :1], times[:, :, :-1]], dim=2)
    right = torch.cat([times[:, :, 1:], times[:, :, -1:]], dim=2)

    a = torch.minimum(up, down)       # dip-direction neighbour min
    b = torch.minimum(left, right)    # strike-direction neighbour min

    # solution of [(t-a)^+]^2 + [(t-b)^+]^2 = fh^2
    one_sided = torch.minimum(a, b) + fh
    rad = 2.0 * fh**2 - (a - b) ** 2
    two_sided = 0.5 * (a + b + torch.sqrt(torch.clamp(rad, min=0.0)))
    candidate = torch.where(torch.abs(a - b) >= fh, one_sided, two_sided)
    return torch.minimum(times, candidate)


def fused_route(device, dtype: torch.dtype, requires_grad: bool, shape) -> bool:
    """Whether a solve of a slowness on ``device`` of ``dtype`` and
    ``shape`` (C, n_dip, n_strike) goes to the kernel: CUDA, float32, no
    gradient, and a grid of 1 to :data:`FUSED_MAX_CELLS` cells."""
    cells = shape[-2] * shape[-1]
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and not requires_grad and 0 < cells <= FUSED_MAX_CELLS)


def eikonal_rupture_times(slowness: torch.Tensor, patch_size: float,
                          nuc_dip_idx: torch.Tensor, nuc_strike_idx: torch.Tensor,
                          epsilon: float = _EPSILON, max_iter: int | None = None) -> torch.Tensor:
    """
    Rupture onset times [s] for all patches of a batch of chains.

    slowness : (C, n_dip, n_strike) per-patch slowness 1/velocity
    patch_size : patch edge length (same length unit as 1/slowness)
    nuc_dip_idx, nuc_strike_idx : (C,) integer nucleation patch indexes
    epsilon : per-chain convergence threshold on the summed squared update
    max_iter : safety bound (default 4·(n_dip+n_strike) + 16)

    Returns (C, n_dip, n_strike) onset times, 0 at the nucleation patch:
    from the kernel where :func:`fused_route` says so, else from the
    plain version.
    """
    chain_iterations = None
    with span("eikonal.solve"):
        if fused_route(slowness.device, slowness.dtype, slowness.requires_grad,
                       slowness.shape):
            times, chain_iterations = eikonal_rupture_times_fused(
                slowness, patch_size, nuc_dip_idx, nuc_strike_idx, epsilon, max_iter)
        else:
            times = eikonal_rupture_times_plain(slowness, patch_size, nuc_dip_idx,
                                                nuc_strike_idx, epsilon, max_iter)
        count("eikonal.solves")
    if chain_iterations is not None and spans_enabled() and chain_iterations.numel():
        count("eikonal.kernel_max_iterations", int(chain_iterations.max()))
    return times


def eikonal_rupture_times_fused(slowness: torch.Tensor, patch_size: float,
                                nuc_dip_idx: torch.Tensor, nuc_strike_idx: torch.Tensor,
                                epsilon: float = _EPSILON, max_iter: int | None = None) -> tuple:
    """The whole solve as one launch of ``csrc/eikonal.cu`` on a CUDA
    float32 slowness of at most :data:`FUSED_MAX_CELLS` cells a chain
    (the arguments as :func:`eikonal_rupture_times`'s).  Returns the
    onsets and the (C,) int32 updates each chain ran; a nucleation index
    outside the grid gives that chain NaN onsets.  Any failure raises."""
    n_chains, n_dip, n_strike = slowness.shape
    if not fused_route(slowness.device, slowness.dtype, False, slowness.shape):
        raise ValueError(f"the eikonal kernel takes CUDA float32 grids of 1 to "
                         f"{FUSED_MAX_CELLS} cells, got {tuple(slowness.shape)} "
                         f"{slowness.dtype} on {slowness.device}")
    if max_iter is None:
        max_iter = _default_max_iter(n_dip, n_strike)
    slowness = slowness.detach().contiguous()
    nuc_d = nuc_dip_idx.to(device=slowness.device, dtype=torch.int64).contiguous()
    nuc_s = nuc_strike_idx.to(device=slowness.device, dtype=torch.int64).contiguous()
    times = torch.empty_like(slowness)
    chain_iterations = torch.empty(n_chains, dtype=torch.int32, device=slowness.device)
    if n_chains == 0:
        return times, chain_iterations
    lib, _ = load("eikonal")
    rc = launch(slowness.device, lib.beat_eikonal_f32, slowness.data_ptr(), nuc_d.data_ptr(),
                nuc_s.data_ptr(), times.data_ptr(), chain_iterations.data_ptr(), n_chains,
                n_dip, n_strike, float(patch_size), float(epsilon), max(int(max_iter), 0))
    if rc != 0:
        raise RuntimeError(f"beat_eikonal_f32 kernel launch failed: cudaError {rc}")
    return times, chain_iterations


def eikonal_rupture_times_plain(slowness: torch.Tensor, patch_size: float,
                                nuc_dip_idx: torch.Tensor, nuc_strike_idx: torch.Tensor,
                                epsilon: float = _EPSILON,
                                max_iter: int | None = None) -> torch.Tensor:
    """The plain version on any device and floating type (the arguments
    as :func:`eikonal_rupture_times`'s)."""
    n_chains, n_dip, n_strike = slowness.shape
    if max_iter is None:
        max_iter = _default_max_iter(n_dip, n_strike)

    fh = slowness * patch_size
    nuc_mask = torch.zeros_like(slowness, dtype=torch.bool)
    nuc_mask[torch.arange(n_chains, device=slowness.device),
             nuc_dip_idx.long(), nuc_strike_idx.long()] = True
    times = torch.where(nuc_mask, 0.0, torch.full_like(slowness, _INIT_TIME))
    active = torch.ones(n_chains, dtype=torch.bool, device=slowness.device)

    iterations = 0      # run, the masked no-ops up to the next check included
    for it in range(max_iter):
        if it and it % CHECK_EVERY == 0 and not bool(active.any()):
            break
        new = _upwind_update(times, fh)
        new = torch.where(nuc_mask, 0.0, new)
        new = torch.where(active[:, None, None], new, times)
        # a frozen chain's change is 0, so it stays frozen
        active = torch.sum((new - times) ** 2, dim=(1, 2)) > epsilon
        times = new
        iterations += 1
    count("eikonal.iterations", iterations)
    return times


def eikonal_rupture_times_numpy(slowness, patch_size, nuc_dip_idx, nuc_strike_idx,
                                epsilon: float = _EPSILON):
    """Gauss-Seidel fast-sweeping reference (Zhao 2004) of one grid: four
    directional sweep orders per iteration, in-place updates, iterated to
    the same threshold.  Host-side ground truth, float64."""
    slowness = np.asarray(slowness, dtype=np.float64)
    n_dip, n_strike = slowness.shape
    fh = slowness * patch_size
    times = np.full((n_dip, n_strike), _INIT_TIME)
    times[nuc_dip_idx, nuc_strike_idx] = 0.0

    def solve_cell(i, j):
        a = min(times[max(i - 1, 0), j], times[min(i + 1, n_dip - 1), j])
        b = min(times[i, max(j - 1, 0)], times[i, min(j + 1, n_strike - 1)])
        f = fh[i, j]
        if abs(a - b) >= f:
            cand = min(a, b) + f
        else:
            cand = 0.5 * (a + b + np.sqrt(max(2.0 * f * f - (a - b) ** 2, 0.0)))
        if cand < times[i, j]:
            times[i, j] = cand

    sweeps = [
        (range(n_dip), range(n_strike)),
        (range(n_dip - 1, -1, -1), range(n_strike)),
        (range(n_dip - 1, -1, -1), range(n_strike - 1, -1, -1)),
        (range(n_dip), range(n_strike - 1, -1, -1)),
    ]
    err = np.inf
    while err > epsilon:
        old = times.copy()
        for ii, jj in sweeps:
            for i in ii:
                for j in jj:
                    if i == nuc_dip_idx and j == nuc_strike_idx:
                        continue
                    solve_cell(i, j)
        err = float(np.sum((times - old) ** 2))
    return times
