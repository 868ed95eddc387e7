"""
Eikonal rupture-onset solver on a regular fault-patch grid, batched over
chains (port of ``beat_tpu/ops/eikonal.py``).

First-arrival times of a rupture front from per-patch slowness and a
nucleation point: the monotone upwind update (Rouy-Tourin / Zhao 2004)
iterated in Jacobi fashion — every cell refreshed from the previous
iterate — until the summed squared change of a chain falls to
``epsilon``.  Each iteration advances the front by one cell, so a solve
takes O(grid diameter) iterations of about thirty small elementwise
kernels; moving the whole solve into one kernel (a block per chain, the
grid in shared memory) is later performance work.

Under ``vmap`` the JAX solver stops each chain at its own iteration, and
``epsilon = 0.1`` on squared seconds stops short of full convergence,
so the stopping point is part of the result.  The batched solver keeps a
per-chain ``active`` mask: a chain whose change has fallen to
``epsilon`` is frozen while the others go on.  Whether any chain is
still active is asked of the device only every :data:`CHECK_EVERY`
iterations; the extra iterations are no-ops under the mask.

The numpy Gauss-Seidel fast-sweeping solver is kept as the
cross-validation reference.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.profiling import count, span

_INIT_TIME = 1e8
_EPSILON = 0.1
#: iterations between two host reads of ``active.any()``
CHECK_EVERY = 8


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

    Returns (C, n_dip, n_strike) onset times, 0 at the nucleation patch.
    """
    n_chains, n_dip, n_strike = slowness.shape
    if max_iter is None:
        max_iter = 4 * (n_dip + n_strike) + 16

    with span("eikonal.solve"):
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
        count("eikonal.solves")
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
