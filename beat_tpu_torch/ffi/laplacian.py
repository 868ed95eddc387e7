"""
Laplacian smoothing operators for distributed-slip regularisation
(copied from ``beat_tpu/ffi/laplacian.py``).

The operators are host-built numpy matrices (static per fault
geometry); their application ``‖L·m‖²`` runs on the device inside the
smoothing prior (:mod:`beat_tpu_torch.models.laplacian`).
"""

from __future__ import annotations

import numpy as np


def get_smoothing_operator_nearest_neighbor(n_patch_strike, n_patch_dip,
                                            patch_size_strike, patch_size_dip):
    """Second-order FD Laplacian between neighbouring patches of a single
    flat fault.  Rows ordered strike-fastest, matching
    :class:`beat_tpu_torch.ffi.fault.FaultGeometry` patch ordering."""
    n_patches = n_patch_dip * n_patch_strike
    smooth = np.zeros((n_patches, n_patches))
    dl_dip = 1.0 / patch_size_dip**2
    dl_strike = 1.0 / patch_size_strike**2

    for i in range(n_patches):
        row, col = divmod(i, n_patch_strike)
        diag = 0.0
        if row > 0:
            smooth[i, i - n_patch_strike] = dl_dip
            diag += dl_dip
        if row < n_patch_dip - 1:
            smooth[i, i + n_patch_strike] = dl_dip
            diag += dl_dip
        if col > 0:
            smooth[i, i - 1] = dl_strike
            diag += dl_strike
        if col < n_patch_strike - 1:
            smooth[i, i + 1] = dl_strike
            diag += dl_strike
        smooth[i, i] = -diag
    return smooth


def get_smoothing_operator_correlated(patch_coords, correlation_function="gaussian"):
    """Distance-correlated Laplacian for irregular patch geometries:
    off-diagonals 1/d² (gaussian) or 1/e^d (exponential), diagonal =
    -row sum.  ``patch_coords``: (npatches, 3) centers [km]."""
    a = np.atleast_2d(patch_coords)
    d = np.sqrt(((a[:, None, :] - a[None, :, :]) ** 2).sum(axis=-1))
    np.fill_diagonal(d, 1.0)
    if correlation_function == "gaussian":
        a = 1.0 / d**2
    elif correlation_function == "exponential":
        a = 1.0 / np.exp(d)
    else:
        raise ValueError("correlation_function must be gaussian or exponential")
    np.fill_diagonal(a, 0.0)
    norm = a.sum(axis=0)
    np.fill_diagonal(a, -norm)
    return a


def smoothing_operator_log_determinant(smooth_op: np.ndarray) -> float:
    """log|LᵀL| for the smoothness-prior normalisation.  The Laplacian
    has a constant-vector nullspace, so the pseudo-determinant over
    non-zero eigenvalues is used when the full determinant vanishes."""
    gram = smooth_op.T @ smooth_op
    eigs = np.linalg.eigvalsh(gram)
    pos = eigs[eigs > 1e-10 * max(eigs.max(), 1e-300)]
    if pos.size == 0:
        return 0.0
    return float(np.sum(np.log(pos)))
