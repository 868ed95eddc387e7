"""
Nearest-Voronoi-node assignment of fault patches (port of
``beat_tpu/ops/voronoi.py``): one argmin over the patch-to-node squared
distances, batched over any leading axes of node positions (one row of
nodes per chain of a trans-dimensional sampler).  Plain torch: the JAX
package computes it in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def squared_distances(node_strike: torch.Tensor, node_dip: torch.Tensor,
                      patch_strike: torch.Tensor, patch_dip: torch.Tensor) -> torch.Tensor:
    """(..., N, M) squared distances of N patches to the M nodes of each
    leading index; coordinates on the fault plane."""
    return ((patch_strike[:, None] - node_strike[..., None, :]) ** 2
            + (patch_dip[:, None] - node_dip[..., None, :]) ** 2)


def nearest_voronoi_node(node_strike: torch.Tensor, node_dip: torch.Tensor,
                         patch_strike: torch.Tensor, patch_dip: torch.Tensor) -> torch.Tensor:
    """Index of the nearest node for every patch: nodes (..., M), patches
    (N,) → (..., N) int32 (the first of equally near nodes)."""
    d2 = squared_distances(node_strike, node_dip, patch_strike, patch_dip)
    return torch.argmin(d2, dim=-1).to(torch.int32)


def nearest_voronoi_node_numpy(node_strike, node_dip, patch_strike, patch_dip) -> np.ndarray:
    """Host version for one set of nodes: (M,) nodes, (N,) patches → (N,)."""
    d2 = ((np.asarray(patch_strike)[:, None] - np.asarray(node_strike)[None, :]) ** 2
          + (np.asarray(patch_dip)[:, None] - np.asarray(node_dip)[None, :]) ** 2)
    return np.argmin(d2, axis=1).astype(np.int32)
