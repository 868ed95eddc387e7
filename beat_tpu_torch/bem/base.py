"""
BEM engine: traction-driven slip on triangular meshes (port of
``beat_tpu/bem/base.py``), assembled and solved in float64 on the
engine's device.

Sources are discretized to triangle meshes on the host; the traction
interaction matrix couples unit slips on source elements to tractions at
receiver elements, the boundary-condition least-squares solve yields the
element slips, and the displacement matrix maps them to observation
points.  :meth:`BEMEngine.solve_batch` does all three for a batch of mesh
sets of one layout at once (the chains of a geometry sampler).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from beat_tpu_torch.bem import tde
from beat_tpu_torch.bem.sources import check_intersection
from beat_tpu_torch.device import resolve
from beat_tpu_torch.sources import moment_to_magnitude

logger = logging.getLogger("beat_tpu_torch.bem.base")

#: column of each slip component in a (ntriangles, 3) slip array
slip_comp_to_idx = {"strike": 0, "dip": 1, "normal": 2}


def lstsq_robust(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution of ``G x = b`` by SVD, the
    solution numpy's ``lstsq`` (LAPACK ``gelsd``) returns: singular
    values at or below ``eps · max(M, N) · s_max`` count as zero.
    ``G`` (..., M, N); ``b`` (..., M) or (..., M, k).  CUDA's
    ``torch.linalg.lstsq`` has only the full-rank ``gels`` driver, so the
    solve is written out."""
    vector = b.dim() == G.dim() - 1
    if vector:
        b = b[..., None]
    U, S, Vh = torch.linalg.svd(G, full_matrices=False)
    cutoff = torch.finfo(G.dtype).eps * max(G.shape[-2:]) * S[..., :1]
    inv = torch.where(S > cutoff, 1.0 / torch.where(S > cutoff, S, 1.0), 0.0)
    x = Vh.transpose(-1, -2) @ (inv[..., None] * (U.transpose(-1, -2) @ b))
    return x[..., 0] if vector else x


@dataclass
class BoundaryCondition:
    """Traction boundary condition linking source and receiver meshes."""

    slip_component: str             # 'strike' | 'dip' | 'normal'
    source_idxs: list = field(default_factory=lambda: [0])
    receiver_idxs: list = field(default_factory=lambda: [0])
    traction: float = 0.0           # [MPa] target traction


@dataclass
class BEMResponse:
    """Result of one solve: displacements (nobs, 3) and element slips (K,)
    as float64 tensors, or None when the geometry is invalid."""

    sources: list
    meshes: list
    displacements: torch.Tensor | None
    slips: torch.Tensor | None
    is_valid: bool = True
    #: per-slip-column element areas in interaction-matrix column order
    col_areas: np.ndarray | None = None

    INVALID = -99.0

    def source_slips(self):
        return self.slips

    def derived_magnitude(self, shear_modulus: float = 33e9):
        if self.slips is None:
            return None
        areas = (self.col_areas if self.col_areas is not None
                 else np.concatenate([m.areas for m in self.meshes]))
        slips = self.slips.double().cpu().numpy()
        m0 = float(np.sum(shear_modulus * areas * np.abs(slips)))
        return float(moment_to_magnitude(max(m0, 1.0)))


class BEMEngine:
    """``process(sources, coords)``: discretize, assemble the interaction
    matrix, solve the slips from the traction BCs and predict the
    displacements at ``coords``, in float64 on ``device``."""

    def __init__(self, boundary_conditions, mesh_size: float = 500.0,
                 poissons_ratio: float = 0.25, shear_modulus: float = 33e9,
                 check_mesh_intersection: bool = True, medium: str = "halfspace",
                 quadrature_level: int = 2, near_quadrature_level: int = 6, *, device):
        self.boundary_conditions = list(boundary_conditions)
        self.mesh_size = mesh_size
        self.nu = poissons_ratio
        self.mu = shear_modulus
        self.check_mesh_intersection = check_mesh_intersection
        #: far/near triangle-subdivision levels of the traction assembly:
        #: (2, 6) gives ~3% penny-crack accuracy; (1, 5) is the cheaper
        #: choice for sampling over geometries
        self.quadrature_level = quadrature_level
        self.near_quadrature_level = near_quadrature_level
        if medium not in ("fullspace", "halfspace"):
            raise ValueError(f"Unknown medium {medium!r}: 'halfspace' (Mindlin kernels, free "
                             "surface at z=0) or 'fullspace' (Kelvin)")
        self.medium = medium
        self.device = resolve(device)

    def discretize(self, sources) -> list:
        return [src.discretize(self.mesh_size) for src in sources]

    def is_invalid(self, meshes) -> bool:
        return bool(self.check_mesh_intersection and check_intersection(meshes))

    def process(self, sources, coords, tractions=None) -> BEMResponse:
        """``tractions``: optional per-BC driving tractions [MPa] in place
        of the BCs' own values."""
        meshes = self.discretize(sources)
        if self.is_invalid(meshes):
            return BEMResponse(sources=sources, meshes=meshes, displacements=None, slips=None,
                               is_valid=False)
        t = None if tractions is None else [list(tractions)]
        slips, disp = self.solve_batch([meshes], coords, t)
        col_areas = np.concatenate([meshes[src_i].areas for bc in self.boundary_conditions
                                    for src_i in bc.source_idxs])
        return BEMResponse(sources=sources, meshes=meshes, displacements=disp[0],
                           slips=slips[0], is_valid=True, col_areas=col_areas)

    def solve_batch(self, mesh_sets, coords, tractions=None) -> tuple:
        """Slips (B, K) and displacements (B, nobs, 3) of B mesh sets of
        one layout: the crack slips until the slip-induced traction
        cancels the applied one, ``G·s = -t``, so a positive normal
        traction opens it.  ``tractions``: (B, n_bc) [MPa] or None for the
        BCs' own values."""
        G = self.get_interaction_matrices(mesh_sets)
        rhs = self._traction_rhs(mesh_sets[0], tractions, len(mesh_sets))
        slips = lstsq_robust(G, -rhs)
        return slips, self._surface_displacements(mesh_sets, slips, coords)

    def get_interaction_matrix(self, meshes) -> torch.Tensor:
        """Tractions at receiver-element collocation points from unit
        slips on source elements (R, K)."""
        return self.get_interaction_matrices([meshes])[0]

    def get_interaction_matrices(self, mesh_sets) -> torch.Tensor:
        return tde.interaction_matrices(mesh_sets, self.boundary_conditions, nu=self.nu,
                                        mu=self.mu, level=self.quadrature_level,
                                        near_level=self.near_quadrature_level,
                                        medium=self.medium, device=self.device)

    def _traction_rhs(self, meshes, tractions=None, n_batch: int = 1) -> torch.Tensor:
        """Driving tractions (B, R) [Pa] on the receiver rows: per BC its
        own value or the chain's entry of ``tractions`` (B, n_bc) [MPa]."""
        counts = [sum(meshes[i].ntriangles for i in bc.receiver_idxs)
                  for bc in self.boundary_conditions]
        if tractions is None:
            tractions = [[bc.traction for bc in self.boundary_conditions]] * n_batch
        t = torch.as_tensor(np.asarray(tractions, dtype=np.float64), device=self.device)
        return torch.repeat_interleave(t * 1e6, torch.as_tensor(counts, device=self.device),
                                       dim=1)

    def _surface_displacements(self, mesh_sets, slips, coords) -> torch.Tensor:
        """Displacements (B, nobs, 3) at ``coords`` of slips (B, K) on B
        mesh sets of one layout."""
        D = tde.displacement_matrices(mesh_sets, coords, nu=self.nu, mu=self.mu,
                                      boundary_conditions=self.boundary_conditions,
                                      medium=self.medium, device=self.device)
        return (D @ slips[..., None]).reshape(len(mesh_sets), -1, 3)
