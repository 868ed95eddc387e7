"""
BEM geodetic composites (port of ``beat_tpu/models/bem.py``), batched
over a leading chain axis.

* :class:`GeodeticBEMLinearComposite` fixes the geometry and samples the
  boundary-condition tractions: the solve is linear in them, so the
  unit-traction LOS responses are built once, in float64 on the card,
  and an evaluation is a (C, n_bc) @ (n_bc, N) product.
* :class:`GeodeticBEMComposite` samples the geometry.  The meshes of a
  chain batch are built on the host; the chains whose meshes share a
  layout (triangle counts) are assembled, solved and mapped to the
  surface together in float64 on the card, one group after another.  A
  chain whose meshes intersect or breach the surface gets the −99 fill
  (``BEMResponse.INVALID``).

Both use :class:`~beat_tpu_torch.models.geodetic.GeodeticComposite`'s
residual (corrections included), whitening and hyperparameters.
"""

from __future__ import annotations

import copy
import logging
from collections import Counter, defaultdict

import numpy as np
import torch

from beat_tpu_torch.bem import tde
from beat_tpu_torch.bem.base import BEMResponse, lstsq_robust
from beat_tpu_torch.models.geodetic import GeodeticComposite
from beat_tpu_torch.parameter import Parameter

logger = logging.getLogger("beat_tpu_torch.models.bem")


def _check_engine(engine, composite):
    if engine.device != composite.data.device:
        raise ValueError(f"BEM engine on {engine.device}, composite on {composite.data.device}")


def unit_los_responses(engine, sources, coords, los) -> torch.Tensor:
    """LOS displacements (N, n_bc) at ``coords`` (N, 2) along ``los``
    (N, 3) per 1 MPa on each boundary condition of ``engine``, float64 on
    its device: the interaction matrix, the traction-balance solve of
    :meth:`~beat_tpu_torch.bem.base.BEMEngine.solve_batch` with one
    right-hand side per BC, and the displacement matrix."""
    meshes = engine.discretize(sources)
    if engine.is_invalid(meshes):
        raise ValueError("BEM source meshes intersect or breach the surface")
    G = engine.get_interaction_matrix(meshes)
    D = tde.displacement_matrix(meshes, coords, nu=engine.nu, mu=engine.mu,
                                boundary_conditions=engine.boundary_conditions,
                                medium=engine.medium, device=engine.device)
    n_bc = len(engine.boundary_conditions)
    rhs = engine._traction_rhs(meshes, np.eye(n_bc), n_bc).T          # (R, n_bc)
    slips = lstsq_robust(G, -rhs)                                       # (K, n_bc)
    disp = (D @ slips).reshape(-1, 3, n_bc)
    los = torch.as_tensor(np.asarray(los, dtype=np.float64), device=disp.device)
    return torch.einsum("nib,ni->nb", disp, los)


class GeodeticBEMLinearComposite(GeodeticComposite):
    """Fixed source geometry, sampled tractions: one
    ``<component>_traction`` per boundary-condition component
    (vector-valued when several BCs share a component).

    unit_los : the (N, n_bc) unit-traction responses of these datasets
        when already computed (:func:`unit_los_responses`, or the JAX
        package's); built on the engine's device otherwise."""

    name = "geodetic"

    def __init__(self, datasets, sources, engine, unit_los=None, *, device, **kwargs):
        super().__init__(datasets, device=device, **kwargs)
        _check_engine(engine, self)
        self.sources = list(sources)
        self.engine = engine
        if unit_los is None:
            unit_los = unit_los_responses(engine, self.sources, self.stack.coords,
                                          self.stack.los)
        if not isinstance(unit_los, torch.Tensor):
            unit_los = torch.as_tensor(np.array(unit_los, dtype=np.float64))
        if unit_los.shape != (self.stack.samples, len(engine.boundary_conditions)):
            raise ValueError(f"unit_los of shape {tuple(unit_los.shape)} for "
                             f"{self.stack.samples} points and "
                             f"{len(engine.boundary_conditions)} boundary conditions")
        self.register_buffer("unit_los", unit_los.to(device=self.data.device,
                                                     dtype=self.data.dtype))
        logger.info("Linear BEM composite: %i BCs over %i points",
                    len(engine.boundary_conditions), self.stack.samples)

    def traction_parameters(self) -> list:
        """Prior templates for the sampled tractions (registry bounds)."""
        counts = Counter(bc.slip_component for bc in self.engine.boundary_conditions)
        return [Parameter.from_defaults(f"{c}_traction", dimension=n)
                for c, n in sorted(counts.items())]

    def _traction_vector(self, point: dict, n_chains: int) -> torch.Tensor:
        """(C, n_bc) tractions [MPa]: the k-th BC of a component takes the
        k-th entry of its sampled vector, a BC whose component is not
        sampled its own value."""
        vals, idx = [], defaultdict(int)
        for bc in self.engine.boundary_conditions:
            name = f"{bc.slip_component}_traction"
            if name in point:
                v = point[name].reshape(n_chains, -1)
                vals.append(v[:, idx[name]] if v.shape[1] > 1 else v[:, 0])
            else:
                vals.append(torch.full((n_chains,), float(bc.traction), dtype=self.data.dtype,
                                       device=self.data.device))
            idx[name] += 1
        return torch.stack(vals, dim=-1)

    def device_data(self) -> dict:
        return {**super().device_data(), "unit_los": self.unit_los}

    def synthetics_los(self, point: dict, data=None) -> torch.Tensor:
        unit_los = self.unit_los if data is None else data["unit_los"]
        n_chains = next(iter(point.values())).shape[0]
        return self._traction_vector(point, n_chains) @ unit_los.T

    def synthetics_los_np(self, point: dict) -> np.ndarray:
        return self.synthetics_np(point)


class GeodeticBEMComposite(GeodeticComposite):
    """Geodetic likelihood with the BEM forward of sampled geometries:
    sampled values override the source templates' attributes by name
    (vector-valued for several sources), sampled ``<component>_traction``
    values the BCs' tractions."""

    name = "geodetic"

    def __init__(self, datasets, sources, engine, *, device, **kwargs):
        super().__init__(datasets, device=device, **kwargs)
        _check_engine(engine, self)
        self.sources = list(sources)
        self.engine = engine

    def _apply_point_np(self, point_np: dict) -> list:
        """Clone the sources with one chain's values applied (host)."""
        out = []
        for i, src in enumerate(self.sources):
            s = copy.copy(src)
            for name, val in point_np.items():
                if hasattr(s, name):
                    v = np.atleast_1d(val)
                    setattr(s, name, float(v[i] if v.size > 1 else v[0]))
            out.append(s)
        return out

    def _point_tractions(self, point_np: dict):
        """Per-BC tractions [MPa] of one chain (occurrence-indexed like
        the linear composite); None when no traction is sampled."""
        if not any(f"{bc.slip_component}_traction" in point_np
                   for bc in self.engine.boundary_conditions):
            return None
        vals, idx = [], defaultdict(int)
        for bc in self.engine.boundary_conditions:
            name = f"{bc.slip_component}_traction"
            if name in point_np:
                v = np.atleast_1d(point_np[name])
                vals.append(float(v[idx[name]] if v.size > 1 else v[0]))
            else:
                vals.append(bc.traction)
            idx[name] += 1
        return vals

    def _forward_names(self, point: dict) -> list:
        bc_names = {f"{bc.slip_component}_traction" for bc in self.engine.boundary_conditions}
        return sorted(n for n in point
                      if any(hasattr(s, n) for s in self.sources) or n in bc_names)

    def synthetics_los(self, point: dict, data=None) -> torch.Tensor:
        """(C, N) LOS synthetics of a chain batch: host meshing per chain,
        then one float64 assembly, solve and surface mapping on the
        engine's device per group of chains sharing a mesh layout; −99
        for invalid geometries."""
        names = self._forward_names(point)
        n_chains = next(iter(point.values())).shape[0]
        for n in names:
            if point[n].device != self.data.device:
                raise ValueError(f"point value {n!r} on {point[n].device}, composite on "
                                 f"{self.data.device}")
        host = {n: point[n].detach().double().cpu().numpy().reshape(n_chains, -1)
                for n in names}
        groups = defaultdict(list)
        for c in range(n_chains):
            point_np = {n: host[n][c] for n in names}
            meshes = self.engine.discretize(self._apply_point_np(point_np))
            if not self.engine.is_invalid(meshes):
                layout = tuple(m.ntriangles for m in meshes)
                groups[layout].append((c, meshes, self._point_tractions(point_np)))
        los64 = torch.as_tensor(self.stack.los, dtype=torch.float64, device=self.engine.device)
        out = torch.full((n_chains, self.stack.samples), BEMResponse.INVALID,
                         dtype=torch.float64, device=self.engine.device)
        for members in groups.values():
            chains = [c for c, _, _ in members]
            tractions = None
            if members[0][2] is not None:
                tractions = [t for _, _, t in members]
            _, disp = self.engine.solve_batch([m for _, m, _ in members], self.stack.coords,
                                              tractions)
            out[chains] = torch.einsum("bni,ni->bn", disp, los64)
        return out.to(device=self.data.device, dtype=self.data.dtype)

    def synthetics_los_np(self, point: dict) -> np.ndarray:
        """(N,) LOS synthetics of one point (no chain axis), numpy."""
        return self.synthetics_np(point)
