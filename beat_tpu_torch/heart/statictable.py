"""
Static Green's-function tables: the surface response to the six
elementary moment tensors on a regular (distance, source-depth) grid,
for geodetic forwards in layered (1-D) media (port of
``beat_tpu/heart/statictable.py``).

The forward is the seismic table's pipeline without time: a bilinear
gather in (distance, depth), the moment tensor rotated into the ray
frame, a contraction over its six components and the rotation of (Z, R,
T) into (east, north, up).  It is batched: sources of any leading shape
(*B) (chains, or chains × patches) against N observation points give
(*B, N, 3).  Depth is per source, so the depth fraction of the gather
is a tensor of shape (*B) (the JAX package's gather takes one traced
depth).

Builders, on the given device: :func:`build_static_table`, the layered
table from the Hankel-domain solver of
:mod:`beat_tpu_torch.heart.layered_statics` (the psgrn analogue), and
:func:`build_homogeneous_static_table`, the analytic homogeneous
halfspace from the port's moment-tensor Okada forward.  A table built by
either package is read with :meth:`StaticGFTable.load`.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.heart.gftable import rotate_m6_to_ray_frame

logger = logging.getLogger("beat_tpu_torch.heart.statictable")

def _step(grid: np.ndarray) -> float:
    return float(grid[1] - grid[0]) if grid.size > 1 else 1.0


def bilinear_cell(d_grid, z_grid, distance: torch.Tensor, depth: torch.Tensor) -> tuple:
    """Cell indices and fractions on uniform (distance, depth) grids:
    ``(d0, z0, fd, fz)`` with d0, fd shaped like ``distance`` and z0, fz
    like ``depth``.  A size-1 axis is a nearest-node lookup (fraction 0).
    The cell index is clamped to the last cell, so a query at the top
    node is exact (fraction 1.0) instead of blending in the neighbour."""
    d_grid, z_grid = np.asarray(d_grid), np.asarray(z_grid)
    di = torch.clamp((distance - float(d_grid[0])) / _step(d_grid), 0.0, float(d_grid.size - 1))
    zi = torch.clamp((depth - float(z_grid[0])) / _step(z_grid), 0.0, float(z_grid.size - 1))
    d0 = torch.clamp(torch.floor(di).long(), max=max(d_grid.size - 2, 0))
    z0 = torch.clamp(torch.floor(zi).long(), max=max(z_grid.size - 2, 0))
    return d0, z0, di - d0, zi - z0


class StaticGFTable(nn.Module):
    """values : (6, 3, ndist, ndepth) float32 (numpy or a tensor) — surface displacement per unit
    elementary MT (order mnn, mee, mdd, mne, mnd, med), receiver at
    azimuth 0 (due north), components (Z up, R = +N, T = +E), a buffer.
    distances, depths : uniform grid nodes [m] (host numpy).
    mu_tops, mus, lams : the 1-D elastic profile (layer tops [m], shear
    moduli and Lamé λ [Pa]) for the moments of finite-source patches."""

    #: axes before the (6, 3, nd, nz) values (the epochs of a subclass)
    LEADING_AXES = 0

    def __init__(self, values, distances, depths, mu_tops=None, mus=None, lams=None,
                 name: str = "static", *, device):
        super().__init__()
        dev = resolve(device)
        self.distances = np.asarray(distances, dtype=np.float64)
        self.depths = np.asarray(depths, dtype=np.float64)
        for label, g in (("distances", self.distances), ("depths", self.depths)):
            if g.size > 1:
                steps = np.diff(g)
                if steps.min() <= 0 or steps.max() - steps.min() > 1e-6 * steps.mean():
                    raise ValueError(
                        f"StaticGFTable {label} must be uniformly spaced and increasing "
                        f"(bilinear index assumes a constant step); got steps "
                        f"[{steps.min():g}, {steps.max():g}]")
        if mu_tops is None:
            mu_tops, mus, lams = [0.0], [33e9], [33e9]
        self.mu_tops = np.asarray(mu_tops, dtype=np.float64)
        self.mus = np.asarray(mus, dtype=np.float64)
        self.lams = np.asarray(lams, dtype=np.float64)
        self.name = str(name)
        values = torch.as_tensor(values, dtype=torch.float32, device=dev)
        nd, nz = self.distances.size, self.depths.size
        want = values.shape[:self.LEADING_AXES] + (6, 3, nd, nz)
        if values.dim() != 4 + self.LEADING_AXES or tuple(values.shape) != tuple(want):
            raise ValueError(f"values {tuple(values.shape)}, expected "
                             f"{'(ne, ' if self.LEADING_AXES else '('}6, 3, {nd}, {nz})")
        self.register_buffer("values", values)
        # the gather's layout: one row of 6 × 3 values per grid node (per epoch)
        self.register_buffer("rows", values.movedim((-2, -1), (-4, -3)).reshape(-1, 18)
                             .contiguous(), persistent=False)
        self.register_buffer("tops", torch.as_tensor(self.mu_tops, dtype=DTYPE, device=dev),
                             persistent=False)
        self.register_buffer("mu_values", torch.as_tensor(self.mus, dtype=DTYPE, device=dev),
                             persistent=False)
        self.register_buffer("lam_values", torch.as_tensor(self.lams, dtype=DTYPE, device=dev),
                             persistent=False)

    def _layer(self, depth: torch.Tensor) -> torch.Tensor:
        tops = self.tops.to(depth.dtype)
        idx = torch.searchsorted(tops, depth.contiguous(), right=True) - 1
        return torch.clamp(idx, 0, tops.numel() - 1)

    def shear_modulus(self, depth: torch.Tensor) -> torch.Tensor:
        """µ at each depth (any shape) from the stored profile."""
        return self.mu_values.to(depth.dtype)[self._layer(depth)]

    def lame_lambda(self, depth: torch.Tensor) -> torch.Tensor:
        return self.lam_values.to(depth.dtype)[self._layer(depth)]

    def _epoch_offset(self) -> int | torch.Tensor:
        """Each observation's offset into a source's (epochs × distances)
        rows: 0 here (one epoch)."""
        return 0

    def synthesize_enu(self, m6, east_shift, north_shift, depth, obs_east, obs_north):
        """Surface displacements (*B, N, 3 = E, N, up) of point MTs m6
        (*B, 6) at positions (*B), observed at (N,) points.

        The bilinear gather runs in two steps: every source's depth blend
        of the table, (*B, [epochs ×] distances, 18), then each
        observation's two distance corners from it — half the rows a
        four-corner gather of (*B, N, 18) reads."""
        de = obs_east - east_shift[..., None]
        dn = obs_north - north_shift[..., None]
        distance = torch.sqrt(de * de + dn * dn)
        azimuth = torch.atan2(de, dn)
        d0, z0, fd, fz = bilinear_cell(self.distances, self.depths, distance, depth)
        m6_ray = rotate_m6_to_ray_frame(m6[..., None, :], azimuth)         # (*B, N, 6)
        nd, nz = self.distances.size, self.depths.size
        rows = self.rows.to(m6_ray.dtype).reshape(-1, nz, 18)               # ([ne ·] nd, nz, 18)
        z1 = torch.clamp(z0 + 1, max=nz - 1)
        fz = fz[..., None]
        per_source = rows[:, z0] * (1.0 - fz) + rows[:, z1] * fz           # ([ne·]nd, *B, 18)
        per_source = per_source.movedim(0, -2).reshape(-1, 18)             # (*B · [ne·]nd, 18)
        n_rows = rows.shape[0]
        base = (torch.arange(d0[..., 0].numel(), device=d0.device)
                .reshape(d0.shape[:-1])[..., None] * n_rows + self._epoch_offset())
        d1 = torch.clamp(d0 + 1, max=nd - 1)
        fd = fd[..., None]
        g = per_source[base + d0] * (1.0 - fd) + per_source[base + d1] * fd  # (*B, N, 18)
        # the contraction over the 6 components as one elementwise product
        # and sum (an einsum here runs as a batched matrix-vector product,
        # 6 × 3 per query, at a tenth of the card's memory rate)
        u_zrt = torch.sum(m6_ray[..., None] * g.unflatten(-1, (6, 3)), dim=-2)
        uz, ur, ut = u_zrt.unbind(-1)
        sa, ca = torch.sin(azimuth), torch.cos(azimuth)
        return torch.stack([ur * sa + ut * ca, ur * ca - ut * sa, uz], dim=-1)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` format: either package reads it."""
        np.savez_compressed(path, values=self.values.cpu().numpy(), distances=self.distances,
                            depths=self.depths, mu_tops=self.mu_tops, mus=self.mus,
                            lams=self.lams, name=np.array(self.name))

    @classmethod
    def load(cls, path: str, *, device) -> "StaticGFTable":
        with np.load(path) as z:
            return cls(z["values"], z["distances"], z["depths"], mu_tops=z["mu_tops"],
                       mus=z["mus"], lams=z["lams"], name=str(z["name"]), device=device)


def static_table_values(models, distances, depths, *, device) -> torch.Tensor:
    """(M, 6, 3, nd, nz) float64 static table values of every model (all
    sharing their layer tops) from the layered solver
    (:func:`~beat_tpu_torch.heart.layered_statics.elementary_mt_displacements`),
    receivers due north: components (Z up, R = +N, T = +E)."""
    from beat_tpu_torch.heart.layered_statics import elementary_mt_displacements

    distances = np.asarray(distances, dtype=np.float64)
    obs = np.stack([np.zeros_like(distances), distances], axis=-1)
    u = elementary_mt_displacements(models, depths, obs, device=device)     # (M, nz, 6, nd, 3)
    return u[..., [2, 1, 0]].permute(0, 2, 4, 3, 1)


def build_static_table(model, distances, depths, name: str = None, *, device) -> StaticGFTable:
    """Layered static table from the Hankel-domain solver on ``device``
    (the psgrn-run replacement; port of ``beat_tpu``'s
    ``build_static_table``): all depths and their six shifted
    evaluations in one batch.  The depth grid is nudged off the layer
    interfaces first (``nudge_depths_off_interfaces``), so no vertical
    dipole straddles one."""
    from beat_tpu_torch.heart.layered_waveforms import nudge_depths_off_interfaces

    dev = resolve(device)
    distances = np.asarray(distances, dtype=np.float64)
    depths = nudge_depths_off_interfaces(model, depths)
    vals = static_table_values([model], distances, depths, device=dev)[0]
    logger.info("Built layered static GF table: %i dist x %i depth (%s)", distances.size,
                depths.size, getattr(model, "name", "model"))
    return StaticGFTable(vals, distances, depths, mu_tops=np.asarray(model.tops),
                         mus=model.rho * model.vs**2,
                         lams=model.rho * (model.vp**2 - 2 * model.vs**2),
                         name=name or f"layered_{getattr(model, 'name', '')}", device=dev)


def build_homogeneous_static_table(distances, depths, nu=0.25, shear_modulus=33e9, *,
                                   device) -> StaticGFTable:
    """The analytic homogeneous-halfspace table from the moment-tensor
    Okada forward, all six unit tensors at all depths in one call on
    ``device``, in :data:`~beat_tpu_torch.heart.okada.FORWARD_DTYPE`."""
    from beat_tpu_torch.heart import okada

    dev, dtype = resolve(device), okada.FORWARD_DTYPE
    distances = np.asarray(distances, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.float64)
    obs = torch.as_tensor(np.stack([np.zeros_like(distances), distances], axis=-1),
                          dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)[:, None, :].expand(6, depths.size, 6)
    z = torch.as_tensor(depths, dtype=dtype, device=dev)[None, :].expand(6, depths.size)
    u = okada.mt_surface_displacement(obs, eye6, depth=z, nu=nu, shear_modulus=shear_modulus)
    # (6, nz, nd, 3 = E, N, up) -> (6, 3 = Z, R, T, nd, nz)
    vals = torch.stack([u[..., 2], u[..., 1], u[..., 0]], dim=1).permute(0, 1, 3, 2)
    lam = 2.0 * shear_modulus * nu / (1.0 - 2.0 * nu)
    return StaticGFTable(vals, distances, depths, mu_tops=[0.0],
                         mus=[shear_modulus], lams=[lam], name="homogeneous", device=dev)
