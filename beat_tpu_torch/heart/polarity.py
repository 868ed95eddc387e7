"""
First-motion polarity forward modeling (port of
``beat_tpu/heart/polarity.py``).

Takeoff vectors come from straight rays in a homogeneous medium, or from
a (depth × distance) :class:`TakeoffTable` that the host ray tracer
(:mod:`beat_tpu_torch.heart.velocity_model`) fills once; the P/SH/SV
amplitudes are the far-field radiation patterns as linear forms on m6.
Every function broadcasts over leading axes, so one call serves a
batch of chains: azimuths and takeoffs (C, n) give weights (C, n, 6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve


@dataclass
class PolarityTarget:
    """One station observing a first-motion polarity."""

    station: str
    azimuth_rad: float            # source->station azimuth [rad]
    takeoff_rad: float            # angle from downward vertical [rad]
    polarity: int                 # observed first motion: +1 / -1
    #: epicentral distance [m] from the catalog origin — needed for
    #: per-draw takeoff re-interpolation when the location is sampled
    distance_m: float | None = None


@dataclass
class TakeoffTable:
    """First-arrival takeoff angles on a (depth × distance) grid as
    tensors on one device, gathered bilinearly inside the likelihood so
    the polarity geometry follows each chain's sampled location."""

    depth_grid: torch.Tensor    # (nd,) source depths [m], ascending
    dist_grid: torch.Tensor     # (nr,) epicentral distances [m], ascending
    angles_rad: torch.Tensor    # (nd, nr) takeoff angles [rad from down]

    @staticmethod
    def _locate(grid, x):
        i = torch.clamp(torch.searchsorted(grid, x.contiguous(), right=True) - 1,
                        0, grid.shape[0] - 2)
        w = (x - grid[i]) / (grid[i + 1] - grid[i])
        return i, torch.clamp(w, 0.0, 1.0)

    def interp(self, depth, distance):
        """Bilinear takeoff [rad] at per-chain ``depth`` (C,) and
        per-target ``distance`` (C, n); returns (C, n).  Cell weights are
        clipped to [0, 1], so queries off the grid take its edge values."""
        A = self.angles_rad
        iz, wz = self._locate(self.depth_grid, depth)
        ir, wr = self._locate(self.dist_grid, distance)
        iz, wz = iz[:, None], wz[:, None]
        a00 = A[iz, ir]
        a01 = A[iz, ir + 1]
        a10 = A[iz + 1, ir]
        a11 = A[iz + 1, ir + 1]
        return ((1 - wz) * ((1 - wr) * a00 + wr * a01)
                + wz * ((1 - wr) * a10 + wr * a11))

    def to(self, device=None, dtype=None) -> "TakeoffTable":
        return TakeoffTable(*(t.to(device=device, dtype=dtype)
                              for t in (self.depth_grid, self.dist_grid, self.angles_rad)))

    def as_device(self) -> dict:
        return {"to_depth_grid": self.depth_grid, "to_dist_grid": self.dist_grid,
                "to_angles": self.angles_rad}

    @classmethod
    def from_device(cls, dev: dict) -> "TakeoffTable":
        return cls(depth_grid=dev["to_depth_grid"], dist_grid=dev["to_dist_grid"],
                   angles_rad=dev["to_angles"])

    @classmethod
    def from_numpy(cls, depth_grid, dist_grid, angles_rad, *, device,
                   dtype=DTYPE) -> "TakeoffTable":
        dev = resolve(device)
        return cls(*(torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=dev)
                     for a in (depth_grid, dist_grid, angles_rad)))


def build_takeoff_table(model, depth_grid, dist_grid, phase: str = "p", *,
                        device) -> TakeoffTable:
    """Fill a :class:`TakeoffTable` with the host ray tracer
    (:func:`~beat_tpu_torch.heart.velocity_model.takeoff_angles`, float64,
    a row of distances a call), then move it to ``device``."""
    from beat_tpu_torch.heart.velocity_model import takeoff_angles

    depth_grid = np.asarray(depth_grid, dtype=float)
    dist_grid = np.asarray(dist_grid, dtype=float)
    ang = np.stack([takeoff_angles(model, z, dist_grid, phase) for z in depth_grid])
    return TakeoffTable.from_numpy(depth_grid, dist_grid, ang, device=device)


def radiation_weights(wavename: str, gvec, azimuth_rad, takeoff_rad):
    """The P/SH/SV radiation linear form, picked by the phase map's name."""
    if wavename.lower().endswith("sh"):
        return radiation_weights_sh(gvec, azimuth_rad)
    if wavename.lower().endswith("sv"):
        return radiation_weights_sv(gvec, azimuth_rad, takeoff_rad)
    return radiation_weights_p(gvec)


def takeoff_vector(azimuth_rad, takeoff_rad):
    """Unit ray vectors (..., 3) at the source in NED; takeoff measured
    from the downward vertical (0 = straight down, π = straight up)."""
    st = torch.sin(takeoff_rad)
    return torch.stack([st * torch.cos(azimuth_rad), st * torch.sin(azimuth_rad),
                        torch.cos(takeoff_rad)], dim=-1)


def straight_ray_takeoff(distance, depth):
    """Takeoff angle for a direct up-going ray in a homogeneous medium."""
    return math.pi - torch.atan2(torch.as_tensor(distance), torch.as_tensor(depth))


def radiation_weights_p(gamma):
    """P radiation as a linear form on m6: amplitude = w·m6 with
    w = (γn², γe², γd², 2γnγe, 2γnγd, 2γeγd) — γᵀMγ.
    gamma : (..., 3) unit ray vectors (NED).  Returns (..., 6)."""
    gn, ge, gd = gamma[..., 0], gamma[..., 1], gamma[..., 2]
    return torch.stack([gn * gn, ge * ge, gd * gd,
                        2 * gn * ge, 2 * gn * gd, 2 * ge * gd], dim=-1)


def radiation_weights_sh(gamma, azimuth_rad):
    """SH radiation linear form: (Mγ)·φ̂, φ̂ the horizontal transverse
    unit vector."""
    phi = torch.stack([-torch.sin(azimuth_rad), torch.cos(azimuth_rad),
                       torch.zeros_like(azimuth_rad)], dim=-1)
    return _bilinear_weights(gamma, phi)


def radiation_weights_sv(gamma, azimuth_rad, takeoff_rad):
    """SV radiation linear form: (Mγ)·θ̂."""
    ct, st = torch.cos(takeoff_rad), torch.sin(takeoff_rad)
    theta = torch.stack([ct * torch.cos(azimuth_rad), ct * torch.sin(azimuth_rad), -st],
                        dim=-1)
    return _bilinear_weights(gamma, theta)


def _bilinear_weights(a, b):
    """Linear form of aᵀMb + bᵀMa (symmetrised) on m6."""
    an, ae, ad = a[..., 0], a[..., 1], a[..., 2]
    bn, be, bd = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([an * bn, ae * be, ad * bd,
                        an * be + ae * bn,
                        an * bd + ad * bn,
                        ae * bd + ad * be], dim=-1)


def pol_synthetics(m6, weights):
    """Radiation amplitudes: weights (n, 6) or (C, n, 6) against m6 (6,)
    or (C, 6); returns (n,) or (C, n)."""
    return torch.matmul(weights, m6.unsqueeze(-1)).squeeze(-1)
