"""
Geodetic data corrections: InSAR orbital ramps, Euler-pole plate
rotation and regional strain-rate fields (port of
``beat_tpu/heart/corrections.py``).

The hierarchical parameters a correction reads are tensors of one
leading shape — (C,) for a batch of chains — and each correction's
displacement is (C, N) over the N observations of its dataset; the
station geometry (latitudes, longitudes, local coordinates, masks) is
host numpy fixed at set-up and placed on the device of the parameters.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

D2R = math.pi / 180.0
EARTH_RADIUS = 6371008.8  # [m]
NANOSTRAIN = 1e-9


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def get_ramp_displacement(locx, locy, azimuth_ramp, range_ramp, offset):
    """Planar orbital ramp: parameters (...) against coordinates (N,) →
    (..., N)."""
    return (locy * azimuth_ramp[..., None] + locx * range_ramp[..., None]
            + offset[..., None])


def latlon_to_xyz(lats, lons) -> torch.Tensor:
    """Unit-sphere Cartesian coordinates (..., 3) of geographic [deg]."""
    rlat, rlon = lats * D2R, lons * D2R
    return torch.stack([torch.cos(rlat) * torch.cos(rlon), torch.cos(rlat) * torch.sin(rlon),
                        torch.sin(rlat)], dim=-1)


def velocities_from_pole(lats, lons, pole_lat, pole_lon, omega) -> torch.Tensor:
    """Plate velocities [m/yr] at stations (N,) [deg] for rotations
    ``omega`` [deg/Myr] about Euler poles (pole parameters of shape (...)):
    (..., N, 3) in (north, east, up), spherical earth."""
    pole_lat = torch.as_tensor(pole_lat)
    lats, lons = _like(lats, pole_lat), _like(lons, pole_lat)
    pole_lon, omega = _like(pole_lon, pole_lat), _like(omega, pole_lat)
    xyz_points = latlon_to_xyz(lats, lons)                                # (N, 3)
    xyz_pole = latlon_to_xyz(pole_lat, pole_lon)[..., None, :]            # (..., 1, 3)
    v_cart = ((omega * 1e-6 * D2R * EARTH_RADIUS)[..., None, None]
              * torch.linalg.cross(xyz_pole.expand(*xyz_pole.shape[:-2], *xyz_points.shape),
                                   xyz_points.expand(*xyz_pole.shape[:-2], *xyz_points.shape)))
    rlat, rlon = lats * D2R, lons * D2R
    # local north, east and down unit vectors in ECEF, (N, 3) each
    north = torch.stack([-torch.sin(rlat) * torch.cos(rlon), -torch.sin(rlat) * torch.sin(rlon),
                         torch.cos(rlat)], dim=-1)
    east = torch.stack([-torch.sin(rlon), torch.cos(rlon), torch.zeros_like(rlon)], dim=-1)
    down = torch.stack([-torch.cos(rlat) * torch.cos(rlon), -torch.cos(rlat) * torch.sin(rlon),
                        -torch.sin(rlat)], dim=-1)
    return torch.stack([torch.sum(north * v_cart, dim=-1), torch.sum(east * v_cart, dim=-1),
                        -torch.sum(down * v_cart, dim=-1)], dim=-1)


def velocities_from_strain_rate_tensor(norths, easts, exx, eyy, exy, rotation) -> torch.Tensor:
    """Velocities [m] of a 2-d strain-rate tensor in nanostrain
    (parameters (...)) at local coordinates (N,) relative to the network
    centroid: (..., N, 3) in (north, east, up)."""
    exx = torch.as_tensor(exx)
    norths, easts = _like(norths, exx), _like(easts, exx)
    d00 = (exx * NANOSTRAIN)[..., None]
    d01 = (0.5 * (exy + rotation) * NANOSTRAIN)[..., None]
    d10 = (0.5 * (exy - rotation) * NANOSTRAIN)[..., None]
    d11 = (eyy * NANOSTRAIN)[..., None]
    v_x = d00 * norths + d01 * easts
    v_y = d10 * norths + d11 * easts
    return torch.stack([v_x, v_y, torch.zeros_like(v_x)], dim=-1)


def _los_projected(v_neu: torch.Tensor, los_enu: torch.Tensor, mask) -> torch.Tensor:
    """(…, N) line-of-sight projection of (…, N, 3) NEU velocities, with
    the station mask applied."""
    disp = (v_neu[..., 1] * los_enu[:, 0] + v_neu[..., 0] * los_enu[:, 1]
            + v_neu[..., 2] * los_enu[:, 2])
    if mask is not None:
        disp = disp * _like(np.asarray(mask, dtype=np.float64), disp)
    return disp


@dataclass
class RampCorrection:
    """InSAR orbital ramp with hierarchicals ``<dataset>_azimuth_ramp``,
    ``<dataset>_range_ramp`` and ``<dataset>_offset``."""

    dataset_name: str

    @property
    def parameter_names(self):
        return [f"{self.dataset_name}_azimuth_ramp", f"{self.dataset_name}_range_ramp",
                f"{self.dataset_name}_offset"]

    def displacement(self, hierarchicals: dict, coords: torch.Tensor) -> torch.Tensor:
        az, rg, off = (hierarchicals[n] for n in self.parameter_names)
        return get_ramp_displacement(coords[:, 0], coords[:, 1], az, rg, off)


@dataclass
class EulerPoleCorrection:
    """GNSS plate-rotation correction with hierarchicals
    ``<number>_pole_lat``, ``<number>_pole_lon`` and ``<number>_omega``:
    LOS-projected station velocities times ``time_span`` [yr].  Instances
    of one ``number`` share their hierarchicals; ``dataset_name`` picks
    the GNSS dataset an instance applies to (None: every GNSS dataset)."""

    number: int
    lats: np.ndarray
    lons: np.ndarray
    time_span: float = 1.0
    dataset_name: str = None
    mask: np.ndarray = None

    @property
    def parameter_names(self):
        return [f"{self.number}_pole_lat", f"{self.number}_pole_lon", f"{self.number}_omega"]

    def displacement(self, hierarchicals: dict, los_enu: torch.Tensor) -> torch.Tensor:
        plat, plon, omega = (hierarchicals[n] for n in self.parameter_names)
        v_neu = velocities_from_pole(self.lats, self.lons, plat, plon, omega)
        return _los_projected(v_neu, los_enu, self.mask) * self.time_span


@dataclass
class StrainRateCorrection:
    """Regional strain-rate correction with hierarchicals ``<number>_exx``,
    ``_eyy``, ``_exy`` and ``_rotation``."""

    number: int
    norths: np.ndarray
    easts: np.ndarray
    dataset_name: str = None
    mask: np.ndarray = None

    @property
    def parameter_names(self):
        return [f"{self.number}_exx", f"{self.number}_eyy", f"{self.number}_exy",
                f"{self.number}_rotation"]

    def displacement(self, hierarchicals: dict, los_enu: torch.Tensor) -> torch.Tensor:
        exx, eyy, exy, rot = (hierarchicals[n] for n in self.parameter_names)
        v_neu = velocities_from_strain_rate_tensor(self.norths, self.easts, exx, eyy, exy, rot)
        return _los_projected(v_neu, los_enu, self.mask)


def station_mask(stations, whitelist=(), blacklist=()) -> np.ndarray:
    """Boolean per-observation mask from station white/blacklists: a
    non-empty whitelist keeps only its members; blacklisted stations are
    always excluded."""
    stations = np.asarray(stations)
    mask = np.ones(stations.shape, dtype=bool)
    if whitelist:
        mask &= np.isin(stations, list(whitelist))
    if blacklist:
        mask &= ~np.isin(stations, list(blacklist))
    return mask
