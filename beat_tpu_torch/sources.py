"""
Source parameterizations (port of ``beat_tpu/sources.py``): the point
moment-tensor source of the geometry inversion, and the rectangular
fault plane whose patch grid carries the distributed-slip (FFI)
inversion.

:class:`RectangularSource` is host numpy geometry (patches, centers);
as a *sampled* finite source of the geometry inversion it is, with the
other source types (MTQT, DC, Explosion, CLVD, DoubleDC, Ringfault), a
ROADMAP item of a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SQRT2 = math.sqrt(2.0)

# pyrocko convention: M0 [Nm] = 10^(1.5·(Mw + 10.7)) · 1e-7
MOMENT_EXP_OFFSET = 1.5 * 10.7 - 7.0  # = 9.05


def magnitude_to_moment(magnitude):
    return 10.0 ** (1.5 * magnitude + MOMENT_EXP_OFFSET)


def moment_to_magnitude(moment):
    return (np.log10(moment) - MOMENT_EXP_OFFSET) / 1.5


def sdr_to_m6(strike, dip, rake, moment=1.0) -> torch.Tensor:
    """Double couple (strike, dip, rake [deg]) → NED MT components
    (mnn, mee, mdd, mne, mnd, med)·M0 (Aki & Richards box 4.4).
    Batched over the leading shape of the angles → (..., 6)."""
    phi, delta, lam = (torch.deg2rad(torch.as_tensor(a, dtype=torch.float32))
                       for a in (strike, dip, rake))
    sd, cd = torch.sin(delta), torch.cos(delta)
    s2d, c2d = torch.sin(2 * delta), torch.cos(2 * delta)
    sl, cl = torch.sin(lam), torch.cos(lam)
    sp, cp = torch.sin(phi), torch.cos(phi)
    s2p, c2p = torch.sin(2 * phi), torch.cos(2 * phi)

    mnn = -(sd * cl * s2p + s2d * sl * sp**2)
    mee = sd * cl * s2p - s2d * sl * cp**2
    mdd = s2d * sl
    mne = sd * cl * c2p + 0.5 * s2d * sl * s2p
    mnd = -(cd * cl * cp + c2d * sl * sp)
    med = -(cd * cl * sp - c2d * sl * cp)
    m = torch.as_tensor(moment, dtype=torch.float32)
    return m[..., None] * torch.stack([mnn, mee, mdd, mne, mnd, med], dim=-1)


def tensile_m6(strike, dip, potency, lam=33e9, mu=33e9) -> torch.Tensor:
    """Moment tensor of a tensile crack opening normal to a plane with
    the given strike/dip [deg]: M = potency·(λ·I + 2µ·n nᵀ), NED basis,
    ``potency`` = area × opening [m³].  Batched like :func:`sdr_to_m6`
    → (..., 6)."""
    phi, delta, pot = (torch.as_tensor(a, dtype=torch.float32) for a in (strike, dip, potency))
    phi, delta = torch.deg2rad(phi), torch.deg2rad(delta)
    # fault normal (hanging-wall side, pointing up) in NED (Aki & Richards)
    n_vec = torch.stack([-torch.sin(delta) * torch.sin(phi),
                         torch.sin(delta) * torch.cos(phi),
                         -torch.cos(delta)], dim=-1)
    nn = n_vec[..., :, None] * n_vec[..., None, :]
    m = pot[..., None, None] * (lam * torch.eye(3) + 2.0 * mu * nn)
    return torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                        m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]], dim=-1)


@dataclass
class BaseSource:
    """Common location/time parameters of all sources."""

    east_shift: float = 0.0   # [m]
    north_shift: float = 0.0  # [m]
    depth: float = 1000.0     # [m]
    time: float = 0.0         # [s] relative to event reference
    duration: float = 1.0     # [s] source-time-function duration

    parameter_names = ("east_shift", "north_shift", "depth", "time")


@dataclass
class MTSource(BaseSource):
    """Full moment tensor with unit-normalised components + magnitude
    (reference ``MTSourceWithMagnitude``)."""

    mnn: float = 1.0
    mee: float = 1.0
    mdd: float = 1.0
    mne: float = 0.0
    mnd: float = 0.0
    med: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "mnn", "mee", "mdd", "mne", "mnd", "med", "magnitude")


@dataclass
class RectangularSource(BaseSource):
    """Rectangular fault plane, anchored at its top-center ('top')."""

    strike: float = 0.0   # [deg]
    dip: float = 90.0     # [deg]
    rake: float = 0.0     # [deg]
    length: float = 1000.0  # [m]
    width: float = 1000.0   # [m]
    slip: float = 1.0       # [m]
    opening_fraction: float = 0.0  # tensile fraction of slip
    anchor: str = "top"
    #: kinematic attributes (FFI mode)
    velocity: float = 3500.0      # rupture velocity [m/s]
    duration: float = 0.0         # STF duration [s]
    nucleation_x: float = 0.0     # [-1, 1] along strike
    nucleation_y: float = 0.0     # [-1, 1] down dip

    parameter_names = ("east_shift", "north_shift", "depth", "strike", "dip",
                       "rake", "length", "width", "slip", "opening_fraction",
                       "time", "velocity", "duration",
                       "nucleation_x", "nucleation_y")

    @property
    def strikevector(self) -> np.ndarray:
        st = np.deg2rad(self.strike)
        return np.array([np.sin(st), np.cos(st), 0.0])

    def patches(self, n_length: int, n_width: int) -> list["RectangularSource"]:
        """Uniform discretization into n_length × n_width sub-faults in
        strike-fastest order, each anchored 'top'."""
        pl = self.length / n_length
        pw = self.width / n_width
        st = np.deg2rad(self.strike)
        di = np.deg2rad(self.dip)
        s_vec = np.array([np.sin(st), np.cos(st)])        # E,N along strike
        d_vec_h = np.array([np.cos(st), -np.sin(st)])     # E,N horizontal dip dir
        out = []
        for iw in range(n_width):
            for il in range(n_length):
                # top-center anchor of this patch
                along = (il + 0.5) * pl - self.length / 2.0
                downdip = iw * pw
                e = self.east_shift + along * s_vec[0] + downdip * np.cos(di) * d_vec_h[0]
                n = self.north_shift + along * s_vec[1] + downdip * np.cos(di) * d_vec_h[1]
                z = self.depth + downdip * np.sin(di)
                out.append(RectangularSource(
                    east_shift=e, north_shift=n, depth=z, time=self.time,
                    strike=self.strike, dip=self.dip, rake=self.rake,
                    length=pl, width=pw, slip=self.slip,
                    opening_fraction=self.opening_fraction, anchor="top",
                    velocity=self.velocity))
        return out

    def center(self) -> np.ndarray:
        """(E, N, Z) of the plane center [m]."""
        st, di = np.deg2rad(self.strike), np.deg2rad(self.dip)
        d_vec_h = np.array([np.cos(st), -np.sin(st)])
        half_w = 0.5 * self.width
        return np.array([
            self.east_shift + half_w * np.cos(di) * d_vec_h[0],
            self.north_shift + half_w * np.cos(di) * d_vec_h[1],
            self.depth + half_w * np.sin(di)])
