"""
Source parameterizations (port of ``beat_tpu/sources.py``, slice 1:
the point moment-tensor source).

The other source types (MTQT, DC, Explosion, CLVD, DoubleDC, Ringfault,
Rectangular) are ROADMAP items of a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

SQRT2 = math.sqrt(2.0)

# pyrocko convention: M0 [Nm] = 10^(1.5·(Mw + 10.7)) · 1e-7
MOMENT_EXP_OFFSET = 1.5 * 10.7 - 7.0  # = 9.05


def magnitude_to_moment(magnitude):
    return 10.0 ** (1.5 * magnitude + MOMENT_EXP_OFFSET)


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
