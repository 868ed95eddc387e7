"""
Source parameterizations (port of ``beat_tpu/sources.py``): the point
sources of the geometry inversion (moment tensor, Tape & Tape lune MT,
double couple, explosion, CLVD, two separated double couples, ring
fault) and the rectangular fault plane, which is a sampled finite source
of the geometry inversion and the patch grid of the distributed-slip
(FFI) inversion.

The moment-tensor math is torch, batched over any leading shape (the
chain axis (C,) of a sampled point, or (C, n) sub-sources); the
rectangle's patches and centers for the FFI are host numpy.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import numpy as np
import torch

SQRT2 = math.sqrt(2.0)
SQRT3 = math.sqrt(3.0)
SQRT6 = math.sqrt(6.0)
PI4 = math.pi / 4.0

# pyrocko convention: M0 [Nm] = 10^(1.5·(Mw + 10.7)) · 1e-7
MOMENT_EXP_OFFSET = 1.5 * 10.7 - 7.0  # = 9.05


def magnitude_to_moment(magnitude):
    return 10.0 ** (1.5 * magnitude + MOMENT_EXP_OFFSET)


def moment_to_magnitude(moment):
    return (np.log10(moment) - MOMENT_EXP_OFFSET) / 1.5


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _f32s(*xs) -> tuple:
    """float32 tensors of ``xs`` broadcast to one shape, numbers placed on
    the device of the tensors among them."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.float32, device=dev)
                                     for x in xs))


# ---------------------------------------------------------------------------
# Rotations (NWU frame, as in Tape & Tape 2015), batched: (...) -> (..., 3, 3)
# ---------------------------------------------------------------------------


def _rot(c, s, rows):
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    vals = {"1": one, "0": zero, "c": c, "s": s, "-s": -s}
    return torch.stack([torch.stack([vals[v] for v in row], dim=-1) for row in rows], dim=-2)


def rot_x(angle) -> torch.Tensor:
    a = _f32(angle)
    return _rot(torch.cos(a), torch.sin(a), (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))


def rot_y(angle) -> torch.Tensor:
    a = _f32(angle)
    return _rot(torch.cos(a), torch.sin(a), (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))


def rot_z(angle) -> torch.Tensor:
    a = _f32(angle)
    return _rot(torch.cos(a), torch.sin(a), (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))


# ---------------------------------------------------------------------------
# Moment-tensor conversions
# ---------------------------------------------------------------------------


def sdr_to_m6(strike, dip, rake, moment=1.0) -> torch.Tensor:
    """Double couple (strike, dip, rake [deg]) → NED MT components
    (mnn, mee, mdd, mne, mnd, med)·M0 (Aki & Richards box 4.4).
    Batched over the leading shape of the angles → (..., 6)."""
    phi, delta, lam = (torch.deg2rad(a) for a in _f32s(strike, dip, rake))
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
    m = torch.as_tensor(moment, dtype=torch.float32, device=phi.device)
    return m[..., None] * torch.stack([mnn, mee, mdd, mne, mnd, med], dim=-1)


def tensile_m6(strike, dip, potency, lam=33e9, mu=33e9) -> torch.Tensor:
    """Moment tensor of a tensile crack opening normal to a plane with
    the given strike/dip [deg]: M = potency·(λ·I + 2µ·n nᵀ), NED basis,
    ``potency`` = area × opening [m³]; ``lam`` and ``mu`` numbers or
    tensors of the angles' shape (moduli at each patch's depth).  Batched
    like :func:`sdr_to_m6` → (..., 6)."""
    phi, delta, pot, lam, mu = _f32s(strike, dip, potency, lam, mu)
    phi, delta = torch.deg2rad(phi), torch.deg2rad(delta)
    # fault normal (hanging-wall side, pointing up) in NED (Aki & Richards)
    n_vec = torch.stack([-torch.sin(delta) * torch.sin(phi),
                         torch.sin(delta) * torch.cos(phi),
                         -torch.cos(delta)], dim=-1)
    nn = n_vec[..., :, None] * n_vec[..., None, :]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    m = pot[..., None, None] * (lam[..., None, None] * eye + 2.0 * mu[..., None, None] * nn)
    return matrix_to_m6(m)


def m6_to_matrix(m6: torch.Tensor) -> torch.Tensor:
    """(..., 6) (mnn, mee, mdd, mne, mnd, med) → (..., 3, 3) symmetric, NED."""
    mnn, mee, mdd, mne, mnd, med = m6.unbind(-1)
    return torch.stack([torch.stack([mnn, mne, mnd], dim=-1),
                        torch.stack([mne, mee, med], dim=-1),
                        torch.stack([mnd, med, mdd], dim=-1)], dim=-2)


def matrix_to_m6(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 6)."""
    return torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2],
                        m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]], dim=-1)


# --- Tape & Tape 2015 lune parameterization --------------------------------

_N_BETA = 1000
_BETA_TABLE = np.linspace(0.0, np.pi, _N_BETA)
_U_TABLE = (0.75 * _BETA_TABLE
            - 0.5 * np.sin(2.0 * _BETA_TABLE)
            + 0.0625 * np.sin(4.0 * _BETA_TABLE))

_LAMBDA_FACTOR = np.array(
    [[SQRT3, -1.0, SQRT2], [0.0, 2.0, SQRT2], [-SQRT3, -1.0, SQRT2]])


def v_to_gamma(v) -> torch.Tensor:
    """Lune longitude γ from v: v = (1/3)·sin(3γ)."""
    return torch.asin(3.0 * _f32(v)) / 3.0


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (constant beyond the ends), differentiable in x."""
    i = torch.clamp(torch.searchsorted(xp, x.detach().contiguous(), right=True), 1,
                    xp.numel() - 1)
    dx = xp[i] - xp[i - 1]
    # flat table steps (u'(β) = 0 at both ends) take the left value
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + ((x - xp[i - 1]) / torch.where(dx0, 1.0, dx)) * (fp[i] - fp[i - 1]))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def w_to_beta(w) -> torch.Tensor:
    """Lune colatitude β from w = (3π/8) − u, u(β) = ¾β − ½sin2β +
    (1/16)sin4β, inverted by interpolation in a float32 table of u(β)
    (the JAX package's table)."""
    w = _f32(w)
    u = 3.0 / 8.0 * math.pi - w
    return _interp(u, _f32(_U_TABLE).to(w.device), _f32(_BETA_TABLE).to(w.device))


def mtqt_to_m6(w, v, kappa, sigma, h, magnitude) -> torch.Tensor:
    """(w, v, κ, σ, h, Mw) → (..., 6) NED moment tensors.  Orientation
    math in NWU, then rotated to NED by Rx(π), as the JAX package does."""
    w, v, kappa, sigma, h, magnitude = _f32s(w, v, kappa, sigma, h, magnitude)
    rho = magnitude_to_moment(magnitude) * SQRT2
    beta = w_to_beta(w)
    gamma = v_to_gamma(v)
    theta = torch.acos(h)
    sb, cb = torch.sin(beta), torch.cos(beta)
    sg, cg = torch.sin(gamma), torch.cos(gamma)
    vec = torch.stack([sb * cg, sb * sg, cb], dim=-1)                  # (..., 3)
    lam = (1.0 / SQRT6) * (vec @ _f32(_LAMBDA_FACTOR).to(vec.device).T) * rho[..., None]
    rot_u = rot_z(-kappa) @ rot_x(theta) @ rot_z(sigma) @ rot_y(
        torch.full_like(kappa, -PI4))
    # rot_u is a rotation: its inverse is its transpose
    m_nwu = (rot_u * lam[..., None, :]) @ rot_u.transpose(-1, -2)
    rx = rot_x(torch.full_like(kappa, math.pi))
    return matrix_to_m6(rx @ m_nwu @ rx.transpose(-1, -2))


@dataclass
class BaseSource:
    """Common location/time parameters of all sources."""

    east_shift: float = 0.0   # [m]
    north_shift: float = 0.0  # [m]
    depth: float = 1000.0     # [m]
    time: float = 0.0         # [s] relative to event reference
    duration: float = 1.0     # [s] source-time-function duration

    parameter_names = ("east_shift", "north_shift", "depth", "time")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["type"] = type(self).__name__
        return d


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
    def dipvector(self) -> np.ndarray:
        """Unit vector down-dip (ENU, z negative down)."""
        st, di = np.deg2rad(self.strike), np.deg2rad(self.dip)
        return np.array([np.cos(di) * np.cos(st), -np.cos(di) * np.sin(st), -np.sin(di)])

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

    @property
    def bottom_depth(self) -> float:
        return self.depth + self.width * np.sin(np.deg2rad(self.dip))

    def center(self) -> np.ndarray:
        """(E, N, Z) of the plane center [m]."""
        st, di = np.deg2rad(self.strike), np.deg2rad(self.dip)
        d_vec_h = np.array([np.cos(st), -np.sin(st)])
        half_w = 0.5 * self.width
        return np.array([
            self.east_shift + half_w * np.cos(di) * d_vec_h[0],
            self.north_shift + half_w * np.cos(di) * d_vec_h[1],
            self.depth + half_w * np.sin(di)])


@dataclass
class MTQTSource(BaseSource):
    """Tape & Tape 2015 lune-parameterised moment tensor."""

    w: float = 0.0
    v: float = 0.0
    kappa: float = 0.0
    sigma: float = 0.0
    h: float = 0.5
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "w", "v", "kappa", "sigma", "h", "magnitude")


@dataclass
class DCSource(BaseSource):
    """Double couple (strike/dip/rake/magnitude)."""

    strike: float = 0.0
    dip: float = 90.0
    rake: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike", "dip", "rake", "magnitude")


@dataclass
class ExplosionSource(BaseSource):
    """Isotropic source (volume change, or magnitude when set)."""

    volume_change: float = 1e6  # [m^3]
    magnitude: float | None = None

    parameter_names = ("east_shift", "north_shift", "depth", "time", "volume_change")


@dataclass
class CLVDSource(BaseSource):
    """Compensated linear vector dipole, symmetry axis from azimuth/dip."""

    azimuth: float = 0.0   # [deg]
    dip: float = 90.0      # [deg]
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "azimuth", "dip", "magnitude")


@dataclass
class DoubleDCSource(BaseSource):
    """Two double couples separated in space and time; ``mix`` splits the
    moment (pyrocko's DoubleDCSource)."""

    strike1: float = 0.0
    dip1: float = 90.0
    rake1: float = 0.0
    strike2: float = 0.0
    dip2: float = 90.0
    rake2: float = 0.0
    mix: float = 0.5
    delta_time: float = 0.0
    delta_depth: float = 0.0
    distance: float = 0.0
    azimuth: float = 0.0
    magnitude: float = 6.0

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike1", "dip1", "rake1", "strike2", "dip2", "rake2",
                       "mix", "delta_time", "delta_depth", "distance",
                       "azimuth", "magnitude")


@dataclass
class RingfaultSource(BaseSource):
    """Ring fault (caldera collapse): ``npointsources`` double couples on
    a circle of ``diameter``, each tangent to the ring with vertical slip
    whose direction ``sign`` sets (+1: inner block down); the ring plane
    is tilted by ``dip`` about the horizontal axis at azimuth ``strike``."""

    strike: float = 0.0       # [deg]
    dip: float = 0.0          # [deg]
    diameter: float = 1000.0  # [m]
    sign: float = 1.0
    magnitude: float = 6.0
    npointsources: int = 8    # discretization (not sampled)

    parameter_names = ("east_shift", "north_shift", "depth", "time",
                       "strike", "dip", "diameter", "sign", "magnitude")

    def sub_sources(self, get) -> tuple:
        """The point double couples of the ring for (C,) parameters from
        ``get`` (name → tensor): ``(m6s (C, n, 6) NED, de, dn, dz (C, n))``,
        offsets relative to (east_shift, north_shift, depth)."""
        n = int(self.npointsources)
        m0_each = magnitude_to_moment(get("magnitude")) / n           # (C,)
        r = get("diameter") / 2.0
        dev = r.device
        phis = torch.arange(n, dtype=torch.float32, device=dev) * (2.0 * math.pi / n)
        # ring-plane tilt: Rodrigues rotation about the horizontal axis at
        # azimuth `strike` (NED), by `dip`
        s = torch.deg2rad(get("strike"))
        di = torch.deg2rad(get("dip"))
        ax, ay = torch.cos(s), torch.sin(s)
        zero = torch.zeros_like(ax)
        K = torch.stack([torch.stack([zero, zero, ay], -1), torch.stack([zero, zero, -ax], -1),
                         torch.stack([-ay, ax, zero], -1)], dim=-2)       # (C, 3, 3)
        R = (torch.eye(3, device=dev) + torch.sin(di)[:, None, None] * K
             + (1.0 - torch.cos(di))[:, None, None] * (K @ K))
        p = torch.stack([r[:, None] * torch.cos(phis), r[:, None] * torch.sin(phis),
                         torch.zeros_like(r)[:, None].expand(-1, n)], dim=-1)   # (C, n, 3)
        p = p @ R.transpose(-1, -2)                                     # R @ p, NED
        # tangent vertical fault: strike along the tangent, slip vertical;
        # sign=+1 -> inner block down
        m = m6_to_matrix(sdr_to_m6(torch.rad2deg(phis) + 90.0, 90.0,
                                   -90.0 * get("sign")[:, None], m0_each[:, None])).to(R.dtype)
        m = R[:, None] @ m @ R[:, None].transpose(-1, -2)
        return matrix_to_m6(m), p[..., 1], p[..., 0], p[..., 2]


source_catalog = {
    "RectangularSource": RectangularSource,
    "MTSource": MTSource,
    "MTQTSource": MTQTSource,
    "DCSource": DCSource,
    "ExplosionSource": ExplosionSource,
    "CLVDSource": CLVDSource,
    "DoubleDCSource": DoubleDCSource,
    "RingfaultSource": RingfaultSource,
}


def _stf_args(t, duration) -> tuple:
    t = torch.as_tensor(t)
    d = torch.clamp(torch.as_tensor(duration, dtype=t.dtype, device=t.device), min=1e-6)
    return t, d, torch.zeros((), dtype=t.dtype, device=t.device)


def boxcar_stf(t, duration) -> torch.Tensor:
    """The boxcar source-time function of unit area, ``1 / d`` on
    [0, d], 0 elsewhere; ``t`` and ``duration`` broadcast (d floored at
    1e-6 s, as for every STF here)."""
    t, d, zero = _stf_args(t, duration)
    return torch.where((t >= 0) & (t <= d), 1.0 / d, zero)


def triangular_stf(t, duration, peak_ratio: float = 0.5) -> torch.Tensor:
    """The triangular source-time function of unit area, rising to its
    peak at ``peak_ratio · d`` and falling to 0 at ``d``."""
    t, d, zero = _stf_args(t, duration)
    tp = peak_ratio * d
    up = torch.where((t >= 0) & (t < tp), t / torch.clamp(tp, min=1e-6), zero)
    down = torch.where((t >= tp) & (t <= d), (d - t) / torch.clamp(d - tp, min=1e-6), zero)
    return (up + down) * 2.0 / d


def half_sinusoid_stf(t, duration) -> torch.Tensor:
    """The half-sinusoid source-time function of unit area,
    ``sin(π t / d) · π / (2 d)`` on [0, d], 0 elsewhere."""
    t, d, zero = _stf_args(t, duration)
    return torch.where((t >= 0) & (t <= d), torch.sin(math.pi * t / d) * math.pi / (2.0 * d),
                       zero)


#: the source-time functions by name (``beat_tpu/sources.py:543-547``)
stf_catalog = {
    "Boxcar": boxcar_stf,
    "Triangular": triangular_stf,
    "HalfSinusoid": half_sinusoid_stf,
}


def rectangular_patch_grid(strike, dip, length, width, east_shift, north_shift, depth,
                           n_length: int, n_width: int, anchor: str = "top") -> tuple:
    """Patch centers of rectangles with (...) parameters: ``(east, north,
    depth, along, down)``, each (..., n_length·n_width) in strike-fastest
    order.  The given position is the plane's 'top' (top-center),
    'center' or 'bottom' point; ``along`` is measured from the plane
    center along strike, ``down`` from the top edge down dip [m]."""
    try:
        anchor_frac = {"top": 0.0, "center": 0.5, "bottom": 1.0}[anchor]
    except KeyError:
        raise ValueError(f"Unknown anchor {anchor!r} (top|center|bottom)") from None
    strike, dip, length, width, east_shift, north_shift, depth = _f32s(
        strike, dip, length, width, east_shift, north_shift, depth)
    dev = strike.device
    st = torch.deg2rad(strike)[..., None]
    di = torch.deg2rad(dip)[..., None]
    along = (torch.arange(n_length, dtype=torch.float32, device=dev) + 0.5) / n_length - 0.5
    down = (torch.arange(n_width, dtype=torch.float32, device=dev) + 0.5) / n_width
    along = along[None, :].expand(n_width, n_length).reshape(-1) * length[..., None]
    down = down[:, None].expand(n_width, n_length).reshape(-1) * width[..., None]
    down_rel = down - anchor_frac * width[..., None]
    east = east_shift[..., None] + torch.sin(st) * along + torch.cos(di) * torch.cos(st) * down_rel
    north = (north_shift[..., None] + torch.cos(st) * along
             - torch.cos(di) * torch.sin(st) * down_rel)
    depth_p = depth[..., None] + torch.sin(di) * down_rel
    return east, north, depth_p, along, down
