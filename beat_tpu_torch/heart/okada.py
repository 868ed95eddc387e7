"""
Rectangular-dislocation (Okada 1985), Mogi and moment-tensor surface
displacements in an elastic halfspace (port of ``beat_tpu/heart/okada.py``).

Batched: every source parameter is a tensor of one common leading shape
``B`` (chains on the geometry path, patches in the library build; numbers
broadcast), the observation points ``coords`` are (N, 2) east/north [m],
and each forward returns (*B, N, 3) displacements (east, north, up).
The functions follow the dtype of their inputs (float32 where every
input is float32); the port's callers evaluate them in
:data:`FORWARD_DTYPE`.

Conventions are the JAX package's: ``_okada_finite`` works in Okada's
frame (origin at the down-dip edge at depth ``d``, ``0 ≤ ξ ≤ L`` along
strike, ``0 ≤ η ≤ W`` up dip); :func:`okada_surface_displacement` takes
the anchor's east/north/depth ('top' = top-center, as ``RectangularSource``),
strike clockwise from north, dip, rake [deg], length, width, slip and
opening [m].

Two things differ from the JAX source in how, not in what, is computed:

* the four Chinnery corners of the finite source are one stacked axis
  of size 4, each corner evaluated once for all three components (the
  JAX source evaluates each corner three times and keeps one component
  each; XLA merges the repeats, eager torch would not);
* every guard of a division, a logarithm, a square root or an arctangent
  guards its *input* (the double-``where`` pattern): ``torch.where``
  passes the gradient of the branch it does not select as 0 times that
  branch's local derivative, so an infinite derivative there would turn
  the gradient into NaN on the fault's top-edge extension (R + η = 0),
  at dip 90° (cos δ = 0) and where q = 0.
"""

from __future__ import annotations

import math

import torch

#: Poisson ratio ν of a Poisson solid (λ = µ)
POISSON_DEFAULT = 0.25

#: the dtype in which the port evaluates these forwards: the geodetic
#: geometry composite, the static library build, the homogeneous static
#: table and the resolution discretization cast their inputs to it and
#: nothing else chooses.  float64: the Chinnery sum is a double difference
#: of nearly equal corner terms, and in float32 the rectangle loses up to
#: 2.4e-4 · max|u| near the fault and the 9-crack moment-tensor expansion
#: about 5e-3 · max|u| at 2 km depth (the JAX package's float32 forwards
#: as much, ``tests/test_torch_okada.py``).  On an H100 float32 halves the
#: forwards' time and memory, but the moment-tensor families then miss
#: their llk bar by up to 9× and the static library its column bar by 3.6×
#: (``chip_smoke.py`` [geo_llk] and [static_ffi_build] read both).
FORWARD_DTYPE = torch.float64

_EPS = 1e-10

#: the corners of Okada's eq. 24, f(x, p) − f(x, p−W) − f(x−L, p) + f(x−L, p−W):
#: (subtract L from ξ, subtract W from η, sign)
_CORNERS = ((0.0, 0.0, 1.0), (0.0, 1.0, -1.0), (1.0, 0.0, -1.0), (1.0, 1.0, 1.0))

#: the 9 fixed crack normals of the moment-tensor expansion (the 3 axes and
#: the 6 axis bisectors), as (strike, dip) of their planes [deg]
_CRACK_STRIKES = (-90.0, 0.0, 0.0, -45.0, -135.0, 90.0, -90.0, 180.0, 0.0)
_CRACK_DIPS = (90.0, 90.0, 0.0, 90.0, 90.0, 45.0, 45.0, 45.0, 45.0)


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _safe_den(den: torch.Tensor) -> torch.Tensor:
    """``den`` kept at least ``_EPS`` away from 0, its sign kept."""
    small = den.abs() < _EPS
    return torch.where(small, torch.where(den >= 0, _EPS, -_EPS).to(den.dtype), den)


def _safe_div(num, den):
    return num / _safe_den(den)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(x) for x ≥ 0, with a finite derivative at 0 (where it is 0)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def _safe_log(x: torch.Tensor) -> torch.Tensor:
    """log(max(x, _EPS)), the clamp taken before the log."""
    return torch.log(torch.clamp(x, min=_EPS))


def _okada_corner(xi, eta, q, sd, cd, a, tensile_only: bool = False) -> tuple:
    """Okada (1985) eqs. 25-30: the corner terms f(ξ, η) of the surface
    displacement of a unit strike-slip, dip-slip and tensile dislocation.
    Returns ``((ux, uy, uz) strike, (ux, uy, uz) dip, (ux, uy, uz) tensile)``,
    or the tensile triple alone when ``tensile_only``.  ``a`` = µ/(λ+µ)."""
    R = _safe_sqrt(xi * xi + eta * eta + q * q)
    ytilde = eta * cd + q * sd
    dtilde = eta * sd - q * cd
    X = _safe_sqrt(xi * xi + q * q)
    R_eta = R + eta
    R_xi = R + xi
    R_d = R + dtilde

    # ln(R+η) diverges where R+η → 0 (behind the fault's edge): Okada's
    # prescription replaces it by −ln(R−η)
    eta_edge = R_eta.abs() < _EPS
    ln_R_eta = torch.where(eta_edge, -_safe_log(R - eta), _safe_log(R_eta))
    ln_R_d = _safe_log(R_d)
    inv_R_eta = torch.where(eta_edge, torch.zeros_like(R), 1.0 / _safe_den(R_eta))
    inv_R_xi = torch.where(R_xi.abs() < _EPS, torch.zeros_like(R), 1.0 / _safe_den(R_xi))

    # θ = atan(ξη / qR), 0 where q = 0 (Okada's convention)
    theta = torch.where(q.abs() < _EPS, torch.zeros_like(R),
                        torch.atan(_safe_div(xi * eta, q * R)))

    # the I-terms (eqs. 28-29), with their cos δ → 0 limits (eq. 29')
    cd_zero = cd.abs() < 1e-6
    cd_s = torch.where(cd_zero, torch.ones_like(cd), cd)
    tan_d = torch.where(cd_zero, torch.zeros_like(cd), sd / cd_s)

    I5_gen = a * 2.0 / cd_s * torch.atan(
        _safe_div(eta * (X + q * cd) + X * (R + X) * sd, xi * (R + X) * cd))
    I5_gen = torch.where(xi.abs() < _EPS, torch.zeros_like(I5_gen), I5_gen)
    I5 = torch.where(cd_zero, -a * _safe_div(xi * sd, R_d), I5_gen)
    I4 = torch.where(cd_zero, -a * _safe_div(q, R_d), a * (ln_R_d - sd * ln_R_eta) / cd_s)
    I3 = torch.where(cd_zero,
                     a / 2.0 * (_safe_div(eta, R_d) + _safe_div(ytilde * q, R_d * R_d)
                                - ln_R_eta),
                     a * (_safe_div(ytilde, cd_s * R_d) - ln_R_eta) + tan_d * I4)
    I1 = torch.where(cd_zero, -a / 2.0 * _safe_div(xi * q, R_d * R_d),
                     a * (-_safe_div(xi, cd_s * R_d)) - tan_d * I5)

    qR = _safe_div(q, R)
    xqR_eta = _safe_div(xi * q, R) * inv_R_eta
    tensile = (q * qR * inv_R_eta - I3 * sd * sd,
               -dtilde * qR * inv_R_xi - sd * (xqR_eta - theta) - I1 * sd * sd,
               ytilde * qR * inv_R_xi + cd * (xqR_eta - theta) - I5 * sd * sd)
    if tensile_only:
        return tensile
    I2 = a * (-ln_R_eta) - I3
    strike = (torch.where(eta_edge, torch.zeros_like(R), _safe_div(xi * q, R * R_eta))
              + theta + I1 * sd,
              ytilde * qR * inv_R_eta + q * cd * inv_R_eta + I2 * sd,
              dtilde * qR * inv_R_eta + q * sd * inv_R_eta + I4 * sd)
    dip = (qR - I3 * sd * cd,
           ytilde * qR * inv_R_xi + cd * theta - I1 * sd * cd,
           dtilde * qR * inv_R_xi + sd * theta - I5 * sd * cd)
    return strike, dip, tensile


def _okada_finite(x, y, d, dip, L, W, U1, U2, U3, a) -> tuple:
    """(ux, uy, uz) in Okada's frame of finite rectangles (eq. 24):
    x, y (..., N) observation coordinates; d, dip [rad], L, W and the
    dislocations U1/U2/U3 (strike, dip, tensile) of shape (..., 1); U1
    and U2 ``None`` for a purely tensile source.  a = µ/(λ+µ)."""
    sd, cd = torch.sin(dip), torch.cos(dip)
    p = y * cd + d * sd
    q = y * sd - d * cd
    # one stacked corner axis (-2): each corner evaluated once
    k_l = _as([c[0] for c in _CORNERS], x)[:, None]
    k_w = _as([c[1] for c in _CORNERS], x)[:, None]
    sign = _as([c[2] for c in _CORNERS], x)[:, None]
    xi = x[..., None, :] - k_l * L[..., None]
    eta = p[..., None, :] - k_w * W[..., None]
    terms = _okada_corner(xi, eta, q[..., None, :], sd[..., None], cd[..., None], a,
                          tensile_only=U1 is None)

    def chinnery(t):
        return torch.sum(sign * t, dim=-2)

    # eqs. 25/26 carry −U/(2π); the tensile eq. 27 carries +U3/(2π)
    if U1 is None:
        ux, uy, uz = (U3 / (2 * math.pi) * chinnery(t) for t in terms)
        return ux, uy, uz
    U = (-U1, -U2, U3)
    out = [0.0, 0.0, 0.0]
    for Ui, triple in zip(U, terms):
        for c in range(3):
            out[c] = out[c] + Ui / (2 * math.pi) * chinnery(triple[c])
    return tuple(out)


def _broadcast(*xs) -> tuple:
    """Source parameters as tensors of one shape and dtype (the floating
    dtype among the tensors, float32 if none), numbers placed on the
    tensors' device."""
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else None
    dtype = torch.float32
    for t in tensors:
        if t.is_floating_point():
            dtype = torch.promote_types(dtype, t.dtype)
    return torch.broadcast_tensors(*(torch.as_tensor(x, dtype=dtype, device=dev) for x in xs))


def okada_surface_displacement(coords, east_shift=0.0, north_shift=0.0, depth=1.0,
                               strike=0.0, dip=90.0, rake=0.0, length=1.0, width=1.0,
                               slip=0.0, opening=0.0, nu=POISSON_DEFAULT,
                               anchor: str = "top", tensile_only: bool = False):
    """Surface displacements of rectangular dislocations: parameters of
    one shape (*B) (numbers broadcast), ``coords`` (N, 2) → (*B, N, 3)
    (east, north, up) [m].  ``anchor``: 'top' (top-center), 'center' or
    'bottom'.  ``tensile_only`` skips the shear terms (exact when
    ``slip`` is 0: they enter multiplied by it)."""
    (east_shift, north_shift, depth, strike, dip, rake, length, width, slip,
     opening) = _broadcast(east_shift, north_shift, depth, strike, dip, rake, length, width,
                           slip, opening)
    coords = torch.as_tensor(coords, dtype=depth.dtype, device=depth.device)
    phi, delta = torch.deg2rad(strike), torch.deg2rad(dip)
    a = 1.0 - 2.0 * nu
    sd, cd = torch.sin(delta), torch.cos(delta)
    frac = {"top": 1.0, "center": 0.5, "bottom": 0.0}.get(anchor)
    if frac is None:
        raise ValueError(f"Unknown anchor '{anchor}'")
    # anchor -> depth of the down-dip edge (Okada's origin) and its
    # horizontal offset up dip
    d_origin = depth + frac * width * sd
    y_off = frac * width * cd

    # strike unit vector s and horizontal down-dip t (= strike + 90°);
    # Okada's frame dips toward −y, so t maps to −y and x to s
    s_e, s_n = torch.sin(phi)[..., None], torch.cos(phi)[..., None]
    t_e, t_n = torch.cos(phi)[..., None], -torch.sin(phi)[..., None]
    rel_e = coords[:, 0] - east_shift[..., None]
    rel_n = coords[:, 1] - north_shift[..., None]
    x = rel_e * s_e + rel_n * s_n + 0.5 * length[..., None]
    y = -(rel_e * t_e + rel_n * t_n) + y_off[..., None]

    col = [v[..., None] for v in (d_origin, delta, length, width)]
    if tensile_only:
        U1 = U2 = None
    else:
        rake_r = torch.deg2rad(rake)
        U1, U2 = (slip * torch.cos(rake_r))[..., None], (slip * torch.sin(rake_r))[..., None]
    ux, uy, uz = _okada_finite(x, y, *col, U1, U2, opening[..., None], a)
    return torch.stack([ux * s_e - uy * t_e, ux * s_n - uy * t_n, uz], dim=-1)


def mogi_surface_displacement(coords, east_shift=0.0, north_shift=0.0, depth=3000.0,
                              volume_change=1e6, nu=POISSON_DEFAULT):
    """Mogi (1958) point pressure sources: u_h = (1−ν)ΔV/π · Δx/R³,
    u_z = (1−ν)ΔV/π · d/R³.  Parameters (*B), coords (N, 2) → (*B, N, 3)."""
    east_shift, north_shift, depth, volume_change = _broadcast(
        east_shift, north_shift, depth, volume_change)
    coords = torch.as_tensor(coords, dtype=depth.dtype, device=depth.device)
    dx = coords[:, 0] - east_shift[..., None]
    dy = coords[:, 1] - north_shift[..., None]
    dz = depth[..., None].expand_as(dx)
    R = torch.sqrt(dx * dx + dy * dy + dz * dz)
    c = ((1.0 - nu) * volume_change / math.pi)[..., None]
    inv_r3 = 1.0 / torch.clamp(R, min=1.0) ** 3
    return torch.stack([c * dx * inv_r3, c * dy * inv_r3, c * dz * inv_r3], dim=-1)


def mt_surface_displacement(coords, m6, east_shift=0.0, north_shift=0.0, depth=5000.0,
                            nu=POISSON_DEFAULT, shear_modulus=33e9, patch_frac=0.08):
    """Halfspace surface displacements of moment-tensor point sources:
    m6 (*B, 6) NED (mnn, mee, mdd, mne, mnd, med) [Nm], positions (*B),
    coords (N, 2) → (*B, N, 3).

    M is expanded on 9 fixed tensile cracks (the 3 axes and the 6 axis
    bisectors), whose potencies are a fixed linear map of m6; each crack
    is a small square Okada patch (side ``patch_frac · depth``) centred on
    the source.  The 9 cracks are one more leading axis of one Okada
    call, evaluated without the shear terms (their slip is 0).  In
    float32 the Chinnery sum over a crack a few hundred metres wide seen
    from tens of kilometres resolves the field only to about 5e-3 · max|u|
    at 2 km depth: see :data:`FORWARD_DTYPE`."""
    east_shift, north_shift, depth = _broadcast(east_shift, north_shift, depth)
    m6 = torch.as_tensor(m6, device=depth.device)
    dtype = torch.promote_types(m6.dtype, depth.dtype) if m6.is_floating_point() else depth.dtype
    m6, east_shift, north_shift, depth = (v.to(dtype)
                                          for v in (m6, east_shift, north_shift, depth))
    coords = torch.as_tensor(coords, dtype=depth.dtype, device=depth.device)
    mu = shear_modulus
    lam = 2.0 * mu * nu / (1.0 - 2.0 * nu)
    mnn, mee, mdd, mne, mnd, med = m6.unbind(-1)
    # diagonal bases B_kk = c1 (λI + 2µ n_k n_kᵀ) + c2 Σ_{j≠k} (λI + 2µ n_j n_jᵀ);
    # off-diagonal bases ±1/(2µ) potency on the two 45° bisector normals
    c1 = (lam + mu) / (mu * (3.0 * lam + 2.0 * mu))
    c2 = -lam / (2.0 * mu * (3.0 * lam + 2.0 * mu))
    qm = 1.0 / (2.0 * mu)
    potencies = torch.stack([c1 * mnn + c2 * (mee + mdd), c1 * mee + c2 * (mnn + mdd),
                             c1 * mdd + c2 * (mnn + mee), qm * mne, -qm * mne,
                             qm * mnd, -qm * mnd, qm * med, -qm * med], dim=-1)  # (*B, 9)
    size = patch_frac * depth[..., None]
    disp = okada_surface_displacement(
        coords, east_shift=east_shift[..., None], north_shift=north_shift[..., None],
        depth=depth[..., None], strike=_as(_CRACK_STRIKES, potencies),
        dip=_as(_CRACK_DIPS, potencies), length=size, width=size,
        opening=potencies / (size * size), nu=nu, anchor="center", tensile_only=True)
    return torch.sum(disp, dim=-3)
