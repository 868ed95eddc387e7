"""
Closed-form elastodynamic reference solutions — external ground truth
(copy of ``beat_tpu/heart/analytic.py``).

The port's wavefield machinery (:mod:`beat_tpu_torch.heart.layered_waveforms`,
the qseis-analogue DWN solver, and :mod:`beat_tpu_torch.heart.store_convert`)
must be validated against solutions that share **none** of its code or
method.  This module implements textbook results straight from the
literature:

* :func:`fullspace_mt_displacement` — the exact displacement field of a
  point moment tensor in a homogeneous unbounded medium, Aki & Richards
  (2002) eq. 4.29: near-field (r⁻⁴ with the ∫τM(t−τ)dτ ramp between the
  P and S arrivals), intermediate-field (r⁻²) and far-field (r⁻¹) terms
  for both wave types.  The reference's waveform physics ultimately rests
  on qseis/qssp (``beat/heart.py:2126-2330``); this is the analytic
  anchor those codes are themselves tested against.
* :func:`fullspace_mt_static` — the t→∞ limit for a step moment, which
  must (and does, see tests) agree with an independent Kelvin point-force
  dipole construction.
* :func:`rayleigh_velocity` — the root of the Rayleigh secular equation
  for a homogeneous half-space.
* :func:`love_dispersion` — fundamental-mode Love phase/group velocity
  for a single layer over a half-space (classic SH dispersion relation,
  e.g. A&R eq. 7.6).

Everything here is plain float64 numpy on host: these are test-time and
setup-time oracles, not sampler-path code.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erf

__all__ = [
    "m6_to_matrix",
    "fullspace_mt_displacement",
    "fullspace_mt_static",
    "smoothed_step",
    "gaussian_pulse",
    "rayleigh_velocity",
    "love_dispersion",
]


def m6_to_matrix(m6) -> np.ndarray:
    """(mnn, mee, mdd, mne, mnd, med) → symmetric 3×3 NED matrix
    (the repo-wide elementary-MT ordering, ``gftable.ELEMENTARY_M6``)."""
    mnn, mee, mdd, mne, mnd, med = (float(v) for v in m6)
    return np.array([[mnn, mne, mnd],
                     [mne, mee, med],
                     [mnd, med, mdd]])


class smoothed_step:
    """Moment history M(t) = 0.5·(1 + erf(t/τ₀)): an analytically smooth
    step with Gaussian rate, band-limited to ~1/(πτ₀) Hz — sampleable on
    any grid with dt ≲ τ₀ without aliasing."""

    def __init__(self, tau0: float):
        self.tau0 = float(tau0)

    def m(self, t):
        return 0.5 * (1.0 + erf(np.asarray(t, dtype=np.float64) / self.tau0))

    def mdot(self, t):
        t = np.asarray(t, dtype=np.float64)
        return np.exp(-((t / self.tau0) ** 2)) / (self.tau0 * np.sqrt(np.pi))


class gaussian_pulse:
    """Moment history M(t) = exp(−((t−t_c)/τ)²): returns to zero, so
    traces are effectively periodic in any window that contains the
    pulse — the right probe for Fourier-resampling paths."""

    def __init__(self, tau: float, tc: float):
        self.tau, self.tc = float(tau), float(tc)

    def m(self, t):
        t = np.asarray(t, dtype=np.float64)
        return np.exp(-(((t - self.tc) / self.tau) ** 2))

    def mdot(self, t):
        t = np.asarray(t, dtype=np.float64)
        return (-2.0 * (t - self.tc) / self.tau**2
                * np.exp(-(((t - self.tc) / self.tau) ** 2)))


def _radiation_tensors(gamma: np.ndarray, M: np.ndarray):
    """Contract the A&R 4.29 radiation tensors with a symmetric M:
    returns the five coefficient vectors (3,) — A^N, A^IP, A^IS, A^FP,
    A^FS — such that u = Σ A·(time factor)/(4πρ·powers)."""
    g = gamma
    gMg = g @ M @ g
    Mg = M @ g
    trM = np.trace(M)
    # A^N_npq M_pq = (15 γnγpγq − 3γnδpq − 3γpδnq − 3γqδnp) M_pq
    AN = 15.0 * g * gMg - 3.0 * g * trM - 6.0 * Mg
    # A^IP_npq M_pq = (6 γnγpγq − γnδpq − γpδnq − γqδnp) M_pq
    AIP = 6.0 * g * gMg - g * trM - 2.0 * Mg
    # A^IS_npq M_pq = −(6 γnγpγq − γnδpq − γpδnq − 2γqδnp) M_pq
    AIS = -(6.0 * g * gMg - g * trM - 3.0 * Mg)
    # A^FP_npq M_pq = γnγpγq M_pq
    AFP = g * gMg
    # A^FS_npq M_pq = −(γnγp − δnp) γq M_pq
    AFS = -(g * gMg - Mg)
    return AN, AIP, AIS, AFP, AFS


def fullspace_mt_displacement(m6, obs, src, t, vp, vs, rho,
                              stf=None, n_quad: int = 256) -> np.ndarray:
    """
    Exact displacement (nt, 3) in NED at ``obs`` from a point moment
    tensor at ``src`` in a homogeneous unbounded medium — Aki & Richards
    (2002) eq. 4.29.

    m6 : (6,) NED moment tensor (mnn, mee, mdd, mne, mnd, med) [Nm]
    obs, src : (3,) NED coordinates [m] (D positive down)
    t : (nt,) times after origin [s]
    stf : moment history object with ``m(t)``/``mdot(t)`` (default: a
        :class:`smoothed_step` with τ₀ = 4 samples of the t grid)
    n_quad : Gauss-Legendre nodes for the near-field ∫_{r/α}^{r/β} τM(t−τ)dτ
        (the integrand is smooth — 256 nodes reach ~1e-12)
    """
    obs = np.asarray(obs, dtype=np.float64)
    src = np.asarray(src, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    M = m6_to_matrix(m6)
    dx = obs - src
    r = float(np.linalg.norm(dx))
    if r <= 0:
        raise ValueError("observer coincides with the source")
    gamma = dx / r
    if stf is None:
        dt = float(np.min(np.diff(t))) if t.size > 1 else 1.0
        stf = smoothed_step(4.0 * dt)

    AN, AIP, AIS, AFP, AFS = _radiation_tensors(gamma, M)
    ta, tb = r / vp, r / vs

    # near-field ramp: Gauss-Legendre over τ ∈ [r/α, r/β]
    xg, wg = np.polynomial.legendre.leggauss(n_quad)
    tau = 0.5 * (tb - ta) * xg + 0.5 * (tb + ta)           # (nq,)
    wq = 0.5 * (tb - ta) * wg
    ramp = np.einsum("q,nq->n", tau * wq, stf.m(t[:, None] - tau[None, :]))

    c = 1.0 / (4.0 * np.pi * rho)
    u = (c / r**4) * np.outer(ramp, AN)
    u += (c / (vp**2 * r**2)) * np.outer(stf.m(t - ta), AIP)
    u += (c / (vs**2 * r**2)) * np.outer(stf.m(t - tb), AIS)
    u += (c / (vp**3 * r)) * np.outer(stf.mdot(t - ta), AFP)
    u += (c / (vs**3 * r)) * np.outer(stf.mdot(t - tb), AFS)
    return u


def fullspace_mt_static(m6, obs, src, vp, vs, rho) -> np.ndarray:
    """t→∞ displacement (3,) in NED of a step moment M·H(t) — the
    closed-form static limit of :func:`fullspace_mt_displacement`
    (∫τdτ ramp → r²(β⁻²−α⁻²)/2, far-field terms → 0)."""
    obs = np.asarray(obs, dtype=np.float64)
    src = np.asarray(src, dtype=np.float64)
    M = m6_to_matrix(m6)
    dx = obs - src
    r = float(np.linalg.norm(dx))
    gamma = dx / r
    AN, AIP, AIS, _, _ = _radiation_tensors(gamma, M)
    c = 1.0 / (4.0 * np.pi * rho)
    return (c / r**2) * (0.5 * (vs**-2 - vp**-2) * AN
                         + AIP / vp**2 + AIS / vs**2)


def rayleigh_velocity(vp: float, vs: float) -> float:
    """Rayleigh-wave speed of a homogeneous half-space: the root
    c ∈ (0, β) of R(c) = (2 − c²/β²)² − 4√(1 − c²/α²)√(1 − c²/β²)
    (the classic secular equation; ≈ 0.9194 β for a Poisson solid)."""
    from scipy.optimize import brentq

    def R(c):
        return ((2.0 - (c / vs) ** 2) ** 2
                - 4.0 * np.sqrt(1.0 - (c / vp) ** 2)
                * np.sqrt(1.0 - (c / vs) ** 2))

    return float(brentq(R, 1e-3 * vs, vs * (1.0 - 1e-9)))


def love_dispersion(freqs, h: float, v1: float, v2: float,
                    rho1: float, rho2: float, mode: int = 0):
    """
    Fundamental (or ``mode``-th) Love-wave phase **and group** velocity
    for a layer (thickness ``h``, shear speed ``v1``, density ``rho1``)
    over a half-space (``v2 > v1``, ``rho2``) — the classic SH
    dispersion relation (A&R eq. 7.6)

        tan(ω h s₁) = µ₂ s₂ / (µ₁ s₁),
        s₁ = √(v₁⁻² − c⁻²),  s₂ = √(c⁻² − v₂⁻²).

    Solved per frequency in the branch-unambiguous form
    ω h s₁ − atan(µ₂s₂/(µ₁s₁)) − mode·π = 0.  Returns (c, U) arrays
    [m/s] with NaN below the mode's cut-off; group velocity
    U = dω/dk from the implicit derivative along the root curve.
    """
    from scipy.optimize import brentq

    mu1, mu2 = rho1 * v1**2, rho2 * v2**2
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))

    def root_k(w):
        # solve for slowness-like variable c in (v1, v2)
        def f(c):
            s1 = np.sqrt(1.0 / v1**2 - 1.0 / c**2)
            s2 = np.sqrt(1.0 / c**2 - 1.0 / v2**2)
            return w * h * s1 - np.arctan2(mu2 * s2, mu1 * s1) - mode * np.pi

        lo, hi = v1 * (1 + 1e-12), v2 * (1 - 1e-12)
        if f(hi) < 0:          # below cut-off: no trapped mode
            return np.nan
        return brentq(f, lo, hi, xtol=1e-10 * v1)

    c = np.array([root_k(2 * np.pi * f) for f in freqs])
    # group velocity from dω/dk along the (ω, k) root curve: central
    # differences of ω(k) with k = ω/c at slightly perturbed frequencies
    U = np.full_like(c, np.nan)
    for i, f in enumerate(freqs):
        if not np.isfinite(c[i]):
            continue
        df = 1e-4 * f
        cp, cm = root_k(2 * np.pi * (f + df)), root_k(2 * np.pi * (f - df))
        if not (np.isfinite(cp) and np.isfinite(cm)):
            continue
        kp = 2 * np.pi * (f + df) / cp
        km = 2 * np.pi * (f - df) / cm
        U[i] = 2 * np.pi * (2 * df) / (kp - km)
    return c, U
