"""
What the plain references share: the analytic Green's functions of a
homogeneous medium, tapers, the Butterworth response, source-time
functions, moment tensors, the inverse-DFT basis, the Gaussian misfit,
and the SMC stage arithmetic.

Written from the published formulas (Aki & Richards eq. 4.96 and box
4.4; Ching & Chen 2007 for the tempering), in float64 NumPy or PyTorch.
Nothing here imports the program under test.

``precision`` is ``"float64"`` for the judge and ``"tf32"`` for the
control: float32 tensors whose matrix products take their operands
rounded to TF32 (10 mantissa bits, round to nearest even) and sum in
float32, as a tensor core running TF32 does.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

LOG_2PI = math.log(2.0 * math.pi)
PRECISIONS = ("float64", "tf32")


def real_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} (one of {PRECISIONS})")
    return torch.float64 if precision == "float64" else torch.float32


def complex_dtype(precision: str) -> torch.dtype:
    return torch.complex128 if real_dtype(precision) == torch.float64 else torch.complex64


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties
    to even); infinities and NaNs pass through."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def einsum(spec: str, a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """A matrix product written as an einsum, in ``precision``: TF32
    rounds the real operands (the real and imaginary parts of complex
    ones) before the float32 product."""
    if precision == "tf32":
        def rnd(t):
            if t.is_complex():
                return torch.complex(tf32_round(t.real), tf32_round(t.imag))
            return tf32_round(t)
        a, b = rnd(a), rnd(b)
    return torch.einsum(spec, a, b)


# -- sources -------------------------------------------------------------------


def magnitude_to_moment(magnitude):
    """Scalar moment [N m] of a moment magnitude (the exponent offset 9.05)."""
    return 10.0 ** (1.5 * np.asarray(magnitude, dtype=np.float64) + 9.05)


def sdr_to_m6(strike, dip, rake, moment=1.0) -> np.ndarray:
    """Double couple → NED (mnn, mee, mdd, mne, mnd, med)·M0, float64
    (Aki & Richards box 4.4)."""
    phi, delta, lam = (np.deg2rad(np.asarray(a, dtype=np.float64)) for a in (strike, dip, rake))
    sd, cd, s2d, c2d = np.sin(delta), np.cos(delta), np.sin(2 * delta), np.cos(2 * delta)
    sl, cl = np.sin(lam), np.cos(lam)
    sp, cp, s2p, c2p = np.sin(phi), np.cos(phi), np.sin(2 * phi), np.cos(2 * phi)
    m = np.stack([-(sd * cl * s2p + s2d * sl * sp**2), sd * cl * s2p - s2d * sl * cp**2,
                  s2d * sl, sd * cl * c2p + 0.5 * s2d * sl * s2p,
                  -(cd * cl * cp + c2d * sl * sp), -(cd * cl * sp - c2d * sl * cp)], axis=-1)
    return np.asarray(moment, dtype=np.float64)[..., None] * m


def rotate_m6(m6: torch.Tensor, azimuth: torch.Tensor) -> torch.Tensor:
    """NED moment tensors (..., 6) in the frame whose north is the
    receiver azimuth [rad, clockwise from north]."""
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    mnn, mee, mdd, mne, mnd, med = m6.unbind(-1)
    return torch.stack(torch.broadcast_tensors(
        ca * ca * mnn + sa * sa * mee + 2 * ca * sa * mne,
        sa * sa * mnn + ca * ca * mee - 2 * ca * sa * mne,
        mdd,
        (ca * ca - sa * sa) * mne + ca * sa * (mee - mnn),
        ca * mnd + sa * med,
        -sa * mnd + ca * med), dim=-1)


# -- Green's functions -----------------------------------------------------------


def homogeneous_spectra(distances, depths, nt: int, dt: float, vp: float, vs: float,
                        rho: float) -> np.ndarray:
    """Far-field P + S spectra of the six elementary moment tensors in a
    homogeneous full space with the free-surface factor 2 (Aki & Richards
    eq. 4.96), receivers at the surface on azimuth 0: complex128
    (6, 3 [Z up, R, T], n_distances, n_depths, nt // 2 + 1)."""
    d, z = np.meshgrid(np.asarray(distances, dtype=np.float64),
                       np.asarray(depths, dtype=np.float64), indexing="ij")
    w = 2.0 * np.pi * np.fft.rfftfreq(nt, dt)
    r = np.sqrt(d * d + z * z)
    r1 = np.maximum(r, 1.0)
    gamma = np.stack([d, np.zeros_like(d), -z], axis=-1) / r1[..., None]   # NED ray
    out = np.zeros((6, 3) + d.shape + (w.size,), dtype=np.complex128)
    for v, shear in ((vp, False), (vs, True)):
        amp = 2.0 / (4.0 * np.pi * rho * v**3 * r1)
        phase = np.exp(-1j * w * (r / v)[..., None])
        for k in range(6):
            e = np.zeros(6)
            e[k] = 1.0
            mnn, mee, mdd, mne, mnd, med = e
            M = np.array([[mnn, mne, mnd], [mne, mee, med], [mnd, med, mdd]])
            mg = gamma @ M
            mgg = np.sum(mg * gamma, axis=-1)
            u = (mg - gamma * mgg[..., None]) if shear else gamma * mgg[..., None]
            u = u * amp[..., None]
            out[k, 0] += -u[..., 2, None] * phase
            out[k, 1] += u[..., 0, None] * phase
            out[k, 2] += u[..., 1, None] * phase
    return out


def bilinear_corners(x: torch.Tensor, grid: np.ndarray) -> tuple:
    """Lower node index and weight toward the upper node of ``x`` on a
    uniform ``grid``, clamped into the grid (the top node is exact)."""
    step = float(grid[1] - grid[0]) if grid.size > 1 else 1.0
    xi = torch.clamp((x - float(grid[0])) / step, 0.0, grid.size - 1.0)
    i0 = torch.clamp(torch.floor(xi).long(), max=max(grid.size - 2, 0))
    return i0, xi - i0


# -- tapers, filters, source-time functions --------------------------------------


def taper_window(a: float, b: float, c: float, d: float, dt: float) -> np.ndarray:
    """Cosine taper over the window [a, d): up a → b, flat, down c → d."""
    n = int(round((d - a) / dt))
    t = a + np.arange(n) * dt
    w = np.ones(n)
    up = (t >= a) & (t < b)
    w[up] = 0.5 - 0.5 * np.cos(np.pi * (t[up] - a) / max(b - a, dt))
    down = (t >= c) & (t <= d)
    w[down] = 0.5 + 0.5 * np.cos(np.pi * (t[down] - c) / max(d - c, dt))
    w[t > d] = 0.0
    return w


def butterworth_response(lower: float, upper: float, order: int, nt: int,
                         dt: float) -> np.ndarray:
    """The digital Butterworth band-pass response on the rFFT grid."""
    nyq = 0.5 / dt
    b, a = scipy.signal.butter(order, [max(lower / nyq, 1e-6), min(upper / nyq, 1.0 - 1e-6)],
                               btype="band")
    _, h = scipy.signal.freqz(b, a, worN=np.fft.rfftfreq(nt, dt) / nyq * np.pi)
    return h


def half_sinusoid_spectrum(freqs: torch.Tensor, duration: torch.Tensor) -> torch.Tensor:
    """Unit-area half-sinusoid source-time function, delayed by half its
    duration: complex (..., nf) for durations (...)."""
    d = torch.clamp(duration, min=1e-4)[..., None]
    wd = 2.0 * math.pi * freqs * d
    denom = math.pi**2 - wd**2
    pole = torch.abs(denom) < 1e-6
    mag = torch.where(pole, torch.full_like(wd, math.pi / 4.0),
                      math.pi**2 * torch.cos(wd / 2.0) / torch.where(pole, 1.0, denom))
    return torch.complex(mag * torch.cos(-wd / 2.0), mag * torch.sin(-wd / 2.0))


def irfft_window_basis(nt: int, starts, taper: np.ndarray) -> tuple:
    """(C, S) float64 (n_targets, nf, n_win): the rows of the inverse
    real DFT of length ``nt`` for each target's window, taper applied."""
    nf = nt // 2 + 1
    n_win = taper.size
    k = np.arange(nf)[:, None]
    wk = np.full((nf, 1), 2.0)
    wk[0] = 1.0
    if nt % 2 == 0:
        wk[-1] = 1.0
    C, S = [], []
    for s in starts:
        n = np.arange(int(s), int(s) + n_win)[None, :]
        ang = 2.0 * np.pi * k * n / nt
        C.append(wk * np.cos(ang) / nt * taper[None, :])
        S.append(-wk * np.sin(ang) / nt * taper[None, :])
    return np.stack(C), np.stack(S)


def window_starts(arrivals: np.ndarray, a: float, dt: float, nt: int, n_win: int) -> np.ndarray:
    """First sample of each target's window: the arrival plus the taper's
    start, rounded to the sample grid and kept inside the trace."""
    return np.clip(np.round((arrivals + a) / dt).astype(np.int64), 0, nt - n_win)


# -- the misfit --------------------------------------------------------------------


def gaussian_terms(residual: torch.Tensor, inv_sd: torch.Tensor, log_det: torch.Tensor,
                   h: torch.Tensor, precision: str) -> tuple:
    """Per-target Gaussian log-likelihood of residuals (R, T, M) under
    diagonal data covariances (standard deviations ``1 / inv_sd`` (T, M))
    scaled by exp(2h): ``(llk (R, T), scale (R, T))``, ``scale`` the sum of
    the magnitudes of the three terms, the size of the rounding that can
    enter the llk."""
    M = residual.shape[-1]
    weights = torch.diag_embed(inv_sd).to(residual.dtype)                   # (T, M, M)
    white = einsum("tij,rtj->rti", weights, residual, precision)
    quad = torch.sum(white * white, dim=-1)
    norm = M * (2.0 * h + LOG_2PI)
    scaled = torch.exp(-2.0 * h) * quad
    return -0.5 * (log_det + norm + scaled), 0.5 * (log_det.abs() + norm.abs() + scaled)


# -- SMC stage arithmetic -------------------------------------------------------------


def next_beta(beta: float, llks: np.ndarray, coef_variation: float) -> float:
    """The tempering step of transitional MCMC: the β whose importance
    weights have the coefficient of variation ``coef_variation``, by
    bisection to 1e-6 on [β, 2], taken as 1 from 1 up."""
    llks = np.asarray(llks, dtype=np.float64)
    low, up = beta, 2.0
    current = up
    while up - low > 1e-6:
        current = (low + up) / 2.0
        temp = np.exp((current - beta) * (llks - llks.max()))
        if np.std(temp) / np.mean(temp) > coef_variation:
            up = current
        else:
            low = current
    return min(current, 1.0)


def importance_weights(old_beta: float, new_beta: float, llks: np.ndarray) -> np.ndarray:
    llks = np.asarray(llks, dtype=np.float64)
    w = np.exp((new_beta - old_beta) * (llks - llks.max()))
    return w / w.sum()


def systematic_count_violations(weights: np.ndarray, parents: np.ndarray) -> int:
    """Parents whose number of children a systematic resample of
    ``weights`` cannot give: each parent i has floor(n·w_i) or one more
    (rounding allowed at the integers), in all n, in ascending order."""
    n = weights.size
    parents = np.asarray(parents)
    if parents.size != n or np.any(np.diff(parents) < 0) or parents.min() < 0 \
            or parents.max() >= n:
        return n
    counts = np.bincount(parents, minlength=n)
    expected = n * np.asarray(weights, dtype=np.float64)
    lo = np.floor(expected - 1e-9)
    hi = np.ceil(expected + 1e-9)
    return int(np.sum((counts < lo) | (counts > hi)))
