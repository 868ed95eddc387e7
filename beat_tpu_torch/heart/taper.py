"""
Arrival tapers, frequency-domain filters and STF spectra (port of
``beat_tpu/heart/taper.py``).

Tapers and filter responses are host numpy arrays computed once per
wavemap; :func:`stf_spectrum_pair` runs on the device, batched over
chains.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ArrivalTaper:
    """Cosine taper with corner times a < b < c < d relative to the phase
    arrival [s]: ramp up a→b, flat b→c, ramp down c→d."""

    a: float = -15.0
    b: float = -10.0
    c: float = 50.0
    d: float = 55.0

    @property
    def duration(self) -> float:
        return self.d - self.a

    def nsamples(self, dt: float) -> int:
        return int(round(self.duration / dt))

    def window(self, dt: float) -> np.ndarray:
        """Taper amplitude array over the chopped window [a, d)."""
        n = self.nsamples(dt)
        t = self.a + np.arange(n) * dt
        w = np.ones(n)
        up = (t >= self.a) & (t < self.b)
        w[up] = 0.5 - 0.5 * np.cos(np.pi * (t[up] - self.a) / max(self.b - self.a, dt))
        down = (t >= self.c) & (t <= self.d)
        w[down] = 0.5 + 0.5 * np.cos(np.pi * (t[down] - self.c) / max(self.d - self.c, dt))
        w[t > self.d] = 0.0
        return w


@dataclass
class Filter:
    """Butterworth bandpass, applied as a frequency response on the rfft
    of fixed-length traces."""

    lower_corner: float = 0.001
    upper_corner: float = 0.1
    order: int = 4

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        """Complex digital Butterworth response on the rfft grid."""
        from scipy import signal

        nyq = 0.5 / dt
        lo = max(self.lower_corner / nyq, 1e-6)
        hi = min(self.upper_corner / nyq, 1.0 - 1e-6)
        b, a = signal.butter(self.order, [lo, hi], btype="band")
        freqs = np.fft.rfftfreq(nsamples, dt)
        _, h = signal.freqz(b, a, worN=freqs / nyq * np.pi)
        return h.astype(np.complex64)


@dataclass
class BandstopFilter(Filter):
    """Butterworth bandstop: rejects the band between the corners."""

    lower_corner: float = 0.12
    upper_corner: float = 0.25
    order: int = 4

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        from scipy import signal

        nyq = 0.5 / dt
        lo = max(self.lower_corner / nyq, 1e-6)
        hi = min(self.upper_corner / nyq, 1.0 - 1e-6)
        b, a = signal.butter(self.order, [lo, hi], btype="bandstop")
        freqs = np.fft.rfftfreq(nsamples, dt)
        _, h = signal.freqz(b, a, worN=freqs / nyq * np.pi)
        return h.astype(np.complex64)


@dataclass
class FrequencyFilter:
    """Flat passband with cosine flanks, on the amplitude spectrum."""

    freqlimits: tuple = (0.005, 0.01, 0.1, 0.2)

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        f1, f2, f3, f4 = self.freqlimits
        freqs = np.fft.rfftfreq(nsamples, dt)
        h = np.zeros_like(freqs)
        ramp_up = (freqs >= f1) & (freqs < f2)
        h[ramp_up] = 0.5 - 0.5 * np.cos(np.pi * (freqs[ramp_up] - f1) / max(f2 - f1, 1e-9))
        h[(freqs >= f2) & (freqs <= f3)] = 1.0
        ramp_dn = (freqs > f3) & (freqs <= f4)
        h[ramp_dn] = 0.5 + 0.5 * np.cos(np.pi * (freqs[ramp_dn] - f3) / max(f4 - f3, 1e-9))
        return h.astype(np.complex64)


@dataclass
class FilterChain:
    """Filters applied in order: on the rfft grid the responses multiply."""

    filters: tuple = ()

    def response(self, nsamples: int, dt: float) -> np.ndarray:
        h = np.ones(nsamples // 2 + 1, dtype=np.complex64)
        for f in self.filters:
            h = h * f.response(nsamples, dt)
        return h.astype(np.complex64)


def stf_spectrum_pair(freqs: torch.Tensor, duration: torch.Tensor,
                      stf_type: str = "HalfSinusoid") -> torch.Tensor:
    """Unit-area source-time-function spectra as (re, im) pairs:
    freqs (nf,), duration (...) → (..., nf, 2)."""
    d = torch.clamp(torch.as_tensor(duration, dtype=freqs.dtype, device=freqs.device),
                    min=1e-4)[..., None]
    w = 2.0 * math.pi * freqs

    if stf_type == "Boxcar":
        mag = torch.sinc(freqs * d)
    elif stf_type == "Triangular":
        mag = torch.sinc(freqs * d / 2.0) ** 2
    elif stf_type == "HalfSinusoid":
        # the safe denominator keeps the w·d = π point finite in both
        # branches of the where (and NaN out of any gradient)
        denom = math.pi**2 - (w * d) ** 2
        near_pole = torch.abs(denom) < 1e-6
        safe = torch.where(near_pole, torch.ones_like(denom), denom)
        mag = torch.where(near_pole, torch.full_like(denom, math.pi / 4.0),
                          math.pi**2 * torch.cos(w * d / 2.0) / safe)
    else:
        raise ValueError(f"Unknown STF {stf_type}")
    phase = -w * d / 2.0
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
