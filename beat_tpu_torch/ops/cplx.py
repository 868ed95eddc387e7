"""
Real-pair complex arithmetic and DFT-as-matmul (port of
``beat_tpu/ops/cplx.py``).

Frequency-domain arrays keep the JAX package's trailing (re, im) axis so
every tensor compares directly against the reference; the inverse rFFT
is a matmul against a precomputed cos/sin basis.
"""

from __future__ import annotations

import numpy as np
import torch


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise complex multiply of (re, im)-pair tensors."""
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    return torch.stack([re, im], dim=-1)


def cexp(phase: torch.Tensor) -> torch.Tensor:
    """e^{i·phase} as an (re, im) pair."""
    return torch.stack([torch.cos(phase), torch.sin(phase)], dim=-1)


def from_np_complex(x: np.ndarray) -> np.ndarray:
    """numpy complex -> float32 (…, 2) pair array."""
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def irfft_basis(nt: int) -> tuple:
    """(IC, IS) float32 numpy matrices (nf, nt) with
    ``re @ IC + im @ IS == np.fft.irfft(spec, n=nt)``."""
    nf = nt // 2 + 1
    k = np.arange(nf)[:, None]
    n = np.arange(nt)[None, :]
    ang = 2.0 * np.pi * k * n / nt
    w = np.full((nf, 1), 2.0)
    w[0] = 1.0
    if nt % 2 == 0:
        w[-1] = 1.0
    IC = (w * np.cos(ang) / nt).astype(np.float32)
    IS = (-w * np.sin(ang) / nt).astype(np.float32)
    return IC, IS


def irfft_pair(pair: torch.Tensor, IC: torch.Tensor, IS: torch.Tensor) -> torch.Tensor:
    """Inverse rFFT of (…, nf, 2) pair spectra via basis matmul → (…, nt)."""
    return pair[..., 0] @ IC + pair[..., 1] @ IS


def rfft_basis(nt: int) -> tuple:
    """(C, S) float32 numpy matrices (nt, nf) with ``x @ C + i·x @ S ==
    np.fft.rfft(x)``."""
    nf = nt // 2 + 1
    n = np.arange(nt)[:, None]
    k = np.arange(nf)[None, :]
    ang = 2.0 * np.pi * n * k / nt
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def amplitude_spectrum(x: torch.Tensor, C: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """|rfft(x)| of real (…, nt) signals via basis matmuls → (…, nf)."""
    re = x @ C
    im = x @ S
    return torch.sqrt(re * re + im * im + 1e-30)
