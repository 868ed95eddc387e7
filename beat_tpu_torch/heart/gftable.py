"""
Device-resident Green's-function tables and the seismic forward (port of
``beat_tpu/heart/gftable.py``).

    bilinear table gather in (distance, depth), channel fused,
    and the moment-tensor weighting in the ray frame — kernel K1c
    → × STF spectrum × time-shift phasor × filter response
    → windowed inverse DFT (matmul basis, taper folded in)

The forward is batched over a leading chain axis: sources carry shape
(C,), targets (T,), and the whole population of C·T (chain, target)
queries reaches K1c as one flat list.  Spectra are real float32 with a
trailing (re, im) axis, as in the JAX package, so every stage compares
directly against it.

Conventions: N-E-D source frame for the MT; (Z up, R radial away from
the source, T = E at azimuth 0) receiver components; distances and
depths in metres; the table's time axis starts ``t0`` seconds after the
origin time.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.heart.taper import stf_spectrum_pair
from beat_tpu_torch.ops.bilgather import bilinear_contract, bilinear_rows, pack_table
from beat_tpu_torch.ops.cplx import cexp, cmul, irfft_basis, irfft_pair
from beat_tpu_torch.profiling import span

logger = logging.getLogger("beat_tpu_torch.heart.gftable")

COMP_Z, COMP_R, COMP_T = 0, 1, 2
component_index = {"Z": COMP_Z, "R": COMP_R, "T": COMP_T}


def rotate_m6_to_ray_frame(m6: torch.Tensor, azimuth_rad: torch.Tensor) -> torch.Tensor:
    """Rotate NED moment tensors (..., 6) so the receiver azimuth maps to
    0 (north); azimuth in radians, clockwise from north."""
    ca = torch.cos(azimuth_rad)
    sa = torch.sin(azimuth_rad)
    mnn, mee, mdd, mne, mnd, med = m6.unbind(-1)
    mnn_r = ca * ca * mnn + sa * sa * mee + 2 * ca * sa * mne
    mee_r = sa * sa * mnn + ca * ca * mee - 2 * ca * sa * mne
    mne_r = (ca * ca - sa * sa) * mne + ca * sa * (mee - mnn)
    mnd_r = ca * mnd + sa * med
    med_r = -sa * mnd + ca * med
    mdd_b = torch.broadcast_to(mdd, mnn_r.shape)
    return torch.stack([mnn_r, mee_r, mdd_b, mne_r, mnd_r, med_r], dim=-1)


def _grid_step(grid: np.ndarray) -> float:
    return float(grid[1] - grid[0]) if grid.size > 1 else 1.0


class GreensTable(nn.Module):
    """
    Elementary-MT Green's-function spectra on a (distance, depth) grid.

    spectra : (6, 3, ndist, ndepth, nfreq, 2) float32 — rfft (re, im)
        pairs of the response to unit elementary MTs (mnn, mee, mdd,
        mne, mnd, med), receiver at azimuth 0, components (Z, R, T).
    distances, depths : uniform grid nodes [m]
    dt, nt, t0 : sample interval [s], samples, time of the first sample
        after the origin [s].

    Buffers: ``spectra``, the gather layout ``packed`` (built once,
    here), the inverse-rFFT basis ``ic``/``is_`` and ``freqs``.
    ``contract_fn`` is what the forward (:meth:`point_spectra`) calls —
    K1c's wrapper :func:`~beat_tpu_torch.ops.bilgather.bilinear_contract`,
    the gather fused with the m6 contraction, differentiable in its
    coefficients through K2c (and K1c again for second derivatives).
    ``rows_fn`` is the row gather of :meth:`gather_spectra` — K1's wrapper
    :func:`~beat_tpu_torch.ops.bilgather.bilinear_rows` (K2 its
    backward).  Either may be swapped for its plain version, as the
    parity checks do.
    """

    def __init__(self, spectra, distances, depths, dt: float, nt: int, t0: float = 0.0,
                 vp: float = 6000.0, vs: float = 3500.0, rho: float = 2700.0,
                 tt_p=None, tt_s=None, *, device):
        super().__init__()
        dev = resolve(device)
        self.distances = np.asarray(distances, dtype=np.float64)
        self.depths = np.asarray(depths, dtype=np.float64)
        for name in ("distances", "depths"):
            g = getattr(self, name)
            if g.size > 1:
                steps = np.diff(g)
                if steps.min() <= 0 or (steps.max() - steps.min() > 1e-6 * steps.mean()):
                    raise ValueError(
                        f"GreensTable {name} must be uniformly spaced and increasing "
                        f"(bilinear index assumes a constant step); got steps "
                        f"[{steps.min():g}, {steps.max():g}]")
        self.dt, self.nt, self.t0 = float(dt), int(nt), float(t0)
        self.vp, self.vs, self.rho = float(vp), float(vs), float(rho)
        self.tt_p = None if tt_p is None else np.asarray(tt_p, dtype=np.float64)
        self.tt_s = None if tt_s is None else np.asarray(tt_s, dtype=np.float64)

        sp = torch.as_tensor(spectra, dtype=DTYPE, device=dev)
        nf = self.nt // 2 + 1
        want = (6, 3, self.distances.size, self.depths.size, nf, 2)
        if tuple(sp.shape) != want:
            raise ValueError(f"spectra shape {tuple(sp.shape)}, expected {want}")
        self.register_buffer("spectra", sp)
        self.register_buffer("packed", pack_table(sp))
        IC, IS = irfft_basis(self.nt)
        self.register_buffer("ic", torch.as_tensor(IC, device=dev))
        self.register_buffer("is_", torch.as_tensor(IS, device=dev))
        self.register_buffer("freqs", torch.as_tensor(
            np.fft.rfftfreq(self.nt, self.dt), dtype=DTYPE, device=dev))
        self.rows_fn = bilinear_rows
        self.contract_fn = bilinear_contract

    @property
    def nf(self) -> int:
        return self.nt // 2 + 1

    # -- host-side geometry -------------------------------------------------

    def travel_time(self, phase: str, distance, depth) -> np.ndarray:
        """First-arrival time [s] (host numpy): bilinear lookup in the
        table's travel-time grid when present, straight ray ``r/v``
        otherwise."""
        is_p = phase.lower().endswith("p")
        tt = self.tt_p if is_p else self.tt_s
        distance = np.asarray(distance, dtype=np.float64)
        if tt is None:
            return np.sqrt(distance**2 + depth**2) / (self.vp if is_p else self.vs)
        d_grid, z_grid = self.distances, self.depths
        di = np.clip((distance - d_grid[0]) / _grid_step(d_grid), 0.0, d_grid.size - 1.0)
        zi = np.clip((depth - z_grid[0]) / _grid_step(z_grid), 0.0, z_grid.size - 1.0)
        d0 = np.minimum(np.floor(di).astype(int), max(d_grid.size - 2, 0))
        z0 = np.minimum(np.floor(zi).astype(int), max(z_grid.size - 2, 0))
        fd, fz = di - d0, zi - z0
        d1 = np.minimum(d0 + 1, d_grid.size - 1)
        z1 = np.minimum(z0 + 1, z_grid.size - 1)
        return ((1 - fd) * (1 - fz) * tt[d0, z0] + fd * (1 - fz) * tt[d1, z0]
                + (1 - fd) * fz * tt[d0, z1] + fd * fz * tt[d1, z1])

    # -- the forward ----------------------------------------------------------

    def _corner_queries(self, distance: torch.Tensor, depth: torch.Tensor,
                        comp_idx: torch.Tensor) -> tuple:
        """Each target's lower corner in the packed layout and its four
        bilinear weights: ``cd``, ``z0`` (..., T) and ``w4`` (..., T, 4),
        differentiable in ``distance`` (..., T) and ``depth`` (...)."""
        d_grid, z_grid = self.distances, self.depths
        di = torch.clamp((distance - d_grid[0]) / _grid_step(d_grid), 0.0, d_grid.size - 1.0)
        zi = torch.clamp((depth - z_grid[0]) / _grid_step(z_grid), 0.0, z_grid.size - 1.0)
        # the cell index clamps to the LAST cell, so a query at the top
        # node is exact (fd/fz reach 1.0); single-node axes give 0 weight
        # to the duplicated +1 node of the packed layout
        d0 = torch.clamp(torch.floor(di).long(), max=max(d_grid.size - 2, 0))
        z0 = torch.clamp(torch.floor(zi).long(), max=max(z_grid.size - 2, 0))
        fd = di - d0
        fz = (zi - z0)[..., None]
        nd_packed = self.packed.shape[0] // 3
        cd = comp_idx.long() * nd_packed + d0
        z0b = torch.broadcast_to(z0[..., None], cd.shape)
        w4 = torch.stack(torch.broadcast_tensors(
            (1 - fd) * (1 - fz), (1 - fd) * fz, fd * (1 - fz), fd * fz), dim=-1)
        return cd, z0b, w4

    def gather_spectra(self, distance: torch.Tensor, depth: torch.Tensor,
                       comp_idx: torch.Tensor) -> torch.Tensor:
        """
        Bilinear (distance, depth) interpolation of each target's own
        channel block, through K1; differentiable in ``distance`` and
        ``depth`` through the weights.

        distance (..., T); depth (...) — one depth per chain, broadcast
        over its targets; comp_idx (T,) channel (0 Z / 1 R / 2 T).
        Returns (..., T, 6, nf, 2).
        """
        cd, z0, w4 = self._corner_queries(distance, depth, comp_idx)
        rows = self.rows_fn(self.packed, cd.reshape(-1), z0.reshape(-1), w4.reshape(-1, 4))
        return rows.reshape(cd.shape + (6, self.nf, 2))

    def point_spectra(self, m6, east_shift, north_shift, depth, station_east,
                      station_north, comp_idx, filter_response=None) -> torch.Tensor:
        """Raw channel spectra (no STF, no time shift) of point MT sources:
        m6 (..., 6), positions (...), stations (T,) → (..., T, nf, 2).

        The gather and the m6 contraction are one pass, K1c, over the
        coefficients ``A = w4 ⊗ m6_ray`` (..., T, 4, 6); its backward is
        K2c, and the autograd of the outer product (a matmul: two in the
        backward) turns K2c's (..., T, 4, 6) into the weights' and the
        moment tensor's cotangents.  No (..., T, 6, nf, 2) rows are made."""
        with span("fullmt.queries"):
            de = station_east - east_shift[..., None]
            dn = station_north - north_shift[..., None]
            distance = torch.sqrt(de**2 + dn**2)
            azimuth = torch.atan2(de, dn)
            cd, z0, w4 = self._corner_queries(distance, depth, comp_idx)
            m6_ray = rotate_m6_to_ray_frame(m6[..., None, :], azimuth)   # (..., T, 6)
            dt = self.packed.dtype
            A = w4.to(dt)[..., :, None] @ m6_ray.to(dt)[..., None, :]
        spec = self.contract_fn(self.packed, cd, z0, A).reshape(cd.shape + (self.nf, 2))
        if filter_response is not None:
            with span("fullmt.filter"):
                spec = cmul(spec, filter_response)
        return spec

    def synthesize_spectra(self, m6, east_shift, north_shift, depth, time_shift,
                           duration, station_east, station_north, comp_idx,
                           stf_type="HalfSinusoid", filter_response=None) -> torch.Tensor:
        """Frequency-domain synthesis: source tensors with leading shape
        (...), stations (T,) → (..., T, nf, 2) spectra of full-length
        traces starting at ``t0``."""
        spec = self.point_spectra(m6, east_shift, north_shift, depth, station_east,
                                  station_north, comp_idx, filter_response)
        with span("fullmt.phasors"):
            w = 2.0 * math.pi * self.freqs
            phasor = cexp(-w * time_shift[..., None])
            stf = stf_spectrum_pair(self.freqs, duration, stf_type)
            return cmul(spec, cmul(phasor, stf)[..., None, :, :])

    def to_time_domain(self, spec: torch.Tensor) -> torch.Tensor:
        """Full-length traces from (…, nf, 2) pair spectra."""
        return irfft_pair(spec, self.ic, self.is_)

    def windowed_ibasis(self, window_starts, window_taper, nsamples_win: int):
        """Per-target inverse-DFT basis restricted to each target's taper
        window, taper folded in: (ICw, ISw), each (T, nf, nsamples_win)."""
        IC, IS = irfft_basis(self.nt)
        starts = np.asarray(window_starts, dtype=int)
        ICw = np.stack([IC[:, s:s + nsamples_win] for s in starts])
        ISw = np.stack([IS[:, s:s + nsamples_win] for s in starts])
        taper = np.asarray(window_taper, dtype=np.float32)[None, None, :]
        dev = self.freqs.device
        return (torch.as_tensor(ICw * taper, device=dev),
                torch.as_tensor(ISw * taper, device=dev))

    @staticmethod
    def synthesize_windows_fused(spec: torch.Tensor, ICw: torch.Tensor,
                                 ISw: torch.Tensor) -> torch.Tensor:
        """Tapered windows (..., T, W) from (..., T, nf, 2) spectra."""
        return (torch.einsum("...tf,tfw->...tw", spec[..., 0], ICw)
                + torch.einsum("...tf,tfw->...tw", spec[..., 1], ISw))

    # -- persistence ------------------------------------------------------------

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` format (``beat_tpu/heart/gftable.py:520``):
        either package reads it."""
        extra = {k: v for k, v in (("tt_p", self.tt_p), ("tt_s", self.tt_s)) if v is not None}
        np.savez_compressed(path, spectra=self.spectra.cpu().numpy(), distances=self.distances,
                            depths=self.depths, meta=np.array([self.dt, float(self.nt), self.t0,
                                                               self.vp, self.vs, self.rho]),
                            **extra)

    @classmethod
    def load(cls, path: str, *, device) -> "GreensTable":
        """Read a table saved by ``beat_tpu``'s ``GreensTable.save`` (.npz)."""
        with np.load(path) as z:
            meta = z["meta"]
            return cls(z["spectra"], z["distances"], z["depths"], dt=float(meta[0]),
                       nt=int(meta[1]), t0=float(meta[2]), vp=float(meta[3]),
                       vs=float(meta[4]), rho=float(meta[5]) if meta.size > 5 else 2700.0,
                       tt_p=z["tt_p"] if "tt_p" in z.files else None,
                       tt_s=z["tt_s"] if "tt_s" in z.files else None, device=device)


# ---------------------------------------------------------------------------
# Homogeneous-medium analytic table (hermetic builder)
# ---------------------------------------------------------------------------

ELEMENTARY_M6 = np.eye(6)


def _m6_to_matrix_np(m6):
    mnn, mee, mdd, mne, mnd, med = m6
    return np.array([[mnn, mne, mnd], [mne, mee, med], [mnd, med, mdd]])


def build_homogeneous_table(distances, depths, nt, dt, vp=6000.0, vs=3500.0,
                            rho=2700.0, t0=0.0, *, device) -> GreensTable:
    """
    Analytic far-field P+S Green's functions of a homogeneous fullspace
    (Aki & Richards eq. 4.96), free-surface factor 2, in the frequency
    domain — the same array as ``beat_tpu``'s builder, vectorised over
    the (distance, depth) grid on the host.
    """
    distances = np.asarray(distances, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.float64)
    w = 2.0 * np.pi * np.fft.rfftfreq(nt, dt)
    nf = w.size
    spectra = np.zeros((6, 3, distances.size, depths.size, nf), dtype=np.complex128)

    d, z = np.meshgrid(distances, depths, indexing="ij")          # (nd, nz)
    r = np.sqrt(d * d + z * z)
    r1 = np.maximum(r, 1.0)
    # unit ray vector source->receiver in NED (receiver north, surface)
    gamma = np.stack([d, np.zeros_like(d), -z], axis=-1) / r1[..., None]
    amp_p = 2.0 / (4.0 * np.pi * rho * vp**3 * r1)
    amp_s = 2.0 / (4.0 * np.pi * rho * vs**3 * r1)
    ph_p = np.exp(-1j * w * (r / vp - t0)[..., None])
    ph_s = np.exp(-1j * w * (r / vs - t0)[..., None])
    for k in range(6):
        M = _m6_to_matrix_np(ELEMENTARY_M6[k])
        mg = gamma @ M                                              # (nd, nz, 3)
        mgg = np.sum(mg * gamma, axis=-1)
        u_p = gamma * mgg[..., None] * amp_p[..., None]
        u_s = (mg - gamma * mgg[..., None]) * amp_s[..., None]
        for u, ph in ((u_p, ph_p), (u_s, ph_s)):
            # NED -> (Z up, R=+N, T=+E at azimuth 0)
            spectra[k, COMP_Z] += -u[..., 2, None] * ph
            spectra[k, COMP_R] += u[..., 0, None] * ph
            spectra[k, COMP_T] += u[..., 1, None] * ph

    pairs = np.stack([spectra.real, spectra.imag], axis=-1).astype(np.float32)
    logger.info("Built homogeneous GF table: %i dist x %i depth x %i samples",
                distances.size, depths.size, nt)
    return GreensTable(pairs, distances, depths, dt=dt, nt=nt, t0=t0, vp=vp, vs=vs,
                       rho=rho, device=device)
