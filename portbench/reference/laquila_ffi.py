"""
The plain reference of the ``laquila_ffi`` configuration: the kinematic
finite-fault log-likelihood of BEAT's L'Aquila example, from the
configuration and the observed windows alone.

The program stacks a precomputed library of tapered, filtered unit-slip
waveforms on a grid of source durations and rupture onsets,
interpolating multilinearly between grid cells.  A window is linear in
the spectra it comes from, so here the same interpolation is applied to
the grid's source-time-function spectra and onset phasors instead, each
patch's spectrum is weighted by them and its slip, the patches are
summed, and one tapered inverse DFT gives each target's window: no
library is built.  The patch spectra are the analytic Green's functions
of a homogeneous medium on the configuration's table grid, interpolated
bilinearly in distance and depth.

The onsets solve the eikonal equation on the patch grid by the
configuration's stated method (Jacobi iterations of the monotone upwind
update from the nucleation patch, each chain stopped once its summed
squared change falls to 0.1 s²): the stopping point is part of the
model, so it is followed in float32 as the configuration states.  A
stopping decision within 1e-3 of the threshold is a coin toss of
rounding; such a chain is also evaluated with that one decision the
other way, and the closer of the two answers counts.

The Laplacian smoothing prior on the slips (nearest neighbours, patch
sizes in km) and the whitened Gaussian misfit complete the likelihood.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (LOG_2PI, bilinear_corners, butterworth_response,
                                        complex_dtype, einsum, gaussian_terms,
                                        half_sinusoid_spectrum, homogeneous_spectra,
                                        irfft_window_basis, real_dtype, rotate_m6, sdr_to_m6,
                                        taper_window, window_starts)

EIKONAL_EPSILON = 0.1
EIKONAL_INIT = 1e8
#: a stopping decision this close to the threshold (relative) can go
#: either way by rounding
EIKONAL_TIE = 1e-3
KM = 1e3


def grid(spec) -> np.ndarray:
    start, stop, n = spec
    return np.linspace(float(start), float(stop), int(n))


def inclusive_grid(bounds, step: float) -> np.ndarray:
    return np.arange(bounds[0], bounds[1] + step / 2, step)


def patch_geometry(config: dict) -> dict:
    """Patch centers (E, N, depth) [m] in strike-fastest order, and the
    plane's angles, of the configuration's fault."""
    f = config["fault"]
    n_s, n_d, size = f["n_strike"], f["n_dip"], f["patch_size"]
    st, di = np.deg2rad(f["strike"]), np.deg2rad(f["dip"])
    s_vec = np.array([np.sin(st), np.cos(st)])
    d_vec = np.array([np.cos(st), -np.sin(st)])
    centers = []
    for iw in range(n_d):
        for il in range(n_s):
            along = (il + 0.5) * size - n_s * size / 2.0
            down = (iw + 0.5) * size                 # the patch's center, down dip
            e = along * s_vec[0] + down * np.cos(di) * d_vec[0]
            n = along * s_vec[1] + down * np.cos(di) * d_vec[1]
            centers.append((e, n, f["depth"] + down * np.sin(di)))
    return {"centers": np.asarray(centers), "n_strike": n_s, "n_dip": n_d, "size": size}


def stations(config: dict, rng: np.random.Generator) -> tuple:
    st = config["stations"]
    az = np.linspace(0, 2 * np.pi, st["n"], endpoint=False) + st["azimuth_offset"]
    dist = rng.uniform(*st["distance_range"], st["n"])
    return dist * np.sin(az), dist * np.cos(az)


def laplacian(n_strike: int, n_dip: int, size_km: float) -> np.ndarray:
    """Finite-difference Laplacian between neighbouring patches."""
    n = n_strike * n_dip
    op = np.zeros((n, n))
    d = 1.0 / size_km**2
    for i in range(n):
        row, col = divmod(i, n_strike)
        for j, ok in ((i - n_strike, row > 0), (i + n_strike, row < n_dip - 1),
                      (i - 1, col > 0), (i + 1, col < n_strike - 1)):
            if ok:
                op[i, j] = d
                op[i, i] -= d
    return op


def eikonal(velocity: torch.Tensor, nuc_strike: torch.Tensor, nuc_dip: torch.Tensor,
            n_strike: int, n_dip: int, size: float, flip_at=None) -> tuple:
    """Onsets (R, n_dip·n_strike) float32, and for each chain the first
    iteration whose stopping decision was within EIKONAL_TIE of the
    threshold (-1 where none).  ``flip_at`` (R,) takes the decision at
    that iteration the other way."""
    v = velocity.to(torch.float32)
    R = v.shape[0]
    fh = (1.0 / v.reshape(R, n_dip, n_strike)) * float(np.sqrt(size * size))
    ns = torch.clamp(torch.round(nuc_strike.to(torch.float32) / size - 0.5), 0, n_strike - 1)
    nd = torch.clamp(torch.round(nuc_dip.to(torch.float32) / size - 0.5), 0, n_dip - 1)
    nuc = torch.zeros_like(fh, dtype=torch.bool)
    nuc[torch.arange(R, device=v.device), nd.long(), ns.long()] = True
    t = torch.where(nuc, 0.0, torch.full_like(fh, EIKONAL_INIT))
    active = torch.ones(R, dtype=torch.bool, device=v.device)
    tie = torch.full((R,), -1, dtype=torch.long, device=v.device)
    for it in range(4 * (n_dip + n_strike) + 16):
        up = torch.cat([t[:, :1], t[:, :-1]], dim=1)
        down = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
        left = torch.cat([t[:, :, :1], t[:, :, :-1]], dim=2)
        right = torch.cat([t[:, :, 1:], t[:, :, -1:]], dim=2)
        a, b = torch.minimum(up, down), torch.minimum(left, right)
        one = torch.minimum(a, b) + fh
        two = 0.5 * (a + b + torch.sqrt(torch.clamp(2.0 * fh**2 - (a - b) ** 2, min=0.0)))
        new = torch.minimum(t, torch.where(torch.abs(a - b) >= fh, one, two))
        new = torch.where(nuc, 0.0, new)
        new = torch.where(active[:, None, None], new, t)
        change = torch.sum(((new - t) ** 2).double(), dim=(1, 2))
        near = active & (torch.abs(change - EIKONAL_EPSILON) <= EIKONAL_TIE * EIKONAL_EPSILON)
        tie = torch.where(near & (tie < 0), it, tie)
        decide = change > EIKONAL_EPSILON
        if flip_at is not None:
            decide = torch.where(flip_at == it, ~decide, decide)
        active = active & decide
        t = new
        if not bool(active.any()):
            break
    return t.reshape(R, -1), tie


class Reference:
    """The log-likelihood (seismic misfit plus Laplacian prior) of chains
    of the configuration's flat layout."""

    def __init__(self, config: dict, inputs: dict, device, precision: str = "float64"):
        self.precision = precision
        self.device = dev = torch.device(device)
        rdt, cdt = real_dtype(precision), complex_dtype(precision)
        tb, lib, f = config["table"], config["library"], config["fault"]
        nt, dt = int(tb["nt"]), float(tb["dt"])
        self.geometry = geo = patch_geometry(config)
        P = geo["centers"].shape[0]
        distances, depths = grid(tb["distances"]), grid(tb["depths"])
        table = homogeneous_spectra(distances, depths, nt, dt, tb["vp"], tb["vs"], tb["rho"])
        table = torch.as_tensor(table.transpose(2, 3, 1, 0, 4)).to(dev)    # (nd, nz, 3, 6, F)
        east, north = inputs["station_east"], inputs["station_north"]
        n_win = int(config["window"]["samples"])
        taper = taper_window(**ffi_taper(n_win, dt), dt=dt)
        response = butterworth_response(**config["filter"], nt=nt, dt=dt)
        z_ref = float(np.mean(depths))
        arrivals = np.sqrt(east**2 + north**2 + z_ref**2) / tb["vp"]
        starts = window_starts(arrivals, ffi_taper(n_win, dt)["a"], dt, nt, n_win)

        # patch spectra G (T, P, F): the unit-slip moment tensor of each
        # patch, rotated to each station, bilinear on the table
        m6 = torch.as_tensor(sdr_to_m6(f["strike"], f["dip"], f["rake"],
                                       f["shear_modulus"] * f["patch_size"] ** 2), device=dev)
        c = torch.as_tensor(geo["centers"], device=dev)
        de = torch.as_tensor(east, device=dev)[:, None] - c[None, :, 0]
        dn = torch.as_tensor(north, device=dev)[:, None] - c[None, :, 1]
        d0, fd = bilinear_corners(torch.sqrt(de**2 + dn**2), distances)      # (T, P)
        z0, fz = bilinear_corners(c[:, 2], depths)                          # (P,)
        m6_ray = rotate_m6(m6, torch.atan2(de, dn))                         # (T, P, 6)
        G = 0.0
        for dd, dz, w in ((0, 0, (1 - fd) * (1 - fz)), (0, 1, (1 - fd) * fz),
                          (1, 0, fd * (1 - fz)), (1, 1, fd * fz)):
            rows = table[torch.clamp(d0 + dd, max=distances.size - 1),
                         torch.clamp(z0 + dz, max=depths.size - 1)[None, :], 0]   # (T, P, 6, F)
            G = G + w[..., None] * torch.einsum("tpk,tpkf->tpf", m6_ray.to(rows.dtype), rows)
        G = G * torch.as_tensor(response, device=dev)
        self.G = G.to(cdt)
        freqs = torch.as_tensor(np.fft.rfftfreq(nt, dt), device=dev)
        self.durations = inclusive_grid(lib["duration_bounds"], lib["duration_sampling"])
        self.starttimes = inclusive_grid(lib["starttime_bounds"], lib["starttime_sampling"])
        self.stf = half_sinusoid_spectrum(freqs, torch.as_tensor(self.durations, device=dev)
                                          ).to(cdt)                          # (D, F)
        omega = 2.0 * math.pi * freqs
        ph = -omega[None, :] * torch.as_tensor(self.starttimes, device=dev)[:, None]
        self.phasor = torch.complex(torch.cos(ph), torch.sin(ph)).to(cdt)    # (S, F)
        C, S = irfft_window_basis(nt, starts, taper)
        self.basis_c = torch.as_tensor(C, dtype=rdt, device=dev)
        self.basis_s = torch.as_tensor(S, dtype=rdt, device=dev)
        self.data = torch.as_tensor(inputs["data"], dtype=rdt, device=dev)
        sd = float(inputs["sd"])
        T = len(east)
        self.inv_sd = torch.full((T, n_win), 1.0 / sd, dtype=rdt, device=dev)
        self.log_det = torch.full((T,), n_win * math.log(sd * sd), dtype=rdt, device=dev)
        op = laplacian(geo["n_strike"], geo["n_dip"], f["patch_size"] / KM)
        eig = np.linalg.eigvalsh(op.T @ op)
        self.lap_logdet = float(np.sum(np.log(eig[eig > 1e-10 * eig.max()])))
        self.lap = torch.as_tensor(op, dtype=rdt, device=dev)
        names = [p[0] for p in config["priors"]]
        sizes = [int(p[1]) for p in config["priors"]]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        self.slices = {n: slice(int(offsets[i]), int(offsets[i + 1]))
                       for i, n in enumerate(names)}
        self.P = P

    def cell_weights(self, durations: torch.Tensor, onsets: torch.Tensor) -> torch.Tensor:
        """(R, P, F) spectral weights of the multilinear cells of float32
        durations and onsets (the library's quantisation: the upper cell
        clipped into the grid, the weights extrapolating outside it)."""
        def corners(x, lo, step, n):
            xi = (x - lo) / step
            ceil = torch.clamp(torch.ceil(xi), 1, n - 1)
            return ceil.long(), (ceil - xi).to(self.stf.real.dtype)

        dc, wd = corners(durations.to(torch.float32), float(self.durations[0]),
                         float(self.durations[1] - self.durations[0]), self.durations.size)
        sc, ws = corners(onsets.to(torch.float32), float(self.starttimes[0]),
                         float(self.starttimes[1] - self.starttimes[0]), self.starttimes.size)
        stf = (1 - wd)[..., None] * self.stf[dc] + wd[..., None] * self.stf[dc - 1]
        ph = (1 - ws)[..., None] * self.phasor[sc] + ws[..., None] * self.phasor[sc - 1]
        return stf * ph

    def synthetics(self, slips: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """(R, T, W) tapered windows of slips (R, P) with cell weights."""
        p = self.precision
        spec = einsum("tpf,rpf->rtf", self.G, slips.to(weights.dtype)[..., None] * weights, p)
        return (einsum("rtf,tfw->rtw", spec.real.contiguous(), self.basis_c, p)
                + einsum("rtf,tfw->rtw", spec.imag.contiguous(), self.basis_s, p))

    def _llk(self, q: torch.Tensor, q32: torch.Tensor, onsets: torch.Tensor) -> tuple:
        p, s = self.precision, self.slices
        slips = q[:, s["uparr"]]
        synth = self.synthetics(slips, self.cell_weights(q32[:, s["durations"]], onsets))
        h = q[:, s["h_any_P_0"]].expand(-1, synth.shape[1])
        llk, scale = gaussian_terms(self.data[None] - synth, self.inv_sd, self.log_det, h, p)
        lm = einsum("rp,qp->rq", slips, self.lap, p)
        quad = torch.sum(lm * lm, dim=-1)
        hl = q[:, s["h_laplacian"]][:, 0]
        norm = self.P * (LOG_2PI + 2.0 * hl)
        scaled = torch.exp(-2.0 * hl) * quad
        lap = -0.5 * (-self.lap_logdet + norm + scaled)
        lap_scale = 0.5 * (abs(self.lap_logdet) + norm.abs() + scaled)
        return llk.sum(-1) + lap, scale.sum(-1) + lap_scale

    def onsets(self, q32: torch.Tensor, flip_at=None) -> tuple:
        s, g = self.slices, self.geometry
        return eikonal(q32[:, s["velocities"]], q32[:, s["nucleation_strike"]][:, 0],
                       q32[:, s["nucleation_dip"]][:, 0], g["n_strike"], g["n_dip"], g["size"],
                       flip_at)

    def llk(self, q) -> tuple:
        """``(llk (R,), scale (R,), alternative llk (R,))`` float64 numpy of
        chains ``q`` (R, dim); the alternative is NaN except where a
        stopping decision of the eikonal was a tie."""
        rdt = real_dtype(self.precision)
        q = np.asarray(q)
        q32 = torch.as_tensor(q.astype(np.float32), device=self.device)
        qr = torch.as_tensor(q, dtype=rdt, device=self.device)
        onsets, tie = self.onsets(q32)
        llk, scale = self._llk(qr, q32, onsets)
        alt = torch.full_like(llk, float("nan"))
        rows = torch.nonzero(tie >= 0).flatten()
        if rows.numel():
            other, _ = self.onsets(q32[rows], flip_at=tie[rows])
            alt[rows] = self._llk(qr[rows], q32[rows], other)[0]
        return (llk.double().cpu().numpy(), scale.double().cpu().numpy(),
                alt.double().cpu().numpy())


def ffi_taper(n_win: int, dt: float) -> dict:
    """The arrival taper that spans exactly ``n_win`` samples."""
    return dict(a=-4.0, b=-2.0, c=n_win * dt - 10.0, d=n_win * dt - 4.0)


def true_windows(config: dict, inputs: dict, device) -> np.ndarray:
    """Noise-free windows (T, W) of the true rupture ``inputs["truth"]``:
    on-grid durations and onsets (the eikonal times rounded to the onset
    grid), each patch on its one cell."""
    n_win = config["window"]["samples"]
    ref = Reference(config, dict(inputs, data=np.zeros((len(inputs["station_east"]), n_win)),
                                 sd=1.0), device)
    truth, g, dev = inputs["truth"], ref.geometry, ref.device
    onsets, _ = eikonal(torch.as_tensor(truth["velocities"][None], device=dev),
                        torch.as_tensor(truth["nucleation_strike"], device=dev),
                        torch.as_tensor(truth["nucleation_dip"], device=dev),
                        g["n_strike"], g["n_dip"], g["size"])
    step = float(ref.starttimes[1] - ref.starttimes[0])
    s_idx = torch.clamp(torch.round(onsets[0] / step).long(), 0, ref.starttimes.size - 1)
    d_idx = torch.as_tensor(np.round((truth["durations"] - ref.durations[0])
                                     / (ref.durations[1] - ref.durations[0])).astype(np.int64),
                            device=dev)
    slips = torch.as_tensor(truth["uparr"][None], dtype=torch.float64, device=dev)
    return ref.synthetics(slips, (ref.stf[d_idx] * ref.phasor[s_idx])[None])[0].cpu().numpy()
