"""
The plain reference of the ``fullmt`` configuration: the waveform
log-likelihood of a full moment tensor in a homogeneous medium, from the
configuration and the observed traces alone.

For each chain: the moment tensor (normalised components times the
magnitude's moment) rotated into each receiver's ray frame, the
Green's-function spectra of the table grid interpolated bilinearly in
distance and depth, the Butterworth filter, the source time shift and
half-sinusoid source-time function, the tapered window of the inverse
DFT, and a Gaussian misfit whose variance is that of the filtered trace
before the phase arrives, scaled by exp(2h) per wavemap.

The table is rebuilt here from the analytic formula; the observed
traces are processed here; nothing comes from the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.common import (bilinear_corners, butterworth_response,
                                        complex_dtype, einsum, gaussian_terms,
                                        half_sinusoid_spectrum, homogeneous_spectra,
                                        irfft_window_basis, magnitude_to_moment, real_dtype,
                                        rotate_m6, sdr_to_m6, taper_window, window_starts)

CHANNELS = {"Z": 0, "R": 1, "T": 2}
M6_NAMES = ("mnn", "mee", "mdd", "mne", "mnd", "med")


def grid(spec) -> np.ndarray:
    start, stop, n = spec
    return np.linspace(float(start), float(stop), int(n))


def stations(config: dict, rng: np.random.Generator) -> tuple:
    """(east, north) [m] of the station ring, distances drawn from ``rng``."""
    st = config["stations"]
    az = np.linspace(0, 2 * np.pi, st["n"], endpoint=False) + st["azimuth_offset"]
    dist = rng.uniform(*st["distance_range"], st["n"])
    return dist * np.sin(az), dist * np.cos(az)


def true_traces(config: dict, east: np.ndarray, north: np.ndarray) -> dict:
    """Noise-free raw traces ``{channel: (n_stations, nt)}`` of the true
    double couple, the Green's functions evaluated at each station's own
    distance (no table)."""
    tb, truth = config["table"], config["truth"]
    nt, dt = tb["nt"], tb["dt"]
    dist = np.hypot(east, north)
    az = np.arctan2(east, north)
    gf = homogeneous_spectra(dist, [truth["depth"]], nt, dt, tb["vp"], tb["vs"],
                             tb["rho"])[:, :, :, 0]                          # (6, 3, n, nf)
    m6 = sdr_to_m6(truth["strike"], truth["dip"], truth["rake"],
                   magnitude_to_moment(truth["magnitude"]))
    m6_ray = rotate_m6(torch.as_tensor(m6)[None], torch.as_tensor(az)).numpy()   # (n, 6)
    freqs = torch.as_tensor(np.fft.rfftfreq(nt, dt))
    stf = half_sinusoid_spectrum(freqs, torch.tensor(float(truth["duration"]))).numpy()
    shift = np.exp(-2j * np.pi * freqs.numpy() * truth["time"])
    spec = np.einsum("nk,kcnf->cnf", m6_ray, gf) * stf * shift
    return {ch: np.fft.irfft(spec[i], n=nt) for ch, i in CHANNELS.items()}


class Reference:
    """The log-likelihood of chains of the configuration's flat layout."""

    def __init__(self, config: dict, inputs: dict, device, precision: str = "float64"):
        self.precision = precision
        self.device = torch.device(device)
        rdt, cdt = real_dtype(precision), complex_dtype(precision)
        tb = config["table"]
        self.distances, self.depths = grid(tb["distances"]), grid(tb["depths"])
        nt, dt = int(tb["nt"]), float(tb["dt"])
        spectra = homogeneous_spectra(self.distances, self.depths, nt, dt, tb["vp"], tb["vs"],
                                      tb["rho"])
        # (distance, depth, channel, component, frequency)
        self.table = torch.as_tensor(spectra.transpose(2, 3, 1, 0, 4)).to(self.device, cdt)
        del spectra
        self.freqs = torch.as_tensor(np.fft.rfftfreq(nt, dt), dtype=rdt, device=self.device)

        # the stations where the configuration's float32 puts them (mm from
        # the seed's float64 coordinates, which moves prior draws' llks by
        # 1e-5 of their scale through the table's interpolation)
        east = np.asarray(inputs["station_east"], dtype=np.float32).astype(np.float64)
        north = np.asarray(inputs["station_north"], dtype=np.float32).astype(np.float64)
        taper = taper_window(**config["taper"], dt=dt)
        n_win = taper.size
        response = butterworth_response(**config["filter"], nt=nt, dt=dt)
        z_ref = float(np.mean(self.depths))
        self.names = [p[0] for p in config["priors"]]
        te, tn, comp, hyper, starts, data, var = [], [], [], [], [], [], []
        for wmap in config["wavemaps"]:
            velocity = tb["vp"] if wmap["name"].lower().endswith("p") else tb["vs"]
            for ch in wmap["channels"]:
                for i in range(len(east)):
                    arrival = math.sqrt(east[i] ** 2 + north[i] ** 2 + z_ref**2) / velocity
                    start = int(window_starts(np.array([arrival]), config["taper"]["a"], dt,
                                              nt, n_win)[0])
                    filtered = np.fft.irfft(np.fft.rfft(inputs["raw"][ch][i], n=nt) * response,
                                            n=nt)
                    pre = max(int(round((arrival - 1.0) / dt)), 2)
                    te.append(east[i])
                    tn.append(north[i])
                    comp.append(CHANNELS[ch])
                    hyper.append(self.names.index(wmap["hyper"]))
                    starts.append(start)
                    data.append(filtered[start:start + n_win] * taper)
                    var.append(max(float(np.var(filtered[:pre])), 1e-30))
        dev = self.device
        de, dn = np.asarray(te), np.asarray(tn)
        self.distance = torch.as_tensor(np.hypot(de, dn), dtype=rdt, device=dev)
        self.azimuth = torch.as_tensor(np.arctan2(de, dn), dtype=rdt, device=dev)
        self.comp = torch.as_tensor(comp, device=dev)
        self.hyper = torch.as_tensor(hyper, device=dev)
        self.data = torch.as_tensor(np.stack(data), dtype=rdt, device=dev)
        var = np.asarray(var)
        self.inv_sd = torch.as_tensor(np.repeat(1.0 / np.sqrt(var)[:, None], n_win, axis=1),
                                      dtype=rdt, device=dev)
        self.log_det = torch.as_tensor(n_win * np.log(var), dtype=rdt, device=dev)
        self.response = torch.as_tensor(response, dtype=cdt, device=dev)
        C, S = irfft_window_basis(nt, starts, taper)
        self.basis_c = torch.as_tensor(C, dtype=rdt, device=dev)
        self.basis_s = torch.as_tensor(S, dtype=rdt, device=dev)
        self.index = {name: i for i, name in enumerate(self.names)}

    def _residuals(self, q) -> tuple:
        """``(q, data - synthetics (R, T, W))`` of chains ``q`` (R, dim)."""
        p = self.precision
        rdt, cdt = real_dtype(p), complex_dtype(p)
        q = torch.as_tensor(np.asarray(q, dtype=np.float64), dtype=rdt, device=self.device)

        def col(name):
            return q[:, self.index[name]]

        comps = torch.stack([col(n) for n in M6_NAMES], dim=-1)
        norm = torch.sqrt(torch.sum(comps[:, :3] ** 2, -1)
                          + 2.0 * torch.sum(comps[:, 3:] ** 2, -1)) / math.sqrt(2.0)
        moment = 10.0 ** (1.5 * col("magnitude") + 9.05)
        m6 = comps / torch.clamp(norm, min=1e-20)[:, None] * moment[:, None]
        m6_ray = rotate_m6(m6[:, None, :], self.azimuth[None, :])              # (R, T, 6)

        d0, fd = bilinear_corners(self.distance, self.distances)              # (T,)
        z0, fz = bilinear_corners(col("depth"), self.depths)                  # (R,)
        w = torch.stack(torch.broadcast_tensors(
            (1 - fd)[None] * (1 - fz)[:, None], (1 - fd)[None] * fz[:, None],
            fd[None] * (1 - fz)[:, None], fd[None] * fz[:, None]), dim=-1)    # (R, T, 4)
        di = torch.stack([d0, d0, d0 + 1, d0 + 1], dim=-1)                    # (T, 4)
        zi = torch.stack([z0, z0 + 1, z0, z0 + 1], dim=-1)                    # (R, 4)
        zi = torch.clamp(zi, max=self.depths.size - 1)
        di = torch.clamp(di, max=self.distances.size - 1)
        rows = self.table[di[None], zi[:, None], self.comp[None, :, None]]    # (R, T, 4, 6, F)
        coef = (w[..., None] * m6_ray[:, :, None, :]).to(cdt)                 # (R, T, 4, 6)
        spec = einsum("rtck,rtckf->rtf", coef, rows, p)
        omega = 2.0 * math.pi * self.freqs
        shift = torch.complex(torch.cos(-omega * col("time")[:, None]),
                              torch.sin(-omega * col("time")[:, None]))
        stf = half_sinusoid_spectrum(self.freqs, col("duration"))
        spec = spec * (self.response * shift * stf)[:, None, :]
        synth = (einsum("rtf,tfw->rtw", spec.real.contiguous(), self.basis_c, p)
                 + einsum("rtf,tfw->rtw", spec.imag.contiguous(), self.basis_s, p))
        return q, self.data[None] - synth

    def llk(self, q) -> tuple:
        """``(llk (R,), scale (R,))`` float64 numpy of chains ``q`` (R, dim)."""
        q, residual = self._residuals(q)
        h = q[:, self.hyper]                                                  # (R, T)
        llk, scale = gaussian_terms(residual, self.inv_sd, self.log_det, h, self.precision)
        return (llk.sum(-1).double().cpu().numpy(), scale.sum(-1).double().cpu().numpy())

    def profile_llk(self, q, bounds=(-2.0, 6.0)) -> tuple:
        """``(llk, scale)`` of chains ``q`` with each wavemap's noise scale
        h at its best for the chain's residuals (clipped to ``bounds``):
        the fit of a source whatever its h."""
        q, residual = self._residuals(q)
        quad = torch.sum((residual * self.inv_sd) ** 2, dim=-1)             # (R, T)
        h = torch.zeros_like(quad)
        for k in torch.unique(self.hyper):
            mine = self.hyper == k
            n = mine.sum() * residual.shape[-1]
            best = 0.5 * torch.log(quad[:, mine].sum(-1) / n)
            h[:, mine] = torch.clamp(best, *bounds)[:, None]
        llk, scale = gaussian_terms(residual, self.inv_sd, self.log_det, h, self.precision)
        return (llk.sum(-1).double().cpu().numpy(), scale.sum(-1).double().cpu().numpy())
