"""
The Green's-function libraries of distributed-slip (FFI) inversion
(port of ``beat_tpu/ffi/gflibrary.py``): the static geodetic library and
the 5-D kinematic one.

``GeodeticGFLibrary`` holds one (npatches, nsamples) matrix per slip
component, the LOS displacement of unit slip on each patch; the forward
is ``Σ_c s_c @ G_c`` over a batch of slips (C, npatches), one product per
component (plain ``torch.matmul``: the JAX package computes it in XLA,
not in a Pallas kernel).  :func:`geo_construct_gf_linear` builds it with
one batched Okada call over the patches, on the device it is given.

``data[target, patch, duration, starttime, sample]`` holds the
tapered, filtered unit-slip synthetics of every patch for a grid of
source durations and rupture-onset times.

* **Construction** (:func:`seis_construct_gf_linear`): one broadcasted
  frequency-domain product per batch of patches, on the table's device,
  spliced into a preallocated device tensor.  The patch spectra come from
  ``GreensTable.point_spectra``, so the build launches K1 once per batch.
* **Stacking** (:meth:`SeismicGFLibrary.stack_all`): the index
  quantisation of the JAX package, then the all-chain stack through
  kernels K3/K4 (:func:`beat_tpu_torch.ops.gfstack.stack_batched`).
* **Storage type**: float32, or bfloat16 at half the memory and bytes
  read (``dtype=``, :meth:`SeismicGFLibrary.to_dtype`; the seismic
  distributer composite stores its libraries so under
  ``BEAT_TPU_STACK_DTYPE=bfloat16``, as the JAX package's does); the
  stack sums in float32 either way.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch
from torch import nn

from beat_tpu_torch.device import DTYPE
from beat_tpu_torch.heart.taper import stf_spectrum_pair
from beat_tpu_torch.ops.cplx import cexp, cmul, from_np_complex
from beat_tpu_torch.ops.gfstack import stack_batched
from beat_tpu_torch.sources import sdr_to_m6, tensile_m6

logger = logging.getLogger("beat_tpu_torch.ffi.gflibrary")

INTERPOLATIONS = ("nearest_neighbor", "multilinear")


#: the static slip components: along rake, rake + 90°, and opening
GEODETIC_COMPONENTS = ("uparr", "uperp", "utens")


class GeodeticGFLibrary(nn.Module):
    """Static GF matrices, ``gf_<component>`` (npatches, nsamples) float32
    buffers; ``component_names`` in order."""

    def __init__(self, gfs: dict, component_names=None, *, device):
        super().__init__()
        self.component_names = list(component_names or gfs.keys())
        for comp in self.component_names:
            self.register_buffer(f"gf_{comp}", torch.as_tensor(gfs[comp], dtype=DTYPE,
                                                               device=device))

    def gf(self, comp: str) -> torch.Tensor:
        return getattr(self, f"gf_{comp}")

    @property
    def npatches(self) -> int:
        return self.gf(self.component_names[0]).shape[0]

    @property
    def nsamples(self) -> int:
        return self.gf(self.component_names[0]).shape[1]

    def stack_all(self, **slips) -> torch.Tensor:
        """``Σ_c s_c @ G_c``: slips (C, npatches) per component → (C, nsamples)."""
        out = 0.0
        for comp, s in slips.items():
            if s is not None:
                out = out + s @ self.gf(comp)
        return out

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` format: either package reads it."""
        np.savez_compressed(path, **{c: self.gf(c).cpu().numpy() for c in self.component_names})

    @classmethod
    def load(cls, path: str, *, device) -> "GeodeticGFLibrary":
        with np.load(path) as z:
            return cls({c: z[c] for c in z.files}, device=device)


def geo_construct_gf_linear(fault, coords, los, components=("uparr", "uperp"), nu=0.25, *,
                            device) -> GeodeticGFLibrary:
    """The static library of ``fault``: the LOS displacement of unit slip
    on every patch, each component one batched Okada call over all
    patches on ``device``, evaluated in
    :data:`~beat_tpu_torch.heart.okada.FORWARD_DTYPE` and stored as
    float32.  'uparr' is unit slip along the patch rake, 'uperp' along
    rake + 90°, 'utens' unit opening."""
    from beat_tpu_torch.heart import okada

    dtype = okada.FORWARD_DTYPE
    patches = fault.get_all_patches()
    coords = torch.as_tensor(np.asarray(coords), dtype=dtype, device=device)
    los = torch.as_tensor(np.asarray(los), dtype=dtype, device=device)
    params = {a: torch.as_tensor([getattr(p, a) for p in patches], dtype=dtype, device=device)
              for a in ("east_shift", "north_shift", "depth", "strike", "dip", "rake",
                        "length", "width")}
    gfs = {}
    for comp in components:
        if comp not in GEODETIC_COMPONENTS:
            raise ValueError(f"Unknown slip component {comp}")
        kw = dict(params)
        if comp == "uperp":
            kw["rake"] = kw["rake"] + 90.0
        slip, opening = (0.0, 1.0) if comp == "utens" else (1.0, 0.0)
        with torch.no_grad():
            disp = okada.okada_surface_displacement(coords, **kw, slip=slip, opening=opening,
                                                    nu=nu, anchor="top")
        gfs[comp] = torch.sum(disp * los, dim=-1).float()
    logger.info("Built geodetic GF library: %i patches x %i samples x %s", len(patches),
                coords.shape[0], list(components))
    return GeodeticGFLibrary(gfs, component_names=list(components), device=device)


#: the storage types of a kinematic library
LIBRARY_DTYPES = (torch.float32, torch.bfloat16)


def _converted(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``data`` in ``dtype`` on its device, converted one target at a time
    into a preallocated tensor: the peak is the two copies (3.93 GB of
    float32 and 1.97 GB of bfloat16 at the Laquila scale), no third."""
    out = torch.empty(data.shape, dtype=dtype, device=data.device)
    for t in range(data.shape[0]):
        out[t].copy_(data[t])
    return out


class SeismicGFLibrary(nn.Module):
    """
    5-D kinematic library: ``data`` (ntargets, npatches, ndurations,
    nstarttimes, nsamples) is a registered buffer in its natural layout
    (a (duration, starttime) cell is one contiguous row, which is what
    kernels K3/K4 read), stored as ``dtype`` (float32 or bfloat16; the
    stack sums in float32); the grid metadata are Python floats.

    ``stack_fn`` is the stack :meth:`stack_all` calls — K3/K4's wrapper
    :func:`~beat_tpu_torch.ops.gfstack.stack_batched`; it may be swapped
    for the plain version, as the parity checks do.
    """

    def __init__(self, data, duration_min: float, duration_sampling: float,
                 starttime_min: float, starttime_sampling: float, component: str = "uparr",
                 reference_times=None, *, device, dtype: torch.dtype = DTYPE):
        super().__init__()
        if dtype not in LIBRARY_DTYPES:
            raise ValueError(f"library dtype {dtype} (float32 or bfloat16)")
        data = torch.as_tensor(data, device=device)
        if data.dim() != 5:
            raise ValueError(f"library data must be (ntargets, npatches, ndurations, "
                             f"nstarttimes, nsamples), got {tuple(data.shape)}")
        if data.dtype != dtype:
            data = _converted(data, dtype)
        self.register_buffer("data", data.contiguous())
        self.duration_min = float(duration_min)
        self.duration_sampling = float(duration_sampling)
        self.starttime_min = float(starttime_min)
        self.starttime_sampling = float(starttime_sampling)
        self.component = component
        self.reference_times = (None if reference_times is None
                                else np.asarray(reference_times, dtype=np.float64))
        self.stack_fn = stack_batched

    ntargets = property(lambda self: self.data.shape[0])
    npatches = property(lambda self: self.data.shape[1])
    ndurations = property(lambda self: self.data.shape[2])
    nstarttimes = property(lambda self: self.data.shape[3])
    nsamples = property(lambda self: self.data.shape[4])

    def to_dtype(self, dtype: torch.dtype) -> "SeismicGFLibrary":
        """A copy of the library stored as ``dtype``, built on its device
        one target at a time; the grid and ``stack_fn`` carry over."""
        lib = SeismicGFLibrary(
            _converted(self.data, dtype), self.duration_min, self.duration_sampling,
            self.starttime_min, self.starttime_sampling, component=self.component,
            reference_times=self.reference_times, device=self.data.device, dtype=dtype)
        lib.stack_fn = self.stack_fn
        return lib

    def target_block(self, targets: slice) -> "SeismicGFLibrary":
        """The library of the targets in ``targets``, with its own copy of
        that block of the data, so a rank that keeps it and drops the
        whole holds only its block; the grid metadata and ``stack_fn``
        carry over (:func:`beat_tpu_torch.parallel.target_sharding`)."""
        lib = SeismicGFLibrary(
            self.data[targets].clone(), self.duration_min, self.duration_sampling,
            self.starttime_min, self.starttime_sampling, component=self.component,
            reference_times=(None if self.reference_times is None
                             else self.reference_times[targets]),
            device=self.data.device, dtype=self.data.dtype)
        lib.stack_fn = self.stack_fn
        return lib

    # -- index quantisation ---------------------------------------------------

    @staticmethod
    def _to_idxs(x: torch.Tensor, n: int, interpolation: str):
        """Grid coordinates → (index, floor-cell weight or None).  Only
        the ceil *index* is clipped: the weight ``ceil − x`` of an ``x``
        beyond the grid lies outside [0, 1], and the stack extrapolates."""
        if interpolation == "nearest_neighbor":
            return torch.clamp(torch.round(x), 0, n - 1).to(torch.int32), None
        if interpolation != "multilinear":
            raise NotImplementedError(f"Interpolation {interpolation}")
        ceil = torch.clamp(torch.ceil(x), 1, n - 1).to(torch.int32)
        return ceil, ceil - x

    def durations2idxs(self, durations, interpolation="nearest_neighbor"):
        d = (durations - self.duration_min) / self.duration_sampling
        return self._to_idxs(d, self.ndurations, interpolation)

    def starttimes2idxs(self, starttimes, interpolation="nearest_neighbor"):
        s = (starttimes - self.starttime_min) / self.starttime_sampling
        return self._to_idxs(s, self.nstarttimes, interpolation)

    def idxs2durations(self, idxs):
        return idxs * self.duration_sampling + self.duration_min

    def idxs2starttimes(self, idxs):
        return idxs * self.starttime_sampling + self.starttime_min

    # -- the hot op -------------------------------------------------------------

    def stack_all(self, durations: torch.Tensor, starttimes: torch.Tensor,
                  slips: torch.Tensor, interpolation="nearest_neighbor") -> torch.Tensor:
        """
        Stack all patches for all targets, for a batch of chains.

        durations : (C, npatches) STF durations [s]
        starttimes : (C, ntargets, npatches) onset times [s], or
            (C, 1, npatches) when every target sees the same onsets
        slips : (C, npatches)

        Returns (C, ntargets, nsamples).
        """
        didx, rt_f = self.durations2idxs(durations, interpolation)
        sidx, st_f = self.starttimes2idxs(starttimes, interpolation)
        return self.stack_fn(self.data, didx, sidx, slips, rt_f, st_f)

    # -- persistence (the JAX package's .npz format) -------------------------------

    def save(self, dirpath: str, name: str) -> None:
        """The JAX package's ``.npz`` format (float32 data: a bfloat16
        library is widened exactly)."""
        os.makedirs(dirpath, exist_ok=True)
        np.savez_compressed(
            os.path.join(dirpath, f"{name}.npz"),
            data=self.data.float().cpu().numpy(),
            meta=np.array([self.duration_min, self.duration_sampling,
                           self.starttime_min, self.starttime_sampling]),
            reference_times=(self.reference_times if self.reference_times is not None
                             else np.zeros(self.ntargets)))

    @classmethod
    def load(cls, dirpath: str, name: str, component="uparr", *,
             device) -> "SeismicGFLibrary":
        with np.load(os.path.join(dirpath, f"{name}.npz")) as z:
            meta = z["meta"]
            return cls(z["data"], duration_min=float(meta[0]),
                       duration_sampling=float(meta[1]), starttime_min=float(meta[2]),
                       starttime_sampling=float(meta[3]), component=component,
                       reference_times=z["reference_times"], device=device)


def patch_m6s(patches, component: str, shear_modulus: float) -> torch.Tensor:
    """(npatches, 6) unit-slip moment tensors of the patches for one slip
    component: 'uparr' along the rake, 'uperp' at rake + 90°, 'utens'
    unit opening."""
    strike = np.array([p.strike for p in patches])
    dip = np.array([p.dip for p in patches])
    rake = np.array([p.rake for p in patches])
    area = np.array([p.length * p.width for p in patches])
    if component == "uparr":
        return sdr_to_m6(strike, dip, rake, shear_modulus * area)
    if component == "uperp":
        return sdr_to_m6(strike, dip, rake + 90.0, shear_modulus * area)
    if component == "utens":
        return tensile_m6(strike, dip, area, lam=shear_modulus, mu=shear_modulus)
    raise ValueError(f"Unknown slip component {component}")


def seis_construct_gf_linear(table, wavemap, fault, component="uparr",
                             duration_bounds=(0.5, 4.0), duration_sampling=0.5,
                             starttime_bounds=(0.0, 8.0), starttime_sampling=0.25,
                             shear_modulus=33e9, stf_type="HalfSinusoid",
                             batch_patches: int = 8) -> SeismicGFLibrary:
    """
    Build the 5-D kinematic library from the GF table, on the table's
    device: per batch of patches, the patch spectra (K1) times the STF
    spectra of the duration grid times the onset phasors of the starttime
    grid, transformed to the time domain, chopped to each target's window
    and tapered.  The grids are inclusive aranges over the bounds at the
    given sampling.
    """
    durations = np.arange(duration_bounds[0], duration_bounds[1] + duration_sampling / 2,
                          duration_sampling)
    starttimes = np.arange(starttime_bounds[0], starttime_bounds[1] + starttime_sampling / 2,
                           starttime_sampling)
    patches = fault.get_all_patches()
    npatches = len(patches)
    nwin = wavemap.nsamples_win
    dev = table.freqs.device

    freqs = table.freqs
    w = 2.0 * math.pi * freqs
    stf_grid = torch.stack([stf_spectrum_pair(freqs, float(d), stf_type)
                            for d in durations])                          # (nd, nf, 2)
    phasor_grid = cexp(-w[None, :] * torch.as_tensor(starttimes, dtype=DTYPE,
                                                     device=dev)[:, None])   # (ns, nf, 2)
    station_e = torch.as_tensor(wavemap.station_east, dtype=DTYPE, device=dev)
    station_n = torch.as_tensor(wavemap.station_north, dtype=DTYPE, device=dev)
    comp_idx = torch.as_tensor(wavemap.comp_idx, device=dev)
    filt = torch.as_tensor(from_np_complex(wavemap.filter_response), device=dev)
    win_starts = [int(s) for s in wavemap.window_starts]
    taper_win = torch.as_tensor(wavemap.taper_window, dtype=DTYPE, device=dev)

    m6s = patch_m6s(patches, component, shear_modulus).to(dev)
    centers = torch.as_tensor(np.stack([p.center() for p in patches]), dtype=DTYPE,
                              device=dev)

    n_targets = station_e.shape[0]
    data = torch.zeros((n_targets, npatches, len(durations), len(starttimes), nwin),
                       dtype=DTYPE, device=dev)
    n_b = max(1, int(batch_patches))
    for i0 in range(0, npatches, n_b):
        i1 = min(i0 + n_b, npatches)
        spec = table.point_spectra(m6s[i0:i1], centers[i0:i1, 0], centers[i0:i1, 1],
                                   centers[i0:i1, 2], station_e, station_n, comp_idx,
                                   filt)                                  # (b, nt, nf, 2)
        full = cmul(cmul(spec[:, :, None, None], stf_grid[None, None, :, None]),
                    phasor_grid[None, None, None])                        # (b, nt, nd, ns, nf, 2)
        traces = table.to_time_domain(full)
        for t, start in enumerate(win_starts):
            data[t, i0:i1] = traces[:, t, :, :, start:start + nwin] * taper_win

    logger.info("Built seismic GF library '%s': %s", component, tuple(data.shape))
    return SeismicGFLibrary(
        data, duration_min=float(durations[0]), duration_sampling=float(duration_sampling),
        starttime_min=float(starttimes[0]), starttime_sampling=float(starttime_sampling),
        component=component, device=dev)


def stack_all_numpy(lib: SeismicGFLibrary, durations, starttimes, slips,
                    interpolation="nearest_neighbor"):
    """Host float64 reference of one chain's stack: durations (P,),
    starttimes (T, P), slips (P,) → (T, N)."""
    data = lib.data.double().cpu().numpy()
    nt, npch = lib.ntargets, lib.npatches
    out = np.zeros((nt, lib.nsamples))
    d = (np.asarray(durations) - lib.duration_min) / lib.duration_sampling
    s = (np.asarray(starttimes) - lib.starttime_min) / lib.starttime_sampling
    for t in range(nt):
        for p in range(npch):
            if interpolation == "nearest_neighbor":
                di = int(np.clip(round(d[p]), 0, lib.ndurations - 1))
                si = int(np.clip(round(s[t, p]), 0, lib.nstarttimes - 1))
                out[t] += data[t, p, di, si, :] * slips[p]
            else:
                dc = int(np.clip(np.ceil(d[p]), 1, lib.ndurations - 1))
                sc = int(np.clip(np.ceil(s[t, p]), 1, lib.nstarttimes - 1))
                fd = dc - d[p]
                fs = sc - s[t, p]
                val = (data[t, p, dc, sc, :] * (1 - fs) * (1 - fd)
                       + data[t, p, dc, sc - 1, :] * fs * (1 - fd)
                       + data[t, p, dc - 1, sc, :] * (1 - fs) * fd
                       + data[t, p, dc - 1, sc - 1, :] * fs * fd)
                out[t] += val * slips[p]
    return out
