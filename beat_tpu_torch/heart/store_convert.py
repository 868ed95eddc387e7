"""
Green's-function stores into device :class:`~beat_tpu_torch.heart.gftable.GreensTable`
tables (port of ``beat_tpu/heart/store_convert.py``).

* **Trace store** (:func:`write_trace_store`, :func:`greens_table_from_traces`):
  a plain ``.npz`` of elementary time traces, the documented interchange
  format any wavefield code can write; the JAX package reads and writes
  the same schema.
* **pyrocko fomosto store** (:func:`greens_table_from_store`): gated on
  ``pyrocko``, as in the JAX package.

:func:`trace_to_spectrum` resamples, places and aligns any batch of
traces at once on their device (the host code takes one trace a call);
the layered waveform builder's tail goes through it too.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from beat_tpu_torch.device import resolve

logger = logging.getLogger("beat_tpu_torch.heart.store_convert")

#: elementary moment tensors in NED (the tables' mnn … med order)
_ELEMENTARY = [dict(mnn=1.0), dict(mee=1.0), dict(mdd=1.0), dict(mne=1.0), dict(mnd=1.0),
               dict(med=1.0)]


def trace_to_spectrum(ydata: torch.Tensor, tmin, dt_in: float, nt: int, dt: float,
                      t0: float = 0.0) -> torch.Tensor:
    """Resample traces onto the table grid and return their rfft.

    ydata (..., n_in) holds samples at ``tmin + i·dt_in`` (``tmin`` a float
    or a tensor of the leading shape); the table wants the band-limited
    signal at ``t0 + j·dt`` for ``j < nt``.  The steps of the JAX package,
    for every trace at once: Fourier resampling ``dt_in → dt`` (spectrum
    truncation or zero-padding), placement at the integer sample offset,
    and the residual sub-sample offset as a phase shift.  Returns
    (..., nt//2 + 1) complex128."""
    y = torch.as_tensor(ydata, dtype=torch.float64)
    dev = y.device
    lead = y.shape[:-1]
    if abs(dt_in - dt) > 1e-9 * dt:
        n_in = y.shape[-1]
        n_out = max(int(round(n_in * dt_in / dt)), 1)
        spec_in = torch.fft.rfft(y)
        spec_out = torch.zeros(lead + (n_out // 2 + 1,), dtype=spec_in.dtype, device=dev)
        ncopy = min(spec_in.shape[-1], spec_out.shape[-1])
        spec_out[..., :ncopy] = spec_in[..., :ncopy]
        y = torch.fft.irfft(spec_out, n=n_out) * (n_out / n_in)

    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float64, device=dev), lead)
    offset = (tmin - t0) / dt
    i0 = torch.floor(offset)
    frac = offset - i0                                   # in [0, 1) sample units
    src = torch.arange(nt, device=dev) - i0.long()[..., None]
    inside = (src >= 0) & (src < y.shape[-1])
    data = torch.where(inside, torch.gather(y, -1, src.clamp(0, y.shape[-1] - 1)), 0.0)
    spec = torch.fft.rfft(data)
    freqs = torch.as_tensor(np.fft.rfftfreq(nt, dt), device=dev)
    phase = torch.exp(-2j * math.pi * freqs * frac[..., None] * dt)
    return torch.where((frac > 1e-12)[..., None], spec * phase, spec)


def write_trace_store(path: str, traces, tmins, distances, depths, dt: float,
                      vp: float = 6000.0, vs: float = 3500.0, rho: float = 2700.0) -> None:
    """Write the trace-store interchange ``.npz``.

    traces : (6, 3, ndist, ndepth, nt_store) elementary time traces (MT
        order mnn … med, components Z/R/T, receiver at azimuth 0), numpy or
        a tensor
    tmins : (ndist, ndepth) start time of each node's traces after the
        origin [s]; distances, depths : grid nodes [m]; dt : store sample
        interval [s]
    """
    traces = np.asarray(traces.cpu() if isinstance(traces, torch.Tensor) else traces)
    tmins = np.asarray(tmins, dtype=np.float64)
    if traces.ndim != 5 or traces.shape[:2] != (6, 3):
        raise ValueError(f"traces must be (6, 3, nd, nz, nt), got {traces.shape}")
    if tmins.shape != traces.shape[2:4]:
        raise ValueError(f"tmins {tmins.shape} != grid {traces.shape[2:4]}")
    if (np.asarray(distances).size, np.asarray(depths).size) != traces.shape[2:4]:
        raise ValueError(f"distances/depths ({np.asarray(distances).size}, "
                         f"{np.asarray(depths).size}) do not match the trace grid "
                         f"{traces.shape[2:4]}")
    np.savez_compressed(path, traces=traces.astype(np.float32), tmins=tmins,
                        distances=np.asarray(distances, dtype=np.float64),
                        depths=np.asarray(depths, dtype=np.float64),
                        meta=np.array([dt, vp, vs, rho]))
    logger.info("Wrote trace store %s (%s)", path, traces.shape)


def greens_table_from_traces(path: str, nt: int, dt: float, t0: float = 0.0, *, device):
    """A :class:`GreensTable` on ``device`` from a trace-store ``.npz``:
    every trace Fourier-resampled to ``dt``, aligned to the common ``t0``
    axis and transformed, in one batch."""
    from beat_tpu_torch.heart.gftable import GreensTable

    dev = resolve(device)
    with np.load(path) as z:
        traces = z["traces"]
        tmins = z["tmins"]
        distances = z["distances"]
        depths = z["depths"]
        dt_store, vp, vs, rho = (float(v) for v in z["meta"])
    spectra = trace_to_spectrum(torch.as_tensor(traces, device=dev),
                                torch.as_tensor(tmins, device=dev), dt_store, nt, dt, t0)
    logger.info("Converted trace store %s -> GreensTable (%i x %i grid, dt %g -> %g)", path,
                distances.size, depths.size, dt_store, dt)
    return GreensTable(torch.view_as_real(spectra).to(torch.float32), distances, depths, dt=dt,
                       nt=nt, t0=t0, vp=vp, vs=vs, rho=rho, device=dev)


def greens_table_from_store(store_id: str, store_superdir: str, distances, depths, nt: int,
                            dt: float, t0: float = 0.0, *, device):
    """Sample a pyrocko GF store into a :class:`GreensTable`: for every
    (distance, depth) node the six elementary MTs' responses at a receiver
    due north in (Z, R, T), then :func:`trace_to_spectrum`.  Needs
    ``pyrocko``."""
    try:
        from pyrocko import gf
    except ImportError as e:
        raise ImportError(
            "pyrocko is required for store conversion; hermetic runs use "
            "beat_tpu_torch.heart.gftable.build_homogeneous_table, the layered builder "
            "(heart.layered_waveforms) or a trace store (greens_table_from_traces)") from e

    from beat_tpu_torch.heart.gftable import GreensTable

    dev = resolve(device)
    engine = gf.LocalEngine(store_superdirs=[store_superdir])
    store = engine.get_store(store_id)
    distances = np.asarray(distances, dtype=float)
    depths = np.asarray(depths, dtype=float)
    spectra = torch.zeros((6, 3, distances.size, depths.size, nt // 2 + 1),
                          dtype=torch.complex128, device=dev)
    for iz, z in enumerate(depths):
        for id_, d in enumerate(distances):
            for k, m6_kwargs in enumerate(_ELEMENTARY):
                source = gf.MTSource(north_shift=0.0, east_shift=0.0, depth=z, **m6_kwargs)
                targets = [gf.Target(quantity="displacement", lat=0.0, lon=0.0, north_shift=d,
                                     east_shift=0.0, store_id=store_id,
                                     codes=("", "GT", "", comp),
                                     azimuth=azi if comp != "Z" else 0.0,
                                     dip=-90.0 if comp == "Z" else 0.0)
                           for comp, azi in (("Z", 0.0), ("R", 0.0), ("T", 90.0))]
                response = engine.process(source, targets)
                for c, tr in enumerate(response.pyrocko_traces()):
                    spectra[k, c, id_, iz] = trace_to_spectrum(
                        torch.as_tensor(tr.ydata, device=dev), tr.tmin, tr.deltat, nt, dt, t0)
    model = store.config.earthmodel_1d
    vp = float(model.profile("vp")[0]) if model is not None else 6000.0
    vs = float(model.profile("vs")[0]) if model is not None else 3500.0
    rho = float(model.profile("rho")[0]) if model is not None else 2700.0
    logger.info("Converted store %s -> GreensTable (%i x %i grid)", store_id, distances.size,
                depths.size)
    return GreensTable(torch.view_as_real(spectra).to(torch.float32), distances, depths, dt=dt,
                       nt=nt, t0=t0, vp=vp, vs=vs, rho=rho, device=dev)
