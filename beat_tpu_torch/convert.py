"""
State carried across from the JAX package: build the port's objects
from numpy arrays of ``beat_tpu``'s, so both packages compute the same
thing on the same inputs.  Nothing here imports ``jax``; callers pass
``jax.device_get`` results.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.ffi.fault import FaultGeometry, SubfaultGrid
from beat_tpu_torch.ffi.gflibrary import SeismicGFLibrary
from beat_tpu_torch.heart.gftable import GreensTable
from beat_tpu_torch.sources import RectangularSource


def greens_table_from_numpy(spectra, distances, depths, dt, nt, t0=0.0, vp=6000.0,
                            vs=3500.0, rho=2700.0, tt_p=None, tt_s=None, *,
                            device) -> GreensTable:
    """A port :class:`GreensTable` from the JAX table's arrays."""
    return GreensTable(np.array(spectra, dtype=np.float32), distances, depths, dt=dt,
                       nt=nt, t0=t0, vp=vp, vs=vs, rho=rho, tt_p=tt_p, tt_s=tt_s,
                       device=device)


def _table_from(obj, device) -> GreensTable:
    return greens_table_from_numpy(
        obj.spectra, obj.distances, obj.depths, obj.dt, obj.nt, obj.t0, obj.vp, obj.vs,
        obj.rho, obj.tt_p, obj.tt_s, device=device)


def wavemap_data_from_numpy(dev: dict, *, device, table: GreensTable | None = None) -> dict:
    """One wavemap's device data for the port's
    ``SeismicGeometryComposite.loglike`` from ``jax.device_get`` of the
    JAX composite's ``_wavemap_device`` dict.

    ``table`` reuses a port table (wavemaps sharing one table share one
    copy); without it the dict's own ``table`` entry is converted."""
    ICw, ISw = dev["win_basis"]
    arrays = {
        "data": dev["data"], "station_east": dev["station_east"],
        "station_north": dev["station_north"], "win_basis_c": ICw, "win_basis_s": ISw,
        "filter": dev["filter"], "weights": dev["weights"], "slog_pdets": dev["slog_pdets"],
        "nsamples": dev["nsamples"],
    }
    out = {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
           for k, v in arrays.items()}
    out["comp_idx"] = torch.as_tensor(np.array(dev["comp_idx"], dtype=np.int32),
                                      device=device)
    out["table"] = table if table is not None else _table_from(dev["table"], device)
    return out


def seismic_gflibrary_from_numpy(data, duration_min, duration_sampling, starttime_min,
                                 starttime_sampling, component="uparr",
                                 reference_times=None, *, device) -> SeismicGFLibrary:
    """A port :class:`SeismicGFLibrary` from the JAX library's 5-D array
    and grid metadata."""
    return SeismicGFLibrary(np.array(data, dtype=np.float32), duration_min,
                            duration_sampling, starttime_min, starttime_sampling,
                            component=component, reference_times=reference_times,
                            device=device)


def fault_geometry_from_numpy(subfaults, components=("uparr",)) -> FaultGeometry:
    """A port :class:`FaultGeometry` from ``(plane, n_strike, n_dip)``
    per subfault, ``plane`` being the ``to_dict()`` of the JAX package's
    ``RectangularSource`` (its ``type`` entry is ignored)."""
    grids = []
    for plane, n_strike, n_dip in subfaults:
        src = RectangularSource(**{k: v for k, v in plane.items() if k != "type"})
        grids.append(SubfaultGrid(plane=src, n_strike=int(n_strike), n_dip=int(n_dip),
                                  patches=src.patches(int(n_strike), int(n_dip))))
    return FaultGeometry(subfaults=grids, components=list(components))
