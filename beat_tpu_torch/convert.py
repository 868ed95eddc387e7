"""
State carried across from the JAX package: build the port's objects
from numpy arrays of ``beat_tpu``'s, or from its host objects read by
attribute (source templates, wavemaps and their options, BEM sources,
boundary conditions and engine settings), so both packages compute the
same thing on the same inputs.  Nothing here
imports ``jax`` or ``beat_tpu``; callers pass ``jax.device_get``
results and the JAX package's objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from beat_tpu_torch.covariance import Covariance
from beat_tpu_torch.ffi.fault import FaultGeometry, SubfaultGrid
from beat_tpu_torch.ffi.gflibrary import GeodeticGFLibrary, SeismicGFLibrary
from beat_tpu_torch.heart import taper
from beat_tpu_torch.heart.geodesy import GeodeticDataset
from beat_tpu_torch.heart.gftable import GreensTable
from beat_tpu_torch.heart.statictable import StaticGFTable
from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu_torch.sources import RectangularSource, source_catalog


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
                                 reference_times=None, *, device,
                                 dtype: torch.dtype = torch.float32) -> SeismicGFLibrary:
    """A port :class:`SeismicGFLibrary` from the JAX library's 5-D array
    and grid metadata, stored as ``dtype``: ``torch.bfloat16`` rounds the
    float32 samples to nearest even, as the JAX package's
    ``with_stacking_layout(dtype=jnp.bfloat16)`` does."""
    return SeismicGFLibrary(np.array(data, dtype=np.float32), duration_min,
                            duration_sampling, starttime_min, starttime_sampling,
                            component=component, reference_times=reference_times,
                            device=device, dtype=dtype)


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


def source_from_numpy(d: dict):
    """A port source template from the ``to_dict()`` of a JAX package
    source (its ``type`` entry picks the class)."""
    cls = source_catalog[d["type"]]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def _filterer_from(obj):
    """The port's filter of a JAX package filter (Filter, FrequencyFilter
    or a FilterChain of them), by its class name and fields."""
    kind = type(obj).__name__
    if kind == "FilterChain":
        return taper.FilterChain(filters=tuple(_filterer_from(f) for f in obj.filters))
    cls = getattr(taper, kind)
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def _covariance_from(cov):
    if cov is None:
        return None
    return Covariance(**{k: None if getattr(cov, k) is None else np.array(getattr(cov, k))
                         for k in ("data", "pred_g", "pred_v")})


def wavemap_from_jax(jwmap, table: GreensTable) -> WaveformMapping:
    """A port :class:`WaveformMapping` on ``table`` with a JAX package
    wavemap's datasets (and their covariances), taper, filter and options
    (domain, quantity, station corrections, picked arrivals, event,
    map number, preprocessing)."""
    datasets = [SeismicDataset(station=d.station, channel=d.channel, east=float(d.east),
                               north=float(d.north), ydata=np.array(d.ydata),
                               covariance=_covariance_from(d.covariance))
                for d in jwmap.datasets]
    t = jwmap.taper
    return WaveformMapping(
        name=jwmap.name, datasets=datasets, table=table,
        taper=taper.ArrivalTaper(a=t.a, b=t.b, c=t.c, d=t.d),
        filterer=_filterer_from(jwmap.filterer), domain=jwmap.domain,
        quantity=jwmap.quantity, station_corrections=jwmap.station_corrections,
        arrival_overrides=(None if jwmap.arrival_overrides is None
                           else dict(jwmap.arrival_overrides)),
        event_idx=int(jwmap.event_idx), event_offset=tuple(map(float, jwmap.event_offset)),
        mapnumber=int(jwmap.mapnumber), preprocess_data=bool(jwmap.preprocess_data))


def geodetic_dataset_from_numpy(name, typ, coords, displacement, los_vector, odw=None,
                                covariance=None, **kwargs) -> GeodeticDataset:
    """A port :class:`GeodeticDataset` from a JAX dataset's arrays:
    ``covariance`` is the JAX dataset's covariance (read by attribute:
    ``data``, ``pred_g``, ``pred_v``) or a data covariance matrix;
    ``kwargs`` the optional fields (lats, lons, stations, mask, ...)."""
    if isinstance(covariance, np.ndarray):
        covariance = Covariance(data=np.array(covariance, dtype=np.float64))
    else:
        covariance = _covariance_from(covariance)
    return GeodeticDataset(name=name, typ=typ, coords=np.array(coords, dtype=np.float64),
                           displacement=np.array(displacement, dtype=np.float64),
                           los_vector=np.array(los_vector, dtype=np.float64),
                           odw=None if odw is None else np.array(odw, dtype=np.float64),
                           covariance=covariance, **kwargs)


def static_table_from_numpy(values, distances, depths, mu_tops=None, mus=None, lams=None,
                            name: str = "static", *, device) -> StaticGFTable:
    """A port :class:`StaticGFTable` from a JAX static table's arrays
    (a layered table built by the JAX package among them)."""
    return StaticGFTable(np.array(values, dtype=np.float32), distances, depths,
                         mu_tops=mu_tops, mus=mus, lams=lams, name=name, device=device)


def geodetic_gflibrary_from_numpy(gfs: dict, component_names=None, *,
                                  device) -> GeodeticGFLibrary:
    """A port :class:`GeodeticGFLibrary` from the JAX library's
    ``{component: (npatches, nsamples)}`` matrices."""
    return GeodeticGFLibrary({c: np.array(g, dtype=np.float32) for c, g in gfs.items()},
                             component_names=component_names, device=device)


def polarity_targets_from_numpy(stations, azimuths_rad, takeoffs_rad, polarities,
                                distances_m=None) -> list:
    """Port :class:`~beat_tpu_torch.heart.polarity.PolarityTarget`\\ s
    from the arrays of a JAX package polarity map's targets."""
    from beat_tpu_torch.heart.polarity import PolarityTarget

    n = len(stations)
    dists = [None] * n if distances_m is None else [float(d) for d in distances_m]
    return [PolarityTarget(station=str(stations[i]), azimuth_rad=float(azimuths_rad[i]),
                           takeoff_rad=float(takeoffs_rad[i]), polarity=int(polarities[i]),
                           distance_m=dists[i]) for i in range(n)]


def takeoff_table_from_numpy(depth_grid, dist_grid, angles_rad, *, device):
    """A port :class:`~beat_tpu_torch.heart.polarity.TakeoffTable` from a
    JAX takeoff table's grids and angles."""
    from beat_tpu_torch.heart.polarity import TakeoffTable

    return TakeoffTable.from_numpy(np.asarray(depth_grid), np.asarray(dist_grid),
                                   np.asarray(angles_rad), device=device)


def bem_source_from_jax(src):
    """The port BEM source of a JAX package BEM source (same class name,
    dataclass fields read by attribute)."""
    from beat_tpu_torch.bem.sources import source_catalog as bem_sources

    cls = bem_sources[type(src).__name__]
    return cls(**{f.name: getattr(src, f.name) for f in dataclasses.fields(cls)})


def bem_engine_from_jax(engine, *, device):
    """A port :class:`~beat_tpu_torch.bem.base.BEMEngine` with a JAX
    engine's boundary conditions and settings."""
    from beat_tpu_torch.bem.base import BEMEngine, BoundaryCondition

    bcs = [BoundaryCondition(**{f.name: getattr(bc, f.name)
                                for f in dataclasses.fields(BoundaryCondition)})
           for bc in engine.boundary_conditions]
    return BEMEngine(bcs, mesh_size=engine.mesh_size, poissons_ratio=engine.nu,
                     shear_modulus=engine.mu,
                     check_mesh_intersection=engine.check_mesh_intersection,
                     medium=engine.medium, quadrature_level=engine.quadrature_level,
                     near_quadrature_level=engine.near_quadrature_level, device=device)


def layered_model_from_numpy(tops, vp, vs, rho, name: str = "custom", qp=None, qs=None):
    """A port :class:`~beat_tpu_torch.heart.velocity_model.LayeredModel`
    from a JAX package model's arrays."""
    from beat_tpu_torch.heart.velocity_model import LayeredModel

    return LayeredModel(tops=np.array(tops, dtype=np.float64), vp=np.array(vp, dtype=np.float64),
                        vs=np.array(vs, dtype=np.float64), rho=np.array(rho, dtype=np.float64),
                        name=str(name), qp=None if qp is None else np.array(qp, np.float64),
                        qs=None if qs is None else np.array(qs, np.float64))


def time_table_from_numpy(values, times, distances, depths, mu_tops, mus, lams,
                          name: str = "viscoelastic", prony=None):
    """A port :class:`~beat_tpu_torch.heart.viscoelastic.TimeDependentStaticGFTable`
    from a JAX time table's arrays; ``prony`` its Prony fit read by
    attribute (``c``, ``d``, ``a``, ``taus``, ``T``, ``max_resid``) or None."""
    from beat_tpu_torch.heart.viscoelastic import PronyFit, TimeDependentStaticGFTable

    fit = None if prony is None else PronyFit(
        c=np.array(prony.c), d=np.array(prony.d), a=np.array(prony.a),
        taus=np.array(prony.taus), T=float(prony.T), max_resid=float(prony.max_resid))
    return TimeDependentStaticGFTable(
        values=np.array(values, dtype=np.float32), times=np.array(times, dtype=np.float64),
        distances=np.array(distances, dtype=np.float64),
        depths=np.array(depths, dtype=np.float64), mu_tops=np.array(mu_tops, np.float64),
        mus=np.array(mus, np.float64), lams=np.array(lams, np.float64), name=str(name),
        prony=fit)
