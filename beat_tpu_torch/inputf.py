"""
Data importers (copied from ``beat_tpu/inputf.py``): the native
portable formats (CSV, npz) and the foreign ones — matlab SAR scenes,
GLOBK GNSS files, kite scenes, obspy waveforms, GlobalCMT NDK catalogs;
the kite and obspy importers are gated on those packages.

``seismic_data.npz`` holds, for each ``<station>.<channel>``, the raw
trace on the GF table's time grid (``:ydata``) and the station's local
(east, north) position [m] (``:coords``) — the JAX package's format, so
either package reads the other's projects.  A picked-arrivals file is
CSV lines ``station,time_s`` (seconds after origin; a header and ``#``
comments are skipped).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from beat_tpu_torch.covariance import Covariance
from beat_tpu_torch.heart.geodesy import GeodeticDataset, diff_ifg, gnss_compound

logger = logging.getLogger("beat_tpu_torch.inputf")


# ---------------------------------------------------------------------------
# Geodetic
# ---------------------------------------------------------------------------


def load_sar_csv(path: str, name: str | None = None, incidence: float = 39.0,
                 heading: float = -168.0) -> GeodeticDataset:
    """
    InSAR displacement from CSV with columns east,north,displacement
    [m] (+ optional incidence,heading columns per row) — the native
    analogue of ``load_ascii_data`` (``beat/inputf.py:92``).
    """
    arr = np.genfromtxt(path, delimiter=",", names=True)
    coords = np.column_stack([arr["east"], arr["north"]])
    inc = arr["incidence"] if "incidence" in (arr.dtype.names or ()) else incidence
    head = arr["heading"] if "heading" in (arr.dtype.names or ()) else heading
    return diff_ifg(name or os.path.basename(path), coords, arr["displacement"],
                    incidence=inc, heading=head)


def kite_scene_to_dataset(scene, name: str) -> GeodeticDataset:
    """
    Convert an in-memory kite ``Scene`` to a :class:`GeodeticDataset`.

    Kite's quadtree stores per-leaf look geometry as ``leaf_thetas``
    (elevation angle of the satellite above the horizon, radians) and
    ``leaf_phis`` (horizontal look azimuth counter-clockwise from east,
    radians).  The reference converts these to satellite
    incidence/heading first — ``incidence = 90 - rad2deg(theta)``,
    ``heading = -rad2deg(phi) + 180`` (``beat/heart.py:1513-1515``) —
    and then builds the LOS unit vector from incidence/heading
    (``beat/heart.py:1393-1400``), which is exactly :func:`diff_ifg`.
    """
    qt = scene.quadtree
    coords = np.column_stack([
        np.asarray(qt.leaf_focal_points[:, 0], dtype=float),
        np.asarray(qt.leaf_focal_points[:, 1], dtype=float)])
    incidence = 90.0 - np.rad2deg(np.asarray(qt.leaf_thetas, dtype=float))
    heading = -np.rad2deg(np.asarray(qt.leaf_phis, dtype=float)) + 180.0
    ds = diff_ifg(name, coords, np.asarray(qt.leaf_means, dtype=float),
                  incidence=incidence, heading=heading)
    cov = getattr(getattr(scene, "covariance", None), "covariance_matrix", None)
    if cov is not None:
        ds.covariance = Covariance(data=np.asarray(cov, dtype=float))
    ds.mask = kite_polygon_mask(scene)
    return ds


def kite_polygon_mask(scene) -> np.ndarray | None:
    """
    Per-leaf boolean mask from user-drawn kite polygons (True = inside
    a polygon, i.e. the deforming region to EXCLUDE from plate-motion /
    ramp correction estimation).  Polygon vertices are in quadtree frame
    units ``[cols, rows]`` and leaves are located by
    ``northings/dN, eastings/dE`` — reference ``DiffIFG.from_kite_scene``
    ``beat/heart.py:1484-1502`` + ``get_data_mask`` ``:1520``.
    """
    pm = getattr(scene, "polygon_mask", None)
    polygons = getattr(pm, "polygons", None) if pm is not None else None
    qt = scene.quadtree
    n = np.asarray(qt.leaf_means).size
    if not polygons:
        return None
    from matplotlib.path import Path

    frame = scene.frame
    rows = np.asarray(qt.leaf_northings, dtype=float) / float(frame.dN)
    cols = np.asarray(qt.leaf_eastings, dtype=float) / float(frame.dE)
    points = np.column_stack([cols, rows])
    mask = np.zeros(n, dtype=bool)
    for vertices in polygons.values():
        mask |= Path(np.asarray(vertices, dtype=float)).contains_points(points)
    return mask


def load_kite_scene(path: str) -> GeodeticDataset:
    """Kite scene importer (reference ``load_kite_scenes``
    ``beat/inputf.py:110``; requires the ``kite`` package)."""
    try:
        from kite import Scene
    except ImportError as e:
        raise ImportError(
            "kite is required for kite scene import; use load_sar_csv or the "
            "npz dataset format instead") from e
    return kite_scene_to_dataset(Scene.load(path), os.path.basename(path))


def load_gnss_csv(path: str, components=("east", "north", "up"),
                  blacklist=()) -> list:
    """
    GNSS displacements from CSV with columns
    station,lat,lon,east,north,up,sigma_east,sigma_north,sigma_up [m]
    — native analogue of ``load_ascii_gnss_globk``
    (``beat/inputf.py:135``).  Returns one compound dataset per component;
    ``blacklist`` drops stations by name (same semantics as the GLOBK
    importer).
    """
    arr = np.genfromtxt(path, delimiter=",", names=True, dtype=None, encoding=None)
    arr = np.atleast_1d(arr)
    if blacklist and "station" in (arr.dtype.names or ()):
        keep = ~np.isin(arr["station"].astype(str), list(blacklist))
        dropped = arr["station"][~keep]
        if dropped.size:
            logger.info("GNSS CSV: blacklisted stations dropped: %s",
                        ", ".join(map(str, dropped)))
        arr = arr[keep]
        if arr.size == 0:
            raise ValueError(f"blacklist removed every station of {path}")
    out = []
    lats = arr["lat"].astype(float)
    lons = arr["lon"].astype(float)
    coords = np.zeros((lats.size, 2))  # filled via update_local_coords later
    for comp in components:
        disp = arr[comp].astype(float)
        sig_name = f"sigma_{comp}"
        ds = gnss_compound(f"gnss_{comp}", coords, disp, comp)
        ds.lats, ds.lons = lats, lons
        ds.stations = arr["station"].astype(str) if "station" in (arr.dtype.names or ()) else None
        if sig_name in (arr.dtype.names or ()):
            sig = arr[sig_name].astype(float)
            ds.covariance = Covariance(data=np.diag(np.maximum(sig, 1e-6) ** 2))
        out.append(ds)
    return out


def load_sar_matlab(datadir: str, names: list) -> list:
    """
    SAR data from the reference's matlab schema
    (``load_SAR_data`` ``beat/inputf.py:61-106``): per scene ``k`` the
    files ``quad_<k>.mat`` (fields ``cfoc`` (N, 2) UTM coords, ``sqval``
    displacements, ``lvQT`` struct with ``inci``/``head``, ``ODW_sub``
    overlap weights) and ``CovMatrix_<k>.mat`` (field ``Cov``).
    """
    import scipy.io

    out = []
    for k in names:
        try:
            data = scipy.io.loadmat(os.path.join(datadir, f"quad_{k}.mat"),
                                    squeeze_me=True, struct_as_record=False)
            covs = scipy.io.loadmat(os.path.join(datadir, f"CovMatrix_{k}.mat"),
                                    squeeze_me=True, struct_as_record=False)
        except FileNotFoundError:
            logger.warning("Scene %s: matlab files missing in %s", k, datadir)
            continue
        coords = np.asarray(data["cfoc"], dtype=np.float64)[:, :2]
        lv = data["lvQT"]
        ds = diff_ifg(k, coords, np.asarray(data["sqval"], dtype=np.float64),
                      incidence=float(np.atleast_1d(lv.inci)[0]),
                      heading=float(np.atleast_1d(lv.head)[0]))
        ds.odw = np.asarray(data["ODW_sub"], dtype=np.float64).ravel()
        ds.covariance = Covariance(data=np.asarray(covs["Cov"], dtype=np.float64))
        out.append(ds)
    return out


def load_ascii_gnss_globk(filedir: str, filename: str,
                          components=("east", "north", "up"),
                          blacklist=()) -> list:
    """
    GLOBK ascii GNSS import (reference ``load_ascii_gnss_globk`` +
    ``load_and_blacklist_gnss`` ``beat/inputf.py:135-263``): 3 header
    rows, 12 float columns + station name in column 13; velocities in
    mm/yr (converted to m); component columns (value, sigma):
    east (2, 6), north (3, 7), up (9, 11); lon/lat in columns 0/1.

    Returns one compound :class:`GeodeticDataset` per component with
    diagonal sigma covariances, blacklisted stations removed.
    """
    path = os.path.join(filedir, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(f"No GLOBK file at {path}")
    names = np.loadtxt(path, skiprows=3, usecols=[12], dtype=str, ndmin=1)
    d = np.loadtxt(path, skiprows=3, usecols=range(12), dtype=float, ndmin=2)
    if names.size != d.shape[0]:
        raise ValueError("Number of stations and data rows differ")
    keep = np.asarray([n not in set(blacklist) for n in names])
    names, d = names[keep], d[keep]

    comp_cols = {"east": (2, 6), "north": (3, 7), "up": (9, 11)}
    mm = 1e-3
    lons, lats = d[:, 0], d[:, 1]
    coords = np.zeros((names.size, 2))
    out = []
    for comp in components:
        vi, si = comp_cols[comp]
        ds = gnss_compound(f"gnss_{comp}", coords, d[:, vi] * mm, comp)
        ds.lats, ds.lons = lats, lons
        ds.stations = names.astype(str)
        ds.covariance = Covariance(
            data=np.diag(np.maximum(d[:, si] * mm, 1e-6) ** 2))
        out.append(ds)
    logger.info("Loaded %i GNSS stations (%s)", names.size, filename)
    return out


# ---------------------------------------------------------------------------
# Seismic
# ---------------------------------------------------------------------------


def load_obspy_traces(datadir: str, inventory_path: str | None = None,
                      channels=("Z", "N", "E"), water_level: float = 60.0):
    """
    Waveform import via obspy (reference ``load_obspy_data``
    ``beat/inputf.py:278-399``; gated on the obspy package): reads every
    file obspy recognises under ``datadir`` (mseed/SAC/…), merges
    segments, removes the instrument response to displacement when an
    inventory (StationXML) is given, and returns the
    ``prepare_local_traces`` input structures:

    ``traces``: dict station -> {channel: (tmin_epoch, dt, ydata)};
    ``stations``: dict station -> (lon, lat) (convert to local meters
    with :func:`beat_tpu_torch.heart.geodesy` helpers before preparation).
    """
    try:
        import obspy
    except ImportError as e:
        raise ImportError(
            "obspy is required for mseed import; use save/load of the native "
            "seismic npz format instead") from e

    stream = obspy.Stream()
    for fn in sorted(os.listdir(datadir)):
        fp = os.path.join(datadir, fn)
        if not os.path.isfile(fp):
            continue
        try:
            stream += obspy.read(fp)
        except Exception:
            logger.debug("Skipping non-waveform file %s", fn)
    stream.merge(method=1, fill_value="interpolate")

    inventory = None
    if inventory_path is not None:
        inventory = obspy.read_inventory(inventory_path)
        stream.remove_response(inventory=inventory, output="DISP",
                               water_level=water_level)

    traces = {}
    stations = {}
    for tr in stream:
        comp = tr.stats.channel[-1].upper()
        if comp not in channels:
            continue
        sta = tr.stats.station
        traces.setdefault(sta, {})[comp] = (
            float(tr.stats.starttime.timestamp), float(tr.stats.delta),
            np.asarray(tr.data, dtype=np.float64))
        if inventory is not None and sta not in stations:
            try:
                coords = inventory.get_coordinates(tr.id, tr.stats.starttime)
                stations[sta] = (coords["longitude"], coords["latitude"])
            except Exception:
                pass
    logger.info("Loaded %i stations from %s", len(traces), datadir)
    return traces, stations


def save_seismic_datasets(datasets, project_dir: str, datadir: str = "./") -> str:
    """Native seismic dataset persistence: raw traces on the table grid."""
    arrays = {}
    for ds in datasets:
        key = f"{ds.station}.{ds.channel}"
        arrays[f"{key}:ydata"] = ds.ydata
        arrays[f"{key}:coords"] = np.array([ds.east, ds.north])
    outdir = os.path.join(project_dir, datadir)
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "seismic_data.npz")
    np.savez_compressed(path, **arrays)
    return path


def load_arrivals_csv(path: str) -> dict:
    """
    Picked phase-arrival times: CSV lines ``station,time_s`` (seconds
    after origin; optional header) → {station: time}.  The native
    analogue of the reference's picked marker files
    (``arrivals_marker_path``, ``config.py:540`` + ``heart.py:2532``).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"No arrivals file at {path}")
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [p.strip() for p in line.split(",")]
            try:
                out[parts[0]] = float(parts[1])
            except (IndexError, ValueError):
                continue  # header or malformed line
    if not out:
        raise ValueError(f"No parsable 'station,time_s' rows in {path}")
    return out


def load_seismic_datasets(project_dir: str, datadir: str = "./") -> list:
    from beat_tpu_torch.heart.seismic import SeismicDataset

    path = os.path.join(project_dir, datadir, "seismic_data.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No seismic data at {path}")
    out = []
    with np.load(path) as z:
        keys = sorted({k.split(":")[0] for k in z.files})
        for key in keys:
            station, channel = key.rsplit(".", 1)
            coords = z[f"{key}:coords"]
            out.append(SeismicDataset(
                station=station, channel=channel,
                east=float(coords[0]), north=float(coords[1]),
                ydata=z[f"{key}:ydata"]))
    return out


# ---------------------------------------------------------------------------
# GCMT catalog (NDK files)
# ---------------------------------------------------------------------------


def read_gcmt_ndk(path: str) -> list:
    """
    Parse a GlobalCMT NDK file (5 lines per event) into event dicts —
    the zero-egress analogue of the reference's on-line GCMT catalog
    search at ``beat init`` (``beat/apps/beat.py:341`` pyrocko
    ``backend_catalog``).

    Returns per event: ``name, date, time_s (within day), lat, lon,
    depth [m], magnitude (Mw from the scalar moment), m6`` — the tensor
    rotated from Harvard USE (r=up, t=south, p=east) to NED
    ``(mnn, mee, mdd, mne, mnd, med)`` and normalised to unit Frobenius/√2.
    """
    events = []
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    if len(lines) % 5:
        raise ValueError(f"{path}: NDK files hold 5 lines per event, "
                         f"got {len(lines)} lines")
    for i in range(0, len(lines), 5):
        l1, l2, _, l4, l5 = lines[i:i + 5]
        date = l1[5:15].strip()
        hh, mm, ss = l1[16:26].strip().split(":")
        fields4 = l4.split()
        exponent = int(fields4[0])
        # value/std pairs: Mrr Mtt Mpp Mrt Mrp Mtp
        mrr, mtt, mpp, mrt, mrp, mtp = (float(v) for v in fields4[1::2])
        # Harvard USE -> NED (Aki & Richards): nn=tt ee=pp dd=rr
        # ne=-tp nd=rt ed=-rp
        m6 = np.array([mtt, mpp, mrr, -mtp, mrt, -mrp])
        norm = np.sqrt(np.sum(m6[:3] ** 2) + 2 * np.sum(m6[3:] ** 2)) / np.sqrt(2)
        sc_mom = float(l5.split()[-7]) * 10.0 ** exponent   # dyne-cm
        m0 = sc_mom * 1e-7                                  # N m
        events.append({
            "name": l2[:16].strip(),
            "date": date.replace("/", "-"),
            "time_s": int(hh) * 3600 + int(mm) * 60 + float(ss),
            "lat": float(l1[27:33]),
            "lon": float(l1[34:41]),
            "depth": float(l1[42:47]) * 1e3,
            "magnitude": 2.0 / 3.0 * (np.log10(max(m0, 1.0)) - 9.1),
            "m6": m6 / max(norm, 1e-30),
        })
    return events


def select_gcmt_event(events: list, name: str | None = None,
                      date: str | None = None) -> dict:
    """Pick one event by (partial) name or date string."""
    if name:
        hits = [e for e in events if name.lower() in e["name"].lower()]
    elif date:
        hits = [e for e in events if e["date"].startswith(date)]
    else:
        hits = events
    if not hits:
        raise ValueError(f"No NDK event matches name={name!r} date={date!r}; "
                         f"available: {[e['name'] for e in events[:10]]}")
    if len(hits) > 1:
        logger.warning("%i NDK events match — taking the first (%s)",
                       len(hits), hits[0]["name"])
    return hits[0]
