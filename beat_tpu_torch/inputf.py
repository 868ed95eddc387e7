"""
The native seismic data files of a project (copied from
``beat_tpu/inputf.py``, trimmed to what the config path calls).

``seismic_data.npz`` holds, for each ``<station>.<channel>``, the raw
trace on the GF table's time grid (``:ydata``) and the station's local
(east, north) position [m] (``:coords``) — the JAX package's format, so
either package reads the other's projects.  A picked-arrivals file is
CSV lines ``station,time_s`` (seconds after origin; a header and ``#``
comments are skipped).
"""

from __future__ import annotations

import os

import numpy as np


def save_seismic_datasets(datasets, project_dir: str, datadir: str = "./") -> str:
    """Write ``<project_dir>/<datadir>/seismic_data.npz``; returns its path."""
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
    """Picked phase-arrival times ``{station: time [s after origin]}``."""
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
    """The traces of ``seismic_data.npz`` as ``SeismicDataset``s, sorted
    by ``station.channel``."""
    from beat_tpu_torch.heart.seismic import SeismicDataset

    path = os.path.join(project_dir, datadir, "seismic_data.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No seismic data at {path}")
    out = []
    with np.load(path) as z:
        for key in sorted({k.split(":")[0] for k in z.files}):
            station, channel = key.rsplit(".", 1)
            coords = z[f"{key}:coords"]
            out.append(SeismicDataset(station=station, channel=channel, east=float(coords[0]),
                                      north=float(coords[1]), ydata=z[f"{key}:ydata"]))
    return out
