"""
Geodetic datasets: InSAR displacement maps (quadtree-subsampled) and GNSS
station compounds, with LOS projection and dataset concatenation (copied
from ``beat_tpu/heart/geodesy.py``; host numpy, it imports the port's
:class:`~beat_tpu_torch.covariance.Covariance`).

Coordinates are local Cartesian east/north metres relative to the event;
data vectors are flat arrays, so all datasets stack into single arrays
that the composites place on their device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from beat_tpu_torch.covariance import Covariance

KM = 1000.0
D2R = np.pi / 180.0
EARTH_RADIUS = 6371.0 * KM


@dataclass
class GeodeticDataset:
    """
    One geodetic observation set: N scalar displacement observations with
    per-observation look directions.

    los_vector rows are unit (E, N, U) look vectors; for GNSS components
    they are coordinate unit vectors; for InSAR the satellite
    line-of-sight.  ``odw`` = overlap data weights (quadtree leaf weights,
    reference ``DiffIFG.odw``), default 1.
    """

    name: str
    typ: str                      # 'SAR' | 'GNSS'
    coords: np.ndarray            # (N, 2) east, north [m]
    displacement: np.ndarray      # (N,) [m]
    los_vector: np.ndarray        # (N, 3) unit (E, N, U)
    odw: np.ndarray | None = None
    covariance: Covariance | None = None
    #: geographic station coords for plate-motion corrections
    lats: np.ndarray | None = None
    lons: np.ndarray | None = None
    #: per-observation station names (GNSS compounds) — used by the
    #: correction station white/blacklists
    stations: np.ndarray | None = None
    #: correction names applying to this dataset
    corrections: list = field(default_factory=list)
    #: acquisition epoch [s] after the event origin (None = co-seismic);
    #: with a viscoelastic GF table each dataset is synthesized at its
    #: own epoch (the psgrn/pscmp time axis, ref config.py:325-348)
    time: float | None = None
    #: per-observation polygon mask (True = inside a user-drawn kite
    #: polygon, i.e. the deforming region): masked points are EXCLUDED
    #: from plate-motion correction estimation (reference ``DiffIFG.mask``
    #: + ``get_data_mask`` ``heart.py:1434,1520``)
    mask: np.ndarray | None = None

    def __post_init__(self):
        n = self.samples
        if self.odw is None:
            self.odw = np.ones(n)
        if self.covariance is None:
            self.covariance = Covariance(data=np.eye(n) * max(float(np.var(self.displacement)), 1e-12))

    @property
    def samples(self) -> int:
        return int(self.displacement.size)

    def update_local_coords(self, event_lat: float, event_lon: float) -> None:
        """Project lat/lon to local east/north relative to the event
        (small-angle equirectangular, reference ``heart.py:1127``)."""
        if self.lats is None or self.lons is None:
            raise ValueError("dataset has no geographic coordinates")
        north = (self.lats - event_lat) * D2R * EARTH_RADIUS
        east = (self.lons - event_lon) * D2R * EARTH_RADIUS * np.cos(event_lat * D2R)
        self.coords = np.column_stack([east, north])


def local_offset(ref_lat: float, ref_lon: float, lat: float, lon: float):
    """(east, north) [m] of (lat, lon) relative to the reference point
    (same small-angle equirectangular as ``update_local_coords``)."""
    north = (lat - ref_lat) * D2R * EARTH_RADIUS
    east = (lon - ref_lon) * D2R * EARTH_RADIUS * np.cos(ref_lat * D2R)
    return float(east), float(north)


def diff_ifg(name, coords, displacement, incidence, heading, **kwargs) -> GeodeticDataset:
    """
    Build an InSAR dataset from incidence/heading angles [deg]
    (reference ``DiffIFG.update_los_vector`` semantics: LOS unit vector
    from satellite geometry).
    """
    los = los_vectors(np.asarray(displacement).size, incidence, heading)
    return GeodeticDataset(name=name, typ="SAR", coords=np.asarray(coords),
                           displacement=np.asarray(displacement),
                           los_vector=los, **kwargs)


def los_vectors(n: int, incidence, heading) -> np.ndarray:
    """(n, 3) unit (E, N, U) line-of-sight vectors of an InSAR geometry,
    incidence and heading [deg] scalars or (n,)."""
    inc = np.atleast_1d(np.asarray(incidence, dtype=float)) * D2R
    head = np.atleast_1d(np.asarray(heading, dtype=float)) * D2R
    if inc.size == 1:
        inc = np.full(n, inc[0])
    if head.size == 1:
        head = np.full(n, head[0])
    return np.column_stack([-np.sin(inc) * np.cos(head), np.sin(inc) * np.sin(head),
                            np.cos(inc)])


def gnss_compound(name, coords, displacement, component, **kwargs) -> GeodeticDataset:
    """GNSS displacement component dataset (reference
    ``GNSSCompoundComponent`` ``heart.py:1162``)."""
    unit = {"east": [1.0, 0.0, 0.0],
            "north": [0.0, 1.0, 0.0],
            "up": [0.0, 0.0, 1.0]}[component]
    n = np.asarray(displacement).size
    los = np.tile(np.asarray(unit), (n, 1))
    return GeodeticDataset(name=name, typ="GNSS", coords=np.asarray(coords),
                           displacement=np.asarray(displacement),
                           los_vector=los, **kwargs)


@dataclass
class DatasetStack:
    """
    All geodetic datasets concatenated into flat arrays for the on-device
    forward model (reference ``concatenate_datasets`` ``heart.py:3356`` +
    the shared-variable setup in ``models/geodetic.py:96-103``).
    """

    coords: np.ndarray        # (Ntot, 2)
    displacement: np.ndarray  # (Ntot,)
    los: np.ndarray           # (Ntot, 3)
    odw: np.ndarray           # (Ntot,)
    slices: list              # per-dataset slices into the stack
    datasets: list            # the source GeodeticDataset objects

    @classmethod
    def from_datasets(cls, datasets) -> "DatasetStack":
        slices, start = [], 0
        for ds in datasets:
            slices.append(slice(start, start + ds.samples))
            start += ds.samples
        return cls(
            coords=np.concatenate([ds.coords for ds in datasets], axis=0),
            displacement=np.concatenate([ds.displacement for ds in datasets]),
            los=np.concatenate([ds.los_vector for ds in datasets], axis=0),
            odw=np.concatenate([ds.odw for ds in datasets]),
            slices=slices,
            datasets=list(datasets),
        )

    @property
    def samples(self) -> int:
        return int(self.displacement.size)
