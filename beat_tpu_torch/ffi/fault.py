"""
Fault geometry: subfault container, uniform patch discretization and
patch-index bookkeeping (port of ``beat_tpu/ffi/fault.py``).

Subfaults are extended :class:`beat_tpu_torch.sources.RectangularSource`
planes split into regular patch grids; slip parameter vectors
concatenate per-subfault blocks in strike-fastest patch order.  The
geometry is host numpy; :meth:`FaultGeometry.point2starttimes` runs on
the device of its arguments, batched over chains.

Also here: the patch sources of a slip solution (``point2sources``),
the interseismic-coupling helpers (``euler_pole2slips``,
``backslip2coupling``) and the PSCMP fault-file writer
(:func:`write_fault_to_pscmp`).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from beat_tpu_torch.ffi.laplacian import (
    get_smoothing_operator_correlated,
    get_smoothing_operator_nearest_neighbor,
)
from beat_tpu_torch.ops.eikonal import eikonal_rupture_times
from beat_tpu_torch.sources import RectangularSource, moment_to_magnitude

logger = logging.getLogger("beat_tpu_torch.ffi.fault")

KM = 1000.0


@dataclass
class SubfaultGrid:
    """One subfault plane with its regular patch grid."""

    plane: RectangularSource
    n_strike: int
    n_dip: int
    patches: list = field(default_factory=list)

    @property
    def npatches(self) -> int:
        return self.n_strike * self.n_dip

    @property
    def patch_length(self) -> float:
        return self.plane.length / self.n_strike

    @property
    def patch_width(self) -> float:
        return self.plane.width / self.n_dip

    def patch_centers_local(self) -> np.ndarray:
        """(npatches, 2) centers in fault-plane coordinates
        (along-strike, down-dip) [m], strike-fastest ordering."""
        s = (np.arange(self.n_strike) + 0.5) * self.patch_length
        d = (np.arange(self.n_dip) + 0.5) * self.patch_width
        ss, dd = np.meshgrid(s, d)
        return np.column_stack([ss.ravel(), dd.ravel()])

    def patch_centers_enz(self) -> np.ndarray:
        """(npatches, 3) centers in (east, north, depth) [m]."""
        return np.stack([np.asarray(p.center()) for p in self.patches])


class FaultOrdering:
    """Slip-vector layout over subfaults: patch index blocks per subfault
    and flattened slices for each slip variable."""

    def __init__(self, npatches_per_subfault):
        self.npatches_list = list(npatches_per_subfault)
        self.slices = []
        start = 0
        for n in self.npatches_list:
            self.slices.append(slice(start, start + n))
            start += n
        self.npatches = start

    def vector2subfault(self, index, vector):
        return vector[..., self.slices[index]]


@dataclass
class FaultGeometry:
    """Container of subfault grids with slip-variable bookkeeping: patch
    geometry is shared between datatypes, and the GF libraries carry
    the datatype specifics."""

    subfaults: list  # of SubfaultGrid
    components: list = field(default_factory=lambda: ["uparr"])

    @property
    def nsubfaults(self) -> int:
        return len(self.subfaults)

    @property
    def npatches(self) -> int:
        return sum(sf.npatches for sf in self.subfaults)

    @property
    def ordering(self) -> FaultOrdering:
        return FaultOrdering([sf.npatches for sf in self.subfaults])

    def get_all_patches(self) -> list:
        out = []
        for sf in self.subfaults:
            out.extend(sf.patches)
        return out

    def get_subfault(self, index) -> SubfaultGrid:
        return self.subfaults[index]

    # -- slip/moment --------------------------------------------------------

    def patch_areas(self) -> np.ndarray:
        """Per-patch areas; an irregular (resolution-discretized) subfault
        has patches of their own sizes."""
        return np.concatenate([np.full(sf.npatches, sf.patch_length * sf.patch_width)
                               if hasattr(sf, "patch_length")
                               else np.array([p.length * p.width for p in sf.patches])
                               for sf in self.subfaults])

    def moment(self, slips: np.ndarray, shear_modulus: float = 33e9) -> float:
        """Σ µ·A·s."""
        return float(np.sum(shear_modulus * self.patch_areas() * np.abs(slips)))

    def magnitude(self, slips: np.ndarray, shear_modulus: float = 33e9) -> float:
        return float(moment_to_magnitude(self.moment(slips, shear_modulus)))

    # -- kinematics ---------------------------------------------------------

    def point2starttimes(self, index: int, velocities: torch.Tensor,
                         nucleation_strike: torch.Tensor, nucleation_dip: torch.Tensor,
                         time=0.0) -> torch.Tensor:
        """
        Rupture-onset times of subfault ``index`` for a batch of chains:
        velocities (C, npatches) [m/s], nucleation point (C,) [m along
        strike/dip], ``time`` a float or (C,) [s].  Returns
        (C, npatches) times in strike-fastest order.
        """
        sf = self.subfaults[index]
        n_chains = velocities.shape[0]
        slowness = 1.0 / velocities.reshape(n_chains, sf.n_dip, sf.n_strike)
        # nucleation coordinates -> nearest patch index (round half to even,
        # as jnp.round does)
        nuc_s = torch.clamp(torch.round(nucleation_strike / sf.patch_length - 0.5),
                            0, sf.n_strike - 1).long()
        nuc_d = torch.clamp(torch.round(nucleation_dip / sf.patch_width - 0.5),
                            0, sf.n_dip - 1).long()
        # patch sizes may differ along strike/dip; the solver takes the
        # geometric-mean cell size (grids are near-square in practice)
        patch_size = float(np.sqrt(sf.patch_length * sf.patch_width))
        times = eikonal_rupture_times(slowness, patch_size, nuc_d, nuc_s)
        times = times.reshape(n_chains, -1)
        if torch.is_tensor(time):
            return times + time.reshape(n_chains, 1)
        return times + time

    def point2sources(self, point: dict, index: int = 0) -> list:
        """The patches of subfault ``index`` as RectangularSources with the
        slip and rake of a result point's ``uparr``/``uperp``/``utens``
        (host values, no chain axis; missing components are 0)."""
        sf = self.subfaults[index]
        slc = self.ordering.slices[index]
        zeros = np.zeros(self.npatches)
        uparr, uperp, utens = (np.asarray(point.get(c, zeros))[slc]
                               for c in ("uparr", "uperp", "utens"))
        slips = np.sqrt(uparr**2 + uperp**2)
        rakes = sf.plane.rake + np.rad2deg(np.arctan2(uperp, np.where(slips > 0, uparr, 1.0)))
        sources = []
        for i, patch in enumerate(sf.patches):
            total = np.sqrt(slips[i] ** 2 + utens[i] ** 2)
            sources.append(RectangularSource(
                east_shift=patch.east_shift, north_shift=patch.north_shift, depth=patch.depth,
                strike=patch.strike, dip=patch.dip, rake=float(rakes[i]), length=patch.length,
                width=patch.width, slip=float(total),
                opening_fraction=float(utens[i] / total) if total > 0 else 0.0,
                anchor=patch.anchor))
        return sources

    # -- interseismic coupling ----------------------------------------------

    def euler_pole2slips(self, pole_lat, pole_lon, omega, event_lat=0.0, event_lon=0.0,
                         index: int = 0) -> np.ndarray:
        """Long-term back-slip rates [m/yr] (npatches,) of subfault
        ``index`` from a rigid plate rotation about an Euler pole: the pole
        velocity at each patch center projected on the patch rake."""
        from beat_tpu_torch.heart.corrections import velocities_from_pole

        sf = self.subfaults[index]
        centers = sf.patch_centers_enz()
        d2r, r_earth = np.pi / 180.0, 6371e3
        lats = event_lat + centers[:, 1] / (d2r * r_earth)
        lons = event_lon + centers[:, 0] / (d2r * r_earth * np.cos(event_lat * d2r))
        v_neu = velocities_from_pole(lats, lons, torch.tensor(float(pole_lat), dtype=torch.float64),
                                     float(pole_lon), float(omega)).numpy()
        # Aki & Richards rake: positive sin(rake) moves the hanging wall up
        # dip, so the dip-slip horizontal component points against the
        # down-dip vector (the Okada U2 and uperp = rake + 90° conventions)
        st, ra = np.deg2rad(sf.plane.strike), np.deg2rad(sf.plane.rake)
        s_vec = np.array([np.sin(st), np.cos(st)])
        down_dip = np.array([np.cos(st), -np.sin(st)]) * np.cos(np.deg2rad(sf.plane.dip))
        rake_dir = np.cos(ra) * s_vec - np.sin(ra) * down_dip
        rake_dir = rake_dir / max(np.linalg.norm(rake_dir), 1e-12)
        return np.stack([v_neu[:, 1], v_neu[:, 0]], axis=-1) @ rake_dir

    @staticmethod
    def backslip2coupling(backslip_rates, interseismic_slips) -> torch.Tensor:
        """Coupling [%] = interseismic slip-deficit rate / long-term plate
        rate per patch, clipped to [0, 100]; tensors of any leading shape."""
        backslip_rates = torch.as_tensor(backslip_rates)
        interseismic_slips = torch.as_tensor(interseismic_slips, dtype=backslip_rates.dtype,
                                             device=backslip_rates.device)
        denom = torch.clamp(backslip_rates.abs(), min=1e-12)
        return torch.clamp(interseismic_slips.abs() / denom, 0.0, 1.0) * 100.0

    # -- regularisation -----------------------------------------------------

    def get_smoothing_operator(self, correlation_function="nearest_neighbor") -> np.ndarray:
        """Block-diagonal over subfaults.  An irregular (resolution-
        discretized) subfault has no strike/dip grid and takes the
        gaussian distance-correlated operator for 'nearest_neighbor'."""
        import scipy.linalg

        blocks = []
        for sf in self.subfaults:
            if correlation_function == "nearest_neighbor" and not hasattr(sf, "n_strike"):
                logger.info("nearest_neighbor smoothing needs a regular grid; using the "
                            "gaussian-correlated operator for the irregular subfault")
                blocks.append(get_smoothing_operator_correlated(sf.patch_centers_enz() / KM,
                                                                "gaussian"))
            elif correlation_function == "nearest_neighbor":
                blocks.append(get_smoothing_operator_nearest_neighbor(
                    sf.n_strike, sf.n_dip, sf.patch_length / KM, sf.patch_width / KM))
            else:
                blocks.append(get_smoothing_operator_correlated(
                    sf.patch_centers_enz() / KM, correlation_function))
        return scipy.linalg.block_diag(*blocks)


_PSCMP_HEADER = """\
# beat_tpu complex fault geometry
# for use with PSCMP from Wang et al. 2008
#-----------------------------------------
#===============================================================================
# RECTANGULAR SUBFAULTS: n, lat0, lon0 then per subfault
#   n  O_lat  O_lon  O_depth[km]  length[km]  width[km]  strike  dip  np_st  np_di  start_time[day]
# followed by one line per patch:
#   pos_s[km]  pos_d[km]  slip_along_strike[m]  slip_along_dip[m]  opening[m]
#===============================================================================
"""

_DEG_PER_M = 1.0 / 111194.9  # spherical-earth metres -> degrees latitude


def write_fault_to_pscmp(filename: str, fault: FaultGeometry, point: dict, lat0: float = 0.0,
                         lon0: float = 0.0, force: bool = False) -> str:
    """Write the discretized fault and a slip solution in PSCMP's
    rectangular-subfault ascii format (Wang et al. 2008), the same file
    as the JAX package writes.  ``point`` holds ``uparr`` (along strike)
    and optionally ``uperp`` (down dip) and ``utens`` (opening); lat0,
    lon0 is the geographic reference of the local origin."""
    if os.path.exists(filename) and not force:
        raise IOError(f"File {filename} exists — pass force=True to overwrite")
    uparr = np.asarray(point["uparr"], dtype=float)
    uperp = np.asarray(point.get("uperp", np.zeros_like(uparr)), dtype=float)
    utens = np.asarray(point.get("utens", np.zeros_like(uparr)), dtype=float)

    lines = [_PSCMP_HEADER, f"{fault.nsubfaults}  {lat0:.6f}  {lon0:.6f}\n"]
    for i in range(fault.nsubfaults):
        sf = fault.get_subfault(i)
        plane = sf.plane
        # top-center anchor -> upper-left (strike-start) corner
        sv = plane.strikevector
        ul_e = plane.east_shift - sv[0] * plane.length / 2.0
        ul_n = plane.north_shift - sv[1] * plane.length / 2.0
        ul_lat = lat0 + ul_n * _DEG_PER_M
        ul_lon = lon0 + ul_e * _DEG_PER_M / max(np.cos(np.deg2rad(lat0)), 1e-12)
        lines.append(f"{i + 1}  {ul_lat:.6f}  {ul_lon:.6f}  {plane.depth / 1e3:.4f}  "
                     f"{plane.length / 1e3:.4f}  {plane.width / 1e3:.4f}  "
                     f"{plane.strike:.2f}  {plane.dip:.2f}  {sf.n_strike}  {sf.n_dip}  0.0\n")
        slc = fault.ordering.slices[i]
        for (pos_s, pos_d), us, ud, op in zip(sf.patch_centers_local() / 1e3, uparr[slc],
                                              uperp[slc], utens[slc]):
            lines.append(f"  {pos_s:.4f}  {pos_d:.4f}  {us:.5f}  {ud:.5f}  {op:.5f}\n")
    with open(filename, "w") as f:
        f.writelines(lines)
    logger.info("Wrote PSCMP fault geometry to %s", filename)
    return filename


def extend_plane(source: RectangularSource, extension_width: float = 0.1,
                 extension_length: float = 0.1) -> RectangularSource:
    """Extend a reference source's plane symmetrically by the given
    fractions, clipped at the surface."""
    dl = source.length * extension_length
    dw = source.width * extension_width
    new_length = source.length + 2 * dl
    di = np.deg2rad(source.dip)
    st = np.deg2rad(source.strike)
    # shift top edge up-dip by dw (clip at surface)
    up_dip = min(dw, source.depth / max(np.sin(di), 1e-6))
    t_e, t_n = np.cos(st), -np.sin(st)
    return RectangularSource(
        east_shift=source.east_shift - up_dip * np.cos(di) * t_e,
        north_shift=source.north_shift - up_dip * np.cos(di) * t_n,
        depth=source.depth - up_dip * np.sin(di),
        time=source.time,
        strike=source.strike, dip=source.dip, rake=source.rake,
        length=new_length, width=up_dip + source.width + dw,
        slip=source.slip, anchor="top", velocity=source.velocity)


def discretize_sources(reference_sources, patch_length: float, patch_width: float,
                       extension_width: float = 0.0, extension_length: float = 0.0,
                       components=("uparr",)) -> FaultGeometry:
    """Uniform discretization of reference sources into a FaultGeometry.
    Patch sizes in [m]; planes are snapped to an integer patch count."""
    subfaults = []
    for src in reference_sources:
        plane = extend_plane(src, extension_width, extension_length) \
            if (extension_width or extension_length) else src
        n_strike = max(1, int(round(plane.length / patch_length)))
        n_dip = max(1, int(round(plane.width / patch_width)))
        sf = SubfaultGrid(plane=plane, n_strike=n_strike, n_dip=n_dip)
        sf.patches = plane.patches(n_strike, n_dip)
        subfaults.append(sf)
        logger.info("Subfault: %i x %i patches (%.1f x %.1f km)",
                    n_strike, n_dip, sf.patch_length / KM, sf.patch_width / KM)
    return FaultGeometry(subfaults=subfaults, components=list(components))
