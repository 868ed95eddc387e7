"""
Fault geometry: subfault container, uniform patch discretization and
patch-index bookkeeping (port of ``beat_tpu/ffi/fault.py``).

Subfaults are extended :class:`beat_tpu_torch.sources.RectangularSource`
planes split into regular patch grids; slip parameter vectors
concatenate per-subfault blocks in strike-fastest patch order.  The
geometry is host numpy; :meth:`FaultGeometry.point2starttimes` runs on
the device of its arguments, batched over chains.

The interseismic-coupling helpers (``euler_pole2slips``,
``backslip2coupling``), ``point2sources`` and the PSCMP writer have no
caller on the kinematic path and wait for a later slice (ROADMAP: the
``fault.py`` leftovers).
"""

from __future__ import annotations

import logging
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
        return np.concatenate([np.full(sf.npatches, sf.patch_length * sf.patch_width)
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

    # -- regularisation -----------------------------------------------------

    def get_smoothing_operator(self, correlation_function="nearest_neighbor") -> np.ndarray:
        """Block-diagonal over subfaults."""
        import scipy.linalg

        blocks = []
        for sf in self.subfaults:
            if correlation_function == "nearest_neighbor":
                blocks.append(get_smoothing_operator_nearest_neighbor(
                    sf.n_strike, sf.n_dip, sf.patch_length / KM, sf.patch_width / KM))
            else:
                blocks.append(get_smoothing_operator_correlated(
                    sf.patch_centers_enz() / KM, correlation_function))
        return scipy.linalg.block_diag(*blocks)


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
