"""
Resolution-based fault discretization (Atzori & Antonioli 2011; Atzori
et al. 2019), ported from ``beat_tpu/ffi/discretization.py``.

Starting from coarse patches, the patches that the data can resolve —
judged by the diagonal of the model resolution matrix

    R = (GᵀG + ε²·LᵀL)⁻¹ GᵀG

— are divided, generation after generation, until no candidates remain.
Each generation builds G with one batched Okada call over its patches on
the given device, in the port's analytic-forward dtype (float64: the
patch divisions are thresholds on R, and a float32 G would move them
with the device's rounding); the solve and the ranking are host numpy.

Only static (geodetic) data participates, as in the reference
(``SeismicLinearGFConfig`` forbids resolution discretization,
``config.py:530-533``).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

import torch

from beat_tpu_torch.device import resolve
from beat_tpu_torch.ffi.fault import FaultGeometry
from beat_tpu_torch.ffi.laplacian import get_smoothing_operator_correlated
from beat_tpu_torch.sources import RectangularSource
from beat_tpu_torch.utility import find_elbow

logger = logging.getLogger("beat_tpu_torch.ffi.discretization")

KM = 1000.0


@dataclass
class ResolutionDiscretizationConfig:
    """Reference ``ResolutionDiscretizationConfig`` (``config.py:396-464``).
    Lengths in [m] here (SI device layer)."""

    epsilon: float = 0.005
    epsilon_search_runs: int = 6
    resolution_thresh: float = 0.999
    depth_penalty: float = 3.5
    alpha: float = 0.3
    patch_widths_min: float = 1e3
    patch_widths_max: float = 8e3
    patch_lengths_min: float = 1e3
    patch_lengths_max: float = 8e3


@dataclass
class IrregularSubfault:
    """Subfault with an irregular patch list (resolution mode)."""

    plane: RectangularSource
    patches: list = field(default_factory=list)

    @property
    def npatches(self) -> int:
        return len(self.patches)

    def patch_centers_enz(self) -> np.ndarray:
        return np.stack([np.asarray(p.center()) for p in self.patches])

    def patch_centers_local(self) -> np.ndarray:
        """(npatches, 2) centers in fault-plane (along-strike, down-dip)
        coordinates [m] from the plane's left-top corner — same
        convention as ``SubfaultGrid.patch_centers_local`` (the plane is
        anchored top-center, so along-strike adds length/2)."""
        p = self.plane
        st, di = np.deg2rad(p.strike), np.deg2rad(p.dip)
        s_vec = np.array([np.sin(st), np.cos(st), 0.0])
        d_vec = np.array([np.cos(di) * np.cos(st),
                          -np.cos(di) * np.sin(st), np.sin(di)])
        rel = self.patch_centers_enz() - np.array(
            [p.east_shift, p.north_shift, p.depth])
        return np.column_stack([rel @ s_vec + p.length / 2.0, rel @ d_vec])


def _divide_patch(patch: RectangularSource) -> list:
    """Split a patch in two along its longer dimension (reference
    division semantics, ``get_division_mapping`` ``ffi/fault.py:1386``)."""
    st = np.deg2rad(patch.strike)
    di = np.deg2rad(patch.dip)
    s_vec = np.array([np.sin(st), np.cos(st)])
    t_vec = np.array([np.cos(st), -np.sin(st)])
    kwargs = dict(strike=patch.strike, dip=patch.dip, rake=patch.rake,
                  slip=patch.slip, anchor="top", velocity=patch.velocity,
                  time=patch.time,
                  opening_fraction=patch.opening_fraction)
    if patch.length >= patch.width:
        half = patch.length / 2.0
        out = []
        for k in (-0.5, 0.5):
            out.append(RectangularSource(
                east_shift=patch.east_shift + k * half * s_vec[0],
                north_shift=patch.north_shift + k * half * s_vec[1],
                depth=patch.depth, length=half, width=patch.width, **kwargs))
        return out
    half = patch.width / 2.0
    down = half * np.cos(di)
    first = RectangularSource(
        east_shift=patch.east_shift, north_shift=patch.north_shift,
        depth=patch.depth, length=patch.length, width=half, **kwargs)
    second = RectangularSource(
        east_shift=patch.east_shift + down * t_vec[0],
        north_shift=patch.north_shift + down * t_vec[1],
        depth=patch.depth + half * np.sin(di),
        length=patch.length, width=half, **kwargs)
    return [first, second]


def _build_G(patches, coords, los, nu=0.25, *, device) -> np.ndarray:
    """(nsamples, npatches) LOS Green's matrix of unit rake slip, one
    batched Okada call over the patches on ``device`` in
    :data:`~beat_tpu_torch.heart.okada.FORWARD_DTYPE`."""
    from beat_tpu_torch.heart import okada

    dev, dtype = resolve(device), okada.FORWARD_DTYPE
    params = {a: torch.as_tensor([getattr(p, a) for p in patches], dtype=dtype, device=dev)
              for a in ("east_shift", "north_shift", "depth", "strike", "dip", "rake", "length",
                        "width")}
    with torch.no_grad():
        disp = okada.okada_surface_displacement(
            torch.as_tensor(np.asarray(coords), dtype=dtype, device=dev), **params,
            slip=1.0, nu=nu, anchor="top")
        cols = torch.sum(disp * torch.as_tensor(np.asarray(los), dtype=dtype, device=dev),
                         dim=-1)
    return cols.double().cpu().numpy().T


def model_resolution(G: np.ndarray, patch_coords_km: np.ndarray, epsilon: float) -> np.ndarray:
    """R = (GᵀG + ε²LᵀL)⁻¹GᵀG with gaussian-correlated smoothing
    (reference laplacian method, ``ffi/fault.py:1802-1816``)."""
    L = get_smoothing_operator_correlated(patch_coords_km, "gaussian")
    GtG = G.T @ G
    A = GtG + epsilon**2 * (L.T @ L)
    return np.linalg.solve(A, GtG)


def optimize_discretization(reference_source, coords, los,
                            config: ResolutionDiscretizationConfig | None = None,
                            nu: float = 0.25, max_generations: int = 12, *, device):
    """
    Iterative resolution-based discretization, G built on ``device``.
    Returns (FaultGeometry with an IrregularSubfault, diag(R), quality index).
    """
    config = config or ResolutionDiscretizationConfig()
    # start: coarse 2x-max patches (reference :1604-1611)
    start_l = min(2 * config.patch_lengths_max, reference_source.length)
    start_w = min(2 * config.patch_widths_max, reference_source.width)
    n_l = max(1, int(round(reference_source.length / start_l)))
    n_w = max(1, int(round(reference_source.width / start_w)))
    patches = reference_source.patches(n_l, n_w)

    data_coords = np.asarray(coords)
    bottom = reference_source.bottom_depth
    r_diag = np.ones(len(patches))

    for gen in range(max_generations):
        G = _build_G(patches, coords, los, nu, device=device)
        centers = np.stack([p.center() for p in patches])
        R = model_resolution(G, centers / KM, config.epsilon)
        r_diag = np.diag(R)

        sizes_l = np.array([p.length for p in patches])
        sizes_w = np.array([p.width for p in patches])
        at_min = (sizes_l <= config.patch_lengths_min * 1.5) & \
                 (sizes_w <= config.patch_widths_min * 1.5)
        too_big = (sizes_l > config.patch_lengths_max) | \
                  (sizes_w > config.patch_widths_max)
        resolved = r_diag > config.resolution_thresh
        candidates = np.where((resolved & ~at_min) | too_big)[0]
        if candidates.size == 0:
            logger.info("Resolution discretization converged after %i generations "
                        "(%i patches)", gen, len(patches))
            break

        # rank (reference :1884-1962): prefer large, shallow, data-close,
        # well-resolved-neighborhood patches
        areas = sizes_l[candidates] * sizes_w[candidates]
        depths = centers[candidates, 2]
        d_data = np.array([
            np.min(np.linalg.norm(data_coords - centers[c, :2], axis=1))
            for c in candidates]) + 1.0
        rank = (areas
                * np.exp(-config.depth_penalty * depths / max(bottom, 1.0))
                * (d_data.min() / d_data)
                * r_diag[candidates])
        order = candidates[np.argsort(rank)[::-1]]
        n_div = max(1, int(np.ceil(config.alpha * candidates.size)))
        # always divide too-big patches
        chosen = list(dict.fromkeys(
            list(np.where(too_big)[0]) + list(order[:n_div])))

        new_patches = []
        for i, p in enumerate(patches):
            if i in chosen:
                new_patches.extend(_divide_patch(p))
            else:
                new_patches.append(p)
        logger.info("Generation %i: %i -> %i patches (divided %i)",
                    gen, len(patches), len(new_patches), len(chosen))
        patches = new_patches

    if len(r_diag) != len(patches):
        # loop exited via max_generations right after a division:
        # recompute the resolution for the geometry actually returned
        G = _build_G(patches, coords, los, nu, device=device)
        centers = np.stack([p.center() for p in patches])
        r_diag = np.diag(model_resolution(G, centers / KM, config.epsilon))
    sf = IrregularSubfault(plane=reference_source, patches=patches)
    fault = FaultGeometry(subfaults=[sf], components=["uparr", "uperp"])
    quality = float(np.mean(r_diag))
    return fault, r_diag, quality


def normalized_resolution_spread(R: np.ndarray) -> float:
    """‖R − I‖_F / n (reference ``normalized_resolution_spread``
    ``ffi/fault.py:2047``)."""
    n = R.shape[0]
    return float(np.linalg.norm(R - np.eye(n)) / n)


def optimize_damping(reference_source, coords, los,
                     config: ResolutionDiscretizationConfig | None = None,
                     nu: float = 0.25, *, device):
    """
    ε sweep: run the discretization for ε…100ε (logspace), pick the elbow
    of (ε, normalized resolution spread) (reference ``optimize_damping``
    ``ffi/fault.py:2057-2204``).

    Returns (best_fault, best_epsilon, results list of dicts).
    """
    config = config or ResolutionDiscretizationConfig()
    epsilons = np.logspace(np.log10(config.epsilon),
                           np.log10(config.epsilon * 100.0),
                           config.epsilon_search_runs)
    results = []
    for eps in epsilons:
        c = ResolutionDiscretizationConfig(**{**config.__dict__, "epsilon": float(eps)})
        fault, r_diag, quality = optimize_discretization(
            reference_source, coords, los, c, nu, device=device)
        patches = fault.get_all_patches()
        G = _build_G(patches, coords, los, nu, device=device)
        centers = np.stack([p.center() for p in patches]) / KM
        R = model_resolution(G, centers, float(eps))
        spread = normalized_resolution_spread(R)
        results.append({"epsilon": float(eps), "fault": fault,
                        "spread": spread, "npatches": len(patches),
                        "quality": quality})
        logger.info("epsilon %.4g: %i patches, spread %.4g",
                    eps, len(patches), spread)

    curve = np.column_stack([[r["epsilon"] for r in results],
                             [r["spread"] for r in results]])
    best = find_elbow(curve)
    logger.info("Optimal damping epsilon = %.4g (%i patches)",
                results[best]["epsilon"], results[best]["npatches"])
    return results[best]["fault"], results[best]["epsilon"], results
