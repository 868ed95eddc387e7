"""
Dataset noise covariances and the seed proposal covariance (copied from
``beat_tpu/covariance.py``, trimmed to what the port calls): waveform and
geodetic noise analysers, the non-Toeplitz estimates in one and two
dimensions, and the prediction covariances of earth-model ensembles.

Host numpy, float64: the products the likelihood consumes on the device
are each dataset's inverse-Cholesky weight matrix and log-determinant.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch

from beat_tpu_torch.utility import ensure_cov_psd, running_window_rms

logger = logging.getLogger("beat_tpu_torch.covariance")


def log_determinant(A: np.ndarray) -> float:
    """Log determinant via Cholesky."""
    chol = scipy.linalg.cholesky(A, lower=True)
    return 2.0 * np.sum(np.log(np.diag(chol)))


def chol_inverse(C: np.ndarray) -> np.ndarray:
    """Inverse of the lower Cholesky factor of ``C`` — the weight matrix
    ``W`` with ``W C Wᵀ = I`` — with a PSD repair when ``C`` is not
    positive definite."""
    C = np.asarray(C, dtype=np.float64)
    try:
        L = scipy.linalg.cholesky(C, lower=True)
    except scipy.linalg.LinAlgError:
        logger.warning("Covariance not positive definite — QR/PSD-repair fallback")
        C = ensure_cov_psd(C)
        L = scipy.linalg.cholesky(C, lower=True)
    W = scipy.linalg.solve_triangular(L, np.eye(C.shape[0]), lower=True)
    if np.isnan(W).any() or np.isinf(W).any():
        raise ValueError("chol_inverse contains NaN/Inf")
    return W


@dataclass
class Covariance:
    """Dataset noise covariance split into data / prediction parts;
    ``total = data + pred_g + pred_v``."""

    data: np.ndarray | None = None
    pred_g: np.ndarray | None = None
    pred_v: np.ndarray | None = None

    @property
    def p_total(self) -> np.ndarray:
        parts = [p for p in (self.data, self.pred_g, self.pred_v) if p is not None]
        if not parts:
            raise ValueError("Covariance has no parts set")
        total = np.zeros_like(parts[0])
        for p in parts:
            total = total + p
        return total

    @property
    def chol_inverse(self) -> np.ndarray:
        return chol_inverse(self.p_total)

    @property
    def log_pdet(self) -> float:
        return log_determinant(ensure_cov_psd(self.p_total))


def exponential_data_covariance(n: int, dt: float, tzero: float) -> np.ndarray:
    """C_ij = exp(-|i-j|·dt/tzero)."""
    idx = np.arange(n)
    return np.exp(-np.abs(idx[:, None] - idx[None, :]) * dt / tzero)


def identity_data_covariance(n: int, dt: float = 0.0, tzero: float = 0.0) -> np.ndarray:
    return np.eye(n)


def ones_data_covariance(n: int, dt: float = 0.0, tzero: float = 0.0) -> np.ndarray:
    return np.ones((n, n)) + np.eye(n) * 1e-6


#: the a-priori data-covariance structures by noise-structure name
#: (``beat_tpu/covariance.py:117-123``); the residual-based ones start
#: from the identity
noise_structure_catalog = {
    "exponential": exponential_data_covariance,
    "identity": identity_data_covariance,
    "import": identity_data_covariance,
    "ones": ones_data_covariance,
    "variance": identity_data_covariance,
    "non-toeplitz": identity_data_covariance,
}


def autocovariance(data: np.ndarray) -> np.ndarray:
    """Biased sample autocovariance of a 1-d series."""
    n = data.size
    centered = data - data.mean()
    return np.correlate(centered, centered, mode="full")[n - 1:] / n


def toeplitz_covariance(data: np.ndarray, window_size: int) -> tuple:
    """Symmetric Toeplitz covariance from the autocovariance of the
    RMS-normalised series, and the running-window RMS: ``(toeplitz, stds)``."""
    data = np.asarray(data, dtype=np.float64)
    stds = running_window_rms(data, window_size=window_size, mode="same")
    return scipy.linalg.toeplitz(autocovariance(data / stds)), stds


def non_toeplitz_covariance(data: np.ndarray, window_size: int) -> np.ndarray:
    """Non-stationary covariance (Dettmer et al. 2007): the Toeplitz
    autocovariance of the RMS-normalised series, scaled by the outer
    product of the running-window RMS."""
    toep, stds = toeplitz_covariance(data, window_size)
    return toep * np.outer(stds, stds)


def k_nearest_neighbor_rms(coords: np.ndarray, data: np.ndarray, k: int | None = None,
                           max_dist_perc: float | None = 0.2) -> np.ndarray:
    """Per-point RMS over neighbours: the ``k`` nearest, or all within
    ``max_dist_perc`` of the scene's extent (exactly one of the two)."""
    from scipy.spatial import cKDTree

    if (k is None) == (max_dist_perc is None):
        raise ValueError("Define either k or max_dist_perc (exactly one)")
    tree = cKDTree(coords)
    if k is not None:
        _, idxs = tree.query(coords, k=k)
        idxs = np.reshape(idxs, (data.size, -1))  # k=1 squeezes the axis
        return np.sqrt(np.mean(data[idxs] ** 2, axis=-1))
    rms = np.empty(data.size)
    radius = float(np.linalg.norm(coords.max(axis=0) - coords.min(axis=0))) * max_dist_perc
    for i, idxs in enumerate(tree.query_ball_point(coords, r=radius)):
        rms[i] = np.sqrt(np.mean(data[idxs] ** 2))
    return rms


def toeplitz_covariance_2d(coords: np.ndarray, data: np.ndarray,
                           max_dist_perc: float = 0.2) -> tuple:
    """The 2-d analogue of :func:`toeplitz_covariance`: the neighbourhood
    RMS in place of the running window, ``(toeplitz, stds)``."""
    stds = k_nearest_neighbor_rms(coords, data, max_dist_perc=max_dist_perc)
    return scipy.linalg.toeplitz(autocovariance(data / stds)), stds


def non_toeplitz_covariance_2d(coords: np.ndarray, data: np.ndarray,
                               max_dist_perc: float = 0.2) -> np.ndarray:
    """Spatial non-stationary covariance of an InSAR scene."""
    toep, stds = toeplitz_covariance_2d(coords, data, max_dist_perc)
    return ensure_cov_psd(toep * np.outer(stds, stds))


@dataclass
class SeismicNoiseAnalyser:
    """Data covariance of waveform datasets.

    structure: 'variance' (pre-arrival window variance × identity),
    'exponential', 'import', 'non-toeplitz'."""

    structure: str = "variance"
    pre_arrival_time: float = 5.0

    def get_data_covariance(self, ydata: np.ndarray, dt: float,
                            arrival_index: int | None = None,
                            residual: np.ndarray | None = None,
                            noise: np.ndarray | None = None) -> np.ndarray:
        """Covariance over the samples of ``ydata`` (the fit window).
        ``noise``: the pre-arrival segment setting the variance level;
        without it the first ``arrival_index``/``pre_arrival_time``
        samples of ``ydata`` are used."""
        n = ydata.size
        if noise is None:
            cut = (arrival_index if arrival_index is not None
                   else max(2, int(self.pre_arrival_time / dt)))
            noise = ydata[:cut]
        var = float(np.var(noise)) if noise.size > 1 else float(np.var(ydata))
        var = max(var, 1e-30)
        if self.structure == "variance":
            return np.eye(n) * var
        elif self.structure == "exponential":
            return exponential_data_covariance(n, dt, tzero=max(dt * 4, 0.5)) * var
        elif self.structure == "non-toeplitz":
            res = residual if residual is not None else ydata
            return non_toeplitz_covariance(res, window_size=max(4, res.size // 5))
        elif self.structure == "import":
            return np.eye(n)
        raise ValueError(f"Unknown noise structure {self.structure}")


@dataclass
class GeodeticNoiseAnalyser:
    """Data covariance of geodetic datasets: 'import' (the imported
    matrix, or the data variance × identity without one) or
    'non-toeplitz' (of the residuals)."""

    structure: str = "import"
    max_dist_perc: float = 0.2

    def get_data_covariance(self, coords: np.ndarray, displacement: np.ndarray,
                            imported: np.ndarray | None = None,
                            residual: np.ndarray | None = None) -> np.ndarray:
        n = displacement.size
        if self.structure == "import":
            if imported is None:
                return np.eye(n) * max(float(np.var(displacement)), 1e-30)
            return imported
        elif self.structure == "non-toeplitz":
            res = residual if residual is not None else displacement
            return non_toeplitz_covariance_2d(coords, res, self.max_dist_perc)
        raise ValueError(f"Unknown noise structure {self.structure}")


def init_proposal_covariance(priors_lower: np.ndarray, priors_upper: np.ndarray,
                             scale: float = 1.0) -> np.ndarray:
    """Diagonal seed proposal covariance from prior widths."""
    widths = (priors_upper - priors_lower) / scale
    widths = np.where(widths <= 0, 1e-12, widths)
    return np.diag((widths / 6.0) ** 2)


def calc_sample_covariance(population: np.ndarray, likelihoods: np.ndarray,
                           beta: float, prev_beta: float = 0.0) -> np.ndarray:
    """Tempered importance-weighted sample covariance of a population,
    PSD-repaired: weights ``exp((β − β_prev)·(llk − max llk))``."""
    weights = np.exp((beta - prev_beta) * (likelihoods - likelihoods.max()))
    cov = np.cov(population, aweights=weights / weights.sum(), rowvar=False, bias=False)
    cov = ensure_cov_psd(np.atleast_2d(cov))
    if np.isnan(cov).any() or np.isinf(cov).any():
        raise ValueError("Sample covariance contains NaN/Inf")
    return cov


def prediction_covariance_from_ensemble(predictions: np.ndarray) -> np.ndarray:
    """Sample covariance (PSD-repaired) of forward-model predictions over
    an ensemble of earth models: ``Covariance.pred_v``.

    predictions : (n_models, nsamples) synthetic data per ensemble member."""
    predictions = np.asarray(predictions, dtype=np.float64)
    if predictions.shape[0] < 2:
        raise ValueError("need >= 2 ensemble members for a prediction covariance")
    return ensure_cov_psd(np.cov(predictions, rowvar=False, bias=False))


def seismic_cov_velocity_models(composite, point: dict, ensemble_tables,
                                wmap_idx: int = 0) -> list:
    """Per-dataset prediction covariances of one wavemap from an ensemble
    of GF tables (velocity-model variations): the fit-space synthetics at
    ``point`` (one chain) through each table, with the reference model's
    fit windows.  Returns one (nsamples_fit, nsamples_fit) matrix per
    dataset."""
    wmap = composite.wavemaps[wmap_idx]
    data = composite.device_data()
    preds = []
    for table in ensemble_tables:
        # swap only the table-dependent entries of this wavemap's data
        ICw, ISw = table.windowed_ibasis(wmap.window_starts, wmap.taper_window,
                                         wmap.nsamples_win)
        swapped = list(data)
        swapped[wmap_idx] = dict(data[wmap_idx], table=table, win_basis_c=ICw, win_basis_s=ISw)
        preds.append(composite.synthetics_fit(point, wmap_idx, swapped)[0]
                     .detach().cpu().numpy())
    preds = np.stack(preds)                 # (n_models, ntargets, nsamples_fit)
    return [prediction_covariance_from_ensemble(preds[:, i]) for i in range(preds.shape[1])]


def geodetic_cov_velocity_models(composite, point: dict, nus=(0.2, 0.25, 0.3),
                                 ensemble_tables=None) -> list:
    """Per-dataset prediction covariances of a geodetic geometry composite
    from earth-model variations: the LOS synthetics at ``point`` (one
    chain) through each of ``ensemble_tables`` (static GF tables), or,
    without tables, with each Poisson ratio of ``nus`` on the analytic
    halfspace.  Returns one matrix per dataset."""
    batched = composite.batch_of_one(point)
    data = composite.device_data()
    preds = []
    with torch.no_grad():
        if ensemble_tables:
            for table in ensemble_tables:
                preds.append(composite.synthetics_los(batched, dict(data, static_table=table))[0]
                             .double().cpu().numpy())
        else:
            base_nu = composite.nu
            try:
                for nu in nus:
                    composite.nu = float(nu)
                    preds.append(composite.synthetics_los(batched, data)[0]
                                 .double().cpu().numpy())
            finally:
                composite.nu = base_nu
    preds = np.stack(preds)
    return [prediction_covariance_from_ensemble(preds[:, slc]) for slc in composite.stack.slices]
