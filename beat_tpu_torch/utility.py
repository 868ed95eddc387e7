"""
Point/vector bijection, covariance PSD repair, windowed statistics, the
elbow of a curve, the km → m conversion of a point and the
finite-difference stencils (copied from ``beat_tpu/utility.py``, trimmed
to what the port calls).

:class:`Ordering` maps between named parameter dicts ("points") and one
flat vector, batched over leading axes; it slices numpy arrays and
torch tensors alike, so the samplers carry flat (chains, dim) tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VarSpec:
    """One named variable inside the flat vector."""

    name: str
    shape: tuple
    slc: slice


class Ordering:
    """Deterministic layout of named (possibly vector-valued) variables
    inside one flat parameter vector."""

    def __init__(self, names_shapes):
        self.vmap: list[VarSpec] = []
        idx = 0
        for name, shape in names_shapes:
            shape = tuple(int(s) for s in shape)
            size = int(np.prod(shape, dtype=int)) if shape else 1
            self.vmap.append(VarSpec(name, shape, slice(idx, idx + size)))
            idx += size
        self.size = idx
        self._by_name = {v.name: v for v in self.vmap}

    @property
    def names(self):
        return [v.name for v in self.vmap]

    def __getitem__(self, name) -> VarSpec:
        return self._by_name[name]

    def __contains__(self, name):
        return name in self._by_name

    def to_array(self, point: dict, dtype=None):
        """Map dict of named arrays -> flat vector (numpy)."""
        out = np.zeros(self.size, dtype=dtype or np.float64)
        for v in self.vmap:
            val = np.asarray(point[v.name], dtype=out.dtype)
            out[v.slc] = val.reshape(-1)
        return out

    def to_point(self, array) -> dict:
        """Map flat vector (with optional leading batch dims) -> dict."""
        point = {}
        for v in self.vmap:
            sl = array[..., v.slc]
            point[v.name] = sl.reshape(array.shape[:-1] + v.shape) if v.shape else sl[..., 0]
        return point


# ---------------------------------------------------------------------------
# Covariance PSD repair
# ---------------------------------------------------------------------------


def is_pos_def(m: np.ndarray) -> bool:
    try:
        np.linalg.cholesky(m)
        return True
    except np.linalg.LinAlgError:
        return False


def near_psd(x: np.ndarray, epsilon: float = 2.0 * np.finfo(float).eps) -> np.ndarray:
    """Nearest positive-semi-definite matrix by eigenvalue clipping on the
    correlation matrix (Higham-style)."""
    if min(x.shape) == 0:
        return x
    d = np.sqrt(np.clip(np.diag(x), epsilon, None))
    scaling = np.outer(d, d)
    corr = x / scaling
    vals, vecs = np.linalg.eigh((corr + corr.T) / 2.0)
    vals = np.clip(vals, epsilon, None)
    t = 1.0 / (vecs**2 @ vals)
    b = vecs * np.sqrt(np.outer(t, vals))
    corr_psd = b @ b.T
    np.fill_diagonal(corr_psd, 1.0)
    return corr_psd * scaling


def ensure_cov_psd(cov: np.ndarray) -> np.ndarray:
    """Return a PSD version of ``cov`` (identity-jitter then near_psd)."""
    cov = np.asarray(cov, dtype=np.float64)
    cov = (cov + cov.T) / 2.0
    if is_pos_def(cov):
        return cov
    jitter = 1e-10 * np.max(np.abs(np.diag(cov)), initial=1.0)
    for _ in range(8):
        if is_pos_def(cov + jitter * np.eye(cov.shape[0])):
            return cov + jitter * np.eye(cov.shape[0])
        jitter *= 10.0
    return near_psd(cov)


def running_window_rms(data: np.ndarray, window_size: int, mode: str = "valid") -> np.ndarray:
    """RMS of a sliding window."""
    data2 = np.power(np.asarray(data, dtype=np.float64), 2)
    window = np.ones(int(window_size)) / float(window_size)
    return np.sqrt(np.convolve(data2, window, mode))


def find_elbow(data: np.ndarray) -> int:
    """Index of the elbow of a monotone curve ``data`` (n, 2) of (x, y):
    the point farthest from the straight line between the endpoints."""
    data = np.asarray(data, dtype=np.float64)
    line = data[-1] - data[0]
    line = line / np.linalg.norm(line)
    rel = data - data[0]
    dists = np.linalg.norm(rel - np.outer(rel @ line, line), axis=1)
    return int(np.argmax(dists))


def adjust_point_units(point: dict, km_vars=("east_shift", "north_shift", "depth", "length",
                                             "width", "nucleation_strike",
                                             "nucleation_dip")) -> dict:
    """Convert km-valued geometry parameters to metres (the base name,
    trailing digits and underscores stripped, is looked up)."""
    out = {}
    for k, v in point.items():
        base = k.rstrip("0123456789_")
        out[k] = np.asarray(v) * 1000.0 if base in km_vars else v
    return out


#: central finite-difference stencils by order: coefficients of the
#: samples at offsets -n//2 .. n//2 steps, and the denominator
STENCILS = {
    3: {"coefficients": np.array([-1.0, 0.0, 1.0]), "denominator": 2.0},
    5: {"coefficients": np.array([1.0, -8.0, 0.0, 8.0, -1.0]), "denominator": 12.0},
}
