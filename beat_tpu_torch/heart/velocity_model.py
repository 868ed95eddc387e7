"""
1-D layered velocity models and first-arrival ray tracing (copied from
``beat_tpu/heart/velocity_model.py``, trimmed to what the polarity
takeoff table needs: :class:`LayeredModel` with its homogeneous and
default-crust constructors, :func:`first_arrival` and
:func:`takeoff_angles`).  Host numpy in float64: takeoff angles are
per-target constants that fill a (depth × distance) table once.

First arrivals in a constant-layer stack are the minimum over

* the **direct (upgoing) ray** from the source to the surface receiver —
  ray parameter found by bisection of the monotonic distance function
  ``X(p) = Σ h_i p v_i / √(1 - p²v_i²)``;
* **head waves** critically refracted along each interface below the
  source whose refractor is faster than every layer on the path:
  ``T = p·x + Σ h_i √(v_i⁻² - p²)`` with ``p = 1/v_refractor``.

Takeoff angles are measured from the downward vertical (0° = straight
down, 180° = straight up).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class LayeredModel:
    """Constant-property layers over a halfspace.

    tops : (nl,) layer-top depths [m], ``tops[0] == 0``; the last layer
        extends to infinity.
    vp, vs : (nl,) velocities [m/s]; rho : (nl,) densities [kg/m³].
    """

    tops: np.ndarray
    vp: np.ndarray
    vs: np.ndarray
    rho: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        self.tops = np.asarray(self.tops, dtype=np.float64)
        self.vp = np.asarray(self.vp, dtype=np.float64)
        self.vs = np.asarray(self.vs, dtype=np.float64)
        self.rho = np.asarray(self.rho, dtype=np.float64)
        if self.tops[0] != 0.0:
            raise ValueError("first layer must start at the surface (tops[0]=0)")
        if not (np.diff(self.tops) > 0).all():
            raise ValueError("layer tops must increase monotonically")
        if not (len(self.tops) == len(self.vp) == len(self.vs) == len(self.rho)):
            raise ValueError("tops/vp/vs/rho must have equal lengths")

    @property
    def nlayers(self) -> int:
        return len(self.tops)

    def velocity(self, phase: str) -> np.ndarray:
        return self.vp if phase.lower().endswith("p") else self.vs

    def layer_of(self, depth: float) -> int:
        return int(np.searchsorted(self.tops, depth, side="right") - 1)

    @classmethod
    def homogeneous(cls, vp=6000.0, vs=3500.0, rho=2700.0) -> "LayeredModel":
        return cls(tops=np.array([0.0]), vp=np.array([vp]), vs=np.array([vs]),
                   rho=np.array([rho]), name="homogeneous")

    @classmethod
    def default_crust(cls) -> "LayeredModel":
        """Two-layer continental crust over mantle (AK135-flavoured
        rounded values)."""
        return cls(tops=np.array([0.0, 20e3, 35e3]),
                   vp=np.array([6000.0, 6600.0, 8040.0]),
                   vs=np.array([3500.0, 3800.0, 4480.0]),
                   rho=np.array([2700.0, 2900.0, 3320.0]),
                   name="default_crust")


def _path_segments(model: LayeredModel, zs: float, phase: str):
    """Thicknesses and velocities of the layers the upgoing leg crosses
    (surface .. source), plus the source-layer index."""
    v = model.velocity(phase)
    isrc = model.layer_of(zs)
    h = []
    for i in range(isrc):
        h.append(model.tops[i + 1] - model.tops[i])
    h.append(zs - model.tops[isrc])  # partial source layer
    return np.asarray(h), v[:isrc + 1].copy(), isrc


def _direct_ray(h, v, x):
    """Upgoing direct ray: bisection on the ray parameter.
    Returns (t, p) or (inf, 0) for degenerate input."""
    if x <= 0.0:
        return float(np.sum(h / v)), 0.0
    mask = h > 0
    h, v = h[mask], v[mask]
    if h.size == 0:
        return np.inf, 0.0
    p_max = 1.0 / v.max()

    def xdist(p):
        s = p * v
        s = np.clip(s, 0.0, 1.0 - 1e-12)
        return float(np.sum(h * s / np.sqrt(1.0 - s * s)))

    lo, hi = 0.0, p_max * (1.0 - 1e-12)
    if xdist(hi) < x:
        p = hi  # numerically horizontal — treat as grazing
    else:
        for _ in range(90):
            mid = 0.5 * (lo + hi)
            if xdist(mid) < x:
                lo = mid
            else:
                hi = mid
        p = 0.5 * (lo + hi)
    s = np.clip(p * v, 0.0, 1.0 - 1e-12)
    t = float(np.sum(h / (v * np.sqrt(1.0 - s * s))))
    return t, p


def _head_waves(model: LayeredModel, zs: float, x: float, phase: str):
    """(t, p, refractor_layer) candidates for critically refracted first
    arrivals along interfaces below the source."""
    v = model.velocity(phase)
    isrc = model.layer_of(zs)
    out = []
    for L in range(isrc + 1, model.nlayers):
        vr = v[L]
        # down leg: source -> top of layer L; up leg: top of layer L -> surface
        h_down = [model.tops[isrc + 1] - zs]
        v_down = [v[isrc]]
        for i in range(isrc + 1, L):
            h_down.append(model.tops[i + 1] - model.tops[i])
            v_down.append(v[i])
        h_up = [model.tops[i + 1] - model.tops[i] for i in range(L)]
        v_up = [v[i] for i in range(L)]
        hh = np.asarray(h_down + h_up)
        vv = np.asarray(v_down + v_up)
        if vr <= vv.max():
            continue  # no critical refraction
        p = 1.0 / vr
        s = p * vv
        eta = np.sqrt(np.maximum(1.0 / vv**2 - p * p, 0.0))
        x_crit = float(np.sum(hh * s / np.sqrt(1.0 - s * s)))
        if x < x_crit:
            continue  # receiver inside the critical distance
        t = p * x + float(np.sum(hh * eta))
        out.append((t, p, L))
    return out


def first_arrival(model: LayeredModel, source_depth: float, distance: float,
                  phase: str = "p"):
    """
    First arrival from a source at ``source_depth`` to a surface receiver
    at epicentral ``distance``.

    Returns ``(time [s], takeoff_deg, ray_parameter [s/m])`` with takeoff
    measured from the downward vertical (0 = down, 180 = up).
    """
    zs = float(source_depth)
    x = float(distance)
    if zs <= 0:
        raise ValueError("source must be below the surface")
    h, v, isrc = _path_segments(model, zs, phase)
    v_src = model.velocity(phase)[isrc]

    t_dir, p_dir = _direct_ray(h, v, x)
    best = (t_dir, float(np.degrees(np.pi - np.arcsin(
        np.clip(p_dir * v_src, 0.0, 1.0)))), p_dir)

    for t, p, _ in _head_waves(model, zs, x, phase):
        if t < best[0]:
            best = (t, float(np.degrees(np.arcsin(
                np.clip(p * v_src, 0.0, 1.0)))), p)
    return best


def takeoff_angles(model: LayeredModel, source_depth: float, distances,
                   phase: str = "p") -> np.ndarray:
    """Vector of first-arrival takeoff angles [rad from downward
    vertical]."""
    return np.asarray([np.deg2rad(first_arrival(model, source_depth, d, phase)[1])
                       for d in np.atleast_1d(distances)])
