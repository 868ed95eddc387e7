"""
1-D layered velocity models and first-arrival ray tracing (copy of
``beat_tpu/heart/velocity_model.py``): :class:`LayeredModel` with its
constructors (homogeneous, default crust, ak135-f average, nd text),
earth flattening, ``.npz`` persistence, the earth-model ensembles
(:func:`vary_model`, :func:`ensemble_earthmodels`, seeded by a numpy
``Generator`` so a seed gives the JAX package's variations) and the ray
tracer.  Host numpy in float64: a model describes the medium and does no
device math; takeoff angles and travel times are per-target constants
filled into tables once.

First arrivals in a constant-layer stack are the minimum over

* the **direct (upgoing) ray** from the source to the surface receiver —
  ray parameter found by bisection of the monotonic distance function
  ``X(p) = Σ h_i p v_i / √(1 - p²v_i²)``;
* **head waves** critically refracted along each interface below the
  source whose refractor is faster than every layer on the path:
  ``T = p·x + Σ h_i √(v_i⁻² - p²)`` with ``p = 1/v_refractor``.

:func:`first_arrivals` runs the JAX package's one-receiver bisection on
a vector of receivers at once (a table's travel times and takeoffs);
:func:`first_arrival` is one receiver.  Takeoff angles are measured from
the downward vertical (0° = straight down, 180° = straight up).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger("beat_tpu_torch.heart.velocity_model")


@dataclass
class LayeredModel:
    """Constant-property layers over a halfspace.

    tops : (nl,) layer-top depths [m], ``tops[0] == 0``; the last layer
        extends to infinity.
    vp, vs : (nl,) velocities [m/s]; rho : (nl,) densities [kg/m³].
    qp, qs : optional (nl,) anelastic quality factors (None = elastic);
        consumed by the DWN waveform builder as constant-Q complex
        velocities ``v·(1 + i/2Q)``.
    """

    tops: np.ndarray
    vp: np.ndarray
    vs: np.ndarray
    rho: np.ndarray
    name: str = "custom"
    qp: np.ndarray = None
    qs: np.ndarray = None

    def __post_init__(self):
        self.tops = np.asarray(self.tops, dtype=np.float64)
        self.vp = np.asarray(self.vp, dtype=np.float64)
        self.vs = np.asarray(self.vs, dtype=np.float64)
        self.rho = np.asarray(self.rho, dtype=np.float64)
        for attr in ("qp", "qs"):
            q = getattr(self, attr)
            if q is not None:
                q = np.asarray(q, dtype=np.float64)
                if q.shape != self.tops.shape:
                    raise ValueError(f"{attr} must match the layer count")
                if (q <= 0).any():
                    raise ValueError(f"{attr} must be positive")
                setattr(self, attr, q)
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

    def properties_at(self, depth: float) -> tuple:
        i = self.layer_of(depth)
        return float(self.vp[i]), float(self.vs[i]), float(self.rho[i])

    # -- constructors ---------------------------------------------------------

    @classmethod
    def homogeneous(cls, vp=6000.0, vs=3500.0, rho=2700.0) -> "LayeredModel":
        return cls(tops=np.array([0.0]), vp=np.array([vp]), vs=np.array([vs]),
                   rho=np.array([rho]), name="homogeneous")

    @classmethod
    def default_crust(cls) -> "LayeredModel":
        """Simple two-layer continental crust over mantle (AK135-flavoured
        rounded values) — the hermetic stand-in for crust2x2 profiles
        (reference ``heart.py`` ``get_velocity_model``)."""
        return cls(tops=np.array([0.0, 20e3, 35e3]),
                   vp=np.array([6000.0, 6600.0, 8040.0]),
                   vs=np.array([3500.0, 3800.0, 4480.0]),
                   rho=np.array([2700.0, 2900.0, 3320.0]),
                   name="default_crust")

    @classmethod
    def ak135_f_average(cls, max_depth: float = 660e3) -> "LayeredModel":
        """The ak135-f continental-average model (Kennett, Engdahl &
        Buland 1995; Q from Montagner & Kennett 1996) down to
        ``max_depth`` — the reference's default base earth model
        (``config.py`` ``earth_model_name='ak135-f-average.m'``)."""
        return cls.from_nd(ak135_f_average_nd_text(max_depth),
                           name="ak135-f-average")

    def earth_flattened(self, rel_step: float = 0.01,
                        radius: float = 6371e3) -> "LayeredModel":
        """Earth-flattening transform (Müller 1977): map the spherical
        model to an equivalent flat one — ``z_f = a·ln(a/r)``,
        ``v_f = v·a/r``, ``ρ_f = ρ·r/a`` — so flat-geometry wavefield
        codes (DWN/Kennett) reproduce spherical travel times, exactly
        what the reference's qseis/qssp stores embed.  Constant layers
        are subdivided so each flattened sublayer's velocity boost stays
        within ``rel_step`` (default 1 %), keeping the layer count (and
        the Kennett-recursion cost) minimal."""
        tops_f, vp_f, vs_f, rho_f, qp_f, qs_f = [], [], [], [], [], []
        a = radius
        bottoms = np.append(self.tops[1:], min(
            self.tops[-1] * 2 + 100e3, 0.95 * a))
        for i in range(self.nlayers):
            z0, z1 = self.tops[i], bottoms[i]
            # subdivide: a/(a-z) grows by ~dz/(a-z); cap at rel_step
            n_sub = max(1, int(np.ceil((z1 - z0) / (rel_step * (a - z1)))))
            edges = np.linspace(z0, z1, n_sub + 1)
            mids = 0.5 * (edges[:-1] + edges[1:])
            f = a / (a - mids)
            tops_f.extend(a * np.log(a / (a - edges[:-1])))
            vp_f.extend(self.vp[i] * f)
            vs_f.extend(self.vs[i] * f)
            rho_f.extend(self.rho[i] / f)
            if self.qp is not None:
                qp_f.extend([self.qp[i]] * n_sub)
            if self.qs is not None:
                qs_f.extend([self.qs[i]] * n_sub)
        return LayeredModel(
            tops=np.asarray(tops_f), vp=np.asarray(vp_f),
            vs=np.asarray(vs_f), rho=np.asarray(rho_f),
            qp=np.asarray(qp_f) if self.qp is not None else None,
            qs=np.asarray(qs_f) if self.qs is not None else None,
            name=f"{self.name}-flat")

    @classmethod
    def from_nd(cls, path_or_text: str, name: str = None) -> "LayeredModel":
        """
        Parse the 'nd' (named-discontinuity) format used by pyrocko/cake
        and TauP: columns ``depth[km] vp[km/s] vs[km/s] rho[g/cm³] …``,
        discontinuity-name lines skipped.  Piecewise-linear profiles are
        converted to constant layers by mid-point averaging.
        """
        import os

        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                text = f.read()
            name = name or os.path.basename(path_or_text)
        else:
            text = path_or_text
        rows = []
        have_q = True
        rows_with_q = 0
        for line in text.splitlines():
            parts = line.split()
            if len(parts) < 4:
                continue  # blank or discontinuity-name line
            try:
                row = [float(p) for p in parts[:4]]
            except ValueError:
                continue
            try:
                row += [float(parts[4]), float(parts[5])]
                rows_with_q += 1
            except (IndexError, ValueError):
                # trailing comments / missing q columns: keep the row
                have_q = False
                row += [0.0, 0.0]
            rows.append(row)
        if rows_with_q and not have_q:
            logger.warning(
                "nd input %s: %i of %i rows carry qp/qs columns but others "
                "do not — Q is dropped for the WHOLE model (purely elastic); "
                "fix the offending rows to enable attenuation",
                name or "<text>", rows_with_q, len(rows))
        if len(rows) < 2:
            raise ValueError("nd input needs at least two depth samples")
        arr = np.asarray(rows)
        d = arr[:, 0] * 1e3
        vp = arr[:, 1] * 1e3
        vs = arr[:, 2] * 1e3
        rho = arr[:, 3] * 1e3
        tops, lvp, lvs, lrho, lqp, lqs = [], [], [], [], [], []
        for i in range(len(d) - 1):
            if d[i + 1] <= d[i]:
                continue  # repeated depth = discontinuity sample pair
            tops.append(d[i])
            lvp.append(0.5 * (vp[i] + vp[i + 1]))
            lvs.append(0.5 * (vs[i] + vs[i + 1]))
            lrho.append(0.5 * (rho[i] + rho[i + 1]))
            lqp.append(0.5 * (arr[i, 4] + arr[i + 1, 4]))
            lqs.append(0.5 * (arr[i, 5] + arr[i + 1, 5]))
        # the deepest sample defines the halfspace below it (nd/cake
        # convention) — without this, step-wise models written as
        # repeated-depth pairs (e.g. "crust / crust / mantle" custom
        # models) silently LOSE their mantle halfspace, because the
        # final row never enters the pairwise loop above
        if tops and d[-1] > tops[-1] and not (
                vp[-1] == lvp[-1] and vs[-1] == lvs[-1]
                and rho[-1] == lrho[-1]):
            tops.append(d[-1])
            lvp.append(vp[-1])
            lvs.append(vs[-1])
            lrho.append(rho[-1])
            lqp.append(arr[-1, 4])
            lqs.append(arr[-1, 5])
        if tops[0] != 0.0:
            tops[0] = 0.0
        qp = np.asarray(lqp) if have_q and min(lqp) > 0 else None
        qs = np.asarray(lqs) if have_q and min(lqs) > 0 else None
        return cls(tops=np.asarray(tops), vp=np.asarray(lvp),
                   vs=np.asarray(lvs), rho=np.asarray(lrho),
                   name=name or "nd_model", qp=qp, qs=qs)

    def to_nd(self) -> str:
        """Serialize as nd text (depth [km], vp/vs [km/s], rho [g/cm³],
        qp, qs) — step-wise layers written as repeated-depth sample
        pairs so :meth:`from_nd` round-trips the model exactly."""
        bottoms = np.append(self.tops[1:], self.tops[-1] + 100e3)
        qp = self.qp if self.qp is not None else np.zeros(self.nlayers)
        qs = self.qs if self.qs is not None else np.zeros(self.nlayers)
        lines = []
        for i in range(self.nlayers):
            row = (self.vp[i] / 1e3, self.vs[i] / 1e3, self.rho[i] / 1e3,
                   qp[i], qs[i])
            for z in (self.tops[i], bottoms[i]):
                lines.append("  ".join(
                    f"{v:.6g}" for v in (z / 1e3,) + row))
        return "\n".join(lines)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        extra = {}
        if self.qp is not None:
            extra["qp"] = self.qp
        if self.qs is not None:
            extra["qs"] = self.qs
        np.savez_compressed(path, tops=self.tops, vp=self.vp, vs=self.vs,
                            rho=self.rho, name=np.array(self.name), **extra)

    @classmethod
    def load(cls, path: str) -> "LayeredModel":
        with np.load(path) as z:
            return cls(tops=z["tops"], vp=z["vp"], vs=z["vs"], rho=z["rho"],
                       name=str(z["name"]),
                       qp=z["qp"] if "qp" in z.files else None,
                       qs=z["qs"] if "qs" in z.files else None)


# ---------------------------------------------------------------------------
# Earth-model uncertainty ensembles (reference heart.py:1722-1902:
# vary_model / ensemble_earthmodel)
# ---------------------------------------------------------------------------


def vary_model(model: LayeredModel, error_depth: float = 0.1,
               error_velocities: float = 0.1,
               depth_limit_variation: float = 600e3, rng=None):
    """
    One Gaussian perturbation of a layered model (reference
    ``heart.vary_model`` ``heart.py:1722``): per layer, vp is drawn from
    ``N(0, vp·error_velocities/3)`` (errors are 3σ fractions) with
    rejection until velocity still increases with depth; vs is scaled by
    the same Δ over the layer's vp/vs ratio (ratio preserved, as the
    reference does); each interior layer boundary moves by
    ``N(0, z·error_depth/3)`` with rejection of layer inversions.
    Layers with tops below ``depth_limit_variation`` are not varied.

    Returns ``(varied_model, cost)`` — ``cost`` counts rejection retries;
    the reference treats cost > 20 as an unlikely model and discards it.
    """
    rng = np.random.default_rng() if rng is None else rng
    tops = model.tops.copy()
    vp = model.vp.copy()
    vs = model.vs.copy()
    cost = 0
    for i in range(model.nlayers):
        if tops[i] >= depth_limit_variation:
            break
        for _ in range(1000):
            dv = float(rng.normal(0.0, vp[i] * error_velocities / 3.0))
            if i == 0 or vp[i] + dv >= vp[i - 1]:
                ratio = vp[i] / vs[i]
                vp[i] += dv
                vs[i] += dv / ratio
                break
            cost += 1
        if i + 1 < model.nlayers and tops[i + 1] < depth_limit_variation:
            for _ in range(1000):
                dz = float(rng.normal(0.0, tops[i + 1] * error_depth / 3.0))
                z_new = tops[i + 1] + dz
                if tops[i] < z_new and (i + 2 >= model.nlayers
                                        or z_new < tops[i + 2]):
                    tops[i + 1] = z_new
                    break
                cost += 1
    return LayeredModel(tops=tops, vp=vp, vs=vs, rho=model.rho.copy(),
                        name=f"{model.name}_var", qp=model.qp,
                        qs=model.qs), cost


def ensemble_earthmodels(model: LayeredModel, num_vary: int = 10,
                         error_depth: float = 0.1,
                         error_velocities: float = 0.1,
                         depth_limit_variation: float = 600e3,
                         max_cost: int = 20, rng=None) -> list:
    """
    Ensemble of ``num_vary`` perturbed models around ``model``, discarding
    unlikely draws with rejection ``cost > max_cost`` (reference
    ``ensemble_earthmodel`` ``heart.py:1856-1899``).  Feeds the
    velocity-model prediction covariances (``Covariance.pred_v``).
    """
    rng = np.random.default_rng() if rng is None else rng
    out = []
    for _ in range(100 * num_vary):
        if len(out) == num_vary:
            break
        varied, cost = vary_model(model, error_depth, error_velocities,
                                  depth_limit_variation, rng)
        if cost > max_cost:
            logger.debug("Skipped unlikely earth model (cost %i)", cost)
            continue
        out.append(varied)
    if len(out) < num_vary:
        raise ValueError(
            f"could only draw {len(out)}/{num_vary} plausible models — "
            f"error_depth/error_velocities too large for this profile?")
    return out


# ---------------------------------------------------------------------------
# First-arrival ray tracing
# ---------------------------------------------------------------------------


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


def first_arrivals(model: LayeredModel, source_depth: float, distances,
                   phase: str = "p") -> tuple:
    """First arrivals from a source at ``source_depth`` to surface receivers
    at epicentral ``distances``, all at once: the upgoing direct ray by 90
    halvings of its ray parameter on every distance together, against each
    head wave that reaches it.  Returns ``(times [s], ray parameters
    [s/m], upgoing)``, each shaped like ``distances``; ``upgoing`` marks
    where the direct ray arrives first."""
    zs = float(source_depth)
    if zs <= 0:
        raise ValueError("source must be below the surface")
    x = np.atleast_1d(np.asarray(distances, dtype=np.float64))
    h_all, v_all, isrc = _path_segments(model, zs, phase)
    keep = h_all > 0
    h, v = h_all[keep], v_all[keep]
    if h.size == 0:
        t, p = np.full(x.shape, np.inf), np.zeros(x.shape)
    else:
        def xdist(p):
            s = np.clip(p[:, None] * v, 0.0, 1.0 - 1e-12)
            return np.sum(h * s / np.sqrt(1.0 - s * s), axis=-1)

        hi0 = (1.0 / v.max()) * (1.0 - 1e-12)
        lo, hi = np.zeros(x.shape), np.full(x.shape, hi0)
        for _ in range(90):
            mid = 0.5 * (lo + hi)
            below = xdist(mid) < x
            lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
        # beyond the grazing ray's reach the ray is taken as horizontal
        p = np.where(xdist(np.full(x.shape, hi0)) < x, hi0, 0.5 * (lo + hi))
        s = np.clip(p[:, None] * v, 0.0, 1.0 - 1e-12)
        t = np.sum(h / (v * np.sqrt(1.0 - s * s)), axis=-1)
    vertical = x <= 0.0
    t = np.where(vertical, np.sum(h_all / v_all), t)
    p = np.where(vertical, 0.0, p)
    upgoing = np.ones(x.shape, dtype=bool)
    for L in range(isrc + 1, model.nlayers):
        head = _head_wave(model, zs, x, phase, L)
        if head is not None:
            t_head, reached, p_head = head
            better = reached & (t_head < t)
            t, p = np.where(better, t_head, t), np.where(better, p_head, p)
            upgoing &= ~better
    return t, p, upgoing


def _head_wave(model: LayeredModel, zs: float, x: np.ndarray, phase: str, L: int):
    """The wave critically refracted along the top of layer ``L`` at
    distances ``x``: ``(times, reached, ray parameter)``, ``reached`` where
    ``x`` is beyond its critical distance; None where layer ``L`` is not
    faster than every layer of the path."""
    v = model.velocity(phase)
    isrc = model.layer_of(zs)
    # down leg: source -> top of layer L; up leg: top of layer L -> surface
    hh = np.asarray([model.tops[isrc + 1] - zs]
                    + [model.tops[i + 1] - model.tops[i] for i in range(isrc + 1, L)]
                    + [model.tops[i + 1] - model.tops[i] for i in range(L)])
    vv = np.asarray([v[isrc]] + [v[i] for i in range(isrc + 1, L)] + [v[i] for i in range(L)])
    if v[L] <= vv.max():
        return None
    p = 1.0 / v[L]
    s = p * vv
    eta = np.sqrt(np.maximum(1.0 / vv**2 - p * p, 0.0))
    x_crit = float(np.sum(hh * s / np.sqrt(1.0 - s * s)))
    return p * x + float(np.sum(hh * eta)), x >= x_crit, p


def _takeoff_deg(model: LayeredModel, zs: float, p, upgoing, phase: str):
    """Takeoff from the downward vertical [deg] of rays of parameter ``p``
    leaving the source upward (direct) or downward (head waves)."""
    v_src = model.velocity(phase)[model.layer_of(zs)]
    down = np.degrees(np.arcsin(np.clip(p * v_src, 0.0, 1.0)))
    return np.where(upgoing, np.degrees(np.pi - np.arcsin(np.clip(p * v_src, 0.0, 1.0))), down)


def first_arrival(model: LayeredModel, source_depth: float, distance: float,
                  phase: str = "p"):
    """First arrival at one receiver (:func:`first_arrivals`): ``(time [s],
    takeoff_deg, ray_parameter [s/m])`` with the takeoff measured from the
    downward vertical (0 = down, 180 = up)."""
    t, p, up = first_arrivals(model, source_depth, [distance], phase)
    return (float(t[0]), float(_takeoff_deg(model, float(source_depth), p, up, phase)[0]),
            float(p[0]))


def takeoff_angles(model: LayeredModel, source_depth: float, distances,
                   phase: str = "p") -> np.ndarray:
    """First-arrival takeoff angles [rad from downward vertical]."""
    _, p, up = first_arrivals(model, source_depth, distances, phase)
    return np.deg2rad(_takeoff_deg(model, float(source_depth), p, up, phase))


def travel_times(model: LayeredModel, source_depth: float, distances,
                 phase: str = "p") -> np.ndarray:
    """First-arrival travel times [s] (:func:`first_arrivals`)."""
    return first_arrivals(model, source_depth, distances, phase)[0]


# ---------------------------------------------------------------------------
# ak135-f continental average (the reference's default base earth model)
# ---------------------------------------------------------------------------

# depth[km]  vp[km/s]  vs[km/s]  rho[g/cm³]  Qp  Qs — ak135 velocities
# (Kennett, Engdahl & Buland 1995), Q from the 'f' attenuation model
# (Montagner & Kennett 1996), crust averaged to the continental profile
# (pyrocko ``ak135-f-average.m``; reference default earth_model_name,
# ``config.py:228``).
_AK135_F_AVERAGE = [
    (0.00, 5.8000, 3.4600, 2.4490, 1478.30, 599.99),
    (20.00, 5.8000, 3.4600, 2.4490, 1478.30, 599.99),
    (20.00, 6.5000, 3.8500, 2.7142, 1368.02, 599.99),
    (35.00, 6.5000, 3.8500, 2.7142, 1368.02, 599.99),
    (35.00, 8.0400, 4.4800, 3.3198, 950.50, 394.62),
    (77.50, 8.0450, 4.4900, 3.3455, 972.77, 403.93),
    (77.50, 8.0450, 4.4900, 3.3455, 182.57, 75.60),
    (120.00, 8.0505, 4.5000, 3.3713, 182.57, 76.06),
    (120.00, 8.0505, 4.5000, 3.3713, 362.61, 150.73),
    (165.00, 8.1750, 4.5090, 3.3985, 365.55, 152.81),
    (210.00, 8.3007, 4.5184, 3.4258, 364.87, 153.57),
    (210.00, 8.3007, 4.5184, 3.4258, 744.45, 313.27),
    (260.00, 8.4822, 4.6094, 3.4561, 744.45, 319.44),
    (310.00, 8.6650, 4.6964, 3.4864, 752.04, 325.61),
    (360.00, 8.8476, 4.7832, 3.5167, 769.80, 331.79),
    (410.00, 9.0302, 4.8702, 3.5470, 772.77, 337.96),
    (410.00, 9.3601, 5.0806, 3.7557, 1193.93, 558.18),
    (460.00, 9.5280, 5.1864, 3.8175, 1202.00, 564.35),
    (510.00, 9.6962, 5.2922, 3.8793, 1210.06, 570.52),
    (560.00, 9.8640, 5.3989, 3.9410, 1218.13, 576.69),
    (610.00, 10.0320, 5.5047, 4.0028, 1226.19, 582.83),
    (660.00, 10.2000, 5.6104, 4.0646, 1234.26, 589.00),
]


def ak135_f_average_nd_text(max_depth: float = 660e3) -> str:
    """The embedded ak135-f-average table as raw nd text (depth [km],
    6 columns, piecewise-linear samples preserved) — for projects whose
    gf_config names a global base model with no custom crust
    (reference ``earth_model_name`` semantics, ``config.py:223-240``)."""
    rows = [r for r in _AK135_F_AVERAGE if r[0] * 1e3 <= max_depth]
    return "\n".join(" ".join(f"{v:g}" for v in r) for r in rows)


def join_nd_with_ak135(crust_text: str, max_depth: float = 660e3) -> str:
    """
    Continue a custom (crustal) nd model with ak135-f-average below its
    deepest sample — the reference's custom-velocity-model semantics
    (``beat/utility.py:1223`` ``join_models``: the global model below
    ``crustal_model.max('z')`` is appended VERBATIM, including any
    remaining global crust — velocity inversions and all; a custom
    below-side discontinuity sample at the max depth has zero extent in
    the joined model, exactly as in cake).

    Returns the joined model as nd text (depth km, 6 columns).  Rows of
    the crustal text missing Q columns get the ak135 crustal values.
    """
    rows = []
    z_max = 0.0
    for line in crust_text.splitlines():
        parts = line.split()
        if len(parts) < 4:
            continue
        try:
            vals = [float(p) for p in parts[:6]]
        except ValueError:
            continue
        if len(vals) < 6:
            vals = vals[:4] + [1478.30, 599.99]
        rows.append(tuple(vals))
        z_max = max(z_max, vals[0])

    # interpolated base row at z_max (cake ``extract(depth_min)``)
    base = [r for r in _AK135_F_AVERAGE if r[0] * 1e3 <= max_depth]
    zb = np.array([r[0] for r in base])
    below = [r for r in base if r[0] > z_max + 1e-9]
    if below:
        i_hi = len(base) - len(below)
        i_lo = max(i_hi - 1, 0)
        if zb[i_hi] > zb[i_lo]:
            t = (z_max - zb[i_lo]) / (zb[i_hi] - zb[i_lo])
            interp = tuple(
                (1 - t) * a + t * b
                for a, b in zip(base[i_lo], base[i_hi]))
            rows.append((z_max,) + interp[1:])
        else:
            rows.append((z_max,) + tuple(base[i_hi][1:]))
        rows.extend(below)
    return "\n".join(
        "  ".join(f"{v:.6g}" for v in r) for r in rows)
