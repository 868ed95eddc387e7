"""
Time-dependent (viscoelastic) layered static Green's functions — the
psgrn time axis (port of ``beat_tpu/heart/viscoelastic.py``).

* **Correspondence principle**: the quasi-static viscoelastic solution
  in the Laplace domain equals the elastic solution at the s-dependent
  moduli, ``û(s) = u_el(µ(s), λ(s)) / s`` for a Heaviside moment release;
  the bulk modulus stays elastic, ``λ(s) = K − 2µ(s)/3``.
* **Burgers shear rheology** per layer: the unrelaxed spring µ in series
  with a Maxwell dashpot η₂ and a Kelvin element (µ₁ = α·µ/(1−α) ∥ η₁):
  ``1/µ(s) = 1/µ + [η₂>0]/(s·η₂) + [η₁>0, α<1]/(µ₁ + s·η₁)``.
* **Real-axis sampling**: at real s > 0 every effective model is elastic,
  so the layered static solver runs unchanged on them — all s nodes as
  one batch of models on the device (:func:`static_table_values`; the
  host code runs one static build per node).
* **Prony collocation with a secular mode**: every table entry is fitted
  as ``u(s) = c + d/(s·T) + Σⱼ aⱼ·sτⱼ/(1+sτⱼ)`` and inverted analytically,
  ``u(t) = c + d·t/T + Σⱼ aⱼ·e^(−t/τⱼ)``.  The fit (a weighted least
  squares per entry, normal equations batched over the entries) and the
  Gaver–Stehfest weights are small float64 host work, as in the JAX
  package.

:func:`build_viscoelastic_static_table` returns a
:class:`TimeDependentStaticGFTable`; its ``at_time`` gives an ordinary
:class:`~beat_tpu_torch.heart.statictable.StaticGFTable`.  Scenes acquired
at different post-event epochs share one forward through
:class:`EpochStaticGFTable`, which reads each observation's epoch slab;
:func:`epoch_table_for_datasets` wires the datasets' acquisition times
to it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from math import factorial

import numpy as np
import torch

from beat_tpu_torch.device import resolve
from beat_tpu_torch.heart.statictable import StaticGFTable, build_static_table, static_table_values
from beat_tpu_torch.heart.velocity_model import LayeredModel

logger = logging.getLogger("beat_tpu_torch.heart.viscoelastic")

DAY = 86400.0


# ---------------------------------------------------------------------------
# Rheology
# ---------------------------------------------------------------------------


@dataclass
class BurgersRheology:
    """Per-layer Burgers-body shear rheology (psgrn columns eta1/eta2/alpha).

    eta1 : (nl,) transient (Kelvin) viscosities [Pa·s]; 0 = no transient.
    eta2 : (nl,) steady-state (Maxwell) viscosities [Pa·s]; 0 = elastic.
    alpha : (nl,) ratio µ₁/(µ₁+µ) of the Kelvin spring to the total —
        α→1 removes the transient element (µ₁→∞).
    """

    eta1: np.ndarray
    eta2: np.ndarray
    alpha: np.ndarray

    def __post_init__(self):
        self.eta1 = np.atleast_1d(np.asarray(self.eta1, dtype=np.float64))
        self.eta2 = np.atleast_1d(np.asarray(self.eta2, dtype=np.float64))
        self.alpha = np.atleast_1d(np.asarray(self.alpha, dtype=np.float64))
        n = self.eta1.size
        if not (self.eta2.size == n == self.alpha.size):
            raise ValueError("eta1/eta2/alpha must have equal layer counts")
        if ((self.alpha <= 0) | (self.alpha > 1)).any():
            raise ValueError("alpha must be in (0, 1]")

    @classmethod
    def elastic(cls, nlayers: int) -> "BurgersRheology":
        return cls(np.zeros(nlayers), np.zeros(nlayers), np.ones(nlayers))

    @property
    def is_elastic(self) -> bool:
        return bool((self.eta1 <= 0).all() and (self.eta2 <= 0).all())

    def mu_of_s(self, mu_unrelaxed: np.ndarray, s: float) -> np.ndarray:
        """Laplace-domain shear moduli of all layers at real s > 0."""
        mu_u = np.asarray(mu_unrelaxed, dtype=np.float64)
        inv = 1.0 / mu_u
        with np.errstate(divide="ignore"):
            m = self.eta2 > 0
            inv = inv + np.where(m, 1.0 / (s * np.where(m, self.eta2, 1.0)), 0.0)
            k = (self.eta1 > 0) & (self.alpha < 1.0)
            mu1 = np.where(k, self.alpha * mu_u / (1.0 - np.where(k, self.alpha, 0.5)), 1.0)
            inv = inv + np.where(k, 1.0 / (mu1 + s * np.where(k, self.eta1, 1.0)), 0.0)
        return 1.0 / inv

    def relaxation_times(self, mu_unrelaxed: np.ndarray) -> np.ndarray:
        """Characteristic times [s] of every relaxing element."""
        mu_u = np.asarray(mu_unrelaxed, dtype=np.float64)
        taus = []
        m = self.eta2 > 0
        taus.extend((self.eta2[m] / mu_u[m]).tolist())
        k = (self.eta1 > 0) & (self.alpha < 1.0)
        if k.any():
            mu1 = self.alpha[k] * mu_u[k] / (1.0 - self.alpha[k])
            taus.extend((self.eta1[k] / mu1).tolist())
        return np.asarray(taus)


def effective_model(model: LayeredModel, rheo: BurgersRheology, s: float,
                    vs_floor: float = 1e-3) -> LayeredModel:
    """Elastic model with the Laplace-domain moduli µ(s), λ(s) = K − 2µ(s)/3;
    ``vs_floor`` clamps the effective vs to this fraction of the unrelaxed
    one (a fully relaxed Maxwell halfspace has no static solution)."""
    mu_u = model.rho * model.vs**2
    lam_u = model.rho * (model.vp**2 - 2 * model.vs**2)
    bulk = lam_u + 2.0 * mu_u / 3.0
    mu_s = np.maximum(rheo.mu_of_s(mu_u, s), (vs_floor**2) * mu_u)
    lam_s = bulk - 2.0 * mu_s / 3.0
    return LayeredModel(tops=model.tops.copy(), vp=np.sqrt((lam_s + 2 * mu_s) / model.rho),
                        vs=np.sqrt(mu_s / model.rho), rho=model.rho.copy(),
                        name=f"{model.name}@s={s:.3e}")


# ---------------------------------------------------------------------------
# Gaver–Stehfest and the Prony fit (host float64)
# ---------------------------------------------------------------------------


def stehfest_weights(n: int = 12) -> np.ndarray:
    """Stehfest (1970) weights Vₖ, k = 1..n (n even)."""
    if n % 2:
        raise ValueError("Stehfest order must be even")
    h = n // 2
    v = np.zeros(n)
    for k in range(1, n + 1):
        acc = 0.0
        for j in range((k + 1) // 2, min(k, h) + 1):
            acc += (j**h * factorial(2 * j)
                    / (factorial(h - j) * factorial(j) * factorial(j - 1)
                       * factorial(k - j) * factorial(2 * j - k)))
        v[k - 1] = (-1.0) ** (k + h) * acc
    return v


def stehfest_invert(F, t: float, n: int = 16):
    """u(t) = ln2/t · Σₖ Vₖ F(k·ln2/t); F must be evaluable essentially
    exactly (the weights sum to ~2·10⁷ in magnitude at n = 16)."""
    v = stehfest_weights(n)
    ln2_t = np.log(2.0) / t
    out = None
    for k in range(1, n + 1):
        term = v[k - 1] * np.asarray(F(k * ln2_t))
        out = term if out is None else out + term
    return ln2_t * out


@dataclass
class PronyFit:
    """Analytic time reconstruction ``u(t) = c + d·t/T + Σⱼ aⱼ·e^(−t/τⱼ)``
    of relaxation functions fitted on the real Laplace axis."""

    c: np.ndarray        #: (...,) long-time offset
    d: np.ndarray        #: (...,) secular (steady creep) rate per T
    a: np.ndarray        #: (nb, ...) Prony amplitudes
    taus: np.ndarray     #: (nb,) fixed relaxation times [s]
    T: float             #: secular reference time [s]
    max_resid: float     #: worst residual relative to the table scale

    def at_time(self, t: float) -> np.ndarray:
        decay = np.exp(-float(t) / self.taus)
        return self.c + self.d * (float(t) / self.T) + np.tensordot(decay, self.a, axes=(0, 0))


def prony_fit(s_nodes: np.ndarray, u_s: np.ndarray, taus_per_decade: float = 4.0,
              secular: bool = True) -> PronyFit:
    """Fit every entry (trailing axes of ``u_s``; leading axis s) as
    ``c + d/(s·T) + Σⱼ aⱼ·sτⱼ/(1+sτⱼ)`` with log-spaced τⱼ: per-entry
    relative row weights 1/(|u| + 1e-3·max|u|), all entries in one batched
    normal-equations solve with a 1e-12 ridge (as the JAX package)."""
    s_nodes = np.asarray(s_nodes, dtype=np.float64)
    n_s = s_nodes.size
    shape = u_s.shape[1:]
    u2 = u_s.reshape(n_s, -1).astype(np.float64)
    taus = np.geomspace(1.0 / s_nodes[-1], 1.0 / s_nodes[0],
                        max(int(np.ceil(np.log10(s_nodes[-1] / s_nodes[0])
                                        * taus_per_decade)) + 1, 3))
    T = float(1.0 / np.sqrt(s_nodes[0] * s_nodes[-1]))
    basis = s_nodes[:, None] * taus[None, :] / (1.0 + s_nodes[:, None] * taus[None, :])
    cols = [np.ones((n_s, 1))]
    if secular:
        cols.append(1.0 / (s_nodes[:, None] * T))
    A = np.concatenate(cols + [basis], axis=1)
    nb = A.shape[1]
    # entries below 1e-9 of the table scale are symmetry zeros: their scale
    # is floored so their weights stay finite
    absmax = np.maximum(np.abs(u2).max(axis=0, keepdims=True),
                        1e-9 * max(np.abs(u2).max(), 1e-300))
    w = 1.0 / (np.abs(u2) + 1e-3 * absmax)
    Aw = A[None, :, :] * w.T[:, :, None]
    yw = (u2 * w).T
    AtA = np.einsum('esb,esc->ebc', Aw, Aw)
    Aty = np.einsum('esb,es->eb', Aw, yw)
    tr = np.einsum('ebb->e', AtA)
    reg = 1e-12 * tr[:, None, None] * np.eye(nb)[None, :, :]
    coef = np.linalg.solve(AtA + reg, Aty[:, :, None])[:, :, 0]
    max_resid = float(np.abs(np.einsum('sb,eb->se', A, coef) - u2).max()
                      / max(np.abs(u2).max(), 1e-300))
    na = 2 if secular else 1
    d = coef[:, 1] if secular else np.zeros(coef.shape[0])
    return PronyFit(c=coef[:, 0].reshape(shape), d=d.reshape(shape),
                    a=coef[:, na:].T.reshape((taus.size,) + shape), taus=taus, T=T,
                    max_resid=max_resid)


# ---------------------------------------------------------------------------
# The time-dependent table and its builder
# ---------------------------------------------------------------------------


@dataclass
class TimeDependentStaticGFTable:
    """Host-side stack of elementary-MT static tables over a time axis.

    values : (nt, 6, 3, ndist, ndepth) float32, the layout of
        :class:`StaticGFTable`'s values per epoch; ``times[0]`` may be 0
        (the unrelaxed, co-seismic response).
    The profile (mu_tops/mus/lams) is the unrelaxed one.
    prony : the analytic reconstruction the builder fitted, exact at any
        epoch (without it ``at_time`` interpolates between snapshots).
    """

    values: np.ndarray
    times: np.ndarray
    distances: np.ndarray
    depths: np.ndarray
    mu_tops: np.ndarray
    mus: np.ndarray
    lams: np.ndarray
    name: str = "viscoelastic"
    prony: PronyFit | None = None

    def values_at(self, t: float | None) -> np.ndarray:
        """(6, 3, nd, nz) values at epoch ``t`` [s] (None → 0): a stored
        snapshot where one is at ``t``, the Prony reconstruction
        otherwise, or linear interpolation between snapshots (clamped)."""
        t = 0.0 if t is None else float(t)
        tt = np.asarray(self.times, dtype=np.float64)
        hit = np.nonzero(tt == t)[0]
        if hit.size:
            return self.values[int(hit[0])]
        if self.prony is not None:
            return self.prony.at_time(t)
        if tt.size == 1:
            return self.values[0]
        i = int(np.clip(np.searchsorted(tt, t) - 1, 0, tt.size - 2))
        f = np.clip((t - tt[i]) / max(tt[i + 1] - tt[i], 1e-30), 0.0, 1.0)
        return (1.0 - f) * self.values[i] + f * self.values[i + 1]

    def at_time(self, t: float | None, *, device) -> StaticGFTable:
        """The elastic-equivalent :class:`StaticGFTable` at epoch ``t`` [s]."""
        t = 0.0 if t is None else float(t)
        return StaticGFTable(np.asarray(self.values_at(t), dtype=np.float32), self.distances,
                             self.depths, mu_tops=self.mu_tops, mus=self.mus, lams=self.lams,
                             name=f"{self.name}@t={t:.0f}s", device=device)

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` format: either package reads it."""
        extra = {}
        if self.prony is not None:
            extra = dict(prony_c=self.prony.c, prony_d=self.prony.d, prony_a=self.prony.a,
                         prony_taus=self.prony.taus, prony_T=np.float64(self.prony.T),
                         prony_resid=np.float64(self.prony.max_resid))
        np.savez_compressed(path, values=np.asarray(self.values, dtype=np.float32),
                            times=self.times, distances=self.distances, depths=self.depths,
                            mu_tops=self.mu_tops, mus=self.mus, lams=self.lams,
                            name=np.array(self.name), **extra)

    @classmethod
    def load(cls, path: str) -> "TimeDependentStaticGFTable":
        with np.load(path) as z:
            prony = None
            if "prony_c" in z:
                prony = PronyFit(c=z["prony_c"], d=z["prony_d"], a=z["prony_a"],
                                 taus=z["prony_taus"], T=float(z["prony_T"]),
                                 max_resid=float(z["prony_resid"]))
            return cls(values=z["values"], times=z["times"], distances=z["distances"],
                       depths=z["depths"], mu_tops=z["mu_tops"], mus=z["mus"], lams=z["lams"],
                       name=str(z["name"]), prony=prony)


def laplace_nodes(model: LayeredModel, rheo: BurgersRheology, times: np.ndarray,
                  s_per_decade: int = 8, vs_floor: float = 1e-3) -> np.ndarray:
    """The log-spaced real s nodes of a build: every requested epoch (modes
    with τ in ~[t_min/100, 100·t_max]) and every rheological corner 1/τ,
    kept clear of the ``vs_floor`` clamp (the secular mode extrapolates the
    creep past it)."""
    mu_u = model.rho * model.vs**2
    tpos = times[times > 0]
    s_lo = 1e-2 / tpos.max()
    s_hi = 1e2 / tpos.min()
    taus = rheo.relaxation_times(mu_u)
    if taus.size:
        s_lo = min(s_lo, 0.1 / taus.max())
        s_hi = max(s_hi, 10.0 / taus.min())
    m = rheo.eta2 > 0
    if m.any():
        # the clamp bites first for the fastest-relaxing Maxwell layer
        s_clean = 100.0 * (vs_floor**2) / (rheo.eta2[m] / mu_u[m]).min()
        if s_clean > s_lo:
            logger.info("Raising s_lo %.2e -> %.2e to stay clear of the vs_floor clamp "
                        "(secular mode covers t beyond)", s_lo, s_clean)
            s_lo = s_clean
    s_hi = max(s_hi, 1e3 * s_lo)
    n_s = max(int(np.ceil(np.log10(s_hi / s_lo) * s_per_decade)) + 1, 6)
    return np.geomspace(s_lo, s_hi, n_s)


def build_viscoelastic_static_table(model: LayeredModel, rheo: BurgersRheology, distances,
                                    depths, times, s_per_decade: int = 8,
                                    vs_floor: float = 1e-3, name: str = None, *,
                                    device) -> TimeDependentStaticGFTable:
    """Time-dependent layered static table (the psgrn time axis).

    times : epochs [s] after the (Heaviside) moment release; t = 0 is
        always added and holds the exact unrelaxed elastic table (a build
        of its own, :func:`build_static_table`).
    The static builds at the s nodes (:func:`laplace_nodes`) run as one
    batch of effective models on ``device``; the Prony fit and the epochs'
    reconstruction run on the host in float64.  Returns host values, as
    the JAX package's table."""
    from beat_tpu_torch.heart.layered_waveforms import nudge_depths_off_interfaces

    dev = resolve(device)
    times = np.sort(np.unique(np.concatenate([[0.0], np.asarray(times, np.float64).ravel()])))
    if (times < 0).any():
        raise ValueError("epochs must be >= 0")
    if rheo.eta1.size != model.nlayers:
        raise ValueError(f"rheology has {rheo.eta1.size} layers but the velocity model has "
                         f"{model.nlayers} — give eta1/eta2/alpha per layer")
    distances = np.asarray(distances, dtype=np.float64)
    depths = nudge_depths_off_interfaces(model, np.asarray(depths, np.float64))
    mu_u = model.rho * model.vs**2
    meta = dict(distances=distances, depths=depths, mu_tops=np.asarray(model.tops), mus=mu_u,
                lams=model.rho * (model.vp**2 - 2 * model.vs**2),
                name=name or f"visco_{model.name}")

    elastic = build_static_table(model, distances, depths, device=dev).values.cpu().numpy()
    if rheo.is_elastic or not (times > 0).any():
        logger.info("Elastic rheology/epochs — replicated the elastic table over %i epochs",
                    times.size)
        return TimeDependentStaticGFTable(values=np.repeat(elastic[None], times.size, axis=0),
                                          times=times, **meta)

    s_nodes = laplace_nodes(model, rheo, times, s_per_decade, vs_floor)
    logger.info("Viscoelastic build: %i s-nodes over [%.2e, %.2e] 1/s for %i epochs "
                "(%i x %i grid)", s_nodes.size, s_nodes[0], s_nodes[-1],
                int((times > 0).sum()), distances.size, depths.size)
    models = [effective_model(model, rheo, s, vs_floor=vs_floor) for s in s_nodes]
    # the JAX package fits its float32 static tables: the same values here
    u_s = static_table_values(models, distances, depths, device=dev).float().double()
    # the secular column exists only for Maxwell elements
    fit = prony_fit(s_nodes, u_s.cpu().numpy(), secular=bool((rheo.eta2 > 0).any()))
    logger.info("Prony fit over %i s-nodes, %i modes + secular: worst relative residual "
                "%.2e", s_nodes.size, fit.taus.size, fit.max_resid)
    if fit.max_resid > 1e-3:
        logger.warning("Viscoelastic Prony fit residual %.1e of the table scale exceeds 1e-3 "
                       "— consider raising s_per_decade", fit.max_resid)
    vals = np.stack([elastic.astype(np.float64) if t == 0.0 else fit.at_time(t)
                     for t in times])
    return TimeDependentStaticGFTable(values=vals.astype(np.float32), times=times, prony=fit,
                                      **meta)


# ---------------------------------------------------------------------------
# Per-observation epochs on the device forward
# ---------------------------------------------------------------------------


class EpochStaticGFTable(StaticGFTable):
    """A stack of per-epoch elementary-MT tables with a per-observation
    epoch index: ``values`` (ne, 6, 3, nd, nz), ``epoch_idx`` (N,) aligned
    with the observations the forward is given; each observation's gather
    reads its own epoch slab, so scenes acquired at different post-event
    times share one forward."""

    LEADING_AXES = 1

    def __init__(self, values, distances, depths, mu_tops=None, mus=None, lams=None,
                 name: str = "static_epochs", *, epoch_idx, device):
        super().__init__(values, distances, depths, mu_tops=mu_tops, mus=mus, lams=lams,
                         name=name, device=device)
        idx = torch.as_tensor(np.asarray(epoch_idx), dtype=torch.long, device=self.values.device)
        if idx.numel() and (idx.min() < 0 or idx.max() >= self.values.shape[0]):
            raise ValueError(f"epoch_idx outside the {self.values.shape[0]} epochs")
        self.register_buffer("epoch_idx", idx)
        self.register_buffer("epoch_offset", idx * self.distances.size, persistent=False)

    @property
    def n_observations(self) -> int:
        return self.epoch_idx.numel()

    def _epoch_offset(self) -> torch.Tensor:
        return self.epoch_offset

    def synthesize_enu(self, m6, east_shift, north_shift, depth, obs_east, obs_north):
        if obs_east.shape[-1] != self.epoch_offset.numel():
            raise ValueError(f"{obs_east.shape[-1]} observations, the epoch index has "
                             f"{self.epoch_offset.numel()}")
        return super().synthesize_enu(m6, east_shift, north_shift, depth, obs_east, obs_north)

    @classmethod
    def from_time_table(cls, ttable: TimeDependentStaticGFTable, obs_times, *,
                        device) -> "EpochStaticGFTable":
        """Collapse the time axis onto the observations: the table at each
        unique epoch (host, exact), and a per-observation index into them."""
        obs_times = np.asarray([0.0 if t is None else float(t) for t in obs_times])
        if obs_times.size == 0:
            raise ValueError("from_time_table needs at least one observation epoch "
                             "(no geodetic samples?)")
        uniq, idx = np.unique(obs_times, return_inverse=True)
        vals = np.stack([np.asarray(ttable.values_at(t), dtype=np.float32) for t in uniq])
        return cls(vals, ttable.distances, ttable.depths, mu_tops=ttable.mu_tops,
                   mus=ttable.mus, lams=ttable.lams, name=f"{ttable.name}_epochs",
                   epoch_idx=idx, device=device)


def epoch_table_for_datasets(ttable: TimeDependentStaticGFTable, datasets,
                             times_days: dict | None = None, *,
                             device) -> EpochStaticGFTable:
    """The epoch table of a list of geodetic datasets, as the JAX package's
    project loader wires it (``beat_tpu/config.py:1190-1215``): a dataset
    named in ``times_days`` gets that acquisition time (days after the
    event, stored in seconds on ``dataset.time``); every observation of a
    dataset reads its dataset's epoch (0 where it has none)."""
    times_days = times_days or {}
    for ds in datasets:
        if ds.name in times_days:
            ds.time = float(times_days[ds.name]) * DAY
    if not datasets:
        raise ValueError("no geodetic datasets to read the viscoelastic table")
    obs_times = np.concatenate([np.full(ds.samples, ds.time if ds.time is not None else 0.0)
                                for ds in datasets])
    table = EpochStaticGFTable.from_time_table(ttable, obs_times, device=device)
    logger.info("Using viscoelastic static GF table at %i acquisition epochs (%s days)",
                table.values.shape[0],
                ", ".join(f"{t / DAY:g}" for t in np.unique(obs_times)))
    return table
