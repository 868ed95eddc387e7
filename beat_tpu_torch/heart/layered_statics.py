"""
Static deformation of a layered elastic halfspace — the psgrn analogue
(port of ``beat_tpu/heart/layered_statics.py``), in float64 on the
caller's device.

* **Hankel-domain global-matrix solver**: for each wavenumber k the
  static P-SV system ``y' = k·M·y`` and the SH system are solved exactly
  per layer in the Jordan basis of M (eigenvalues ±1, defective:
  solutions ``(p + q·kz)e^{±kz}``), each exponential normalized to the
  boundary it decays from, so the global system stays well conditioned at
  any k·h.  The Jordan pairs of each material are 4 × 4 host constants
  (an SVD nullspace and a least-squares generalized eigenvector, as in
  the JAX package); the columns, the global matrices and their solves
  (``torch.linalg.solve`` over the batch) run on the device.
* **Point forces** enter as traction jumps across the source depth.
* **Surface displacements** come from trapezoid Hankel transforms whose
  Bessel matrices are evaluated on the device
  (:mod:`beat_tpu_torch.ops.bessel`: ``torch.special``'s J0/J1 miss
  scipy's by up to 4e-7) and applied as matrix products.
* **Moment tensors** are force dipoles: centred differences of the force
  Green tensor over the source position (horizontal ones by receiver
  shifts, the vertical one by two more solves at z_s ± δ).

The host code evaluates one depth, one shift and one model at a time.
Here every solve of a batch is one leading axis: the models (the s nodes
of a viscoelastic build are effective elastic models sharing one set of
interfaces), the source depths and their ±δ solves; and every Hankel
transform of a batch (six shifted evaluations per depth, all depths) is
one batched product over wavenumber grids padded to a common length with
zero quadrature weights.  Batches are cut to the memory budget of
:func:`beat_tpu_torch.device.chunk_budget`.

Conventions: z positive down, free surface at z = 0; the force Green
tensor G[i, j] is displacement component i ∈ (x = east, y = north,
z = down) per unit point force along j at the source.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from beat_tpu_torch.device import chunk_budget, resolve
from beat_tpu_torch.ops.bessel import bessel_j0, bessel_j1

logger = logging.getLogger("beat_tpu_torch.heart.layered_statics")

FLOAT = torch.float64
#: log-spaced solver nodes of :class:`ForceKernels`
N_SOLVE = 1600
#: cap of a trapezoid Hankel grid (``_integration_grid``)
NK_MAX = 600_000


# ---------------------------------------------------------------------------
# Per-material Jordan bases (host constants)
# ---------------------------------------------------------------------------


def _psv_matrix(lam: float, mu: float) -> np.ndarray:
    """M of the scaled static P-SV system y' = k M y with
    y = (U, V, P/(µk), S/(µk))."""
    a = lam / (lam + 2 * mu)
    beta = mu / (lam + 2 * mu)
    delta = 4 * (lam + mu) / (lam + 2 * mu)
    return np.array([
        [0.0, a, beta, 0.0],
        [-1.0, 0.0, 0.0, 1.0],
        [0.0, 0.0, 0.0, 1.0],
        [0.0, delta, -a, 0.0],
    ])


def _jordan_pair(M: np.ndarray, s: float):
    """(q, p) with M q = s q and (M - s I) p = q: SVD nullspace, largest
    entry made positive, and least squares."""
    A = M - s * np.eye(4)
    _, _, vt = np.linalg.svd(A)
    q = vt[-1]
    q = q / q[np.argmax(np.abs(q))]
    p, *_ = np.linalg.lstsq(A, q, rcond=None)
    return q, p


class Media:
    """The elastic constants of M layered models sharing one set of
    interfaces, on a device: ``lam``, ``mu`` (M, L) and the Jordan pairs
    ``qm, pm, qp, pp`` (M, L, 4) of every layer's P-SV matrix."""

    def __init__(self, models, *, device):
        models = list(models) if isinstance(models, (list, tuple)) else [models]
        tops = np.asarray(models[0].tops, dtype=np.float64)
        for m in models[1:]:
            if not np.array_equal(np.asarray(m.tops, dtype=np.float64), tops):
                raise ValueError("the models of one batch must share their layer tops")
        self.tops = tops
        self.device = resolve(device)
        lam = np.stack([m.rho * (m.vp**2 - 2 * m.vs**2) for m in models])
        mu = np.stack([m.rho * m.vs**2 for m in models])
        pairs = np.empty((4,) + lam.shape + (4,))
        for i, j in np.ndindex(*lam.shape):
            M = _psv_matrix(lam[i, j], mu[i, j])
            pairs[0, i, j], pairs[1, i, j] = _jordan_pair(M, -1.0)
            pairs[2, i, j], pairs[3, i, j] = _jordan_pair(M, +1.0)
        t = lambda a: torch.as_tensor(a, dtype=FLOAT, device=self.device)  # noqa: E731
        self.lam, self.mu = t(lam), t(mu)
        self.mu_ref = t(np.median(mu, axis=1))
        self.qm, self.pm, self.qp, self.pp = (t(a) for a in pairs)

    @property
    def n_models(self) -> int:
        return self.lam.shape[0]


# ---------------------------------------------------------------------------
# Columns, layer pieces and the global-matrix solves
# ---------------------------------------------------------------------------


def _psv_columns_k(bases: tuple, k: torch.Tensor, dz_top: torch.Tensor,
                   dz_bot: torch.Tensor) -> torch.Tensor:
    """Fundamental P-SV solutions of one material at one depth per
    wavenumber: ``bases`` (qm, pm, qp, pp) each (..., 4), ``k`` (..., nk),
    the depth's offsets ``dz_top = z - z_top >= 0`` and ``dz_bot = z -
    z_bot <= 0`` (...,).  Columns [down1, down2, up1, up2], each normalized
    to the boundary it decays from: (..., nk, 4, 4).  A halfspace uses the
    first two."""
    qm, pm, qp, pp = (b[..., None, :] for b in bases)
    xm = k * dz_top[..., None]
    xp = k * dz_bot[..., None]
    em, ep = torch.exp(-xm)[..., None], torch.exp(xp)[..., None]
    return torch.stack([qm * em, (pm + qm * xm[..., None]) * em,
                        qp * ep, (pp + qp * xp[..., None]) * ep], dim=-1)


def _sh_columns_k(k: torch.Tensor, dz_top: torch.Tensor, dz_bot: torch.Tensor) -> torch.Tensor:
    """SH fundamental solutions (W, T/(µk)) = (1, ∓1)e^{∓k·}: (..., nk, 2, 2)
    (columns down, up; a halfspace uses the first)."""
    em = torch.exp(-k * dz_top[..., None])
    ep = torch.exp(k * dz_bot[..., None])
    return torch.stack([torch.stack([em, -em], dim=-1), torch.stack([ep, ep], dim=-1)], dim=-1)


def _split_layers(tops: np.ndarray, zs: float) -> tuple:
    """Layer pieces ``(z_top, z_bot, layer)`` with the source depth
    inserted as an interface, and the index of the source interface
    (interface i sits at pieces[i].z_bot == pieces[i + 1].z_top)."""
    pieces = []
    src_iface = None
    nl = len(tops)
    for i in range(nl):
        z0 = float(tops[i])
        z1 = float(tops[i + 1]) if i + 1 < nl else np.inf
        if z0 < zs < z1:
            pieces.append((z0, zs, i))
            src_iface = len(pieces) - 1
            pieces.append((zs, z1, i))
        else:
            if zs == z0 and i > 0 and src_iface is None:
                src_iface = len(pieces) - 1
            pieces.append((z0, z1, i))
    if src_iface is None:
        raise ValueError(f"source depth {zs} not strictly inside the model")
    return pieces, src_iface


def _piece_arrays(tops: np.ndarray, zs_list, device) -> tuple:
    """Per (source depth, piece): thickness (inf for the halfspace) and
    layer index, and each depth's source interface; every depth must give
    the same number of pieces."""
    split = [_split_layers(tops, float(z)) for z in zs_list]
    n = {len(p) for p, _ in split}
    if len(n) != 1:
        raise ValueError("a solve batch needs source depths that split the same layer count")
    h = np.array([[z1 - z0 for z0, z1, _ in p] for p, _ in split])
    layer = np.array([[li for _, _, li in p] for p, _ in split])
    src = np.array([s for _, s in split])
    return (torch.as_tensor(np.where(np.isfinite(h), h, 0.0), dtype=FLOAT, device=device),
            torch.as_tensor(layer, device=device), src)


def _solve_psv_batch(media: Media, zs_list, k: torch.Tensor, jumps: list) -> list:
    """Solve the P-SV global system of every model, source depth and
    wavenumber at once: ``k`` (Z, nk) (one grid per depth), ``jumps`` a
    list of (Z, nk, 4) source jump vectors (physical variables (U, V,
    P/k, S/k), below minus above).  Returns surface vectors [(M, Z, nk,
    4), ...]."""
    h, layer, src = _piece_arrays(media.tops, zs_list, k.device)
    Z, Lp = layer.shape
    M, nk = media.n_models, k.shape[-1]
    ncols = [4] * (Lp - 1) + [2]
    offs = np.concatenate([[0], np.cumsum(ncols)])
    N = int(offs[-1])
    bases = tuple(b[:, layer] for b in (media.qm, media.pm, media.qp, media.pp))  # (M, Z, Lp, 4)
    # stress rows in units of the models' median µ: the same system with
    # rows of one scale (µ·(P̃, S̃) rows are ~1e10 beside displacement rows
    # of 1, which costs LAPACK's pivoting 1e-8 of the kernels)
    mu_ref = media.mu_ref[:, None, None, None, None, None]
    mu = media.mu[:, layer][..., None, None, None] / mu_ref              # (M, Z, Lp, 1, 1, 1)
    kz = k[None, :, None, :]
    zero = torch.zeros_like(h)
    # each piece at its top (dz_top = 0, dz_bot = -h) and at its bottom
    # (dz_top = h, dz_bot = 0), in physical continuity variables µ·(P̃, S̃)
    scale = torch.ones((4, 1), dtype=FLOAT, device=k.device)
    scale[2:] = 0.0
    top = _psv_columns_k(bases, kz, zero, -h)                            # (M, Z, Lp, nk, 4, 4)
    bot = _psv_columns_k(bases, kz, h, zero)
    phys = lambda c: c * (scale + (1 - scale) * mu)                              # noqa: E731
    A = torch.zeros((M, Z, nk, N, N), dtype=FLOAT, device=k.device)
    top_phys = phys(top)
    A[..., 0:2, offs[0]:offs[1]] = top_phys[:, :, 0, :, 2:4, :ncols[0]]
    bot_phys = phys(bot)
    for i in range(Lp - 1):
        r = 2 + 4 * i
        A[..., r:r + 4, offs[i]:offs[i + 1]] = -bot_phys[:, :, i, :, :, :ncols[i]]
        A[..., r:r + 4, offs[i + 1]:offs[i + 2]] = top_phys[:, :, i + 1, :, :, :ncols[i + 1]]
    b = torch.zeros((M, Z, nk, N, len(jumps)), dtype=FLOAT, device=k.device)
    jump_scale = torch.ones((M, 1, 4), dtype=FLOAT, device=k.device)
    jump_scale[..., 2:] = 1.0 / media.mu_ref[:, None, None]
    for z, s in enumerate(src):
        r = 2 + 4 * int(s)
        for j, jump in enumerate(jumps):
            b[:, z, :, r:r + 4, j] = jump[z] * jump_scale
    coef = torch.linalg.solve(A, b)
    c_surf = top[:, :, 0, :, :, :ncols[0]]                                       # (M, Z, nk, 4, c)
    y0 = c_surf @ coef[..., offs[0]:offs[1], :]                                  # (M, Z, nk, 4, R)
    return [y0[..., j] for j in range(len(jumps))]


def _solve_sh_batch(media: Media, zs_list, k: torch.Tensor, jump2: torch.Tensor) -> torch.Tensor:
    """The SH global system of every model, depth and wavenumber: ``jump2``
    (Z, nk, 2) in (W, T/k).  Returns surface vectors (M, Z, nk, 2)."""
    h, layer, src = _piece_arrays(media.tops, zs_list, k.device)
    Z, Lp = layer.shape
    M, nk = media.n_models, k.shape[-1]
    ncols = [2] * (Lp - 1) + [1]
    offs = np.concatenate([[0], np.cumsum(ncols)])
    N = int(offs[-1])
    mu = media.mu[:, layer][..., None, None] / media.mu_ref[:, None, None, None, None]
    kz = k[:, None, :]
    zero = torch.zeros_like(h)
    top = _sh_columns_k(kz, zero, -h)[None]                              # (1, Z, Lp, nk, 2, 2)
    bot = _sh_columns_k(kz, h, zero)[None]
    row_scale = torch.tensor([1.0, 0.0], dtype=FLOAT, device=k.device)[:, None]

    def phys(c):
        return c * (row_scale + (1 - row_scale) * mu[..., None])                 # T/k = µ·T̃

    top_phys, bot_phys = phys(top), phys(bot)
    A = torch.zeros((M, Z, nk, N, N), dtype=FLOAT, device=k.device)
    A[..., 0:1, offs[0]:offs[1]] = top_phys[:, :, 0, :, 1:2, :ncols[0]]
    for i in range(Lp - 1):
        r = 1 + 2 * i
        A[..., r:r + 2, offs[i]:offs[i + 1]] = -bot_phys[:, :, i, :, :, :ncols[i]]
        A[..., r:r + 2, offs[i + 1]:offs[i + 2]] = top_phys[:, :, i + 1, :, :, :ncols[i + 1]]
    b = torch.zeros((M, Z, nk, N, 1), dtype=FLOAT, device=k.device)
    for z, s in enumerate(src):
        r = 1 + 2 * int(s)
        b[:, z, :, r:r + 2, 0] = jump2[z]
    b[..., 0::2, :] /= media.mu_ref[:, None, None, None, None]                 # the T rows
    coef = torch.linalg.solve(A, b)[..., 0]
    c_surf = top[:, :, 0, :, :, :ncols[0]]                                       # (1, Z, nk, 2, c)
    return (c_surf @ coef[..., offs[0]:offs[1], None])[..., 0]


def surface_kernels(media: Media, zs_list, k: torch.Tensor) -> dict:
    """Surface displacement kernels of unit point forces at the depths
    ``zs_list`` over per-depth wavenumber grids ``k`` (Z, nk), for every
    model of ``media``: U0, V0 (vertical, +down force, m = 0) and U1, V1,
    W1 (horizontal force, m = 1; W1 the SH part), each (M, Z, nk)."""
    # vertical force: Δ(P/k) = -1/(2πk); horizontal: Δ(S/k) = Δ(T/k) = -1/(2πk)
    c = -1.0 / (2 * math.pi * k)
    zero = torch.zeros_like(k)
    jz = torch.stack([zero, zero, c, zero], dim=-1)
    jh = torch.stack([zero, zero, zero, c], dim=-1)
    yz, yh = _solve_psv_batch(media, zs_list, k, [jz, jh])
    w = _solve_sh_batch(media, zs_list, k, jh[..., 2:])
    return {"U0": yz[..., 0], "V0": yz[..., 1], "U1": yh[..., 0], "V1": yh[..., 1],
            "W1": w[..., 0]}


class ForceKernels:
    """Point-force surface kernels on log-spaced solver grids (one per
    source depth), resampled onto the much finer oscillation-resolving
    Hankel grids: the solves are decoupled from the quadrature.

    ``kern[name]`` (M, Z, n): the kernels of every model of ``media`` at
    every depth of ``zs_list``."""

    NAMES = ("U0", "V0", "U1", "V1", "W1")

    def __init__(self, media: Media, zs_list, n: int = N_SOLVE):
        self.zs = np.atleast_1d(np.asarray(zs_list, dtype=np.float64))
        self.k = np.stack([np.geomspace(1e-6 / z, 60.0 / z, n) for z in self.zs])
        k = torch.as_tensor(self.k, dtype=FLOAT, device=media.device)
        self.kern = _batched_kernels(media, self.zs, k)
        self._k, self._logk = k, torch.log(k)
        # g(k) = k·kernel: bounded, finite at k → 0, smooth in log k
        self._g = torch.stack([k * self.kern[name] for name in self.NAMES], dim=-2)  # (M, Z, 5, n)

    def resample_g(self, k_fine: torch.Tensor, which: torch.Tensor) -> torch.Tensor:
        """g(k) of depth ``which[e]`` at ``k_fine[e]`` (E, K), linearly
        interpolated in log k (``np.interp``: clamped at the ends; k = 0
        takes the k → 0 limit).  Returns (M, E, 5, K)."""
        logk = self._logk[which]                                                  # (E, n)
        lk = torch.log(torch.maximum(k_fine, self._k[which, :1]))
        n = logk.shape[-1]
        j = torch.clamp(torch.searchsorted(logk, lk, right=True) - 1, 0, n - 2)
        x0, x1 = torch.gather(logk, 1, j), torch.gather(logk, 1, j + 1)
        t = torch.clamp((lk - x0) / (x1 - x0), 0.0, 1.0)
        g = self._g[:, which]                                                     # (M, E, 5, n)
        idx = j[None, :, None, :].expand(g.shape[0], -1, g.shape[2], -1)
        y0, y1 = torch.gather(g, 3, idx), torch.gather(g, 3, idx + 1)
        return y0 + t[None, :, None, :] * (y1 - y0)


def _batched_kernels(media: Media, zs: np.ndarray, k: torch.Tensor) -> dict:
    """:func:`surface_kernels` over the depths, grouped by their layer
    pieces' count (a depth on an interface splits no layer) and cut to
    the memory budget (the global matrices are (M, Z, nk, N, N) float64)."""
    n_pieces = np.array([len(_split_layers(media.tops, float(z))[0]) for z in zs])
    out = {}
    for n in np.unique(n_pieces):
        idx = np.flatnonzero(n_pieces == n)
        per_depth = media.n_models * k.shape[-1] * (4 * int(n)) ** 2 * 8 * 4
        step = max(1, int(chunk_budget(media.device) // per_depth))
        for i in range(0, idx.size, step):
            part = idx[i:i + step]
            out[tuple(part)] = surface_kernels(media, zs[part], k[part])
    order = np.argsort(np.concatenate([np.asarray(p) for p in out]))
    return {name: torch.cat([p[name] for p in out.values()], dim=1)[:, order]
            for name in ForceKernels.NAMES}


#: points a half cycle of J(k·r_max) on the Hankel grids (the JAX package's)
PTS_PER_HALFCYCLE = 20.0


def _integration_grid(zs: float, r_max: float,
                      pts_per_halfcycle: float = PTS_PER_HALFCYCLE) -> np.ndarray:
    """Linear trapezoid grid resolving the J(kr) oscillation at the
    farthest receiver and the e^{-k·zs} kernel decay."""
    k_max = 60.0 / zs
    dk = min(np.pi / (pts_per_halfcycle * max(r_max, zs)), 1.0 / (40.0 * zs))
    n = min(int(np.ceil(k_max / dk)), NK_MAX)
    return np.linspace(0.0, k_max, n + 1)


# ---------------------------------------------------------------------------
# Hankel synthesis of shifted evaluations
# ---------------------------------------------------------------------------


def bessel_matrices(r: torch.Tensor, k: torch.Tensor) -> tuple:
    """The Bessel synthesis matrices (J0, J1, J1/kr, J1' = J0 - J1/kr) of
    radii ``r`` (..., N) and wavenumbers ``k`` (..., K): each (..., N, K),
    float64 on their device (:mod:`beat_tpu_torch.ops.bessel`; J1/kr → 1/2
    at kr = 0)."""
    kr = r[..., :, None] * k[..., None, :]
    J0 = bessel_j0(kr)
    J1 = bessel_j1(kr)
    J1_over = torch.where(kr > 0, J1 / torch.where(kr > 0, kr, 1.0), 0.5)
    return J0, J1, J1_over, J0 - J1_over


def _assemble_G(mv: tuple, cphi: torch.Tensor, sphi: torch.Tensor) -> torch.Tensor:
    """(..., N, 3, 3) Green tensors from the five synthesis vectors
    (uz_z, ur_z, uz_x1, ur_x1, up_x1) (..., N) and the receivers' azimuth
    factors (..., N)."""
    uz_z, ur_z, uz_x1, ur_x1, up_x1 = mv
    c, s = cphi, sphi
    col_x = torch.stack([c * ur_x1 * c + s * up_x1 * s, c * ur_x1 * s - s * up_x1 * c,
                         c * uz_x1], dim=-1)
    col_y = torch.stack([s * ur_x1 * c - c * up_x1 * s, s * ur_x1 * s + c * up_x1 * c,
                         s * uz_x1], dim=-1)
    col_z = torch.stack([ur_z * c, ur_z * s, uz_z], dim=-1)
    return torch.stack([col_x, col_y, col_z], dim=-1)


def _hankel_static(g: torch.Tensor, k: torch.Tensor, kw: torch.Tensor,
                   r: torch.Tensor) -> tuple:
    """Synthesis vectors of kernels ``g`` (M, E, 5, K) (U0, V0, U1, V1, W1
    times k) on grids ``k`` with trapezoid weights ``kw`` (E, K) at radii
    ``r`` (E, N): five (M, E, N)."""
    J0, J1, J1_over, J1p = bessel_matrices(r, k)                                 # (E, N, K)
    gw = (g * kw[None, :, None, :]).permute(1, 3, 0, 2)                           # (E, K, M, 5)
    E, K, M, _ = gw.shape

    def apply(J, cols):
        return (J @ gw[..., cols].reshape(E, K, -1)).reshape(E, -1, M, len(cols))

    uz_z = apply(J0, [0])[..., 0]
    j1 = apply(J1, [1, 2])
    jo = apply(J1_over, [3, 4])
    jp = apply(J1p, [3, 4])
    mv = (uz_z, -j1[..., 0], j1[..., 1], jp[..., 0] + jo[..., 1], jo[..., 0] + jp[..., 1])
    return tuple(v.permute(2, 0, 1) for v in mv)


def _shifted_G(kernels: ForceKernels, evals: list, device,
               pts_per_halfcycle: float = PTS_PER_HALFCYCLE) -> torch.Tensor:
    """Green tensors (M, E, N, 3, 3) of evaluations ``(kernel depth
    index, receivers (N, 2) numpy)``: each on its own trapezoid grid
    (``_integration_grid`` of its depth and farthest receiver), padded to
    a common length with zero weights and synthesized together in chunks
    of the memory budget."""
    grids, radii, cphi, sphi = [], [], [], []
    for iz, obs in evals:
        r = np.maximum(np.hypot(obs[:, 0], obs[:, 1]), 1e-6)
        radii.append(r)
        cphi.append(obs[:, 0] / r)
        sphi.append(obs[:, 1] / r)
        grids.append(_integration_grid(float(kernels.zs[iz]), float(r.max()),
                                       pts_per_halfcycle))
    n_obs = radii[0].size
    # per (evaluation, k): 16 float64 per receiver (kr, the four Bessel
    # matrices and the Cephes temporaries live while J1 is evaluated beside
    # J0), and the M models' five weighted kernels four times over
    bytes_per_k = n_obs * 8 * 16 + kernels._g.shape[0] * 5 * 8 * 4
    out = []
    start = 0
    while start < len(evals):
        stop, k_len = start, 0
        while stop < len(evals):
            k_next = max(k_len, grids[stop].size)
            if stop > start and (stop + 1 - start) * k_next * bytes_per_k > chunk_budget(device):
                break
            k_len, stop = k_next, stop + 1
        k = np.zeros((stop - start, k_len))
        kw = np.zeros_like(k)
        for e in range(start, stop):
            grid = grids[e]
            w = np.gradient(grid)
            w[0] *= 0.5
            w[-1] *= 0.5
            k[e - start, :grid.size], kw[e - start, :grid.size] = grid, w
        t = lambda a: torch.as_tensor(np.stack(a) if isinstance(a, list) else a,  # noqa: E731
                                      dtype=FLOAT, device=device)
        kt, kwt = t(k), t(kw)
        which = torch.as_tensor([evals[e][0] for e in range(start, stop)], device=device)
        g = kernels.resample_g(kt, which)
        mv = _hankel_static(g, kt, kwt, t(radii[start:stop]))
        out.append(_assemble_G(mv, t(cphi[start:stop]), t(sphi[start:stop])))
        start = stop
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Point forces and moment tensors
# ---------------------------------------------------------------------------


def point_force_surface_displacement(model, zs: float, obs_xy, *, device) -> torch.Tensor:
    """Static surface displacement Green tensor (N, 3, 3) of buried unit
    point forces: component i ∈ (east, north, down) per unit force j ∈
    (+east, +north, +down); receivers ``obs_xy`` (N, 2) relative to the
    epicentre."""
    dev = resolve(device)
    kernels = ForceKernels(Media([model], device=dev), [zs])
    return _shifted_G(kernels, [(0, np.asarray(obs_xy, dtype=np.float64))], dev)[0, 0]


def _m6_ned_to_xyz(m6: np.ndarray) -> np.ndarray:
    """NED m6 (..., 6) → full (..., 3, 3) in the (x = E, y = N, z = down)
    frame of G."""
    mnn, mee, mdd, mne, mnd, med = np.moveaxis(np.asarray(m6, dtype=np.float64), -1, 0)
    return np.stack([np.stack([mee, mne, med], -1), np.stack([mne, mnn, mnd], -1),
                     np.stack([med, mnd, mdd], -1)], -2)


def source_gradients(models, depths, obs_xy, rel_step: float = 1e-3, *,
                     device) -> torch.Tensor:
    """∂G_kp/∂ξ_q over the source position for every model and depth:
    (M, nz, N, 3, 3, 3) in the (x = E, y = N, z = down) frame.  Per depth
    one solve at z_s and two at z_s ± δ (δ = rel_step·z_s), all models and
    depths in one batch; six shifted Hankel evaluations per depth, all in
    one batch."""
    return _source_gradients(models, depths, obs_xy, rel_step, resolve(device),
                             PTS_PER_HALFCYCLE)


def _source_gradients(models, depths, obs_xy, rel_step: float, dev: torch.device,
                      pts_per_halfcycle: float) -> torch.Tensor:
    """:func:`source_gradients` on Hankel grids of ``pts_per_halfcycle``."""
    media = models if isinstance(models, Media) else Media(models, device=dev)
    depths = np.atleast_1d(np.asarray(depths, dtype=np.float64))
    obs = np.asarray(obs_xy, dtype=np.float64)
    d = rel_step * depths
    kernels = ForceKernels(media, np.concatenate([depths, depths + d, depths - d]))
    nz = depths.size
    evals = []
    for i, di in enumerate(d):
        for shift in ((di, 0.0), (-di, 0.0), (0.0, di), (0.0, -di)):
            evals.append((i, obs - np.asarray(shift)[None, :]))
        evals += [(nz + i, obs), (2 * nz + i, obs)]
    # (M, nz, 6, N, 3, 3): per depth the shifts +x, -x, +y, -y, then z ± δ
    G = _shifted_G(kernels, evals, dev, pts_per_halfcycle).unflatten(1, (nz, 6))
    two_d = torch.as_tensor(2 * d, dtype=FLOAT, device=dev)[None, :, None, None, None]
    return torch.stack([(G[:, :, 0] - G[:, :, 1]) / two_d, (G[:, :, 2] - G[:, :, 3]) / two_d,
                        (G[:, :, 4] - G[:, :, 5]) / two_d], dim=-1)


def source_gradient_tensor(model, zs: float, obs_xy, rel_step: float = 1e-3, *,
                           device) -> torch.Tensor:
    """∂G_kp/∂ξ_q (N, 3, 3, 3) of one model at one depth."""
    return source_gradients([model], [zs], obs_xy, rel_step, device=device)[0, 0]


def _mt_from_gradients(dG: torch.Tensor, m_xyz: torch.Tensor) -> torch.Tensor:
    """Surface displacements (..., N, 3 = east, north, up) of moment
    tensors ``m_xyz`` (..., 3, 3) from source gradients (..., N, 3, 3, 3)."""
    u = torch.einsum("...pq,...nkpq->...nk", m_xyz, dG)
    return torch.stack([u[..., 0], u[..., 1], -u[..., 2]], dim=-1)


def elementary_mt_displacements(models, depths, obs_xy, rel_step: float = 1e-3, *,
                                device) -> torch.Tensor:
    """(M, nz, 6, N, 3) surface displacements (east, north, up) of the six
    unit elementary moment tensors (mnn, mee, mdd, mne, mnd, med) for
    every model and depth: the table builders' batch."""
    dG = source_gradients(models, depths, obs_xy, rel_step, device=device)
    m_xyz = torch.as_tensor(_m6_ned_to_xyz(np.eye(6)), dtype=FLOAT, device=dG.device)
    return _mt_from_gradients(dG[:, :, None], m_xyz)


def elementary_mt_surface_displacements(model, zs: float, obs_xy, rel_step: float = 1e-3, *,
                                        device) -> torch.Tensor:
    """(6, N, 3) surface displacements (east, north, up) of the six unit
    elementary moment tensors at depth ``zs``."""
    return elementary_mt_displacements([model], [zs], obs_xy, rel_step, device=device)[0, 0]


def mt_surface_displacement_layered(model, zs: float, obs_xy, m6, rel_step: float = 1e-3, *,
                                    device) -> torch.Tensor:
    """Surface displacement (N, 3 = east, north, up) of a buried point
    moment tensor (NED m6 [Nm]) in the layered model."""
    return _mt_displacement(model, zs, obs_xy, m6, rel_step, resolve(device),
                            PTS_PER_HALFCYCLE)


def _mt_displacement(model, zs: float, obs_xy, m6, rel_step: float, dev: torch.device,
                     pts_per_halfcycle: float) -> torch.Tensor:
    """:func:`mt_surface_displacement_layered` on Hankel grids of
    ``pts_per_halfcycle`` (the JAX package's 20 resolves the Bessel
    oscillation; models with deep interfaces need more near k = 0, where
    their kernels change on the scale 1/depth: the ω → 0 check of
    ``chip_smoke.py`` reads this converged reference)."""
    dG = _source_gradients([model], [zs], obs_xy, rel_step, dev, pts_per_halfcycle)[0, 0]
    m_xyz = torch.as_tensor(_m6_ned_to_xyz(m6), dtype=FLOAT, device=dG.device)
    return _mt_from_gradients(dG, m_xyz)
