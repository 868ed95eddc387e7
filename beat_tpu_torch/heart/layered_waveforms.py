"""
Layered-earth waveform Green's functions by the discrete wavenumber
method — the qseis analogue (port of ``beat_tpu/heart/layered_waveforms.py``),
in complex128 on the caller's device.

* For each complex frequency ``ω' = ω − iζ`` and wavenumber k the P-SV
  and SH wave solutions of every layer (principal-branch vertical
  wavenumbers), each normalized to the boundary it decays from, meet the
  free-surface, interface and radiation conditions: one global linear
  system per (ω, k) (:func:`dynamic_force_kernels`, batched
  ``torch.linalg.solve``), or the Kennett recursion of
  :mod:`beat_tpu_torch.heart.reflectivity` over the whole lattice.
* Point forces enter as frequency-independent traction jumps; surface
  displacements follow by midpoint-rule Hankel synthesis over k, whose
  frequency-independent Bessel matrices are evaluated once per grid on
  the device (:mod:`beat_tpu_torch.ops.bessel`) and applied to all
  frequencies of a chunk as real GEMMs (the complex columns viewed as
  real pairs, ``torch.view_as_real``).
* Moment tensors are force dipoles (horizontal derivatives by receiver
  shifts, the vertical one by two more solves), as in the static module.
* The Bouchon damping ``ζ = ζ_cycles·π/T`` is undone in the time domain;
  the table's tail (inverse FFT, growth, alignment to ``t0``) is one
  batched pass over every trace.

Host pieces (numpy, as in the JAX package): the wavenumber grids and
their ``nk_max`` clamp (:func:`dynamic_integration_grid`), the depth
buckets, :func:`nudge_depths_off_interfaces`, the cubic-spline matrix of
the evanescent tail (:func:`spline_matrix`, applied on the device as one
GEMM), the ray-traced travel-time tables, and the bins with |ω| < 0.06,
which the Kennett path recomputes in ``np.clongdouble`` on the host
(:func:`_kernels_band_safe`: the P-SV basis degenerates as ω → 0, and no
complex type of torch or CUDA is wider than complex128), falling back to
the global-matrix solve on the device where even that disagrees.

Conventions: z positive down, free surface at z = 0, NED moment tensors,
receiver components (Z up, R radial, T transverse) at azimuth 0.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from beat_tpu_torch.device import chunk_budget, resolve
from beat_tpu_torch.heart.layered_statics import _assemble_G, _m6_ned_to_xyz, bessel_matrices

logger = logging.getLogger("beat_tpu_torch.heart.layered_waveforms")

CFLOAT = torch.complex128
FLOAT = torch.float64
_KERNEL_NAMES = ("U0", "V0", "U1", "V1", "W1")


def _as_complex(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.complex128), device=device)


# ---------------------------------------------------------------------------
# Per-layer wave columns and the global-matrix solves
# ---------------------------------------------------------------------------


def _psv_wave_entries(lam, mu, rho, w2, k):
    """Raw P-SV wave-column entries of one material over the lattice
    (``w2`` (..., 1) or (...), ``k`` (..., nk)): ``(nu_a, nu_b, cols)``,
    cols (..., nk, 4, 4) in physical variables (U, V, P, S), columns
    [P down, SV down, P up, SV up]; 'down' ~ e^{−νz}, 'up' ~ e^{+νz}."""
    va2 = (lam + 2 * mu) / rho
    vb2 = mu / rho
    nu_a = torch.sqrt(k * k - w2 / va2 + 0j)
    nu_b = torch.sqrt(k * k - w2 / vb2 + 0j)
    p_even = 2 * mu * nu_a**2 - lam * (w2 / va2)
    s_even = mu * k * (nu_b**2 + k * k)
    kc = k + 0j * k
    cols = []
    for s, fam in ((-1, "P"), (-1, "SV"), (+1, "P"), (+1, "SV")):
        if fam == "P":
            col = torch.broadcast_tensors(s * nu_a, kc, p_even, 2 * mu * s * nu_a * k)
        else:
            col = torch.broadcast_tensors(k * k + 0j * k, s * nu_b * k,
                                          2 * mu * s * nu_b * k * k, s_even)
        cols.append(torch.stack(col, dim=-1))
    return nu_a, nu_b, torch.stack(cols, dim=-1)


def _psv_columns_dyn(lam, mu, rho, w2, k, dz_top, dz_bot, halfspace, stress_scale):
    """Boundary-normalized P-SV columns at one evaluation depth:
    (..., nk, 4, ncols), stress rows divided by ``stress_scale`` and each
    column by its max-abs entry; ncols 2 (halfspace) or 4."""
    nu_a, nu_b, cols = _psv_wave_entries(lam, mu, rho, w2, k)
    row_scale = torch.stack(torch.broadcast_tensors(
        torch.ones_like(stress_scale), torch.ones_like(stress_scale), stress_scale,
        stress_scale), dim=-1)
    cols = cols / row_scale[..., None]
    norm = torch.amax(torch.abs(cols), dim=-2)                      # (..., nk, 4)
    cols = cols / norm[..., None, :]
    nus = torch.stack(torch.broadcast_tensors(nu_a, nu_b), dim=-1)  # (..., nk, 2)
    phase = [torch.exp(-nus * dz_top)]
    if not halfspace:
        phase.append(torch.exp(nus * dz_bot))
    phase = torch.cat(phase, dim=-1)
    return cols[..., :phase.shape[-1]] * phase[..., None, :]


def _sh_columns_dyn(mu, rho, w2, k, dz_top, dz_bot, halfspace, stress_scale):
    """SH columns y = (W, T), T = µ ∂_z W: (..., nk, 2, ncols)."""
    nu_b = torch.sqrt(k * k - w2 * rho / mu + 0j)
    one = torch.ones_like(nu_b)
    cols = [torch.stack([one, -mu * nu_b / stress_scale], dim=-1)]
    if not halfspace:
        cols.append(torch.stack([one, mu * nu_b / stress_scale], dim=-1))
    cols = torch.stack(cols, dim=-1)
    norm = torch.amax(torch.abs(cols), dim=-2)
    cols = cols / norm[..., None, :]
    phase = [torch.exp(-nu_b * dz_top)]
    if not halfspace:
        phase.append(torch.exp(nu_b * dz_bot))
    return cols * torch.stack(phase, dim=-1)[..., None, :]


def _split_layers_rho(model, zs: float):
    """Layer pieces (z_top, z_bot, lam, mu, rho) with the source depth as
    an interface; constant-Q complex velocities ``v·(1 + i/2Q)`` make the
    Lamé moduli complex."""
    tops = list(model.tops)
    vp, vs, rho = model.vp, model.vs, model.rho
    if getattr(model, "qp", None) is not None:
        vp = vp * (1.0 + 0.5j / model.qp)
    if getattr(model, "qs", None) is not None:
        vs = vs * (1.0 + 0.5j / model.qs)
    lam_l = rho * (vp**2 - 2 * vs**2)
    mu_l = rho * vs**2
    cast = complex if np.iscomplexobj(lam_l) else float
    pieces = []
    src_iface = None
    nl = len(tops)
    for i in range(nl):
        z0 = float(tops[i])
        z1 = float(tops[i + 1]) if i + 1 < nl else np.inf
        mat = (cast(lam_l[i]), cast(mu_l[i]), float(rho[i]))
        if z0 < zs < z1:
            pieces.append((z0, zs) + mat)
            src_iface = len(pieces) - 1
            pieces.append((zs, z1) + mat)
        else:
            if zs == z0 and i > 0 and src_iface is None:
                src_iface = len(pieces) - 1
            pieces.append((z0, z1) + mat)
    if src_iface is None:
        raise ValueError(f"source depth {zs} not strictly inside the model")
    return pieces, src_iface


def _solve_psv_dyn(pieces, src_iface, k, w2, stress_scale, jumps):
    """Batched complex P-SV global solve over the lattice (``w2`` (..., 1),
    ``k`` (nk,), ``stress_scale`` (..., nk)); ``jumps`` are physical (U, V,
    P, S) source discontinuities (4,).  Returns [(..., nk, 4) surface
    vectors, ...] (stress entries still scaled)."""
    L = len(pieces)
    ncols = [2 if i == L - 1 else 4 for i in range(L)]
    offs = np.concatenate([[0], np.cumsum(ncols)])
    N = int(offs[-1])
    lattice = stress_scale.shape
    A = torch.zeros(lattice + (N, N), dtype=CFLOAT, device=k.device)
    b = torch.zeros(lattice + (N, len(jumps)), dtype=CFLOAT, device=k.device)

    def cols_at(i, z):
        z0, z1, lam, mu, rho = pieces[i]
        return _psv_columns_dyn(lam, mu, rho, w2, k, z - z0,
                                0.0 if not np.isfinite(z1) else z - z1,
                                halfspace=(i == L - 1), stress_scale=stress_scale)

    c_surf = cols_at(0, pieces[0][0])
    A[..., 0, offs[0]:offs[1]] = c_surf[..., 2, :]               # P(0) = 0
    A[..., 1, offs[0]:offs[1]] = c_surf[..., 3, :]               # S(0) = 0
    row = 2
    for i in range(L - 1):
        z = pieces[i][1]
        A[..., row:row + 4, offs[i]:offs[i + 1]] = -cols_at(i, z)
        A[..., row:row + 4, offs[i + 1]:offs[i + 2]] = cols_at(i + 1, z)
        if i == src_iface:
            one = torch.ones_like(stress_scale)
            scale = torch.stack([one, one, stress_scale, stress_scale], dim=-1)
            for jr, jump in enumerate(jumps):
                b[..., row:row + 4, jr] = _as_complex(jump, k.device) / scale
        row += 4
    coef = torch.linalg.solve(A, b)
    y0 = c_surf @ coef[..., offs[0]:offs[1], :]                 # (..., nk, 4, R)
    return [y0[..., jr] for jr in range(len(jumps))]


def _solve_sh_dyn(pieces, src_iface, k, w2, stress_scale, jump2):
    L = len(pieces)
    ncols = [1 if i == L - 1 else 2 for i in range(L)]
    offs = np.concatenate([[0], np.cumsum(ncols)])
    N = int(offs[-1])
    lattice = stress_scale.shape
    A = torch.zeros(lattice + (N, N), dtype=CFLOAT, device=k.device)
    b = torch.zeros(lattice + (N, 1), dtype=CFLOAT, device=k.device)

    def cols_at(i, z):
        z0, z1, lam, mu, rho = pieces[i]
        return _sh_columns_dyn(mu, rho, w2, k, z - z0, 0.0 if not np.isfinite(z1) else z - z1,
                               halfspace=(i == L - 1), stress_scale=stress_scale)

    c_surf = cols_at(0, pieces[0][0])
    A[..., 0, offs[0]:offs[1]] = c_surf[..., 1, :]               # T(0) = 0
    row = 1
    for i in range(L - 1):
        z = pieces[i][1]
        A[..., row:row + 2, offs[i]:offs[i + 1]] = -cols_at(i, z)
        A[..., row:row + 2, offs[i + 1]:offs[i + 2]] = cols_at(i + 1, z)
        if i == src_iface:
            jv = np.asarray(jump2, dtype=np.complex128)
            b[..., row, 0] = float(jv[0].real)
            b[..., row + 1, 0] = complex(jv[1]) / stress_scale
        row += 2
    coef = torch.linalg.solve(A, b)[..., 0]
    return (c_surf @ coef[..., offs[0]:offs[1], None])[..., 0]


def dynamic_force_kernels(model, zs: float, w_c, k_grid, *, device) -> dict:
    """Surface displacement kernels of buried unit point forces by the
    global-matrix solve: ``w_c`` one complex frequency or an array of
    them; returns complex (nk,) or (nf, nk) tensors U0, V0, U1, V1, W1."""
    dev = resolve(device)
    pieces, src_iface = _split_layers_rho(model, zs)
    w_c = np.asarray(w_c, dtype=np.complex128)
    k = torch.as_tensor(np.asarray(k_grid, dtype=np.float64), device=dev)
    w = _as_complex(w_c.reshape(-1, 1), dev)
    w2 = w * w
    vs_min = float(np.min(model.vs))
    mu0 = float(np.median(model.rho * model.vs**2))
    stress_scale = mu0 * (k + torch.abs(w) / vs_min)            # (nf, nk)
    jz = np.zeros(4)
    jz[2] = -1.0 / (2 * np.pi)
    jh = np.zeros(4)
    jh[3] = -1.0 / (2 * np.pi)
    jsh = np.zeros(2)
    jsh[1] = -1.0 / (2 * np.pi)
    out = {n: [] for n in _KERNEL_NAMES}
    n_pieces = len(pieces)
    per_bin = k.numel() * (4 * n_pieces) ** 2 * 16 * 4
    step = max(1, int(chunk_budget(dev) // per_bin))
    for i in range(0, w2.shape[0], step):
        sl = slice(i, i + step)
        yz, yh = _solve_psv_dyn(pieces, src_iface, k, w2[sl], stress_scale[sl], [jz, jh])
        wsh = _solve_sh_dyn(pieces, src_iface, k, w2[sl], stress_scale[sl], jsh)
        for name, v in (("U0", yz[..., 0]), ("V0", yz[..., 1]), ("U1", yh[..., 0]),
                        ("V1", yh[..., 1]), ("W1", wsh[..., 0])):
            out[name].append(v)
    kern = {n: torch.cat(v) for n, v in out.items()}
    return {n: v[0] for n, v in kern.items()} if w_c.ndim == 0 else kern


# ---------------------------------------------------------------------------
# Grids (host)
# ---------------------------------------------------------------------------


def dynamic_integration_grid(model, zs: float, r_max: float, T: float, w_abs: float,
                             ppw: float = 1.2, nk_max: int = 120_000,
                             tail_coeff: float = 50.0) -> np.ndarray:
    """Midpoint-rule wavenumber grid: spacing resolves the Bessel
    oscillation over the Bouchon periodicity ``r_max + vp_max·T``, extent
    the propagating region plus the ``e^{−k·zs}`` evanescent tail
    (truncated at ``e^{−tail_coeff}``); clamped at ``nk_max`` with a
    warning shown once per process."""
    vp_max = float(np.max(model.vp))
    vs_min = float(np.min(model.vs))
    span = r_max + vp_max * T
    dk = 2.0 * np.pi / (ppw * span)
    k_max = w_abs / vs_min * 1.05 + tail_coeff / max(zs, 1e3)
    nk = int(np.ceil(k_max / dk))
    if nk > nk_max:
        if not getattr(dynamic_integration_grid, "_clamp_warned", False):
            dynamic_integration_grid._clamp_warned = True
            logger.warning(
                "wavenumber grid clamped: %i -> %i points (k_max %.3g, dk %.3g) — the "
                "evanescent tail is truncated; shorten the window, lower fmax or raise "
                "nk_max (warning shown once; later clamps in this build are silent)",
                nk, nk_max, k_max, dk)
        nk = nk_max
    return (np.arange(nk) + 0.5) * dk


def _hybrid_solve_grid(model, k_grid: np.ndarray, w_abs: float,
                       pts_per_decade: int = 128) -> tuple:
    """A pole-resolving dense head (``k_grid`` up to 1.3·ω_max/vs_min) and
    a log-spaced evanescent tail: ``(solve_grid, n_dense)`` with
    ``solve_grid[:n_dense] == k_grid[:n_dense]``."""
    vs_min = float(np.min(np.real(model.vs)))
    k_dense = 1.3 * w_abs / vs_min
    n_dense = int(np.searchsorted(k_grid, k_dense)) + 1
    if n_dense >= k_grid.size - 8:
        return k_grid, k_grid.size
    k_lo = k_grid[n_dense - 1]
    k_hi = k_grid[-1]
    n_tail = max(int(np.ceil(np.log10(k_hi / k_lo) * pts_per_decade)), 8)
    tail = np.geomspace(k_lo, k_hi, n_tail + 1)[1:]
    tail[-1] = k_hi
    return np.concatenate([k_grid[:n_dense], tail]), n_dense


def spline_matrix(x_solve: np.ndarray, x_out: np.ndarray) -> np.ndarray:
    """S (n_out, n_solve) with ``S @ y == CubicSpline(x_solve, y)(x_out)``
    for any data y: scipy's not-a-knot spline is linear in its data, so
    the spline of the identity's columns is the map (host float64)."""
    from scipy.interpolate import CubicSpline

    return CubicSpline(x_solve, np.eye(x_solve.size), axis=0)(x_out)


def _depth_buckets(model, depths, r_max, T, w_abs, ppw, tail_coeff, ratio: float = 2.0):
    """Group table depths so each bucket shares one wavenumber grid within
    ``ratio`` of each member's own k_max."""
    def kmax(zs):
        vs_min = float(np.min(model.vs))
        return w_abs / vs_min * 1.05 + tail_coeff / max(zs, 1e3)

    order = sorted(range(len(depths)), key=lambda i: -kmax(depths[i]))
    buckets = []
    cur, cur_k = [], None
    for i in order:
        ki = kmax(depths[i])
        if cur and cur_k / ki > ratio:
            buckets.append(cur)
            cur, cur_k = [], None
        if not cur:
            cur_k = ki
        cur.append(i)
    if cur:
        buckets.append(cur)
    return buckets


def nudge_depths_off_interfaces(model, depths, rel_step: float = 1e-3):
    """Shift the (uniform) depth grid by a small constant offset until no
    node's vertical dipole (±rel_step·z) straddles a layer interface."""
    depths = np.asarray(depths, dtype=np.float64).copy()

    def bad(z):
        d = 2.0 * rel_step * z
        return (model.layer_of(z - d) != model.layer_of(z + d)
                or model.layer_of(z) != model.layer_of(z + d))

    for _ in range(16):
        offenders = [z for z in depths if bad(z)]
        if not offenders:
            return depths
        shift = 3.0 * rel_step * max(offenders)
        depths = depths + shift
        logger.info("depth grid shifted %.3g m off a layer interface", shift)
    raise ValueError(f"could not place the depth grid clear of layer interfaces "
                     f"{list(model.tops)} — choose depth bounds away from interfaces")


# ---------------------------------------------------------------------------
# Hankel synthesis
# ---------------------------------------------------------------------------


def _hankel_weights(r, k_grid: torch.Tensor) -> tuple:
    """The Bessel synthesis matrices (J0, J1, J1/kr, J1') (nr, nk) of radii
    ``r``, on the device of ``k_grid``."""
    r = torch.as_tensor(np.asarray(r, dtype=np.float64), device=k_grid.device)
    return bessel_matrices(r, k_grid)


def _rmatmul(J: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Real (nr, nk) @ complex (nk, nc) as one real GEMM over the complex
    columns viewed as (re, im) pairs."""
    C = C.contiguous()
    out = J @ torch.view_as_real(C).reshape(C.shape[0], -1)
    return torch.view_as_complex(out.reshape(J.shape[0], -1, 2).contiguous())


def _midpoint_dk(k_grid: torch.Tensor) -> float:
    return float(k_grid[1] - k_grid[0]) if k_grid.numel() > 1 else float(k_grid[0]) * 2


def _hankel_apply_band(weights: tuple, k_grid: torch.Tensor, kernels: dict) -> tuple:
    """Synthesis arrays (uz_z, ur_z, uz_x1, ur_x1, up_x1), each (nr, nf), of
    (nf, nk) kernels: every Bessel matrix applied to all frequencies in one
    GEMM."""
    J0, J1, J1_over, J1p = weights
    kd = (k_grid * _midpoint_dk(k_grid))[None, :]
    u0 = (kernels["U0"] * kd).T
    nf = u0.shape[1]
    pair_vu = torch.cat([(kernels["V0"] * kd).T, (kernels["U1"] * kd).T], dim=1)
    pair_vw = torch.cat([(kernels["V1"] * kd).T, (kernels["W1"] * kd).T], dim=1)
    uz_z = _rmatmul(J0, u0)
    j1_vu = _rmatmul(J1, pair_vu)
    jo_vw = _rmatmul(J1_over, pair_vw)
    jp_vw = _rmatmul(J1p, pair_vw)
    return (uz_z, -j1_vu[:, :nf], j1_vu[:, nf:], jp_vw[:, :nf] + jo_vw[:, nf:],
            jo_vw[:, :nf] + jp_vw[:, nf:])


def _G_assemble_band(mv: tuple, cphi, sphi) -> torch.Tensor:
    """(nr, nf, 3, 3) Green tensors from (nr, nf) synthesis arrays and
    (nr,) azimuth factors."""
    dev = mv[0].device
    c = torch.as_tensor(np.asarray(cphi, dtype=np.float64), device=dev)[:, None]
    s = torch.as_tensor(np.asarray(sphi, dtype=np.float64), device=dev)[:, None]
    return _assemble_G(mv, c, s)


def _shift_stencil(distances: np.ndarray, d: float) -> dict:
    """Radii and azimuth factors of the source-gradient stencil for
    receivers due north: ±d·ex share the radius hypot(d, r); +d·ey and
    −d·ey move them to r ∓ d; the vertical pair sits at r."""
    r_x = np.hypot(d, distances)
    return dict(r_x=r_x, sphi_x=distances / r_x, cphi_xp=-d / r_x, cphi_xm=d / r_x,
                ones=np.ones(distances.size), zeros=np.zeros(distances.size))


def _mt_spectra_from_G(G: dict, d: float, w_c: torch.Tensor, m_xyz: torch.Tensor) -> torch.Tensor:
    """(6, 3, nd, nf) elementary-MT step spectra (Z, R, T) from the six
    shifted Green tensors (nd, nf, 3, 3)."""
    dG = torch.stack([(G["xp"] - G["xm"]) / (2 * d), (G["yp"] - G["ym"]) / (2 * d),
                      (G["zp"] - G["zm"]) / (2 * d)], dim=-1)
    u = torch.einsum("mpq,dfcpq->mdfc", m_xyz.to(dG.dtype), dG) / (1j * w_c)[None, None, :, None]
    return torch.stack([-u[..., 2], u[..., 1], u[..., 0]], dim=1)


def _m_xyz(device) -> torch.Tensor:
    return torch.as_tensor(_m6_ned_to_xyz(np.eye(6)), dtype=FLOAT, device=device)


def elementary_mt_spectra(model, zs: float, distances, w_c: complex, k_grid, rel_step=1e-3, *,
                          device) -> torch.Tensor:
    """(6, 3, nd) complex spectra of the six unit elementary moment tensors
    (step moment) at one complex frequency, receivers due north, (Z, R, T),
    by global-matrix solves on ``k_grid`` (the per-frequency method)."""
    return elementary_mt_spectra_band(model, zs, distances, np.atleast_1d(w_c), k_grid,
                                      rel_step, device=device)[..., 0]


def elementary_mt_spectra_band(model, zs: float, distances, w_list, k_grid, rel_step=1e-3, *,
                               device) -> torch.Tensor:
    """(6, 3, nd, nw) elementary-MT spectra for a band sharing one
    wavenumber grid: global-matrix solves of all frequencies at once,
    Bessel matrices evaluated once per depth."""
    dev = resolve(device)
    distances = np.asarray(distances, dtype=np.float64)
    w_list = np.asarray(w_list, dtype=np.complex128)
    d = rel_step * zs
    k = torch.as_tensor(np.asarray(k_grid, dtype=np.float64), device=dev)
    st = _shift_stencil(distances, d)
    W = {"0": _hankel_weights(distances, k), "x": _hankel_weights(st["r_x"], k),
         "ym": _hankel_weights(distances - d, k), "yp": _hankel_weights(distances + d, k)}
    kern0 = dynamic_force_kernels(model, zs, w_list, k_grid, device=dev)
    kp = dynamic_force_kernels(model, zs + d, w_list, k_grid, device=dev)
    km = dynamic_force_kernels(model, zs - d, w_list, k_grid, device=dev)
    return _bucket_depth_spectra(W, st, k, kern0, kp, km, d, _as_complex(w_list, dev))


def _bucket_depth_spectra(W: dict, st: dict, k: torch.Tensor, kern0: dict, kp: dict, km: dict,
                          d: float, w_c: torch.Tensor) -> torch.Tensor:
    """One depth's (6, 3, nd, nf) spectra from its three force-kernel sets
    (nf, nk): five Hankel applications (±d·ex share one) and six shifted
    Green tensors."""
    mv_x = _hankel_apply_band(W["x"], k, kern0)
    G = {"xp": _G_assemble_band(mv_x, st["cphi_xp"], st["sphi_x"]),
         "xm": _G_assemble_band(mv_x, st["cphi_xm"], st["sphi_x"]),
         "yp": _G_assemble_band(_hankel_apply_band(W["ym"], k, kern0), st["zeros"], st["ones"]),
         "ym": _G_assemble_band(_hankel_apply_band(W["yp"], k, kern0), st["zeros"], st["ones"]),
         "zp": _G_assemble_band(_hankel_apply_band(W["0"], k, kp), st["zeros"], st["ones"]),
         "zm": _G_assemble_band(_hankel_apply_band(W["0"], k, km), st["zeros"], st["ones"])}
    return _mt_spectra_from_G(G, d, w_c, _m_xyz(k.device))


# ---------------------------------------------------------------------------
# The Kennett-recursion bucket (the table builder's path)
# ---------------------------------------------------------------------------


#: |ω| below which the Kennett kernels are recomputed in np.clongdouble
W_ESCALATE = 0.06


def host_escalation(model, zs_set, w_c: np.ndarray, k_grid: np.ndarray,
                    w_escalate: float = W_ESCALATE) -> dict:
    """The Kennett kernels of the bins of ``w_c`` with |ω| < ``w_escalate``,
    recomputed on the host in ``np.clongdouble`` (the JAX package's
    precision escalation: the P-SV basis degenerates as ω → 0 and roundoff
    grows ~|ω|⁻⁵; no complex type of torch or CUDA is wider than
    complex128): ``{"bins": indices into w_c, "kernels": {zs: {name:
    (n_bins, nk) complex128}}, "seconds": host seconds}``.  Pure numpy, so
    the builder runs it in a worker thread beside the device work."""
    from beat_tpu_torch.heart.reflectivity import ReflectivitySolver

    t0 = time.perf_counter()
    bins = np.flatnonzero(np.abs(w_c) < w_escalate)
    kernels = {}
    if bins.size:
        w2 = (w_c * w_c)[:, None]
        s256 = ReflectivitySolver(model, w2[bins].astype(np.clongdouble),
                                  np.asarray(k_grid)[None, :], dtype=np.clongdouble,
                                  backend="numpy")
        kernels = {zs: {name: v.astype(np.complex128) for name, v in
                        s256.force_kernels(zs).items()} for zs in zs_set}
    return {"bins": bins, "kernels": kernels, "seconds": time.perf_counter() - t0}


def _host_slice(host: dict, c0: int, c1: int) -> dict:
    """The part of a :func:`host_escalation` of a whole band that falls in
    the frequency chunk [c0, c1), its bins counted from c0."""
    inside = (host["bins"] >= c0) & (host["bins"] < c1)
    return {"bins": host["bins"][inside] - c0, "seconds": host["seconds"],
            "kernels": {zs: {n: v[inside] for n, v in k.items()}
                        for zs, k in host["kernels"].items()}}


def _kernels_band_safe(model, zs_set, w_c: np.ndarray, k_grid: np.ndarray,
                       w_escalate: float = W_ESCALATE, fallback_tol: float = 1e-6, *,
                       device, stats: dict | None = None, host: dict | None = None) -> dict:
    """Force kernels (nf, nk) per source depth by the Kennett solver on
    ``device`` in complex128, with the precision escalation of the JAX
    package: bins with |ω| < ``w_escalate`` take the host's
    ``np.clongdouble`` kernels (:func:`host_escalation`, or ``host``
    computed beforehand for these bins), and any bin whose
    complex128/clongdouble disagreement implies a clongdouble error above
    ``fallback_tol`` falls back to the global-matrix solver on ``device``.
    ``stats`` counts the host bins, their solves, the fallbacks and the
    host seconds."""
    from beat_tpu_torch.heart.reflectivity import ReflectivitySolver

    dev = resolve(device)
    w2 = (w_c * w_c)[:, None]
    solver = ReflectivitySolver(model, w2, np.asarray(k_grid)[None, :], device=dev)
    kerns = {zs: solver.force_kernels(zs) for zs in zs_set}
    del solver

    low = np.abs(w_c) < w_escalate
    if not low.any():
        return kerns
    # the host's clongdouble bins, while the device works on the lattice
    host = host_escalation(model, zs_set, w_c, k_grid, w_escalate) if host is None else host
    host = host.result() if hasattr(host, "result") else host
    low_idx = np.flatnonzero(low)
    if not np.array_equal(host["bins"], low_idx):
        raise ValueError("the host escalation holds other bins than this chunk's")
    eps_gain = 1500.0          # conservative eps128/eps256 error shrink
    low_t = torch.as_tensor(low_idx, device=dev)
    n_fallback = 0
    for zs in zs_set:
        bad_bins = set()
        for name in _KERNEL_NAMES:
            a256 = host["kernels"][zs][name]
            a128 = kerns[zs][name][low_t].cpu().numpy()
            scale = np.abs(a256).max(axis=1) + 1e-300
            disagree = np.abs(a128 - a256).max(axis=1) / scale
            kerns[zs][name][low_t] = torch.as_tensor(a256, device=dev)
            bad_bins.update(low_idx[np.flatnonzero(disagree / eps_gain > fallback_tol)])
        for jf in sorted(bad_bins):
            logger.info("kennett: bin |w|=%.3g at zs=%g m beyond clongdouble precision — "
                        "global-matrix fallback", abs(w_c[jf]), zs)
            exact = dynamic_force_kernels(model, zs, complex(w_c[jf]), k_grid, device=dev)
            for name in _KERNEL_NAMES:
                kerns[zs][name][jf] = exact[name]
        n_fallback += len(bad_bins)
    if stats is not None:
        stats["host_bins"] = stats.get("host_bins", 0) + int(low.sum())
        stats["host_bin_solves"] = stats.get("host_bin_solves", 0) + int(low.sum()) * len(zs_set)
        stats["fallback_bins"] = stats.get("fallback_bins", 0) + n_fallback
        stats["host_s"] = stats.get("host_s", 0.0) + host["seconds"]
    return kerns


def _expand_kernels(kerns: dict, S: torch.Tensor | None, n_dense: int, solve_grid: np.ndarray,
                    k_grid: np.ndarray, zs: float) -> dict:
    """Kernels solved on the hybrid grid, expanded to the full Hankel grid:
    the dense head copied; the tail de-trended by e^{-k·zs}, mapped by the
    spline matrix ``S`` (one GEMM) and re-trended."""
    if S is None:
        return kerns
    dev = S.device
    k_solve = torch.as_tensor(solve_grid[n_dense - 1:], dtype=FLOAT, device=dev)
    k_out = torch.as_tensor(k_grid[n_dense:], dtype=FLOAT, device=dev)
    grow_s = torch.exp(k_solve * zs)
    decay_o = torch.exp(-k_out * zs)
    out = {}
    for name, v in kerns.items():
        g = (v[:, n_dense - 1:] * grow_s).T                     # (n_solve, nf)
        tail = _rmatmul(S, g).T * decay_o
        out[name] = torch.cat([v[:, :n_dense], tail], dim=1)
    return out


def _solver_bytes_per_point(n_layers: int) -> float:
    """Peak bytes a lattice point of :class:`ReflectivitySolver` holds: its
    kept sweeps (~37 complex128 arrays a layer) and the interface R/T
    built while sweeping (~20 a layer), with room for the temporaries."""
    return 16.0 * (70 * n_layers + 60)


def _bucket_lattice(model, zs_list, d: float, w_list: np.ndarray, k_grid: np.ndarray) -> tuple:
    """``(zs_eval, solve_grid, n_dense)`` of a bucket: the depths its
    kernels are solved at (each member and its ±d dipole) and its hybrid
    solve grid."""
    zs_eval = sorted({z for zs in zs_list for z in (zs, zs + d, zs - d)})
    solve_grid, n_dense = _hybrid_solve_grid(model, k_grid, float(np.abs(w_list).max()))
    return zs_eval, solve_grid, n_dense


def mt_spectra_kennett_bucket(model, zs_list, distances, w_list, k_grid, rel_step: float = 1e-3,
                              nf_chunk: int | None = None, d: float | None = None, *, device,
                              stats: dict | None = None, host=None) -> torch.Tensor:
    """(nz, 6, 3, nd, nf) elementary-MT spectra of a group of source depths
    sharing one wavenumber grid — the Kennett-recursion path.

    The interface sweeps serve every depth of the bucket and the ±d
    dipoles; the Bessel matrices (one horizontal step ``d = rel_step·
    min(zs)`` unless given) are shared by the depths; the Hankel synthesis
    batches a chunk's frequencies into real GEMMs.  ``nf_chunk`` defaults to
    what the memory budget holds (:func:`_solver_bytes_per_point` over the
    solve lattice, and the expanded kernels of one depth).  ``host`` is the
    bucket's :func:`host_escalation` over all of ``w_list`` (or a future of
    it), computed here when None."""
    dev = resolve(device)
    distances = np.asarray(distances, dtype=np.float64)
    zs_list = [float(z) for z in zs_list]
    w_list = np.asarray(w_list, dtype=np.complex128)
    k_grid = np.asarray(k_grid, dtype=np.float64)
    nd, nz, nf = distances.size, len(zs_list), w_list.size
    d = rel_step * min(zs_list) if d is None else float(d)

    k = torch.as_tensor(k_grid, device=dev)
    st = _shift_stencil(distances, d)
    W = {"0": _hankel_weights(distances, k), "x": _hankel_weights(st["r_x"], k),
         "ym": _hankel_weights(distances - d, k), "yp": _hankel_weights(distances + d, k)}

    zs_eval, solve_grid, n_dense = _bucket_lattice(model, zs_list, d, w_list, k_grid)
    S = None
    if n_dense < k_grid.size:
        S = torch.as_tensor(spline_matrix(np.log(solve_grid[n_dense - 1:]),
                                          np.log(k_grid[n_dense:])), device=dev)
    if nf_chunk is None:
        per_freq = max(solve_grid.size * (_solver_bytes_per_point(model.nlayers)
                                          + 16 * 5 * len(zs_eval)),
                       k_grid.size * 16 * 5 * 3 * 3)
        nf_chunk = int(max(1, min(nf, chunk_budget(dev) // per_freq)))
    if stats is not None:
        stats.setdefault("buckets", []).append(dict(
            depths=len(zs_list), nk=int(k_grid.size), nk_solve=int(solve_grid.size),
            nf_chunk=int(nf_chunk)))

    out = torch.zeros((nz, 6, 3, nd, nf), dtype=CFLOAT, device=dev)
    for c0 in range(0, nf, nf_chunk):
        sl = slice(c0, min(c0 + nf_chunk, nf))
        w_c = w_list[sl]
        chunk_host = None
        if host is not None:
            host = host.result() if hasattr(host, "result") else host
            chunk_host = _host_slice(host, sl.start, sl.stop)
        kerns = _kernels_band_safe(model, zs_eval, w_c, solve_grid, device=dev, stats=stats,
                                   host=chunk_host)
        wt = _as_complex(w_c, dev)
        for iz, zs in enumerate(zs_list):
            kern0, kp, km = (_expand_kernels(kerns[z], S, n_dense, solve_grid, k_grid, z)
                             for z in (zs, zs + d, zs - d))
            out[iz, ..., sl] = _bucket_depth_spectra(W, st, k, kern0, kp, km, d, wt)
        del kerns
    return out


# ---------------------------------------------------------------------------
# Table builder
# ---------------------------------------------------------------------------


def kennett_plan(model, distances, depths, nt: int, dt: float, zeta_cycles: float = 1.0,
                 ppw: float = 1.2, fmax: float | None = None, tail_coeff: float = 50.0) -> dict:
    """The host plan of a Kennett build: the frequencies, the band's
    complex frequencies ``w_band`` and mask ``in_band``, and per depth
    bucket the depth indices, the shared wavenumber grid and the
    horizontal dipole step's base depth (the bucket's shallowest)."""
    distances = np.asarray(distances, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.float64)
    freqs = np.fft.rfftfreq(nt, dt)
    T = nt * dt
    zeta = zeta_cycles * np.pi / T
    fmax = freqs[-1] if fmax is None else fmax
    in_band = freqs <= fmax + 1e-12
    w_band = 2.0 * np.pi * freqs[in_band] - 1j * zeta
    w_abs = float(np.abs(w_band).max())
    r_max = float(distances.max())
    buckets = []
    for bucket in _depth_buckets(model, depths, r_max, T, w_abs, ppw, tail_coeff):
        zs_min = float(min(depths[i] for i in bucket))
        buckets.append(dict(depth_idx=list(bucket), zs_min=zs_min,
                            k_grid=dynamic_integration_grid(model, zs_min, r_max, T, w_abs,
                                                            ppw=ppw, tail_coeff=tail_coeff)))
    return dict(freqs=freqs, zeta=zeta, in_band=in_band, w_band=w_band, buckets=buckets)


def undamp_to_spectra(damped: torch.Tensor, nt: int, dt: float, zeta: float,
                      t0: float = 0.0) -> torch.Tensor:
    """The table tail as one batched pass: damped spectra (..., nf) →
    traces by inverse FFT → times the Bouchon growth e^{ζt} → aligned to
    the ``t0`` time axis and transformed back (``trace_to_spectrum``)."""
    from beat_tpu_torch.heart.store_convert import trace_to_spectrum

    growth = torch.exp(zeta * torch.arange(nt, dtype=FLOAT, device=damped.device) * dt)
    traces = torch.fft.irfft(damped, n=nt) * growth
    return trace_to_spectrum(traces, 0.0, dt, nt, dt, t0)


def check_depths(model, depths, rel_step: float) -> None:
    """Refuse depth nodes whose vertical dipole straddles an interface."""
    for zs in depths:
        d = rel_step * float(zs)
        if model.layer_of(zs - d) != model.layer_of(zs + d) or \
                model.layer_of(zs) != model.layer_of(zs + d):
            raise ValueError(
                f"depth node {zs:g} m is within rel_step·z = {d:g} m of a layer interface "
                f"(tops {list(model.tops)}): the vertical finite-difference dipole would "
                f"straddle the material discontinuity — move the node or adjust the grid "
                f"(nudge_depths_off_interfaces)")


def build_layered_waveform_table(model, distances, depths, nt: int, dt: float, t0: float = 0.0,
                                 zeta_cycles: float = 1.0, rel_step: float = 1e-3,
                                 ppw: float = 1.2, fmax: float | None = None,
                                 tail_coeff: float = 50.0, method: str = "kennett", *, device,
                                 stats: dict | None = None):
    """A :class:`~beat_tpu_torch.heart.gftable.GreensTable` for a 1-D
    layered model by the discrete wavenumber method on ``device``.

    model : :class:`~beat_tpu_torch.heart.velocity_model.LayeredModel`
    distances, depths : table grid [m] (depths more than ``rel_step·depth``
        from any interface)
    nt, dt, t0 : the table's time axis (responses to unit moment steps)
    zeta_cycles : Bouchon damping ζ = ζ_cycles·π/(nt·dt)
    fmax : optional synthesis cutoff [Hz]: spectra above it stay zero
    method : 'kennett' (default: the R/T recursion, depth buckets sharing
        k-grids, hybrid dense/log-tail solve lattice, frequency-batched
        Hankel GEMMs); 'band' (global-matrix solves sharing one k-grid per
        depth); 'perfreq' (a k-grid per frequency)
    stats : a dict the Kennett path fills (host bins, fallbacks, host
        seconds, buckets)
    """
    from beat_tpu_torch.heart.gftable import GreensTable
    from beat_tpu_torch.heart.velocity_model import travel_times

    if method not in ("kennett", "band", "perfreq"):
        raise ValueError(f"method must be 'kennett', 'band' or 'perfreq', got {method!r}")
    dev = resolve(device)
    distances = np.asarray(distances, dtype=np.float64)
    depths = np.asarray(depths, dtype=np.float64)
    check_depths(model, depths, rel_step)
    plan = kennett_plan(model, distances, depths, nt, dt, zeta_cycles, ppw, fmax, tail_coeff)
    freqs, in_band, w_band = plan["freqs"], plan["in_band"], plan["w_band"]
    T = nt * dt
    r_max = float(distances.max())
    damped = torch.zeros((6, 3, distances.size, depths.size, freqs.size), dtype=CFLOAT,
                         device=dev)
    band_idx = torch.as_tensor(np.flatnonzero(in_band), device=dev)
    if method == "kennett":
        # every bucket's host bins (clongdouble) in worker threads, beside
        # the device's work on the buckets one after the other
        with ThreadPoolExecutor(max_workers=len(plan["buckets"])) as pool:
            hosts = []
            for b in plan["buckets"]:
                zs_eval, solve_grid, _ = _bucket_lattice(
                    model, depths[b["depth_idx"]], rel_step * b["zs_min"], w_band, b["k_grid"])
                hosts.append(pool.submit(host_escalation, model, zs_eval, w_band, solve_grid))
            for b, host in zip(plan["buckets"], hosts):
                spec = mt_spectra_kennett_bucket(model, depths[b["depth_idx"]], distances,
                                                 w_band, b["k_grid"], rel_step, device=dev,
                                                 stats=stats, host=host)
                for jb, iz in enumerate(b["depth_idx"]):
                    damped[:, :, :, iz, band_idx] = spec[jb]
                logger.info("layered waveform table: %i depths done on a %i-point k-grid "
                            "(%i freqs, %i distances)", len(b["depth_idx"]), b["k_grid"].size,
                            len(w_band), distances.size)
    else:
        w_abs = float(np.abs(w_band).max())
        for iz, zs in enumerate(depths):
            if method == "band":
                k_grid = dynamic_integration_grid(model, zs, r_max, T, w_abs, ppw=ppw,
                                                  tail_coeff=tail_coeff)
                damped[:, :, :, iz, band_idx] = elementary_mt_spectra_band(
                    model, zs, distances, w_band, k_grid, rel_step, device=dev)
            else:
                for jf, w_c in zip(np.flatnonzero(in_band), w_band):
                    k_grid = dynamic_integration_grid(model, zs, r_max, T, abs(w_c), ppw=ppw,
                                                      tail_coeff=tail_coeff)
                    damped[:, :, :, iz, jf] = elementary_mt_spectra(
                        model, zs, distances, w_c, k_grid, rel_step, device=dev)
            logger.info("layered waveform table: depth %g m done (%i freqs, %i distances)",
                        zs, freqs.size, distances.size)

    spectra = undamp_to_spectra(damped, nt, dt, plan["zeta"], t0)
    del damped
    tt_p = np.stack([travel_times(model, zs, distances, "p") for zs in depths], axis=-1)
    tt_s = np.stack([travel_times(model, zs, distances, "s") for zs in depths], axis=-1)
    vp_eff, vs_eff = _effective_velocities(model, float(np.median(depths)))
    pairs = torch.view_as_real(spectra).to(torch.float32)
    logger.info("Built layered waveform GF table: %i dist x %i depth x %i samples (DWN, ζ=%g)",
                distances.size, depths.size, nt, plan["zeta"])
    return GreensTable(pairs, distances, depths, dt=dt, nt=nt, t0=t0, vp=vp_eff, vs=vs_eff,
                       rho=float(model.rho[0]), tt_p=tt_p, tt_s=tt_s, device=dev)


def _effective_velocities(model, zs: float) -> tuple:
    """Straight-ray effective (vp, vs) down to the source depth."""
    tops = np.append(model.tops, zs + 1e9)
    t_p = t_s = 0.0
    z_cum = 0.0
    for i in range(model.nlayers):
        h = min(tops[i + 1], zs) - tops[i]
        if h <= 0:
            break
        t_p += h / model.vp[i]
        t_s += h / model.vs[i]
        z_cum += h
    if z_cum <= 0:
        return float(model.vp[0]), float(model.vs[0])
    return z_cum / t_p, z_cum / t_s
