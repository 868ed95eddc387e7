"""
Kennett reflection/transmission recursion for the layered waveform GFs —
the fast solver behind :mod:`beat_tpu_torch.heart.layered_waveforms`
(port of ``beat_tpu/heart/reflectivity.py``).

Per layer a handful of 2×2 complex operations (scalars for SH), all
elementwise over the whole (frequency × wavenumber) lattice, stable
through decay-normalized layer phases (|e^{-νh}| ≤ 1) (Kennett 1983;
Müller 1985).  As in the JAX package:

* every 2×2 matrix over the lattice is a tuple of four arrays
  ``(m00, m01, m10, m11)``, never a trailing (..., 2, 2) axis;
* the small solves (interface R/T, source decomposition) are closed-form
  2×2 block Schur eliminations;
* the interface sweeps depend on the model only: one bottom-up and one
  top-down sweep serve every source depth (a table bucket's depths and
  their ±δ dipoles).

The solver runs on either array backend:

* **torch** (``ReflectivitySolver(model, w2, k, device=...)``):
  complex128 tensors on the device — the table builder's path;
* **numpy** (``backend="numpy"``, no device): the host path, for the few bins near
  ω = 0 that the builder recomputes in ``np.clongdouble`` (80-bit x87;
  neither torch nor CUDA has a complex type wider than complex128),
  operation for operation the JAX package's code.

Conventions are those of the global-matrix solver of
:mod:`layered_waveforms` (same wave columns, source jumps and stress
scaling); ``tests/test_torch_layered.py`` holds the kernels against the
JAX solver.
"""

from __future__ import annotations

import numpy as np
import torch

from beat_tpu_torch.device import resolve


class _Numpy:
    """The array functions the solver needs, on host numpy."""

    sqrt, exp, abs, maximum = map(staticmethod, (np.sqrt, np.exp, np.abs, np.maximum))
    zeros_like, ones_like = map(staticmethod, (np.zeros_like, np.ones_like))

    @staticmethod
    def asarray(x, dtype):
        return np.asarray(x, dtype=dtype)

    @staticmethod
    def cast(x, dtype):
        return x.astype(dtype)

    @staticmethod
    def real_dtype(dtype):
        return np.real(np.zeros(1, dtype)).dtype


class _Torch:
    """The same on torch tensors of one device."""

    sqrt, exp, abs, maximum = map(staticmethod, (torch.sqrt, torch.exp, torch.abs,
                                                 torch.maximum))
    zeros_like, ones_like = map(staticmethod, (torch.zeros_like, torch.ones_like))

    def __init__(self, device):
        self.device = device

    def asarray(self, x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @staticmethod
    def cast(x, dtype):
        return x.to(dtype)

    @staticmethod
    def real_dtype(dtype):
        return torch.empty((), dtype=dtype).real.dtype


# ---------------------------------------------------------------------------
# 2x2 algebra on component tuples (m00, m01, m10, m11)
# ---------------------------------------------------------------------------


def _mmul(A, B):
    a, b, c, d = A
    e, f, g, h = B
    return (a * e + b * g, a * f + b * h, c * e + d * g, c * f + d * h)


def _minv(A):
    a, b, c, d = A
    det = a * d - b * c
    return (d / det, -b / det, -c / det, a / det)


def _msub_eye(A):
    """I - A"""
    a, b, c, d = A
    return (1.0 - a, -b, -c, 1.0 - d)


def _mdress(E, A):
    """diag(E) @ A @ diag(E) for E = (e0, e1)."""
    a, b, c, d = A
    e0, e1 = E
    return (e0 * a * e0, e0 * b * e1, e1 * c * e0, e1 * d * e1)


def _madd(A, B):
    return tuple(x + y for x, y in zip(A, B))


def _msub(A, B):
    return tuple(x - y for x, y in zip(A, B))


def _mzero_like(xp, x):
    z = xp.zeros_like(x)
    return (z, z, z, z)


# ---------------------------------------------------------------------------
# Per-layer wave columns (z-independent, normalized once per layer)
# ---------------------------------------------------------------------------


class _LayerWaves:
    """Normalized P-SV + SH wave columns of one material over the
    lattice: raw entries as ``layered_waveforms._psv_wave_entries``, stress
    rows divided by ``stress_scale`` and each column by its max-abs entry.
    ``Du/Ds`` are the displacement/stress blocks of [P down, SV down],
    ``Uu/Us`` of [P up, SV up]; SH columns are (W, T) pairs."""

    __slots__ = ("nu_a", "nu_b", "nu_sh", "Du", "Ds", "Uu", "Us", "sh_D", "sh_U")

    def __init__(self, xp, lam, mu, rho, w2, k, stress_scale, dtype):
        va2 = (lam + 2 * mu) / rho
        vb2 = mu / rho
        nu_a = xp.sqrt(xp.cast(k * k - w2 / va2, dtype))
        nu_b = xp.sqrt(xp.cast(k * k - w2 / vb2, dtype))
        self.nu_a, self.nu_b = nu_a, nu_b
        self.nu_sh = nu_b

        kk = xp.cast(k * k, dtype) + xp.zeros_like(nu_a)
        kc = xp.cast(k, dtype) + xp.zeros_like(nu_a)
        p_even = (2 * mu * nu_a**2 - lam * (w2 / va2)) / stress_scale + xp.zeros_like(nu_a)
        s_even = (mu * k * (nu_b**2 + k * k)) / stress_scale + xp.zeros_like(nu_a)
        pk2 = 2 * mu * nu_a * kc / stress_scale        # P col S entry (+up)
        sk2 = 2 * mu * nu_b * kk / stress_scale        # SV col P entry (+up)

        def norm4(u, v, p, s):
            n = xp.maximum(xp.maximum(xp.abs(u), xp.abs(v)), xp.maximum(xp.abs(p), xp.abs(s)))
            return u / n, v / n, p / n, s / n

        # P (s=±1):  U = s·ν_α, V = k, P = p_even, S = s·2µν_α k
        # SV (s=±1): U = k², V = s·ν_β k, P = s·2µν_β k², S = s_even
        uPd, vPd, pPd, sPd = norm4(-nu_a, kc, p_even, -pk2)
        uSd, vSd, pSd, sSd = norm4(kk, -nu_b * kc, -sk2, s_even)
        uPu, vPu, pPu, sPu = norm4(nu_a, kc, p_even, pk2)
        uSu, vSu, pSu, sSu = norm4(kk, nu_b * kc, sk2, s_even)
        self.Du = (uPd, uSd, vPd, vSd)
        self.Ds = (pPd, pSd, sPd, sSd)
        self.Uu = (uPu, uSu, vPu, vSu)
        self.Us = (pPu, pSu, sPu, sSu)

        # SH columns y = (W, T), T = µ ∂_z W
        t_dn = -mu * nu_b / stress_scale
        t_up = mu * nu_b / stress_scale
        one = xp.ones_like(xp.abs(t_dn))
        n_dn = xp.maximum(xp.abs(t_dn), one)
        n_up = xp.maximum(xp.abs(t_up), one)
        self.sh_D = (1.0 / n_dn, t_dn / n_dn)
        self.sh_U = (1.0 / n_up, t_up / n_up)


def _interface_rt(a: _LayerWaves, b: _LayerWaves):
    """Local welded-contact R/T at one interface by 2×2 block Schur."""
    iUu_a = _minv(a.Uu)
    S = _mmul(a.Us, iUu_a)
    t_d = _mmul(_minv(_msub(_mmul(S, b.Du), b.Ds)), _msub(_mmul(S, a.Du), a.Ds))
    r_d = _mmul(iUu_a, _msub(_mmul(b.Du, t_d), a.Du))

    iDu_b = _minv(b.Du)
    Sb = _mmul(b.Ds, iDu_b)
    t_u = _mmul(_minv(_msub(_mmul(Sb, a.Uu), a.Us)), _msub(_mmul(Sb, b.Uu), b.Us))
    r_u = _mmul(iDu_b, _msub(_mmul(a.Uu, t_u), b.Uu))

    aD0, aD1 = a.sh_D
    aU0, aU1 = a.sh_U
    bD0, bD1 = b.sh_D
    bU0, bU1 = b.sh_U
    det_d = -aU0 * bD1 + bD0 * aU1
    rs_d = (aD0 * bD1 - bD0 * aD1) / det_d
    ts_d = (-aU0 * aD1 + aD0 * aU1) / det_d
    det_u = -bD0 * aU1 + aU0 * bD1
    rs_u = (bU0 * aU1 - aU0 * bU1) / det_u
    ts_u = (-bD0 * bU1 + bU0 * bD1) / det_u
    return (r_d, t_d, r_u, t_u), (rs_d, ts_d, rs_u, ts_u)


# ---------------------------------------------------------------------------
# Region composition (Kennett addition rules)
# ---------------------------------------------------------------------------


class _Region:
    """R/T matrices of a stack between two levels: ``u_t = R_D d_t + T_U
    u_b`` and ``d_b = T_D d_t + R_U u_b``."""

    __slots__ = ("R_D", "T_D", "R_U", "T_U")

    def __init__(self, R_D, T_D, R_U, T_U):
        self.R_D, self.T_D, self.R_U, self.T_U = R_D, T_D, R_U, T_U

    @classmethod
    def empty(cls, xp, proto):
        z, one = xp.zeros_like(proto), xp.ones_like(proto)
        return cls((z, z, z, z), (one, z, z, one), (z, z, z, z), (one, z, z, one))

    def below(self, other: "_Region") -> "_Region":
        """self stacked above other."""
        Q = _minv(_msub_eye(_mmul(self.R_U, other.R_D)))
        QT = _mmul(Q, self.T_D)
        R_D = _madd(self.R_D, _mmul(self.T_U, _mmul(other.R_D, QT)))
        T_D = _mmul(other.T_D, QT)
        Q2 = _minv(_msub_eye(_mmul(other.R_D, self.R_U)))
        T_U = _mmul(self.T_U, _mmul(Q2, other.T_U))
        R_U = _madd(other.R_U, _mmul(other.T_D, _mmul(Q, _mmul(self.R_U, other.T_U))))
        return _Region(R_D, T_D, R_U, T_U)

    def add_phase_below(self, E):
        """Append a uniform layer (diag phase E = (e_α, e_β)) below."""
        e0, e1 = E
        a, b, c, d = self.T_D
        T_D = (e0 * a, e0 * b, e1 * c, e1 * d)
        a, b, c, d = self.T_U
        T_U = (a * e0, b * e1, c * e0, d * e1)
        return _Region(self.R_D, T_D, _mdress(E, self.R_U), T_U)


class _RegionSH:
    __slots__ = ("R_D", "T_D", "R_U", "T_U")

    def __init__(self, R_D, T_D, R_U, T_U):
        self.R_D, self.T_D, self.R_U, self.T_U = R_D, T_D, R_U, T_U

    @classmethod
    def empty(cls, xp, proto):
        z = xp.zeros_like(proto)
        return cls(z, xp.ones_like(proto), z, xp.ones_like(proto))

    def below(self, other):
        Q = 1.0 / (1.0 - self.R_U * other.R_D)
        QT = Q * self.T_D
        return _RegionSH(self.R_D + self.T_U * other.R_D * QT, other.T_D * QT,
                         other.R_U + other.T_D * Q * self.R_U * other.T_U,
                         self.T_U * Q * other.T_U)

    def add_phase_below(self, e):
        return _RegionSH(self.R_D, e * self.T_D, e * self.R_U * e, self.T_U * e)


# ---------------------------------------------------------------------------
# The solver
# ---------------------------------------------------------------------------


class ReflectivitySolver:
    """The source-independent interface sweeps of one model over one (w2, k)
    lattice; :meth:`force_kernels` then evaluates any source depth against
    them.

    w2, k : broadcastable lattices of ω'² (complex) and wavenumbers, e.g.
        (nf, 1) and (1, nk) — numpy arrays, or anything ``torch.as_tensor``
        takes on the torch backend.
    device : the torch device of the lattice (torch backend; required,
        through :func:`~beat_tpu_torch.device.resolve`).
    backend : ``"torch"`` (default) or ``"numpy"``, the host path, which
        takes no device and whose ``dtype`` may be ``np.clongdouble``.
    Anelastic Q enters as constant-Q complex velocities through complex
    Lamé moduli; ``stress_scale`` is the global-matrix solver's
    conditioning divisor.  Only what :meth:`force_kernels` reads is kept
    (the JAX package also keeps the top-down regions and phases)."""

    def __init__(self, model, w2, k, dtype=None, *, device=None, backend="torch"):
        if backend == "numpy":
            if device is not None:
                raise ValueError("the numpy backend runs on the host and takes no device")
            xp = _Numpy()
            dtype = np.complex128 if dtype is None else dtype
        elif backend == "torch":
            xp = _Torch(resolve(device))
            dtype = torch.complex128 if dtype is None else dtype
        else:
            raise ValueError(f"backend must be 'torch' or 'numpy', not {backend!r}")
        self.xp, self.dtype = xp, dtype
        rdtype = xp.real_dtype(dtype)
        w2 = xp.asarray(w2, dtype)
        k = xp.asarray(k, rdtype)
        tops = np.asarray(model.tops, dtype=np.float64)
        vp, vs, rho = model.vp, model.vs, model.rho
        if getattr(model, "qp", None) is not None:
            vp = vp * (1.0 + 0.5j / model.qp)
        if getattr(model, "qs", None) is not None:
            vs = vs * (1.0 + 0.5j / model.qs)
        lam = rho * (vp**2 - 2 * vs**2)
        mu = rho * vs**2
        self.tops = tops
        self.thick = np.diff(tops)
        L = tops.size

        w_abs = xp.cast(xp.sqrt(xp.abs(w2)), rdtype)
        vs_min = float(np.min(np.real(model.vs)))
        mu0 = float(np.median(model.rho * model.vs**2))
        stress_scale = xp.cast(mu0 * (k + w_abs / vs_min), rdtype)
        self._jump_scale = stress_scale

        scalar = (lambda v: complex(v)) if np.iscomplexobj(lam) else float
        self.layers = [_LayerWaves(xp, scalar(lam[i]), scalar(mu[i]), float(rho[i]), w2, k,
                                   stress_scale, dtype) for i in range(L)]
        proto = self.layers[0].nu_a

        E, E_sh = [None] * L, [None] * L
        for i in range(L - 1):
            h = float(self.thick[i])
            E[i] = (xp.exp(-self.layers[i].nu_a * h), xp.exp(-self.layers[i].nu_b * h))
            E_sh[i] = xp.exp(-self.layers[i].nu_sh * h)

        iface, iface_sh = {}, {}
        for i in range(1, L):
            iface[i], iface_sh[i] = _interface_rt(self.layers[i - 1], self.layers[i])

        # bottom-up sweep: composite R_D of everything below interface i,
        # referenced at tops[i]
        self._rbelow = [None] * L
        self._rbelow_sh = [None] * L
        R = _mzero_like(xp, proto)
        Rs = xp.zeros_like(proto)
        for i in range(L - 1, 0, -1):
            r_d, t_d, r_u, t_u = iface[i]
            rs_d, ts_d, rs_u, ts_u = iface_sh[i]
            if i < L - 1:
                Rd = _mdress(E[i], R)
                e = E_sh[i]
                Rds = e * Rs * e
            else:
                Rd = _mzero_like(xp, proto)
                Rds = xp.zeros_like(proto)
            Q = _minv(_msub_eye(_mmul(r_u, Rd)))
            R = _madd(r_d, _mmul(t_u, _mmul(Rd, _mmul(Q, t_d))))
            Rs = rs_d + ts_u * Rds * ts_d / (1.0 - rs_u * Rds)
            self._rbelow[i] = R
            self._rbelow_sh[i] = Rs

        # free-surface reflection from layer-0 stress rows: P = S = 0 at z = 0
        top = self.layers[0]
        self._R_F = _mmul(_minv(top.Ds), tuple(-x for x in top.Us))
        self._R_F_sh = -top.sh_U[1] / top.sh_D[1]
        recv = _madd(top.Uu, _mmul(top.Du, self._R_F))
        recv_sh = top.sh_U[0] + top.sh_D[0] * self._R_F_sh

        # top-down sweep: the welded region [surface .. tops[j]], and from it
        # per layer R̂_U = R_U + T_D R_F (I − R_D R_F)^{-1} T_U and the
        # surface-arrival operator W_j = recv (I − R_D R_F)^{-1} T_U
        self._ruhat = [None] * L
        self._ruhat_sh = [None] * L
        self._wsurf = [None] * L
        self._wsurf_sh = [None] * L
        reg, reg_sh = _Region.empty(xp, proto), _RegionSH.empty(xp, proto)
        for j in range(L):
            if j:
                reg = reg.add_phase_below(E[j - 1]).below(_Region(*iface.pop(j)))
                reg_sh = reg_sh.add_phase_below(E_sh[j - 1]).below(_RegionSH(*iface_sh.pop(j)))
            Qf = _minv(_msub_eye(_mmul(reg.R_D, self._R_F)))
            QT = _mmul(Qf, reg.T_U)
            self._ruhat[j] = _madd(reg.R_U, _mmul(reg.T_D, _mmul(self._R_F, QT)))
            self._wsurf[j] = _mmul(recv, QT)
            qf = 1.0 / (1.0 - reg_sh.R_D * self._R_F_sh)
            self._ruhat_sh[j] = reg_sh.R_U + reg_sh.T_D * self._R_F_sh * qf * reg_sh.T_U
            self._wsurf_sh[j] = recv_sh * qf * reg_sh.T_U

    # -- per-source evaluation ------------------------------------------

    def layer_of(self, zs: float) -> int:
        j = int(np.searchsorted(self.tops, zs, side="right") - 1)
        if j < 0 or zs <= self.tops[0]:
            raise ValueError(f"source depth {zs} above the model top")
        return j

    def force_kernels(self, zs: float) -> dict:
        """Surface displacement kernels U0, V0, U1, V1, W1 of buried unit
        point forces at depth ``zs`` over the whole lattice (the
        conventions of ``layered_waveforms.dynamic_force_kernels``)."""
        xp = self.xp
        j = self.layer_of(zs)
        lay = self.layers[j]

        dz_top = float(zs - self.tops[j])
        e_up = (xp.exp(-lay.nu_a * dz_top), xp.exp(-lay.nu_b * dz_top))
        e_up_sh = xp.exp(-lay.nu_sh * dz_top)
        if j < len(self.tops) - 1:
            dz_bot = float(self.tops[j + 1] - zs)
            e_dn = (xp.exp(-lay.nu_a * dz_bot), xp.exp(-lay.nu_b * dz_bot))
            e_dn_sh = xp.exp(-lay.nu_sh * dz_bot)
            R_D_hat = _mdress(e_dn, self._rbelow[j + 1])
            R_D_hat_sh = e_dn_sh * self._rbelow_sh[j + 1] * e_dn_sh
        else:
            R_D_hat = _mzero_like(xp, lay.nu_a)
            R_D_hat_sh = xp.zeros_like(lay.nu_a)

        R_U_hat = _mdress(e_up, self._ruhat[j])
        R_U_hat_sh = e_up_sh * self._ruhat_sh[j] * e_up_sh

        # source jumps (below − above): vertical force ΔP = −1/2π,
        # horizontal ΔS = −1/2π, SH ΔT the same; decomposed on [D, −U] by
        # block Schur: σ_U = c · Schur^{-1}, σ_D = Du^{-1} Uu σ_U
        c = (-1.0 / (2.0 * np.pi)) / self._jump_scale
        iDu = _minv(lay.Du)
        G = _mmul(iDu, lay.Uu)
        iS = _minv(_msub(_mmul(lay.Ds, G), lay.Us))
        sU = (iS[0] * c, iS[1] * c, iS[2] * c, iS[3] * c)
        sD = _mmul(G, sU)

        # u0 = wsurf · E_up · (I − R̂_D R̂_U)^{-1} (σ_U + R̂_D σ_D)
        Q = _minv(_msub_eye(_mmul(R_D_hat, R_U_hat)))
        src = _madd(sU, _mmul(R_D_hat, sD))
        e0, e1 = e_up
        W = self._wsurf[j]
        W = (W[0] * e0, W[1] * e1, W[2] * e0, W[3] * e1)
        u0 = _mmul(W, _mmul(Q, src))

        D0, D1 = lay.sh_D
        U0c, U1c = lay.sh_U
        det = -D0 * U1c + U0c * D1
        s_D = (U0c * c) / det
        s_U = (D0 * c) / det
        q_sh = 1.0 / (1.0 - R_D_hat_sh * R_U_hat_sh)
        w_sh = self._wsurf_sh[j] * e_up_sh * q_sh * (s_U + R_D_hat_sh * s_D)
        return {"U0": u0[0], "V0": u0[2], "U1": u0[1], "V1": u0[3], "W1": w_sh}


def reflectivity_force_kernels(model, zs: float, w_c, k_grid, *, device) -> dict:
    """:meth:`ReflectivitySolver.force_kernels` at one or several complex
    frequencies ``w_c`` over ``k_grid``, matching
    ``layered_waveforms.dynamic_force_kernels``."""
    w_c = np.asarray(w_c, dtype=np.complex128)
    solver = ReflectivitySolver(model, (w_c * w_c).reshape(-1, 1),
                                np.asarray(k_grid, dtype=np.float64)[None, :], device=device)
    kern = solver.force_kernels(zs)
    if w_c.ndim == 0:
        return {n: v[0] for n, v in kern.items()}
    return kern
