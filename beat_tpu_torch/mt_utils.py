"""
Moment-tensor decomposition and source-type coordinates on the host, in
numpy (copied from ``beat_tpu/mt_utils.py``): the scalar moment,
iso/DC/CLVD decomposition, nodal-plane strike/dip/rake, the Kagan angle,
Hudson (u, v) and lune (γ, δ) source-type coordinates and the P
radiation amplitude.  ``Problem.derived_samples`` reads its nodal planes
and normalised components from here.
"""

from __future__ import annotations

import numpy as np


def m6_to_matrix(m6):
    mnn, mee, mdd, mne, mnd, med = np.asarray(m6, dtype=float)
    return np.array([[mnn, mne, mnd], [mne, mee, med], [mnd, med, mdd]])


def scalar_moment(m6) -> float:
    """Frobenius scalar moment M0 = ‖M‖_F / √2."""
    M = m6_to_matrix(m6)
    return float(np.sqrt((M * M).sum()) / np.sqrt(2.0))


def decompose(m6) -> dict:
    """ISO/DC/CLVD percentages + eigen frame (standard decomposition)."""
    M = m6_to_matrix(m6)
    iso = np.trace(M) / 3.0
    dev = M - iso * np.eye(3)
    eigs, vecs = np.linalg.eigh(dev)       # ascending
    # sort by absolute value descending for CLVD convention
    order = np.argsort(np.abs(eigs))[::-1]
    d = eigs[order]
    F = -d[2] / d[0] if d[0] != 0 else 0.0  # CLVD fraction parameter
    m0_dev = np.abs(d[0])
    m0_iso = np.abs(iso)
    m0 = m0_iso + m0_dev
    if m0 == 0:
        return {"iso": 0.0, "dc": 100.0, "clvd": 0.0, "moment": 0.0}
    return {
        "iso": 100.0 * m0_iso / m0 * np.sign(iso) if m0 else 0.0,
        "dc": 100.0 * (m0_dev / m0) * (1.0 - 2.0 * abs(F)),
        "clvd": 100.0 * (m0_dev / m0) * 2.0 * abs(F),
        "moment": scalar_moment(m6),
        "eigenvalues": eigs,
        "eigenvectors": vecs,
    }


def both_strike_dip_rake(m6):
    """
    Nodal planes of the best double couple from the deviatoric eigen
    frame.  Returns ((s1, d1, r1), (s2, d2, r2)) in degrees.
    """
    M = m6_to_matrix(m6)
    dev = M - np.trace(M) / 3.0 * np.eye(3)
    eigs, vecs = np.linalg.eigh(dev)
    t_axis = vecs[:, np.argmax(eigs)]   # tension
    p_axis = vecs[:, np.argmin(eigs)]   # pressure
    n1 = (t_axis + p_axis) / np.sqrt(2.0)
    u1 = (t_axis - p_axis) / np.sqrt(2.0)

    def plane_sdr(n, u):
        # ensure normal points up (z down in NED: up = negative z comp)
        if n[2] > 0:
            n, u = -n, -u
        dip = np.degrees(np.arccos(np.clip(-n[2], -1.0, 1.0)))
        strike = np.degrees(np.arctan2(-n[0], n[1]))
        s_vec = np.array([np.cos(np.radians(strike)),
                          np.sin(np.radians(strike)), 0.0])
        updip = np.cross(n, s_vec)  # n × ŝ = up-dip unit vector
        rake = np.degrees(np.arctan2(np.dot(u, updip), np.dot(u, s_vec)))
        return strike % 360.0, dip, rake

    return plane_sdr(n1, u1), plane_sdr(u1, n1)


def kagan_angle(m6_a, m6_b) -> float:
    """
    Minimum rotation angle [deg] between the best-double-couple
    principal-axis frames of two mechanisms (Kagan 1991) — the standard
    mechanism-similarity metric (0° identical, ≤120° always).

    Computed from the deviatoric eigenframes: the four DC symmetry
    operations (identity + 180° flips about each principal axis) are
    applied and the smallest rotation angle kept.
    """

    def frame(m6):
        M = m6_to_matrix(np.asarray(m6, dtype=float))
        dev = M - np.trace(M) / 3.0 * np.eye(3)
        _, V = np.linalg.eigh(dev)          # ascending: P, B, T columns
        if np.linalg.det(V) < 0:
            V[:, 1] *= -1.0                 # right-handed (B flip is a
        return V                            # DC symmetry anyway)

    Va, Vb = frame(m6_a), frame(m6_b)
    best = 180.0
    for flip in (np.diag([1.0, 1.0, 1.0]), np.diag([1.0, -1.0, -1.0]),
                 np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
        R = Vb @ flip @ Va.T
        c = (np.trace(R) - 1.0) / 2.0
        best = min(best, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
    return best


def hudson_coords(m6):
    """Hudson skewed-diamond (u, v) source-type coordinates."""
    M = m6_to_matrix(m6)
    iso = np.trace(M) / 3.0
    dev_eigs = np.linalg.eigvalsh(M - iso * np.eye(3))
    d = np.sort(dev_eigs)[::-1]  # d1 >= d2 >= d3
    m_max = max(abs(d[0]), abs(d[2]))
    if m_max == 0:
        T = 0.0
    else:
        T = 2.0 * d[1] / m_max
    k = iso / (abs(iso) + m_max) if (abs(iso) + m_max) > 0 else 0.0
    u = T * (1.0 - abs(k))
    return u, k


def lune_coords(m6):
    """Tape & Tape lune (γ [deg], δ [deg]) from MT eigenvalues."""
    M = m6_to_matrix(m6)
    lam = np.sort(np.linalg.eigvalsh(M))[::-1]
    norm = np.linalg.norm(lam)
    if norm == 0:
        return 0.0, 0.0
    gamma = np.degrees(np.arctan2(-lam[0] + 2 * lam[1] - lam[2],
                                  np.sqrt(3.0) * (lam[0] - lam[2]))) \
        if lam[0] != lam[2] else 0.0
    beta = np.degrees(np.arccos(np.clip(lam.sum() / (np.sqrt(3.0) * norm), -1, 1)))
    delta = 90.0 - beta
    return gamma, delta


def radiation_amplitude(m6, gamma_vecs):
    """P radiation amplitude γᵀMγ for unit vectors (N, 3) in NED."""
    M = m6_to_matrix(m6)
    g = np.asarray(gamma_vecs)
    return np.einsum("ni,ij,nj->n", g, M, g)
