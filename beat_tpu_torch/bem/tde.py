"""
Triangular-dislocation elastic kernels and the BEM matrices (port of
``beat_tpu/bem/tde.py``), in float64 on the caller's device.

* Two point-force solutions: Kelvin (full space) and Mindlin (1936;
  half space with a traction-free surface at z = 0, z positive down),
  and Boussinesq–Cerruti for surface observations by reciprocity.
* A dislocation element is its moment-density surface distribution
  ``u_k(x) = ∫_S m_pq ∂U_kp/∂ξ_q dS`` with
  ``m = λ (b·n) I + µ (b nᵀ + n bᵀ)``, integrated by the centroid rule on
  4^L congruent subtriangles.
* Every derivative comes from ``torch.func.jacfwd``: the source gradient
  of the displacements, the receiver gradient of the stresses (nested)
  and the source gradient of the surface kernel.  None is derived by
  hand.

Precision: the quadrature sums cancel to about 1e-7 of their largest
terms, so everything here is float64 (:data:`FLOAT`); the H100 runs it
natively.

Batching: :func:`interaction_matrices` and :func:`displacement_matrices`
evaluate every (receiver, element, quadrature point) triple of a batch of
matrices as ``torch.func.vmap`` over flat triples, in chunks sized by
:func:`~beat_tpu_torch.device.chunk_budget` (a chunk costs about 150 ms
of host dispatch whatever its size, some 2200 ATen calls through
``torch.func``, so on a card only chunks of millions of triples leave the
device the bound); the near field (receivers within two element sizes
of a source element) is one more such batch at ``near_level``.  A batch
holds the matrices of several meshes with one layout (one per chain of a
geometry sampler).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from beat_tpu_torch.device import chunk_budget, resolve

logger = logging.getLogger("beat_tpu_torch.bem.tde")

FLOAT = torch.float64
#: peak bytes one triple holds in the stress (nested ``jacfwd``) and the
#: surface displacement (``jacfwd``) evaluations, for sizing the chunks
#: (4466–4514 and 1096–1098 on an H100 80GB HBM3,
#: ``tools/bench_torch_bem.py``); the volume displacements take the
#: stress's figure, an upper bound
STRESS_TRIPLE_BYTES = 4608
DISPLACEMENT_TRIPLE_BYTES = 1152


def kelvin_displacement(x, xi, mu=33e9, nu=0.25):
    """Kelvin solution U (3, 3): displacement component k at ``x`` per
    unit point force in direction i at ``xi`` (full space)."""
    r_vec = x - xi
    r = torch.sqrt(torch.sum(r_vec**2) + 1e-12)
    rhat = r_vec / r
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return ((3.0 - 4.0 * nu) * eye + torch.outer(rhat, rhat)) / \
        (16.0 * math.pi * mu * (1.0 - nu) * r)


def mindlin_displacement(x, xi, mu=33e9, nu=0.25):
    """
    Mindlin (1936) point-force solution in the half space ``z >= 0``
    with a traction-free surface at ``z = 0`` (z positive down).

    Returns (3, 3): displacement component k at ``x`` per unit point
    force in direction i at ``xi`` (columns: +east, +north, +down).
    """
    dx = x[0] - xi[0]
    dy = x[1] - xi[1]
    z = x[2]
    c = xi[2]
    r2h = dx * dx + dy * dy
    R1 = torch.sqrt(r2h + (z - c) ** 2 + 1e-12)
    R2 = torch.sqrt(r2h + (z + c) ** 2 + 1e-12)
    zc = z + c
    zm = z - c
    S = R2 + zc
    A = 1.0 / (16.0 * math.pi * mu * (1.0 - nu))
    m34 = 3.0 - 4.0 * nu
    q = 4.0 * (1.0 - nu) * (1.0 - 2.0 * nu)

    def horizontal(a, b_):
        """Force along the horizontal unit axis whose coordinate is a
        (the other horizontal coordinate is b_): returns (u_a, u_b, u_z)."""
        u_a = A * (m34 / R1 + 1.0 / R2 + a * a / R1**3 + m34 * a * a / R2**3
                   + 2.0 * c * z / R2**3 * (1.0 - 3.0 * a * a / R2**2)
                   + q / S * (1.0 - a * a / (R2 * S)))
        u_b = A * a * b_ * (1.0 / R1**3 + m34 / R2**3 - 6.0 * c * z / R2**5
                            - q / (R2 * S**2))
        u_z = A * a * (zm / R1**3 + m34 * zm / R2**3 - 6.0 * c * z * zc / R2**5
                       + q / (R2 * S))
        return u_a, u_b, u_z

    # force along +x (east)
    uxx, uyx, uzx = horizontal(dx, dy)
    # force along +y (north): same solution with the horizontal axes swapped
    uyy, uxy, uzy = horizontal(dy, dx)
    # force along +z (down): Mindlin's vertical-load solution
    ur = A * (zm / R1**3 + m34 * zm / R2**3 - q / (R2 * S)
              + 6.0 * c * z * zc / R2**5)
    uxz = dx * ur
    uyz = dy * ur
    uzz = A * (m34 / R1 + (8.0 * (1.0 - nu) ** 2 - m34) / R2
               + zm**2 / R1**3 + (m34 * zc**2 - 2.0 * c * z) / R2**3
               + 6.0 * c * z * zc**2 / R2**5)

    # rows: displacement component at x; columns: force direction at xi
    return torch.stack([torch.stack([uxx, uxy, uxz]),
                        torch.stack([uyx, uyy, uyz]),
                        torch.stack([uzx, uzy, uzz])])


def boussinesq_cerruti_displacement(xi, x0, mu=33e9, nu=0.25):
    """
    Displacement (3, 3) at interior point ``xi`` (z = depth, positive
    down) per unit point force applied at the free-surface point ``x0``
    (z = 0): columns = force direction (x, y, z-down); Boussinesq (normal
    load) + Cerruti (tangential load) half-space solutions.
    """
    d = xi - x0
    x, y, z = d[0], d[1], d[2]
    R = torch.sqrt(x * x + y * y + z * z + 1e-12)
    Rz = R + z
    k = 1.0 / (4.0 * math.pi * mu)
    om = 1.0 - 2.0 * nu

    # Cerruti: unit tangential force along x
    ux_x = k * (1.0 / R + x * x / R**3 + om * (1.0 / Rz - x * x / (R * Rz**2)))
    uy_x = k * (x * y / R**3 - om * x * y / (R * Rz**2))
    uz_x = k * (x * z / R**3 + om * x / (R * Rz))
    # unit tangential force along y (swap roles of x and y)
    ux_y = k * (x * y / R**3 - om * x * y / (R * Rz**2))
    uy_y = k * (1.0 / R + y * y / R**3 + om * (1.0 / Rz - y * y / (R * Rz**2)))
    uz_y = k * (y * z / R**3 + om * y / (R * Rz))
    # Boussinesq: unit normal force (z down)
    ux_z = k * (x * z / R**3 - om * x / (R * Rz))
    uy_z = k * (y * z / R**3 - om * y / (R * Rz))
    uz_z = k * (z * z / R**3 + 2.0 * (1.0 - nu) / R)

    # rows: displacement component at xi; columns: force direction at x0
    return torch.stack([torch.stack([ux_x, ux_y, ux_z]),
                        torch.stack([uy_x, uy_y, uy_z]),
                        torch.stack([uz_x, uz_y, uz_z])])


def moment_density(b, n, mu=33e9, lam=33e9):
    """m_pq = λ(b·n)δ_pq + µ(b_p n_q + b_q n_p) per unit area."""
    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    return lam * torch.dot(b, n) * eye + mu * (torch.outer(b, n) + torch.outer(n, b))


def _greens_fn(medium: str):
    if medium == "fullspace":
        return kelvin_displacement
    elif medium == "halfspace":
        return mindlin_displacement
    raise ValueError(f"Unknown medium {medium!r} (fullspace|halfspace)")


def point_dislocation_displacement(x, xi, m_pq, mu=33e9, nu=0.25, medium="fullspace"):
    """u_k(x) (3,) of a point moment m_pq at ξ: m_pq ∂U_kp/∂ξ_q, the
    source gradient from ``jacfwd``."""
    green = _greens_fn(medium)
    dU = jacfwd(green, argnums=1)(x, xi, mu, nu)          # (k, p, q)
    return torch.einsum("pq,kpq->k", m_pq, dU)


def _displacement_gradient(x, xi, m_pq, mu, nu, medium):
    """∂u_k/∂x_l (3, 3) of a point moment: ``jacfwd`` over the receiver
    of :func:`point_dislocation_displacement` (itself a ``jacfwd`` over
    the source)."""
    return jacfwd(point_dislocation_displacement)(x, xi, m_pq, mu, nu, medium)


def _surface_point_displacement(x0, xi, m_pq, mu, nu):
    """Surface displacement (3,) at ``x0`` (z = 0) of a point moment at
    ξ by reciprocity: m_pq ∂G_pk/∂ξ_q of the surface-force solution."""
    dG = jacfwd(boussinesq_cerruti_displacement)(xi, x0, mu, nu)   # (p, k, q)
    return torch.einsum("pq,pkq->k", m_pq, dG)


def lame_lambda(mu: float, nu: float) -> float:
    return 2.0 * mu * nu / (1.0 - 2.0 * nu)


# ---------------------------------------------------------------------------
# Quadrature
# ---------------------------------------------------------------------------


def _subdivide_batch(tris: torch.Tensor, level: int):
    """Centroids (T, 4^level, 3) and equal sub-areas (T,) of the 4^level
    congruent subtriangles of each triangle (T, 3, 3), in the order and
    with the arithmetic of the JAX package's recursive subdivision."""
    t = tris[:, None]                                     # (T, 1, 3, 3)
    for _ in range(level):
        t0, t1, t2 = t[:, :, 0], t[:, :, 1], t[:, :, 2]
        m01, m12, m20 = (t0 + t1) / 2, (t1 + t2) / 2, (t2 + t0) / 2
        children = torch.stack([torch.stack([t0, m01, m20], dim=2),
                                torch.stack([m01, t1, m12], dim=2),
                                torch.stack([m20, m12, t2], dim=2),
                                torch.stack([m01, m12, m20], dim=2)], dim=2)
        t = children.reshape(t.shape[0], -1, 3, 3)       # children of k at 4k..4k+3
    cents = (t[:, :, 0] + t[:, :, 1] + t[:, :, 2]) / 3.0
    area = 0.5 * torch.linalg.norm(torch.cross(tris[:, 1] - tris[:, 0],
                                               tris[:, 2] - tris[:, 0], dim=-1), dim=-1)
    return cents, area / 4**level


def _subdivide(tri, level: int):
    """Centroids (4^level, 3) and the equal area of one triangle's
    subtriangles (numpy, float64)."""
    cents, dA = _subdivide_batch(torch.as_tensor(np.asarray(tri, dtype=np.float64))[None],
                                 level)
    return cents[0].numpy(), float(dA[0])


def _unit_normals(tris: torch.Tensor) -> torch.Tensor:
    n = torch.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def _moments(tris, bs, mu, lam, level):
    """Quadrature of T elements with Burgers vectors ``bs`` (T, 3): the
    subtriangle centroids (T, Q, 3) and the moments m·dA (T, 3, 3)."""
    cents, dA = _subdivide_batch(tris, level)
    m = vmap(moment_density, in_dims=(0, 0, None, None))(bs, _unit_normals(tris), mu, lam)
    return cents, m * dA[:, None, None]


def _chunks(n_pairs: int, per_pair: int, triple_bytes: int, chunk_bytes: float):
    """Slices over ``n_pairs`` pairs of ``per_pair`` triples each, every
    slice within ``chunk_bytes``."""
    step = max(1, int(chunk_bytes // (per_pair * triple_bytes)))
    return [slice(s, min(s + step, n_pairs)) for s in range(0, n_pairs, step)]


def _quadrature_sums(fn, n_pairs: int, pair_inputs, level: int, mu, lam, triple_bytes: int,
                     device: torch.device) -> torch.Tensor:
    """Σ over the 4^level quadrature points of ``fn(x, ξ, m·dA)`` for each
    of ``n_pairs`` (point, element) pairs: ``pair_inputs(slice)`` gives
    the pairs' points (n, 3), triangles (n, 3, 3) and Burgers vectors
    (n, 3).  Every (point, element, quadrature point) triple of a chunk
    is one ``vmap`` batch.  Returns (n_pairs, ...)."""
    Q = 4**level
    out = []
    for sl in _chunks(n_pairs, Q, triple_bytes, chunk_budget(device)):
        x, tris, bs = pair_inputs(sl)
        cents, m = _moments(tris, bs, mu, lam, level)
        n = x.shape[0]
        vals = vmap(fn)(x[:, None].expand(n, Q, 3).reshape(-1, 3), cents.reshape(-1, 3),
                        m[:, None].expand(n, Q, 3, 3).reshape(-1, 3, 3))
        out.append(vals.reshape(n, Q, *vals.shape[1:]).sum(dim=1))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Single elements
# ---------------------------------------------------------------------------


def _element_sums(fn, obs, tri, b, mu, nu, lam, level, triple_bytes, device):
    """Σ over one element's quadrature points of ``fn`` at each of
    ``obs`` (N, 3)."""
    dev = resolve(device)
    lam = lame_lambda(mu, nu) if lam is None else lam
    x = torch.as_tensor(np.asarray(obs, dtype=np.float64), device=dev)
    tri = torch.as_tensor(np.asarray(tri, dtype=np.float64), device=dev)
    b = torch.as_tensor(np.asarray(b, dtype=np.float64), device=dev)

    def pair_inputs(sl):
        n = x[sl].shape[0]
        return x[sl], tri.expand(n, 3, 3), b.expand(n, 3)

    return _quadrature_sums(fn, x.shape[0], pair_inputs, level, mu, lam, triple_bytes,
                            dev), lam


def element_displacement(obs, tri, b, mu=33e9, nu=0.25, lam=None, level: int = 2,
                         medium: str = "fullspace", *, device) -> torch.Tensor:
    """Displacement (N, 3) at points ``obs`` (N, 3) from a uniform Burgers
    vector ``b`` on triangle ``tri`` (3, 3), quadrature level ``level``;
    ``medium`` picks the Kelvin (fullspace) or Mindlin (halfspace) kernel."""
    def fn(x1, xi, m1):
        return point_dislocation_displacement(x1, xi, m1, mu, nu, medium)

    return _element_sums(fn, obs, tri, b, mu, nu, lam, level, STRESS_TRIPLE_BYTES, device)[0]


def _stress_from_gradient(grad, mu, lam):
    eps = 0.5 * (grad + grad.transpose(-1, -2))
    tr = torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=grad.dtype, device=grad.device)
    return lam * tr[..., None, None] * eye + 2.0 * mu * eps


def element_stress(obs, tri, b, mu=33e9, nu=0.25, lam=None, level: int = 2,
                   medium: str = "fullspace", *, device) -> torch.Tensor:
    """Stress tensors (N, 3, 3) at ``obs`` from the element: the receiver
    gradient of the displacement field by ``jacfwd``."""
    def fn(x1, xi, m1):
        return _displacement_gradient(x1, xi, m1, mu, nu, medium)

    grad, lam = _element_sums(fn, obs, tri, b, mu, nu, lam, level, STRESS_TRIPLE_BYTES,
                              device)
    return _stress_from_gradient(grad, mu, lam)


def element_surface_displacement_halfspace(obs_xy, tri, b, mu=33e9, nu=0.25, lam=None,
                                           level: int = 3, *, device) -> torch.Tensor:
    """Half-space surface displacements (N, 3) at ``obs_xy`` (N, 2) of a
    buried triangular dislocation, by reciprocity (Boussinesq–Cerruti at
    the buried point; source derivatives by ``jacfwd``).  Components are
    (east, north, z-down)."""
    xy = np.asarray(obs_xy, dtype=np.float64)
    x0 = np.concatenate([xy, np.zeros_like(xy[:, :1])], axis=1)

    def fn(x1, xi, m1):
        return _surface_point_displacement(x1, xi, m1, mu, nu)

    return _element_sums(fn, x0, tri, b, mu, nu, lam, level, DISPLACEMENT_TRIPLE_BYTES,
                         device)[0]


# ---------------------------------------------------------------------------
# BEM assembly, batched over mesh sets of one layout
# ---------------------------------------------------------------------------


def _slip_vectors(mesh, component):
    if component == "strike":
        return mesh.unit_strike_vectors
    elif component == "dip":
        return mesh.unit_dip_vectors
    elif component == "normal":
        return mesh.normals
    raise ValueError(f"Unknown slip component {component}")


def _columns(meshes, boundary_conditions):
    """Per column (BC × source mesh × element): triangles (K, 3, 3) and
    Burgers vectors (K, 3), numpy, in the matrices' column order."""
    tris, bs = [], []
    for bc in boundary_conditions:
        for src_i in bc.source_idxs:
            mesh = meshes[src_i]
            tris.append(mesh.triangles)
            bs.append(_slip_vectors(mesh, bc.slip_component))
    return np.concatenate(tris), np.concatenate(bs)


def _receivers(meshes, boundary_conditions, self_offset_frac):
    """Collocation points, normals and BC slip directions (R, 3) each."""
    pts, normals, dirs = [], [], []
    for bc in boundary_conditions:
        for rec_i in bc.receiver_idxs:
            mesh = meshes[rec_i]
            off = (self_offset_frac * np.sqrt(mesh.areas))[:, None] * mesh.normals
            pts.append(mesh.centroids + off)
            normals.append(mesh.normals)
            dirs.append(_slip_vectors(mesh, bc.slip_component))
    return np.concatenate(pts), np.concatenate(normals), np.concatenate(dirs)


def _stacked(arrays, dev):
    return torch.as_tensor(np.stack(arrays), dtype=FLOAT, device=dev)


def interaction_matrices(mesh_sets, boundary_conditions, nu=0.25, mu=33e9, level: int = 2,
                         near_level: int = 6, self_offset_frac: float = 0.5,
                         medium: str = "fullspace", *, device) -> torch.Tensor:
    """
    Traction interaction matrices (B, R, K) of B mesh sets of one layout
    (equal triangle counts per mesh): rows = receiver-element BC
    tractions projected on the BC slip direction, columns = unit slips of
    source elements per BC, float64 on ``device``.

    Collocation points sit ``self_offset_frac · sqrt(area)`` along the
    receiver normal; entries whose collocation point lies within two
    element sizes of the source element's centroid are evaluated at
    ``near_level`` instead of ``level``.  Each of the two sets is one
    batch of (receiver, element, quadrature point) triples.
    """
    dev = resolve(device)
    lam = lame_lambda(mu, nu)
    tris, bs, rec_pts, rec_n, rec_dir, near = [], [], [], [], [], []
    for meshes in mesh_sets:
        t, b = _columns(meshes, boundary_conditions)
        pts, normals, dirs = _receivers(meshes, boundary_conditions, self_offset_frac)
        size = np.sqrt(np.concatenate([meshes[i].areas for bc in boundary_conditions
                                       for i in bc.source_idxs]))
        cent = np.concatenate([meshes[i].centroids for bc in boundary_conditions
                               for i in bc.source_idxs])
        dist = np.linalg.norm(pts[:, None, :] - cent[None, :, :], axis=2)
        for lst, arr in ((tris, t), (bs, b), (rec_pts, pts), (rec_n, normals),
                         (rec_dir, dirs), (near, dist < 2.0 * size[None, :])):
            lst.append(arr)
    tris, bs, rec_pts, rec_n, rec_dir = (_stacked(a, dev)
                                         for a in (tris, bs, rec_pts, rec_n, rec_dir))
    near = torch.as_tensor(np.stack(near), device=dev)          # (B, R, K)
    B, R, K = near.shape
    flat_tris, flat_bs = tris.reshape(-1, 3, 3), bs.reshape(-1, 3)

    def fn(x1, xi, m1):
        return _displacement_gradient(x1, xi, m1, mu, nu, medium)

    G = torch.empty((B, R, K), dtype=FLOAT, device=dev)
    for mask, lev in ((~near, level), (near, near_level)):
        b_i, r_i, k_i = torch.nonzero(mask, as_tuple=True)
        if b_i.numel() == 0:
            continue
        col = b_i * K + k_i

        def pair_inputs(sl):
            return rec_pts[b_i[sl], r_i[sl]], flat_tris[col[sl]], flat_bs[col[sl]]

        grad = _quadrature_sums(fn, b_i.numel(), pair_inputs, lev, mu, lam,
                                STRESS_TRIPLE_BYTES, dev)
        traction = torch.einsum("nij,nj->ni", _stress_from_gradient(grad, mu, lam),
                                rec_n[b_i, r_i])
        G[b_i, r_i, k_i] = torch.einsum("ni,ni->n", traction, rec_dir[b_i, r_i])
    logger.info("Assembled %i BEM interaction matrices %s (%i near pairs)", B, (R, K),
                int(near.sum()))
    return G


def interaction_matrix(meshes, boundary_conditions, nu=0.25, mu=33e9, level: int = 2,
                       near_level: int = 6, self_offset_frac: float = 0.5,
                       medium: str = "fullspace", *, device) -> torch.Tensor:
    """The (R, K) traction interaction matrix of one mesh set
    (:func:`interaction_matrices` with a batch of one)."""
    return interaction_matrices([meshes], boundary_conditions, nu=nu, mu=mu, level=level,
                                near_level=near_level, self_offset_frac=self_offset_frac,
                                medium=medium, device=device)[0]


def displacement_matrices(mesh_sets, coords, nu=0.25, mu=33e9, level: int = 3,
                          boundary_conditions=None, medium: str = "halfspace", *,
                          device) -> torch.Tensor:
    """
    Displacements (B, 3·nobs, K) at observation points per unit element
    slip, for B mesh sets of one layout.  2-D coords are free-surface
    observations through the exact half-space reciprocity kernel; 3-D
    coords go through the ``medium`` volume kernel.  Rows are (east,
    north, up) per point; columns in :func:`interaction_matrices`' order.
    All (point, element, quadrature point) triples are one batch.
    """
    dev = resolve(device)
    lam = lame_lambda(mu, nu)
    coords = torch.as_tensor(np.asarray(coords, dtype=np.float64), device=dev)
    if coords.shape[1] == 2:
        obs = torch.cat([coords, torch.zeros_like(coords[:, :1])], dim=1)
        triple_bytes = DISPLACEMENT_TRIPLE_BYTES

        def fn(x1, xi, m1):
            return _surface_point_displacement(x1, xi, m1, mu, nu)
    else:
        obs = coords
        triple_bytes = STRESS_TRIPLE_BYTES

        def fn(x1, xi, m1):
            return point_dislocation_displacement(x1, xi, m1, mu, nu, medium)

    cols = [_columns(meshes, boundary_conditions or []) for meshes in mesh_sets]
    flat_tris = _stacked([c[0] for c in cols], dev).reshape(-1, 3, 3)
    flat_bs = _stacked([c[1] for c in cols], dev).reshape(-1, 3)
    B, N = len(mesh_sets), obs.shape[0]
    K = flat_tris.shape[0] // B

    def pair_inputs(sl):
        # pair p: column p // N, point p % N
        p = torch.arange(sl.start, sl.stop, device=dev)
        col = p // N
        return obs[p % N], flat_tris[col], flat_bs[col]

    disp = _quadrature_sums(fn, B * K * N, pair_inputs, level, mu, lam, triple_bytes,
                            dev)                                         # (B·K·N, 3)
    disp[:, 2] = -disp[:, 2]                      # z-down -> up
    return disp.reshape(B, K, 3 * N).transpose(1, 2)


def displacement_matrix(meshes, coords, nu=0.25, mu=33e9, level: int = 3,
                        boundary_conditions=None, medium: str = "halfspace", *,
                        device) -> torch.Tensor:
    """The (3·nobs, K) displacement matrix of one mesh set."""
    return displacement_matrices([meshes], coords, nu=nu, mu=mu, level=level,
                                 boundary_conditions=boundary_conditions, medium=medium,
                                 device=device)[0]
