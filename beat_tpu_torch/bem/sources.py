"""
BEM source geometries: parameterised surfaces discretized into triangle
meshes (copied from ``beat_tpu/bem/sources.py``; host numpy, the meshes
equal the JAX package's bit for bit).

Structured triangulations are generated directly (no gmsh), with the
reference's parameter sets (half axes, plunge, curvature/bend
parameters).  Coordinates: (east, north, depth) [m], depth positive down.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

D2R = np.pi / 180.0


@dataclass
class TriangleMesh:
    """Discretized source mesh (reference ``DiscretizedBEMSource``)."""

    vertices: np.ndarray   # (nv, 3) east, north, depth
    faces: np.ndarray      # (nf, 3) int indices

    @property
    def ntriangles(self) -> int:
        return int(self.faces.shape[0])

    @property
    def triangles(self) -> np.ndarray:
        """(nf, 3, 3) corner coordinates."""
        return self.vertices[self.faces]

    @property
    def centroids(self) -> np.ndarray:
        return self.triangles.mean(axis=1)

    @property
    def normals(self) -> np.ndarray:
        t = self.triangles
        n = np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        return n / np.linalg.norm(n, axis=1, keepdims=True)

    @property
    def areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1)

    @property
    def unit_strike_vectors(self) -> np.ndarray:
        """Horizontal in-plane unit vectors (reference ``sources.py:120``)."""
        n = self.normals
        up = np.array([0.0, 0.0, -1.0])
        s = np.cross(n, np.broadcast_to(up, n.shape))
        norms = np.linalg.norm(s, axis=1, keepdims=True)
        # horizontal faces: any horizontal direction
        s = np.where(norms > 1e-9, s / np.maximum(norms, 1e-12),
                     np.array([1.0, 0.0, 0.0]))
        return s

    @property
    def unit_dip_vectors(self) -> np.ndarray:
        return np.cross(self.normals, self.unit_strike_vectors)


def _grid_triangulation(nx: int, ny: int):
    """Faces of a structured (nx+1)×(ny+1) vertex grid."""
    faces = []
    for j in range(ny):
        for i in range(nx):
            v00 = j * (nx + 1) + i
            v10 = v00 + 1
            v01 = v00 + (nx + 1)
            v11 = v01 + 1
            faces.append([v00, v10, v11])
            faces.append([v00, v11, v01])
    return np.asarray(faces, dtype=np.int32)


@dataclass
class BaseBEMSource:
    east_shift: float = 0.0
    north_shift: float = 0.0
    depth: float = 2000.0

    def discretize(self, mesh_size: float) -> TriangleMesh:
        raise NotImplementedError

    def _place(self, verts: np.ndarray) -> np.ndarray:
        return verts + np.array([self.east_shift, self.north_shift, self.depth])


@dataclass
class TriangleBEMSource(BaseBEMSource):
    """Single triangle from explicit corners (reference :217)."""

    p1: tuple = (0.0, 0.0, 0.0)
    p2: tuple = (1000.0, 0.0, 0.0)
    p3: tuple = (0.0, 1000.0, 0.0)

    def discretize(self, mesh_size: float = 0.0) -> TriangleMesh:
        verts = np.array([self.p1, self.p2, self.p3], dtype=float)
        return TriangleMesh(self._place(verts), np.array([[0, 1, 2]], dtype=np.int32))


@dataclass
class RectangularBEMSource(BaseBEMSource):
    """Planar rectangle (strike/dip), structured triangulation
    (reference ``RectangularBEMSource``)."""

    strike: float = 0.0
    dip: float = 90.0
    length: float = 4000.0
    width: float = 2000.0

    def discretize(self, mesh_size: float) -> TriangleMesh:
        nx = max(1, int(round(self.length / mesh_size)))
        ny = max(1, int(round(self.width / mesh_size)))
        x = np.linspace(-self.length / 2, self.length / 2, nx + 1)
        y = np.linspace(0.0, self.width, ny + 1)
        X, Y = np.meshgrid(x, y)
        st, di = self.strike * D2R, self.dip * D2R
        s_vec = np.array([np.sin(st), np.cos(st), 0.0])
        d_vec = np.array([np.cos(di) * np.cos(st), -np.cos(di) * np.sin(st),
                          np.sin(di)])
        verts = X.reshape(-1, 1) * s_vec + Y.reshape(-1, 1) * d_vec
        return TriangleMesh(self._place(verts), _grid_triangulation(nx, ny))


@dataclass
class EllipseBEMSource(BaseBEMSource):
    """Planar ellipse (half axes, strike, plunge-capable dipping plane)
    (reference ``EllipseBEMSource`` :390)."""

    a_half_axis: float = 2000.0
    b_half_axis: float = 1000.0
    strike: float = 0.0
    dip: float = 0.0
    plunge: float = 0.0

    def discretize(self, mesh_size: float) -> TriangleMesh:
        n_ring = max(8, int(round(2 * np.pi * self.a_half_axis / mesh_size)))
        n_rad = max(2, int(round(min(self.a_half_axis, self.b_half_axis) / mesh_size)))
        verts = [np.zeros(3)]
        faces = []
        prev_ring = None
        for r_i in range(1, n_rad + 1):
            frac = r_i / n_rad
            ring = []
            for k in range(n_ring):
                ang = 2 * np.pi * k / n_ring
                ring.append([frac * self.a_half_axis * np.cos(ang),
                             frac * self.b_half_axis * np.sin(ang), 0.0])
            start = len(verts)
            verts.extend(ring)
            idx = [start + k for k in range(n_ring)]
            if prev_ring is None:
                for k in range(n_ring):
                    faces.append([0, idx[k], idx[(k + 1) % n_ring]])
            else:
                for k in range(n_ring):
                    k2 = (k + 1) % n_ring
                    faces.append([prev_ring[k], idx[k], idx[k2]])
                    faces.append([prev_ring[k], idx[k2], prev_ring[k2]])
            prev_ring = idx
        verts = np.asarray(verts)
        # orient: strike rotation, then dip, then plunge about strike axis
        verts = _rotate(verts, self.strike, self.dip, self.plunge)
        return TriangleMesh(self._place(verts),
                            np.asarray(faces, dtype=np.int32))


@dataclass
class DiskBEMSource(EllipseBEMSource):
    """Circular crack/sill (reference ``DiskBEMSource``)."""

    def __post_init__(self):
        self.b_half_axis = self.a_half_axis


@dataclass
class RingfaultBEMSource(BaseBEMSource):
    """Cylindrical (caldera ring) fault surface (reference
    ``RingfaultBEMSource`` :702)."""

    diameter: float = 3000.0
    height: float = 1500.0          # vertical extent [m] below `depth`
    strike: float = 0.0

    def discretize(self, mesh_size: float) -> TriangleMesh:
        r = self.diameter / 2.0
        n_ring = max(8, int(round(2 * np.pi * r / mesh_size)))
        n_z = max(1, int(round(self.height / mesh_size)))
        verts = []
        for zi in range(n_z + 1):
            z = self.height * zi / n_z
            for k in range(n_ring):
                ang = 2 * np.pi * k / n_ring
                verts.append([r * np.cos(ang), r * np.sin(ang), z])
        faces = []
        for zi in range(n_z):
            for k in range(n_ring):
                k2 = (k + 1) % n_ring
                v00 = zi * n_ring + k
                v01 = zi * n_ring + k2
                v10 = (zi + 1) * n_ring + k
                v11 = (zi + 1) * n_ring + k2
                faces.append([v00, v01, v11])
                faces.append([v00, v11, v10])
        return TriangleMesh(self._place(np.asarray(verts)),
                            np.asarray(faces, dtype=np.int32))


@dataclass
class CurvedBEMSource(RectangularBEMSource):
    """Rectangle with quadratic along-strike bend and down-dip curvature
    (reference ``CurvedBEMSource`` :860, bend/curv parameters)."""

    bend_location: float = 0.5
    bend_amplitude: float = 0.0
    curv_amplitude_bottom: float = 0.0
    curv_location_bottom: float = 0.5

    def discretize(self, mesh_size: float) -> TriangleMesh:
        mesh = super().discretize(mesh_size)
        verts = mesh.vertices - np.array([self.east_shift, self.north_shift,
                                          self.depth])
        st, di = self.strike * D2R, self.dip * D2R
        s_vec = np.array([np.sin(st), np.cos(st), 0.0])
        d_vec = np.array([np.cos(di) * np.cos(st), -np.cos(di) * np.sin(st),
                          np.sin(di)])
        t_vec = np.array([np.cos(st), -np.sin(st), 0.0])
        along = verts @ s_vec / max(self.length, 1e-9) + 0.5   # 0..1
        # down-dip fraction measured along the dip vector, not from the
        # vertical coordinate (which only reaches sin(dip) x width)
        downdip = np.clip(verts @ d_vec / max(self.width, 1e-9), 0, 1)
        bend = self.bend_amplitude * self.length * \
            (along - self.bend_location) ** 2
        curv = self.curv_amplitude_bottom * self.width * \
            (downdip - self.curv_location_bottom) ** 2
        verts = verts + np.outer(bend + curv, t_vec)
        return TriangleMesh(self._place(verts), mesh.faces)


def check_intersection(meshes: list, min_distance: float = 1.0) -> bool:
    """
    Conservative mesh-intersection guard (reference ``check_intersection``
    ``bem/sources.py:981``): True if any two meshes' triangles come
    closer than ``min_distance`` (centroid-distance vs circumradius
    bound) or any vertex breaches the free surface.
    """
    for mesh in meshes:
        if np.any(mesh.vertices[:, 2] < -1e-6):
            return True
    for i in range(len(meshes)):
        for j in range(i + 1, len(meshes)):
            ci = meshes[i].centroids
            cj = meshes[j].centroids
            ri = np.max(np.linalg.norm(
                meshes[i].triangles - ci[:, None, :], axis=2), axis=1)
            rj = np.max(np.linalg.norm(
                meshes[j].triangles - cj[:, None, :], axis=2), axis=1)
            d = np.linalg.norm(ci[:, None, :] - cj[None, :, :], axis=2)
            if np.any(d < ri[:, None] + rj[None, :] + min_distance):
                return True
    return False


def _rotate(verts: np.ndarray, strike: float, dip: float, plunge: float) -> np.ndarray:
    """Rotate a z=0 planar mesh built with its major (+x) axis along
    east: first an azimuth rotation about vertical takes +x onto the
    strike direction (without it the strike parameter would be a no-op
    for horizontal sills), then dip tilts about the strike axis and
    plunge about the dip axis."""
    st, di, pl = strike * D2R, dip * D2R, plunge * D2R

    def rot(axis, ang):
        axis = axis / np.linalg.norm(axis)
        K = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K

    s_axis = np.array([np.sin(st), np.cos(st), 0.0])
    d_axis = np.array([np.cos(st), -np.sin(st), 0.0])
    # local +x (east) -> strike direction
    R_az = rot(np.array([0.0, 0.0, 1.0]), np.pi / 2.0 - st)
    R = rot(s_axis, di) @ rot(d_axis, pl) @ R_az
    return verts @ R.T


source_catalog = {
    "TriangleBEMSource": TriangleBEMSource,
    "RectangularBEMSource": RectangularBEMSource,
    "EllipseBEMSource": EllipseBEMSource,
    "DiskBEMSource": DiskBEMSource,
    "RingfaultBEMSource": RingfaultBEMSource,
    "CurvedBEMSource": CurvedBEMSource,
}
