"""
The port's BEM mode against the JAX package on the CPU, in float64 on
both sides: the meshes of every source type and the intersection guard;
the Kelvin, Mindlin and Boussinesq–Cerruti point-force solutions and
their ``torch.func.jacfwd`` derivatives against ``jax.jacfwd`` of the JAX
ones; the element displacements, stresses and surface displacements, the
interaction and displacement matrices on a 1 km disk; the SVD solve
against numpy's ``lstsq``; ``BEMEngine.process``.

Bars: the meshes and the guard are the same host numpy code, equal; the
kernels rtol 1e-12 (the same float64 expressions, rounded in another
order); everything that sums quadrature points rtol 1e-9 of each
column's (or each evaluation's) largest value: the sums cancel to about
1e-7 of their largest terms, so the kernels' 1e-16 rounding can reach
1e-9 of the result.

The JAX assembly evaluates one element column at a time, op by op, about
1.4 s a column with the Mindlin kernel on a CPU: the matrices are
compared on the full space (24 × 24) and, for the half space, on one
source triangle against the disk's 24 receivers.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.bem import base as jbase
from beat_tpu.bem import sources as jsources
from beat_tpu.bem import tde as jtde
from beat_tpu_torch import convert
from beat_tpu_torch.bem import BoundaryCondition, base, sources, tde
from test_torch_okada import jax_x64

KERNEL_RTOL = 1e-12
QUAD_RTOL = 1e-9
MU, NU = 33e9, 0.25
LEVELS = (1, 3)                       # (far, near) subdivision levels of the matrices

SOURCES = {
    "TriangleBEMSource": dict(p1=(0.0, 0.0, 100.0), p2=(900.0, 50.0, 0.0),
                              p3=(100.0, 800.0, 300.0), depth=2e3),
    "RectangularBEMSource": dict(strike=30.0, dip=60.0, length=3e3, width=1.5e3, depth=2e3),
    "EllipseBEMSource": dict(a_half_axis=2e3, b_half_axis=900.0, strike=20.0, dip=35.0,
                             plunge=10.0, depth=4e3),
    "DiskBEMSource": dict(a_half_axis=1e3, depth=3e3),
    "RingfaultBEMSource": dict(diameter=3e3, height=1.2e3, strike=10.0, depth=1e3),
    "CurvedBEMSource": dict(strike=120.0, dip=50.0, length=4e3, width=2e3, bend_amplitude=0.1,
                            curv_amplitude_bottom=0.2, depth=2e3),
}


@pytest.mark.parametrize("name", list(SOURCES))
def test_meshes_equal_jax(name):
    for mesh_size in (300.0, 700.0):
        jsrc = jsources.source_catalog[name](**SOURCES[name])
        ported = convert.bem_source_from_jax(jsrc)
        for src in (sources.source_catalog[name](**SOURCES[name]), ported):
            got, want = src.discretize(mesh_size), jsrc.discretize(mesh_size)
            np.testing.assert_array_equal(got.vertices, want.vertices)
            np.testing.assert_array_equal(got.faces, want.faces)
            for prop in ("normals", "areas", "unit_strike_vectors", "unit_dip_vectors"):
                np.testing.assert_array_equal(getattr(got, prop), getattr(want, prop))


@pytest.mark.parametrize("placement", [
    dict(b=dict(depth=3e3, east_shift=5e3)),           # apart
    dict(b=dict(depth=3.2e3, east_shift=300.0)),        # overlapping
    dict(b=dict(depth=-200.0, east_shift=5e3)),         # breaching the surface
])
def test_check_intersection_equals_jax(placement):
    a = dict(a_half_axis=1e3, depth=3e3)
    b = dict(a_half_axis=1e3, **placement["b"])
    meshes = [sources.DiskBEMSource(**a).discretize(500.0),
              sources.DiskBEMSource(**b).discretize(500.0)]
    jmeshes = [jsources.DiskBEMSource(**a).discretize(500.0),
               jsources.DiskBEMSource(**b).discretize(500.0)]
    assert sources.check_intersection(meshes) == jsources.check_intersection(jmeshes)
    assert sources.check_intersection(meshes[1:]) == jsources.check_intersection(jmeshes[1:])


def _pairs(n=40, seed=0):
    """Receivers and sources (n, 3) at depth, some near each other."""
    rng = np.random.default_rng(seed)
    x = rng.uniform([-3e3, -3e3, 100.0], [3e3, 3e3, 6e3], (n, 3))
    xi = rng.uniform([-3e3, -3e3, 200.0], [3e3, 3e3, 6e3], (n, 3))
    xi[::4] = x[::4] + rng.normal(0, 50.0, (len(xi[::4]), 3))
    xi[:, 2] = np.abs(xi[:, 2])
    return x, xi


def _assert_close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("kernel", ["kelvin_displacement", "mindlin_displacement",
                                    "boussinesq_cerruti_displacement"])
def test_point_force_kernels_and_jacfwd_match_jax(kernel):
    x, xi = _pairs()
    if kernel == "boussinesq_cerruti_displacement":
        x = x.copy()
        xi, x = x, np.concatenate([xi[:, :2], np.zeros((len(xi), 1))], axis=1)
    fn, jfn = getattr(tde, kernel), getattr(jtde, kernel)
    tx, txi = torch.as_tensor(x), torch.as_tensor(xi)
    got = torch.vmap(fn, in_dims=(0, 0, None, None))(tx, txi, MU, NU)
    # the derivatives the BEM uses: over the second argument for the point
    # forces (the source), over the first for Boussinesq-Cerruti (the buried point)
    argnum = 0 if kernel == "boussinesq_cerruti_displacement" else 1
    dgot = torch.vmap(torch.func.jacfwd(fn, argnums=argnum),
                      in_dims=(0, 0, None, None))(tx, txi, MU, NU)
    with jax_x64():
        jx, jxi = jnp.asarray(x), jnp.asarray(xi)
        want = jax.jit(jax.vmap(lambda a, b: jfn(a, b, MU, NU)))(jx, jxi)
        dwant = jax.jit(jax.vmap(jax.jacfwd(lambda a, b: jfn(a, b, MU, NU),
                                            argnums=argnum)))(jx, jxi)
        want, dwant = np.asarray(want), np.asarray(dwant)
    _assert_close(got.numpy(), want, KERNEL_RTOL)
    _assert_close(dgot.numpy(), dwant, KERNEL_RTOL)


@pytest.mark.parametrize("medium", ["fullspace", "halfspace"])
def test_point_dislocation_and_its_receiver_gradient_match_jax(medium):
    x, xi = _pairs(seed=1)
    rng = np.random.default_rng(2)
    b, n = rng.normal(size=3), rng.normal(size=3)
    n /= np.linalg.norm(n)
    lam = tde.lame_lambda(MU, NU)
    m = tde.moment_density(torch.as_tensor(b), torch.as_tensor(n), MU, lam)
    tx, txi = torch.as_tensor(x), torch.as_tensor(xi)
    got = torch.vmap(tde.point_dislocation_displacement,
                     in_dims=(0, 0, None, None, None, None))(tx, txi, m, MU, NU, medium)
    grad = torch.vmap(tde._displacement_gradient,
                      in_dims=(0, 0, None, None, None, None))(tx, txi, m, MU, NU, medium)
    with jax_x64():
        jm = jtde.moment_density(jnp.asarray(b), jnp.asarray(n), MU, lam)
        _assert_close(m.numpy(), np.asarray(jm), KERNEL_RTOL)

        def f(a, c):
            return jtde.point_dislocation_displacement(a, c, jm, MU, NU, medium)

        want = np.asarray(jax.jit(jax.vmap(f))(jnp.asarray(x), jnp.asarray(xi)))
        gwant = np.asarray(jax.jit(jax.vmap(jax.jacfwd(f)))(jnp.asarray(x), jnp.asarray(xi)))
    _assert_close(got.numpy(), want, KERNEL_RTOL)
    _assert_close(grad.numpy(), gwant, KERNEL_RTOL)


@pytest.fixture(scope="module")
def disk():
    """The 1 km disk at 3 km, meshed at 1 km (24 triangles), in both
    packages, and observation points around it."""
    rng = np.random.default_rng(5)
    src = dict(a_half_axis=1e3, depth=3e3)
    mesh = sources.DiskBEMSource(**src).discretize(1000.0)
    jmesh = jsources.DiskBEMSource(**src).discretize(1000.0)
    return dict(mesh=mesh, jmesh=jmesh, surface=rng.uniform(-6e3, 6e3, (40, 2)),
                volume=np.concatenate([rng.uniform(-3e3, 3e3, (24, 2)),
                                       rng.uniform(500.0, 5e3, (24, 1))], axis=1))


def _columns_close(got, want, rtol=QUAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bar = rtol * np.abs(want).max(axis=0, keepdims=True)
    assert (np.abs(got - want) <= bar).all(), float((np.abs(got - want) / bar).max())


@pytest.mark.parametrize("medium", ["fullspace", "halfspace"])
def test_element_functions_match_jax(disk, medium):
    mesh = disk["mesh"]
    e = 5
    tri, b = mesh.triangles[e], mesh.unit_dip_vectors[e]
    obs = mesh.centroids + 0.5 * np.sqrt(mesh.areas)[:, None] * mesh.normals
    got = tde.element_stress(obs, tri, b, level=LEVELS[1], medium=medium, device="cpu")
    want = jtde.element_stress(obs, tri, b, level=LEVELS[1], medium=medium)
    _columns_close(got.numpy().reshape(len(obs), 9), np.asarray(want).reshape(-1, 9))
    got = tde.element_displacement(disk["volume"], tri, b, level=LEVELS[1], medium=medium,
                                   device="cpu")
    want = jtde.element_displacement(disk["volume"], tri, b, level=LEVELS[1], medium=medium)
    _columns_close(got.numpy(), want)
    if medium == "halfspace":
        got = tde.element_surface_displacement_halfspace(disk["surface"], tri, b, level=3,
                                                         device="cpu")
        want = jtde.element_surface_displacement_halfspace(disk["surface"], tri, b, level=3)
        _columns_close(got.numpy(), want)
    cents, dA = tde._subdivide(tri, 3)
    jcents, jdA = jtde._subdivide(tri, 3)
    np.testing.assert_array_equal(cents, jcents)
    assert dA == jdA


@pytest.fixture(scope="module")
def matrices(disk):
    """The JAX package's full-space interaction and surface displacement
    matrices of the disk under a normal-traction BC."""
    bcs = [jbase.BoundaryCondition("normal", [0], [0], traction=10.0)]
    G = jtde.interaction_matrix([disk["jmesh"]], bcs, nu=NU, mu=MU, level=LEVELS[0],
                                near_level=LEVELS[1], medium="fullspace")
    D = jtde.displacement_matrix([disk["jmesh"]], disk["surface"], nu=NU, mu=MU,
                                 boundary_conditions=bcs)
    return dict(G=G, D=D, bcs=[BoundaryCondition(**dataclasses.asdict(bc)) for bc in bcs])


def test_interaction_and_displacement_matrices_match_jax(disk, matrices):
    G = tde.interaction_matrix([disk["mesh"]], matrices["bcs"], nu=NU, mu=MU,
                               level=LEVELS[0], near_level=LEVELS[1], medium="fullspace",
                               device="cpu")
    _columns_close(G.numpy(), matrices["G"])
    D = tde.displacement_matrix([disk["mesh"]], disk["surface"], nu=NU, mu=MU,
                                boundary_conditions=matrices["bcs"], device="cpu")
    _columns_close(D.numpy(), matrices["D"])
    # a batch of two mesh sets of one layout: each its own matrices
    shifted = sources.DiskBEMSource(a_half_axis=1e3, depth=3.5e3).discretize(1000.0)
    Gb = tde.interaction_matrices([[disk["mesh"]], [shifted]], matrices["bcs"], nu=NU, mu=MU,
                                  level=LEVELS[0], near_level=LEVELS[1], medium="fullspace",
                                  device="cpu")
    np.testing.assert_array_equal(Gb[0].numpy(), G.numpy())
    G2 = tde.interaction_matrix([shifted], matrices["bcs"], nu=NU, mu=MU, level=LEVELS[0],
                                near_level=LEVELS[1], medium="fullspace", device="cpu")
    np.testing.assert_array_equal(Gb[1].numpy(), G2.numpy())


def test_halfspace_matrices_match_jax(disk):
    """A BC whose source is one triangle and whose receivers are the
    disk's 24 elements (the half-space assembly, with near pairs), and the
    volume displacement matrix of that triangle."""
    tri_src = dict(p1=(0.0, 0.0, 0.0), p2=(600.0, 100.0, 80.0), p3=(100.0, 500.0, -50.0),
                   depth=3.4e3)
    jbc = [jbase.BoundaryCondition("strike", [1], [0])]
    bc = [BoundaryCondition("strike", [1], [0])]
    meshes = [disk["mesh"], sources.TriangleBEMSource(**tri_src).discretize()]
    jmeshes = [disk["jmesh"], jsources.TriangleBEMSource(**tri_src).discretize()]
    G = tde.interaction_matrix(meshes, bc, level=LEVELS[0], near_level=LEVELS[1],
                               medium="halfspace", device="cpu")
    want = jtde.interaction_matrix(jmeshes, jbc, level=LEVELS[0], near_level=LEVELS[1],
                                   medium="halfspace")
    assert want.shape == (24, 1)
    _columns_close(G.numpy(), want)
    # the volume branch of the displacement matrix: the element's own
    # displacements (held against the JAX package above), z flipped to up
    D = tde.displacement_matrix(meshes, disk["volume"], level=2, boundary_conditions=bc,
                                medium="halfspace", device="cpu")
    u = tde.element_displacement(disk["volume"], meshes[1].triangles[0],
                                 meshes[1].unit_strike_vectors[0], level=2, medium="halfspace",
                                 device="cpu")
    np.testing.assert_array_equal(D[:, 0].reshape(-1, 3).numpy(),
                                  (u * torch.tensor([1.0, 1.0, -1.0], dtype=u.dtype)).numpy())


@pytest.mark.parametrize("shape", ["square", "tall", "rank_deficient"])
def test_svd_solve_matches_numpy_lstsq(shape):
    rng = np.random.default_rng(7)
    G = rng.normal(size={"square": (30, 30), "tall": (50, 20),
                         "rank_deficient": (40, 25)}[shape])
    if shape == "rank_deficient":
        G[:, 20:] = G[:, :5] @ rng.normal(size=(5, 5))       # rank 20
    b = rng.normal(size=(G.shape[0], 3))
    want = np.linalg.lstsq(G, b, rcond=None)[0]
    got = base.lstsq_robust(torch.as_tensor(G), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    vec = base.lstsq_robust(torch.as_tensor(G), torch.as_tensor(b[:, 0])).numpy()
    np.testing.assert_allclose(vec, want[:, 0], rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_engine_process_matches_jax(disk, matrices):
    """``process`` on the full space: the slips of numpy's ``lstsq`` on
    the JAX interaction matrix (the JAX engine's own solve) and the JAX
    displacement matrix's displacements; a traction override; the invalid
    response and the derived magnitude."""
    jengine = jbase.BEMEngine(matrices["bcs"], mesh_size=1000.0, medium="fullspace",
                              quadrature_level=LEVELS[0], near_quadrature_level=LEVELS[1])
    engine = convert.bem_engine_from_jax(jengine, device="cpu")
    src = [sources.DiskBEMSource(a_half_axis=1e3, depth=3e3)]
    for tractions, t in ((None, 10.0), ([25.0], 25.0)):
        resp = engine.process(src, disk["surface"], tractions=tractions)
        rhs = np.full(disk["mesh"].ntriangles, t * 1e6)
        slips = jbase.lstsq_robust(matrices["G"], -rhs)
        _columns_close(resp.slips.numpy()[:, None], slips[:, None])
        _columns_close(resp.displacements.numpy(), (matrices["D"] @ slips).reshape(-1, 3))
        jresp = jbase.BEMResponse(sources=[], meshes=[disk["jmesh"]], displacements=None,
                                  slips=slips, col_areas=disk["jmesh"].areas)
        # the JAX package's moment_to_magnitude is jnp.log10 in float32
        assert abs(resp.derived_magnitude() - jresp.derived_magnitude()) < 1e-6
    bad = engine.process([sources.DiskBEMSource(a_half_axis=1e3, depth=-500.0)],
                         disk["surface"])
    assert not bad.is_valid and bad.slips is None and bad.derived_magnitude() is None
