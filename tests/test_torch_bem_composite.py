"""
The port's BEM composites against the JAX package on the CPU: the linear
composite's unit-traction LOS responses, its batched ``loglike`` and
``hyper_loglike`` (two boundary conditions, a ramp correction in the
residual) against ``jax.vmap`` of the JAX composite; the geometry
composite's batched forward and likelihoods against the JAX composite's
per-point forward on a batch whose chains have different triangle
counts, with a chain breaching the surface (−99 fill); a small SMC of
the linear flagship that recovers the traction.

The JAX assembly runs one element column at a time, op by op, so the
JAX references use a 1 km × 1-2 km rectangle meshed at 1 km (2 or 4
triangles) on the full space; the half-space kernels and the disk's
matrices are held against the JAX package in ``test_torch_bem.py``.

Bars: unit responses and synthetics, float32 casts of float64 solves,
rtol 1e-6 of their largest value; llks the JAX package's per-chain
float32 bar, rtol 2e-5 (``tests/test_float32_llk.py:101``); the
traction recovery the JAX test's 10 % (``tests/test_bem_inversion.py:100``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.bem import base as jbase
from beat_tpu.bem import sources as jsources
from beat_tpu.models.bem import GeodeticBEMComposite as JaxBEM
from beat_tpu.models.bem import GeodeticBEMLinearComposite as JaxLinear
from beat_tpu_torch import convert, flagship
from beat_tpu_torch.bem import RectangularBEMSource
from beat_tpu_torch.heart.corrections import RampCorrection
from beat_tpu_torch.models.bem import GeodeticBEMComposite, GeodeticBEMLinearComposite
from beat_tpu_torch.samplers import SMCParams
from test_torch_geodetic import jax_correction, jax_dataset

F32_RTOL = 1e-6
LLK_RTOL = 2e-5
RECOVERY = 0.1
RECT = dict(strike=30.0, dip=60.0, length=1e3, width=1e3, depth=2e3)


@pytest.fixture(scope="module")
def scene():
    """One SAR scene of 64 points over ±6 km with a correlated noise
    covariance and a uplift-like signal, in both packages."""
    rng = np.random.default_rng(0)
    e = np.linspace(-6e3, 6e3, 8)
    coords = np.stack(np.meshgrid(e, e), -1).reshape(-1, 2)
    los = np.tile([0.1, -0.05, 0.99], (len(coords), 1))
    los /= np.linalg.norm(los, axis=1, keepdims=True)
    d = np.hypot(*(coords[:, None] - coords[None]).transpose(2, 0, 1))
    cov = 1e-4 * np.exp(-d / 4e3) + 1e-6 * np.eye(len(coords))
    disp = 0.05 * np.exp(-np.hypot(*coords.T) / 3e3) + rng.normal(0, 0.01, len(coords))
    ds = convert.geodetic_dataset_from_numpy("volcano", "SAR", coords, disp, los,
                                             covariance=cov)
    return ds, jax_dataset(ds)


def _engines(bcs, **settings):
    jengine = jbase.BEMEngine([jbase.BoundaryCondition(**bc) for bc in bcs], mesh_size=1000.0,
                              medium="fullspace", quadrature_level=1, near_quadrature_level=3,
                              **settings)
    return convert.bem_engine_from_jax(jengine, device="cpu"), jengine


def _chains(names, bounds, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(*bounds[k], n).astype(np.float32) for k in names}


@pytest.fixture(scope="module")
def linear(scene):
    ds, jds = scene
    engine, jengine = _engines([dict(slip_component="normal", traction=10.0),
                                dict(slip_component="dip", traction=1.0)],
                               check_mesh_intersection=True)
    corr = RampCorrection("volcano")
    port = GeodeticBEMLinearComposite([ds], [RectangularBEMSource(**RECT)], engine,
                                      corrections=[corr], device="cpu")
    jx = JaxLinear([jds], [jsources.RectangularBEMSource(**RECT)], jengine,
                   corrections=[jax_correction(corr)])
    return port, jx


def test_linear_unit_los_and_llk_match_jax(linear, scene):
    port, jx = linear
    want = np.asarray(jx._unit_los)
    np.testing.assert_allclose(port.unit_los.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    assert [p.name for p in port.traction_parameters()] == \
        [p.name for p in jx.traction_parameters()] == ["dip_traction", "normal_traction"]
    bounds = dict(normal_traction=(1.0, 60.0), dip_traction=(-5.0, 5.0), h_SAR=(-1.0, 1.0),
                  volcano_azimuth_ramp=(-1e-6, 1e-6), volcano_range_ramp=(-1e-6, 1e-6),
                  volcano_offset=(-0.02, 0.02))
    assert set(port.get_hypernames() + port.get_hierarchical_names()) < set(bounds)
    pts = _chains(bounds, bounds, 8, seed=1)
    point = {k: torch.as_tensor(v) for k, v in pts.items()}
    jpts = {k: jnp.asarray(v) for k, v in pts.items()}
    with torch.no_grad():
        got = port.loglike(point).numpy()
    jdata = jx.device_data()
    want = np.asarray(jax.jit(jax.vmap(lambda p: jx.loglike(p, jdata)))(jpts))
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    fixed = {k: float(v[0]) for k, v in pts.items()}
    with torch.no_grad():
        got = port.hyper_loglike({"h_SAR": point["h_SAR"]}, fixed).numpy()
    want = np.asarray(jax.vmap(lambda h: jx.hyper_loglike(
        {"h_SAR": h}, {k: jnp.asarray(v) for k, v in fixed.items()}, jdata))(jpts["h_SAR"]))
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    # the responses carried across from the JAX package give the same llk
    carried = GeodeticBEMLinearComposite(port.datasets, port.sources, port.engine,
                                         unit_los=np.asarray(jx._unit_los),
                                         corrections=port.corrections, device="cpu")
    with torch.no_grad():
        np.testing.assert_allclose(carried.loglike(point).numpy(), port.loglike(point).numpy(),
                                   rtol=LLK_RTOL)


def test_geometry_batch_of_mixed_layouts_matches_jax(scene):
    """Chains of 2 and 4 triangles (two groups, one of three chains) and
    one breaching the surface: the batched forward against the JAX
    composite's per-point one, then the llks."""
    ds, jds = scene
    engine, jengine = _engines([dict(slip_component="normal", traction=10.0)],
                               check_mesh_intersection=True)
    port = GeodeticBEMComposite([ds], [RectangularBEMSource(**RECT)], engine, device="cpu")
    jx = JaxBEM([jds], [jsources.RectangularBEMSource(**RECT)], jengine)
    pts = {"length": np.array([1e3, 2e3, 1e3, 1e3], np.float32),
           "depth": np.array([2e3, 2.5e3, 2.75e3, -500.0], np.float32),
           "normal_traction": np.array([10.0, 20.0, 15.0, 5.0], np.float32),
           "h_SAR": np.array([0.1, -0.2, 0.0, 0.3], np.float32)}
    layouts = [engine.discretize(port._apply_point_np({k: v[c] for k, v in pts.items()}))[0]
               .ntriangles for c in range(4)]
    assert layouts == [2, 4, 2, 2]
    point = {k: torch.as_tensor(v) for k, v in pts.items()}
    with torch.no_grad():
        synth = port.synthetics_los(point).numpy()
        llk = port.loglike(point).numpy()
    assert (synth[3] == -99.0).all()
    for c in range(4):
        jpoint = {k: v[c] for k, v in pts.items()}
        want = jx.synthetics_los_np(jpoint)
        np.testing.assert_allclose(synth[c], want, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want).max())
        np.testing.assert_allclose(port.synthetics_los_np(jpoint), want, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want).max())
    jllk = np.asarray(jax.vmap(jx.loglike)({k: jnp.asarray(v) for k, v in pts.items()}))
    np.testing.assert_allclose(llk, jllk, rtol=LLK_RTOL)
    assert llk[3] < llk[:3].min()
    # the hyper-only likelihood: the chains' h with the residuals of chain 0
    fixed = {k: float(v[0]) for k, v in pts.items() if k != "h_SAR"}
    with torch.no_grad():
        got = port.hyper_loglike({"h_SAR": point["h_SAR"]}, fixed).numpy()
    jfixed = {k: jnp.asarray(v) for k, v in fixed.items()}
    want = np.asarray(jax.vmap(lambda h: jx.hyper_loglike({"h_SAR": h}, jfixed))(
        jnp.asarray(pts["h_SAR"])))
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_geometry_batch_of_disks_equals_per_chain_process(scene):
    """Disks with ``a_half_axis`` varied (24 and 27 triangles, two layout
    groups) through the batched forward against the engine's own
    ``process`` of each chain, float64 cast to float32.  As in the JAX
    package, a sampled ``a_half_axis`` is set on a copy of the template,
    so a disk's ``b_half_axis`` keeps the template's value (ROADMAP,
    queue 3)."""
    from beat_tpu_torch.bem import DiskBEMSource

    ds, _ = scene
    engine, _ = _engines([dict(slip_component="normal", traction=10.0)],
                         check_mesh_intersection=True)
    port = GeodeticBEMComposite([ds], [DiskBEMSource(a_half_axis=1e3, depth=3e3)], engine,
                                device="cpu")
    pts = {"a_half_axis": np.array([1e3, 1.5e3, 1e3], np.float32),
           "depth": np.array([3e3, 3.25e3, 3.5e3], np.float32)}
    with torch.no_grad():
        synth = port.synthetics_los({k: torch.as_tensor(v) for k, v in pts.items()}).numpy()
    for c in range(3):
        src = port._apply_point_np({k: v[c] for k, v in pts.items()})
        resp = engine.process(src, ds.coords)
        want = np.einsum("ni,ni->n", resp.displacements.numpy(), ds.los_vector)
        assert resp.meshes[0].ntriangles == (24, 27, 24)[c]
        np.testing.assert_allclose(synth[c], want, rtol=F32_RTOL,
                                   atol=F32_RTOL * np.abs(want).max())


def test_linear_flagship_smc_recovers_the_traction(tmp_path):
    problem = flagship.build_bem_flagship(**flagship.BEM_TEST_SIZE, seed=1, device="cpu",
                                          outfolder=str(tmp_path))
    comp = problem.composites["geodetic"]
    assert comp.unit_los.dtype == torch.float32 and comp.unit_los.shape == (600, 1)
    q_tr, _ = problem.sample(SMCParams(n_chains=64, n_steps=30, seed=4))
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))["normal_traction"]
    true = flagship.BEM_TRUE_TRACTION
    assert abs(est - true) / true < RECOVERY, est


def test_geometry_flagship_prefers_the_true_depth(tmp_path):
    problem = flagship.build_bem_flagship(**dict(flagship.BEM_TEST_SIZE, n_points=60), seed=1,
                                          device="cpu", geometry=True, outfolder=str(tmp_path))
    logp, data = problem.make_logp_fn()
    true = problem.point_to_array(problem.true_point)
    moved = problem.point_to_array(dict(problem.true_point, depth=4.5e3))
    with torch.no_grad():
        llk = logp(torch.as_tensor(np.stack([true, moved]), dtype=torch.float32), data)
    assert torch.isfinite(llk).all() and llk[0] > llk[1]
