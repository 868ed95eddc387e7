"""
The port's source parameterizations against the JAX package on the CPU:
the moment tensor of every point-source type (batched over chains)
and its Jacobian, the lune helpers of the MTQT source, the DoubleDC and
Ringfault sub-sources and the rectangle's patch grid, on the same numpy
draws through ``beat_tpu`` (``vmap``) and the port.

The draws keep away from the parameterizations' singular points, as the
JAX package's tests do: dips off 0° and 90° (strike and rake degenerate
there), v off ±1/3 (``v_to_gamma``'s derivative is infinite) and w off
±3π/8 (the ends of the β table), h off 0 and 1 (``arccos``).

Bars: float32 transcendental functions in two libraries, rtol 1e-5 and
atol 1e-6 · max|value| (the JAX package's synthesis bar,
``tests/test_seismic.py:389``); Jacobian-vector products rtol 1e-4 and
atol 1e-5 · max (sums of those terms).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import beat_tpu.models.seismic as jseismic
import beat_tpu.sources as jsources
from beat_tpu_torch import sources
from beat_tpu_torch.models import seismic
import test_torch_common  # noqa: F401  (the tests' thread policy)

RTOL, ATOL_REL = 1e-5, 1e-6
JVP_RTOL, JVP_ATOL_REL = 1e-4, 1e-5
N = 32

#: per source type: the template's own fields and the sampled parameters' ranges
RANGES = {
    "MTSource": dict(mnn=(-1.4, 1.4), mee=(-1.4, 1.4), mdd=(-1.4, 1.4), mne=(-1, 1),
                     mnd=(-1, 1), med=(-1, 1), magnitude=(4.0, 7.0)),
    "MTQTSource": dict(w=(-1.1, 1.1), v=(-0.3, 0.3), kappa=(0.1, 6.2), sigma=(-1.5, 1.5),
                       h=(0.05, 0.95), magnitude=(4.0, 7.0)),
    "DCSource": dict(strike=(0.0, 360.0), dip=(5.0, 85.0), rake=(-180.0, 180.0),
                     magnitude=(4.0, 7.0)),
    "ExplosionSource": dict(volume_change=(1e6, 1e9)),
    "CLVDSource": dict(azimuth=(0.0, 360.0), dip=(5.0, 85.0), magnitude=(4.0, 7.0)),
    "DoubleDCSource": dict(strike1=(0.0, 360.0), dip1=(5.0, 85.0), rake1=(-180.0, 180.0),
                           strike2=(0.0, 360.0), dip2=(5.0, 85.0), rake2=(-180.0, 180.0),
                           mix=(0.05, 0.95), magnitude=(4.0, 7.0), distance=(0.0, 5e3),
                           azimuth=(0.0, 360.0), delta_depth=(0.0, 3e3),
                           delta_time=(0.0, 3.0)),
    "RingfaultSource": dict(strike=(0.0, 360.0), dip=(0.0, 40.0), diameter=(500.0, 5e3),
                            sign=(-1.0, 1.0), magnitude=(4.0, 7.0)),
}


def _draws(source: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(lo, hi, N).astype(np.float32)
            for k, (lo, hi) in RANGES[source].items()}


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


def _port_get(template, draws):
    point = {k: torch.as_tensor(v) for k, v in draws.items()}
    return seismic.point_getter(template, point, 0, 1, N, "cpu"), point


def _jax_m6(jtemplate, draws):
    return np.asarray(jax.vmap(lambda p: jseismic.source_m6(jtemplate, p, 0, 1))(
        {k: jnp.asarray(v) for k, v in draws.items()}))


def _templates(source, **fields):
    return getattr(sources, source)(**fields), getattr(jsources, source)(**fields)


@pytest.mark.parametrize("source,fields", [
    ("MTSource", {}), ("MTQTSource", {}), ("DCSource", {}), ("ExplosionSource", {}),
    ("ExplosionSource", dict(magnitude=5.5)), ("CLVDSource", {}), ("DoubleDCSource", {})])
def test_source_m6_matches_jax(source, fields):
    template, jtemplate = _templates(source, **fields)
    draws = _draws(source)
    get, _ = _port_get(template, draws)
    got = seismic.source_m6(template, get)
    assert got.shape == (N, 6)
    _close(got, _jax_m6(jtemplate, draws))


@pytest.mark.parametrize("source", ["MTSource", "MTQTSource", "DCSource", "CLVDSource",
                                    "DoubleDCSource"])
def test_source_m6_jacobian_matches_jax(source):
    """The m6's vector-Jacobian product with a random cotangent, per
    chain and parameter: autograd against ``jax.vjp`` of the vmapped
    function."""
    template, jtemplate = _templates(source)
    draws = _draws(source, seed=1)
    cot = np.random.default_rng(2).normal(size=(N, 6)).astype(np.float32)
    names = sorted(draws)
    _, vjp = jax.vjp(lambda *xs: jax.vmap(lambda p: jseismic.source_m6(jtemplate, p, 0, 1))(
        dict(zip(names, xs))), *(jnp.asarray(draws[k]) for k in names))
    want = vjp(jnp.asarray(cot))
    point = {k: torch.as_tensor(draws[k]).requires_grad_() for k in names}
    m6 = seismic.source_m6(template, seismic.point_getter(template, point, 0, 1, N, "cpu"))
    got = torch.autograd.grad(m6, [point[k] for k in names], torch.as_tensor(cot),
                              allow_unused=True)
    for k, g, w in zip(names, got, want):
        # parameters the moment tensor does not read (a DoubleDC's offsets)
        if g is None:
            np.testing.assert_array_equal(np.asarray(w), 0.0)
        else:
            _close(g, w, JVP_RTOL, JVP_ATOL_REL)


def test_source_m6_refuses_finite_and_ring_sources():
    for template in (sources.RectangularSource(), sources.RingfaultSource()):
        with pytest.raises(NotImplementedError, match=type(template).__name__):
            seismic.source_m6(template, lambda name: torch.zeros(1))


def test_lune_helpers_match_jax():
    rng = np.random.default_rng(3)
    v = rng.uniform(-0.33, 0.33, 200).astype(np.float32)
    # across the β table and beyond its ends (constant there, as jnp.interp)
    w = np.concatenate([rng.uniform(-1.2, 1.2, 200), [-2.0, 2.0, -3 * np.pi / 8]]).astype(
        np.float32)
    _close(sources.v_to_gamma(torch.as_tensor(v)), jsources.v_to_gamma(jnp.asarray(v)))
    _close(sources.w_to_beta(torch.as_tensor(w)), jsources.w_to_beta(jnp.asarray(w)))
    g = jax.vmap(jax.grad(jsources.w_to_beta))(jnp.asarray(w[:200]))
    wt = torch.as_tensor(w[:200]).requires_grad_()
    (got,) = torch.autograd.grad(sources.w_to_beta(wt).sum(), wt)
    _close(got, g, JVP_RTOL, JVP_ATOL_REL)
    angles = rng.uniform(-np.pi, np.pi, 8).astype(np.float32)
    for port_fn, jax_fn in ((sources.rot_x, jsources.rot_x), (sources.rot_y, jsources.rot_y),
                            (sources.rot_z, jsources.rot_z)):
        _close(port_fn(torch.as_tensor(angles)), jax.vmap(jax_fn)(jnp.asarray(angles)))
    m6 = rng.normal(size=(8, 6)).astype(np.float32)
    mat = sources.m6_to_matrix(torch.as_tensor(m6))
    _close(mat, jsources.m6_to_matrix(jnp.asarray(m6)))
    np.testing.assert_array_equal(sources.matrix_to_m6(mat).numpy(), m6)
    args = [rng.uniform(lo, hi, N).astype(np.float32)
            for lo, hi in RANGES["MTQTSource"].values()]
    _close(sources.mtqt_to_m6(*map(torch.as_tensor, args)),
           jax.vmap(jsources.mtqt_to_m6)(*map(jnp.asarray, args)))


def test_double_dc_sub_sources_match_jax():
    template, jtemplate = _templates("DoubleDCSource")
    draws = _draws("DoubleDCSource", seed=4)
    get, _ = _port_get(template, draws)
    m6, de, dn, dz, dt = seismic.double_dc_sub_sources(get)
    assert m6.shape == (N, 2, 6) and de.shape == dn.shape == dz.shape == dt.shape == (N, 2)

    def jax_subs(p):
        subs = jseismic.double_dc_sub_sources(jseismic.point_getter(jtemplate, p, 0, 1))
        return [jnp.stack([jnp.broadcast_to(s[i], jnp.shape(subs[0][i])) for s in subs])
                for i in range(5)]

    want = jax.vmap(jax_subs)({k: jnp.asarray(v) for k, v in draws.items()})
    for got, w in zip((m6, de, dn, dz, dt), want):
        _close(got, w, atol_rel=1e-5)


@pytest.mark.parametrize("npointsources", [8, 5])
def test_ringfault_sub_sources_match_jax(npointsources):
    template, jtemplate = _templates("RingfaultSource", npointsources=npointsources)
    draws = _draws("RingfaultSource", seed=5)
    get, _ = _port_get(template, draws)
    got = template.sub_sources(get)
    want = jax.vmap(lambda p: jtemplate.sub_sources(jseismic.point_getter(jtemplate, p, 0, 1)))(
        {k: jnp.asarray(v) for k, v in draws.items()})
    assert got[0].shape == (N, npointsources, 6)
    for g, w in zip(got, want):
        # offsets that vanish (a level ring's dz) are compared absolutely
        _close(g, w, atol_rel=1e-5)


@pytest.mark.parametrize("anchor", ["top", "center", "bottom"])
@pytest.mark.parametrize("grid", [(8, 5), (3, 1)])
def test_rectangular_patch_grid_matches_jax(anchor, grid):
    rng = np.random.default_rng(6)
    args = [rng.uniform(lo, hi, N).astype(np.float32) for lo, hi in (
        (0, 360), (10, 90), (3e3, 10e3), (2e3, 6e3), (-3e3, 3e3), (-3e3, 3e3), (4e3, 1e4))]
    got = sources.rectangular_patch_grid(*map(torch.as_tensor, args), *grid, anchor=anchor)
    want = jax.vmap(lambda *a: jsources.rectangular_patch_grid(*a, *grid, anchor=anchor))(
        *map(jnp.asarray, args))
    for g, w in zip(got, want):
        assert g.shape == (N, grid[0] * grid[1])
        _close(g, w)
    with pytest.raises(ValueError, match="anchor"):
        sources.rectangular_patch_grid(*args, *grid, anchor="side")


def test_catalog_matches_jax():
    assert set(sources.source_catalog) == set(jsources.source_catalog)
    for name, cls in sources.source_catalog.items():
        jcls = jsources.source_catalog[name]
        assert cls.parameter_names == jcls.parameter_names, name
        assert cls().to_dict().keys() <= jcls().to_dict().keys(), name
