"""
The port's halfspace forwards (``beat_tpu_torch.heart.okada``) against
the JAX package's (``beat_tpu.heart.okada``): the rectangle, Mogi and the
moment-tensor expansion batched over sources against ``jax.vmap`` of the
JAX functions, their gradients against ``jax.grad``, finite gradients at
the rectangle's singular places, and the float32 path against float64.
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_tpu.heart import okada as jokada
from beat_tpu_torch.heart import okada
from test_torch_common import THREADS  # noqa: F401  (thread policy)

RECT_NAMES = ("east_shift", "north_shift", "depth", "strike", "dip", "rake", "length",
              "width", "slip", "opening")
#: per point: |port - JAX| <= BAR · max|u| of that source, float32 on both sides
BAR = 1e-4


@contextmanager
def jax_x64():
    """JAX in float64 for one block (the setting is global: restore it)."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _coords(n=160, seed=0, half=25e3):
    return np.random.default_rng(seed).uniform(-half, half, (n, 2))


def _rect_params(seed=1):
    """Six rectangles: every anchor-relevant geometry, dip 90° among them,
    shear and tensile slip."""
    rng = np.random.default_rng(seed)
    p = {"east_shift": rng.uniform(-3e3, 3e3, 6), "north_shift": rng.uniform(-3e3, 3e3, 6),
         "depth": rng.uniform(500.0, 6e3, 6), "strike": rng.uniform(0.0, 360.0, 6),
         "dip": np.array([30.0, 52.0, 70.0, 90.0, 45.0, 85.0]),
         "rake": rng.uniform(-180.0, 180.0, 6), "length": rng.uniform(2e3, 15e3, 6),
         "width": rng.uniform(2e3, 10e3, 6), "slip": rng.uniform(0.1, 2.0, 6),
         "opening": np.array([0.0, 0.2, 0.0, 0.5, 0.0, 0.1])}
    return p


def _assert_per_point(got, want, bar=BAR):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    err = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1)
    assert (err <= bar * scale).all(), err / scale


@pytest.mark.parametrize("anchor", ["top", "center", "bottom"])
def test_rectangle_matches_jax_vmap(anchor):
    """Both packages in float64: the same algebra to rounding."""
    coords, p = _coords(), _rect_params()
    with jax_x64():
        want = np.asarray(jax.vmap(lambda q: jokada.okada_surface_displacement(
            jnp.asarray(coords), **q, anchor=anchor))({k: jnp.asarray(v) for k, v in p.items()}))
    got = okada.okada_surface_displacement(
        torch.as_tensor(coords), anchor=anchor, **{k: torch.as_tensor(v) for k, v in p.items()})
    assert got.shape == (6, len(coords), 3) and got.dtype == torch.float64
    _assert_per_point(got.numpy(), want, bar=1e-10)


def test_rectangle_float32_matches_jax_float32():
    """Both packages in float32, at the per-point bar, on the rectangles
    whose float32 sums are well conditioned.  Near vertical (dip 85°, the
    sixth source) the I-terms' 1/cos δ amplifies the cancellation and
    both packages' float32 results are off float64 by about 3e-4 · max|u|,
    each in its own way."""
    coords, p = _coords(), _rect_params()
    p = {k: v[:5] for k, v in p.items()}
    want = jax.vmap(lambda q: jokada.okada_surface_displacement(
        jnp.asarray(coords, dtype=jnp.float32), **q))(
        {k: jnp.asarray(v, dtype=jnp.float32) for k, v in p.items()})
    got = okada.okada_surface_displacement(
        torch.as_tensor(coords, dtype=torch.float32),
        **{k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()})
    assert got.dtype == torch.float32
    _assert_per_point(got.numpy(), want)


def test_mogi_matches_jax_vmap():
    coords = _coords()
    rng = np.random.default_rng(2)
    p = {"east_shift": rng.uniform(-3e3, 3e3, 5), "north_shift": rng.uniform(-3e3, 3e3, 5),
         "depth": rng.uniform(1e3, 8e3, 5), "volume_change": rng.uniform(-1e7, 1e7, 5)}
    want = jax.vmap(lambda q: jokada.mogi_surface_displacement(
        jnp.asarray(coords, dtype=jnp.float32), **q))(
        {k: jnp.asarray(v, dtype=jnp.float32) for k, v in p.items()})
    got = okada.mogi_surface_displacement(
        torch.as_tensor(coords, dtype=torch.float32),
        **{k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()})
    _assert_per_point(got.numpy(), want)


def _mt_inputs(seed=3):
    rng = np.random.default_rng(seed)
    m6 = rng.normal(size=(4, 6)) * 1e17
    pos = {"east_shift": rng.uniform(-2e3, 2e3, 4), "north_shift": rng.uniform(-2e3, 2e3, 4),
           "depth": np.array([2e3, 4e3, 6e3, 9e3])}
    return _coords(), m6, pos


def test_mt_matches_jax_vmap_in_float64():
    """Both packages in float64 (``okada.FORWARD_DTYPE``, as the port's
    callers evaluate it), at the per-point bar.  (In float32 either
    package misses it, by up to 5e-3 · max|u| at 2 km depth: the Chinnery
    double difference over a crack of 0.08 · depth cancels in float32.)"""
    coords, m6, pos = _mt_inputs()
    with jax_x64():
        want = np.asarray(jax.vmap(lambda m, e, n, d: jokada.mt_surface_displacement(
            jnp.asarray(coords), m, e, n, d))(jnp.asarray(m6), *map(jnp.asarray, pos.values())))
    dt = okada.FORWARD_DTYPE
    got = okada.mt_surface_displacement(
        torch.as_tensor(coords, dtype=dt), torch.as_tensor(m6, dtype=dt),
        **{k: torch.as_tensor(v, dtype=dt) for k, v in pos.items()})
    assert got.shape == (4, len(coords), 3) and got.dtype == torch.float64
    _assert_per_point(got.numpy(), want)


def _singular_sources():
    """Sources and observation points at the rectangle's singular places:
    a surface-breaking fault observed on its top edge's extension and at
    its corners (R + η = 0, R = 0), a vertical fault (cos δ = 0), and a
    buried fault observed on the surface line of its plane (q = 0) and
    on its strike ends (ξ = 0)."""
    out = []
    # surface-breaking, strike 0 (north), anchor 'top' at the origin, L = 4 km
    trace = np.array([[0.0, y] for y in (-4e3, -2e3, 0.0, 2e3, 3e3, 6e3)])
    out.append((dict(depth=0.0, strike=0.0, dip=60.0, rake=45.0, length=4e3, width=3e3,
                     slip=1.0, opening=0.2), trace))
    grid = np.array([[x, y] for x in (-3e3, 0.0, 1.5e3) for y in (-5e3, -2e3, 0.0, 2e3, 5e3)])
    out.append((dict(depth=1e3, strike=30.0, dip=90.0, rake=-60.0, length=4e3, width=3e3,
                     slip=1.0, opening=0.1), grid))
    # buried, strike 90 (east): q = 0 on y_okada = d·cos δ / sin δ, i.e. the
    # line where the plane extended up meets the surface
    dip, depth, width = 50.0, 2e3, 3e3
    d = depth + width * np.sin(np.deg2rad(dip))
    y_q0 = d * np.cos(np.deg2rad(dip)) / np.sin(np.deg2rad(dip)) - width * np.cos(np.deg2rad(dip))
    line = np.array([[x, y_q0] for x in (-3e3, -2e3, 0.0, 2e3, 4e3)])
    out.append((dict(depth=depth, strike=90.0, dip=dip, rake=90.0, length=4e3, width=width,
                     slip=1.0, opening=0.0), line))
    return out


@pytest.mark.parametrize("case", range(3), ids=["top_edge", "vertical", "q_zero"])
def test_gradients_finite_at_singular_places(case):
    params, coords = _singular_sources()[case]
    leaves = {k: torch.tensor(float(v), dtype=torch.float32, requires_grad=True)
              for k, v in params.items()}
    u = okada.okada_surface_displacement(torch.as_tensor(coords, dtype=torch.float32),
                                         **leaves)
    assert torch.isfinite(u).all()
    grads = torch.autograd.grad(u.sum() + (u * u).sum(), list(leaves.values()))
    assert all(torch.isfinite(g) for g in grads), dict(zip(leaves, grads))


def test_mt_gradient_finite_at_the_epicentre():
    coords = np.array([[0.0, 0.0], [0.0, 400.0], [3e3, 0.0]])
    m6 = torch.tensor([1.0, -0.5, -0.5, 0.3, 0.2, -0.1], dtype=torch.float32,
                      requires_grad=True)
    pos = {k: torch.tensor(v, requires_grad=True) for k, v in
           (("east_shift", 0.0), ("north_shift", 0.0), ("depth", 3e3))}
    u = okada.mt_surface_displacement(torch.as_tensor(coords, dtype=torch.float32), m6 * 1e17,
                                      **pos)
    grads = torch.autograd.grad(u.sum(), [m6, *pos.values()])
    assert all(torch.isfinite(g).all() for g in grads)


def _generic_rectangle():
    return dict(east_shift=800.0, north_shift=-300.0, depth=1.5e3, strike=146.0, dip=52.0,
                rake=-110.0, length=12e3, width=10e3, slip=0.6, opening=0.05)


def test_gradients_match_jax_grad():
    """∂(w · u)/∂θ of every parameter θ, both packages in float64."""
    coords = _coords(60, seed=4)
    w = np.random.default_rng(5).normal(size=(60, 3))
    p = _generic_rectangle()
    with jax_x64():
        def jf(*vals):
            u = jokada.okada_surface_displacement(jnp.asarray(coords), **dict(zip(RECT_NAMES,
                                                                                vals)))
            return jnp.sum(u * jnp.asarray(w))

        want = jax.grad(jf, argnums=tuple(range(10)))(*(jnp.float64(p[k]) for k in RECT_NAMES))
    leaves = [torch.tensor(p[k], dtype=torch.float64, requires_grad=True) for k in RECT_NAMES]
    u = okada.okada_surface_displacement(torch.as_tensor(coords), **dict(zip(RECT_NAMES, leaves)))
    got = torch.autograd.grad(torch.sum(u * torch.as_tensor(w)), leaves)
    for name, g, h in zip(RECT_NAMES, got, want):
        np.testing.assert_allclose(float(g), float(h), rtol=1e-7, atol=1e-12, err_msg=name)


def test_mogi_and_mt_gradients_match_jax_grad():
    coords, m6, pos = _mt_inputs()
    w = np.random.default_rng(6).normal(size=(len(coords), 3))
    with jax_x64():
        def jmt(m, e, n, d):
            return jnp.sum(jokada.mt_surface_displacement(jnp.asarray(coords), m, e, n, d)
                           * jnp.asarray(w))

        def jmogi(e, n, d, v):
            return jnp.sum(jokada.mogi_surface_displacement(jnp.asarray(coords), e, n, d, v)
                           * jnp.asarray(w))

        want_mt = jax.grad(jmt, argnums=(0, 1, 2, 3))(jnp.asarray(m6[0]), 100.0, -50.0, 4e3)
        want_mogi = jax.grad(jmogi, argnums=(0, 1, 2, 3))(100.0, -50.0, 4e3, 1e6)
    leaves = [torch.tensor(m6[0], requires_grad=True)] + [
        torch.tensor(v, dtype=torch.float64, requires_grad=True) for v in (100.0, -50.0, 4e3)]
    got = torch.autograd.grad(torch.sum(okada.mt_surface_displacement(
        torch.as_tensor(coords), *leaves) * torch.as_tensor(w)), leaves)
    for g, h in zip(got, want_mt):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), rtol=1e-7, atol=1e-30)
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in (100.0, -50.0, 4e3, 1e6)]
    got = torch.autograd.grad(torch.sum(okada.mogi_surface_displacement(
        torch.as_tensor(coords), *leaves) * torch.as_tensor(w)), leaves)
    for g, h in zip(got, want_mogi):
        np.testing.assert_allclose(float(g), float(h), rtol=1e-9)


def test_float64_path_against_float32_path():
    """The same code in both dtypes, each following its inputs.  The
    rectangle's float32 Chinnery sums lose up to a few 1e-4 · max|u|
    against float64 (measured 2e-4 on this 12 × 10 km rectangle over
    ±25 km; bar 1e-3); the moment-tensor expansion's lose more (5.3e-3 of
    max|u| for the source at 2 km depth here; bar 1e-2), and more than
    1e-3: why the port's callers evaluate them in float64."""
    coords = _coords(400, seed=7)
    p = _generic_rectangle()
    u32 = okada.okada_surface_displacement(
        torch.as_tensor(coords, dtype=torch.float32),
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in p.items()})
    u64 = okada.okada_surface_displacement(
        torch.as_tensor(coords), **{k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()})
    assert u32.dtype == torch.float32 and u64.dtype == torch.float64
    scale = float(u64.abs().max())
    assert float((u32.double() - u64).abs().max()) <= 1e-3 * scale
    coords, m6, pos = _mt_inputs()
    m32 = okada.mt_surface_displacement(
        torch.as_tensor(coords, dtype=torch.float32), torch.as_tensor(m6, dtype=torch.float32),
        **{k: torch.as_tensor(v, dtype=torch.float32) for k, v in pos.items()})
    m64 = okada.mt_surface_displacement(torch.as_tensor(coords),
                                        torch.as_tensor(m6, dtype=torch.float32).double(),
                                        **{k: torch.as_tensor(v) for k, v in pos.items()})
    assert m32.dtype == torch.float32 and m64.dtype == torch.float64
    scale = m64.abs().amax(dim=(1, 2))
    err = (m32.double() - m64).abs().amax(dim=(1, 2))
    assert (err <= 1e-2 * scale).all() and float((err / scale).max()) > 1e-3, err / scale
