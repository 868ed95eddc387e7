"""
Kernels K1 and K2 of the port (``beat_tpu_torch/ops/bilgather.py``) on
the CPU: the wrappers' plain versions against the JAX package's Pallas
kernels in interpret mode, its numpy reference and its custom VJP, on
the same numpy inputs; and the autograd pair (K1 and K2 as each other's
backward) under ``gradcheck`` and ``gradgradcheck``.  The CUDA kernels
themselves are held against the plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.ops.bilgather import bilinear_rows as jax_bilinear_rows
from beat_tpu.ops.bilgather import bilinear_rows_pallas, corner_rows_pallas
from beat_tpu.ops.bilgather import bilinear_rows_reference as jax_reference
from beat_tpu.ops.bilgather import pack_table as jax_pack_table
from beat_tpu_torch.ops.bilgather import (BilinearRows, CornerDot, bilinear_rows,
                                          bilinear_rows_reference, corner_dot,
                                          corner_dot_reference, pack_table)
import test_torch_common  # noqa: F401  (the tests' thread policy)

# the JAX package's bar for gathered spectra (tests/test_seismic.py:349-350)
ATOL_REL = 2e-6
# K2: M products summed in another order than JAX's einsum; per query the
# bar is rtol plus K2_ATOL · Σ_j |g_ij| · max_c |row_cj|
K2_RTOL, K2_ATOL = 1e-5, 1e-6

CASES = {
    # n not a multiple of the Pallas kernel's 256-row block
    "ragged": dict(nd=7, nz=5, nf=13, n=300),
    "top_edge": dict(nd=6, nz=4, nf=9, n=40, edge=True),
    "all_channels": dict(nd=5, nz=3, nf=7, n=33, channels=True),
    "single_depth_node": dict(nd=6, nz=1, nf=9, n=24),
    "single_distance_node": dict(nd=1, nz=4, nf=9, n=24),
}


def _spectra(nd, nz, nf, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(6, 3, nd, nz, nf, 2)).astype(np.float32)


def _queries(nd, nz, n, edge=False, channels=False, seed=1):
    """Bilinear queries as GreensTable.gather_spectra builds them:
    (channel, d0, z0) cells with the +1 corner weight 0 on single-node
    axes, and exact top nodes (fd = fz = 1.0) for ``edge``."""
    rng = np.random.default_rng(seed)
    comp = np.arange(n) % 3 if channels else rng.integers(0, 3, n)
    d0 = rng.integers(0, max(nd - 1, 1), n)
    z0 = rng.integers(0, max(nz - 1, 1), n)
    fd = rng.uniform(0, 1, n).astype(np.float32) if nd > 1 else np.zeros(n, np.float32)
    fz = rng.uniform(0, 1, n).astype(np.float32) if nz > 1 else np.zeros(n, np.float32)
    if edge:
        d0[::2], fd[::2] = nd - 2, 1.0
        z0[1::2], fz[1::2] = nz - 2, 1.0
    w4 = np.stack([(1 - fd) * (1 - fz), (1 - fd) * fz, fd * (1 - fz), fd * fz], axis=-1)
    return comp, d0, z0, w4.astype(np.float32)


def _logical_bilinear(spectra, comp, d0, z0, w4):
    """numpy bilinear blend on the unpacked table, the +1 corner clamped
    to the last node (the JAX plain gather's rule for single-node axes)."""
    nd, nz = spectra.shape[2], spectra.shape[3]
    rows = np.transpose(spectra, (1, 2, 3, 0, 4, 5)).reshape(3, nd, nz, -1)
    d1, z1 = np.minimum(d0 + 1, nd - 1), np.minimum(z0 + 1, nz - 1)
    return (w4[:, 0, None] * rows[comp, d0, z0] + w4[:, 1, None] * rows[comp, d0, z1]
            + w4[:, 2, None] * rows[comp, d1, z0] + w4[:, 3, None] * rows[comp, d1, z1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_pallas_and_reference(case):
    c = dict(CASES[case])
    nd, nz, nf, n = c.pop("nd"), c.pop("nz"), c.pop("nf"), c.pop("n")
    spectra = _spectra(nd, nz, nf)
    comp, d0, z0, w4 = _queries(nd, nz, n, **c)
    packed = pack_table(torch.as_tensor(spectra))
    CD, NZ, M = packed.shape
    cd = comp * (CD // 3) + d0
    got = bilinear_rows(packed, torch.as_tensor(cd), torch.as_tensor(z0),
                        torch.as_tensor(w4)).numpy()
    scale = np.abs(spectra).max()

    # the TPU kernel (interpret mode) on the same rows in its padded layout
    t4 = jax_pack_table(jnp.asarray(packed.reshape(CD * NZ, M).numpy()), CD, NZ)
    pallas = np.asarray(bilinear_rows_pallas(t4, jnp.asarray(cd), jnp.asarray(z0),
                                             jnp.asarray(w4), interpret=True))[:, :M]
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL_REL * scale)
    np.testing.assert_allclose(got, jax_reference(t4, cd, z0, w4)[:, :M], rtol=0,
                               atol=ATOL_REL * scale)
    # and the logical table: duplicated single nodes change nothing
    np.testing.assert_allclose(got, _logical_bilinear(spectra, comp, d0, z0, w4), rtol=0,
                               atol=ATOL_REL * scale)


def test_packed_rows_equal_jax_layout_without_padding():
    nd, nz, nf = 7, 5, 13
    spectra = _spectra(nd, nz, nf, seed=4)
    packed = pack_table(torch.as_tensor(spectra)).numpy()
    flat = jnp.reshape(jnp.transpose(jnp.asarray(spectra), (1, 2, 3, 0, 4, 5)),
                       (3 * nd * nz, 6 * nf * 2))
    t4 = np.asarray(jax_pack_table(flat, 3 * nd, nz))
    M = 6 * nf * 2
    assert t4.shape[-1] * 8 > M                         # the TPU row is padded
    np.testing.assert_array_equal(packed, t4.reshape(3 * nd, nz, -1)[..., :M])


def test_launch_counter_stays_zero_on_cpu():
    spectra = _spectra(4, 3, 5)
    packed = pack_table(torch.as_tensor(spectra))
    comp, d0, z0, w4 = _queries(4, 3, 10)
    before = bilinear_rows.launches
    out = bilinear_rows(packed, torch.as_tensor(comp * 4 + d0), torch.as_tensor(z0),
                        torch.as_tensor(w4))
    assert out.shape == (10, packed.shape[2])
    assert bilinear_rows.launches == before == 0
    ref = bilinear_rows_reference(packed, torch.as_tensor(comp * 4 + d0),
                                  torch.as_tensor(z0), torch.as_tensor(w4))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "row_not_float4", "weights_shape", "float_index"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    tbl = torch.zeros((6, 3, 12 * 3))
    cd = torch.zeros(5, dtype=torch.int64)
    w4 = torch.zeros((5, 4))
    args = {"dtype": (tbl.double(), cd, cd, w4),
            "row_not_float4": (tbl[:, :, :-2].contiguous(), cd, cd, w4),
            "weights_shape": (tbl, cd, cd, w4[:, :3]),
            "float_index": (tbl, cd.float(), cd, w4)}[bad]
    with pytest.raises(ValueError):
        bilinear_rows(*args)


def _case_inputs(case, seed=2):
    """Port table, JAX padded table, queries and a cotangent (n, M) of one
    K1 case, all from numpy."""
    c = dict(CASES[case])
    nd, nz, nf, n = c.pop("nd"), c.pop("nz"), c.pop("nf"), c.pop("n")
    packed = pack_table(torch.as_tensor(_spectra(nd, nz, nf)))
    CD, NZ, M = packed.shape
    comp, d0, z0, w4 = _queries(nd, nz, n, **c)
    cd = comp * (CD // 3) + d0
    g = np.random.default_rng(seed).normal(size=(n, M)).astype(np.float32)
    t4 = jax_pack_table(jnp.asarray(packed.reshape(CD * NZ, M).numpy()), CD, NZ)
    return packed, t4, cd, z0, w4, g


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2_matches_pallas_corner_rows_and_jax_vjp(case):
    packed, t4, cd, z0, w4, g = _case_inputs(case)
    n, M = g.shape
    got = corner_dot(packed, torch.as_tensor(cd), torch.as_tensor(z0),
                     torch.as_tensor(g)).numpy()
    rows = np.asarray(corner_rows_pallas(t4, jnp.asarray(cd), jnp.asarray(z0),
                                         interpret=True))[..., :M]
    bar = K2_ATOL * np.abs(g).sum(-1) * np.abs(rows).max(axis=(1, 2))
    # the TPU kernel's corner rows (interpret mode), reduced as _bil_bwd does
    want = np.einsum("nj,ncj->nc", g, rows)
    np.testing.assert_array_less(np.abs(got - want), K2_RTOL * np.abs(want) + bar[:, None])
    # the w4 cotangent of the JAX package's differentiable gather
    _, vjp = jax.vjp(lambda w: jax_bilinear_rows(t4, jnp.asarray(cd), jnp.asarray(z0), w),
                     jnp.asarray(w4))
    g_pad = np.zeros((n, t4.shape[2] * t4.shape[3]), np.float32)
    g_pad[:, :M] = g
    (dw4,) = vjp(jnp.asarray(g_pad))
    np.testing.assert_array_less(np.abs(got - np.asarray(dw4)),
                                 K2_RTOL * np.abs(np.asarray(dw4)) + bar[:, None])


def _f64_case(n=6):
    """The first ``n`` top-edge queries in float64 (the plain versions
    take it; the kernels do not)."""
    packed, _, cd, z0, w4, g = _case_inputs("top_edge")
    return (packed.double(), torch.as_tensor(cd[:n], dtype=torch.int32),
            torch.as_tensor(z0[:n], dtype=torch.int32),
            torch.as_tensor(w4[:n], dtype=torch.float64).requires_grad_(),
            torch.as_tensor(g[:n], dtype=torch.float64).requires_grad_())


@pytest.mark.parametrize("check", [torch.autograd.gradcheck, torch.autograd.gradgradcheck])
@pytest.mark.parametrize("fn", ["BilinearRows", "CornerDot"])
def test_autograd_pair_gradcheck(fn, check):
    """float64 finite differences of each function's backward and double
    backward, which run through the other function (the plain versions
    inside on the CPU)."""
    tbl, cd, z0, w4, g = _f64_case()
    if fn == "BilinearRows":
        assert check(lambda w: BilinearRows.apply(tbl, cd, z0, w), (w4,))
    else:
        assert check(lambda x: CornerDot.apply(tbl, cd, z0, x), (g,))


def test_hessian_runs_through_the_pair_and_table_is_data():
    tbl, cd, z0, w4, _ = _f64_case()
    w = w4.detach().reshape(-1)

    def f(rows_fn):
        return lambda x: torch.sum(torch.tanh(rows_fn(tbl, cd, z0, x.reshape(-1, 4))))

    torch.testing.assert_close(torch.autograd.functional.hessian(f(bilinear_rows), w),
                               torch.autograd.functional.hessian(f(bilinear_rows_reference), w))
    out = bilinear_rows(tbl.clone().requires_grad_(), cd, z0, w4)
    with pytest.raises(RuntimeError, match="table is data"):
        out.sum().backward()


def test_k2_launch_counter_stays_zero_on_cpu():
    packed, _, cd, z0, _, g = _case_inputs("ragged")
    out = corner_dot(packed, torch.as_tensor(cd), torch.as_tensor(z0), torch.as_tensor(g))
    assert out.shape == (g.shape[0], 4)
    assert corner_dot.launches == 0
    torch.testing.assert_close(out, corner_dot_reference(
        packed, torch.as_tensor(cd).int(), torch.as_tensor(z0).int(), torch.as_tensor(g)),
        rtol=0, atol=0)
