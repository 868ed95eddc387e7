"""
Kernels K1c and K2c of the port (``beat_tpu_torch/ops/bilgather.py``:
the bilinear gather fused with the m6 contraction, and its transpose) on
the CPU.  Their plain versions against the JAX package's composition —
``beat_tpu.ops.bilgather.bilinear_rows`` (the Pallas kernel in interpret
mode), or its numpy reference, followed by the einsum of
``beat_tpu/heart/gftable.py:468`` — and against ``jax.vjp`` of that
composition, on the same numpy inputs; the autograd pair under
``gradcheck``, ``gradgradcheck`` and a Hessian; and ``point_spectra``
going through the pair without making the (…, 6, nf, 2) rows.  The CUDA
kernels are held against the plain versions on the card
(``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.ops.bilgather import bilinear_rows as jax_bilinear_rows
from beat_tpu.ops.bilgather import bilinear_rows_reference as jax_reference
from beat_tpu.ops.bilgather import corner_rows_pallas
from beat_tpu.ops.bilgather import pack_table as jax_pack_table
from beat_tpu_torch import flagship
from beat_tpu_torch.heart.gftable import rotate_m6_to_ray_frame
from beat_tpu_torch.optimize import laplace_approximation
from beat_tpu_torch.ops import bilgather
from beat_tpu_torch.ops.bilgather import (BilinearContract, ContractCornerDot,
                                          bilinear_contract, bilinear_contract_reference,
                                          contract_corner_dot, contract_corner_dot_reference,
                                          pack_table)
from beat_tpu_torch.sources import sdr_to_m6
from test_torch_common import counters, launches, spy

# K1c/K2c sum 24 (or L) products in another order than JAX's einsums: per
# query |err| <= RTOL·|want| + ATOL · Σ|coefficients| · max|corner row|
RTOL, ATOL = 1e-5, 1e-6

CASES = {
    # L = 2·nf ≡ 2 (mod 4), as at every table the port builds (nf odd)
    "odd_nf": dict(nd=7, nz=5, nf=13, n=40),
    # L ≡ 0 (mod 4)
    "even_nf": dict(nd=6, nz=4, nf=8, n=24),
    # indices past the last cell: clamped to cd <= CD-2, z0 <= NZ-2, and
    # exact top nodes (the +1 corner's weight is then 1)
    "clamped_edges": dict(nd=6, nz=4, nf=9, n=30, edge=True),
    "single_depth_node": dict(nd=6, nz=1, nf=9, n=24),
    "single_distance_node": dict(nd=1, nz=4, nf=7, n=24),
}


def _inputs(case, seed=0):
    """Port table, JAX padded table, raw (unclamped) corner indices, w4,
    m6 (n, 6) and a cotangent G (n, L) of one case, all from numpy."""
    c = CASES[case]
    nd, nz, nf, n = c["nd"], c["nz"], c["nf"], c["n"]
    rng = np.random.default_rng(seed)
    spectra = rng.normal(size=(6, 3, nd, nz, nf, 2)).astype(np.float32)
    packed = pack_table(torch.as_tensor(spectra))
    CD, NZ, M = packed.shape
    comp = rng.integers(0, 3, n)
    d0 = rng.integers(0, max(nd - 1, 1), n)
    z0 = rng.integers(0, max(nz - 1, 1), n)
    fd = rng.uniform(0, 1, n).astype(np.float32) if nd > 1 else np.zeros(n, np.float32)
    fz = rng.uniform(0, 1, n).astype(np.float32) if nz > 1 else np.zeros(n, np.float32)
    if c.get("edge"):
        d0[::3], fd[::3] = nd + 2, 1.0           # beyond the grid: clamped
        z0[1::3], fz[1::3] = nz - 1, 1.0         # the top node itself: clamped
    w4 = np.stack([(1 - fd) * (1 - fz), (1 - fd) * fz, fd * (1 - fz), fd * fz],
                  axis=-1).astype(np.float32)
    cd = comp * (CD // 3) + d0
    m6 = rng.normal(size=(n, 6)).astype(np.float32)
    G = rng.normal(size=(n, M // 6)).astype(np.float32)
    t4 = jax_pack_table(jnp.asarray(packed.reshape(CD * NZ, M).numpy()), CD, NZ)
    return packed, t4, cd, z0, w4, m6, G


def _rows(packed, cd, z0):
    """(n, 4, M) corner rows as the wrapper clamps them (numpy)."""
    CD, NZ, M = packed.shape
    t = packed.numpy()
    cd, z0 = np.clip(cd, 0, CD - 2), np.clip(z0, 0, NZ - 2)
    return np.stack([t[cd, z0], t[cd, z0 + 1], t[cd + 1, z0], t[cd + 1, z0 + 1]], axis=1)


def _jax_spectra(t4, cd, z0, w4, m6, M, rows_fn):
    """The JAX forward: the blended rows, then gftable.py:468's einsum."""
    rows = rows_fn(t4, jnp.asarray(cd), jnp.asarray(z0), w4)[:, :M]
    rows = jnp.reshape(rows, (rows.shape[0], 6, -1, 2))
    return jnp.einsum("tk,tkfr->tfr", m6, rows)


def _assert_per_query(got, want, coef_abs_sum, rows):
    bar = RTOL * np.abs(want) + (ATOL * coef_abs_sum * np.abs(rows).max(axis=(1, 2)))[:, None]
    err = np.abs(got - want)
    assert (err <= bar).all(), f"worst err/bar {(err / bar).max()}"


@pytest.mark.parametrize("jax_path", ["pallas_interpret", "numpy_reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1c_matches_jax_gather_and_einsum(case, jax_path):
    packed, t4, cd, z0, w4, m6, _ = _inputs(case)
    M = packed.shape[2]
    A = w4[:, :, None] * m6[:, None, :]
    got = bilinear_contract(packed, torch.as_tensor(cd), torch.as_tensor(z0),
                            torch.as_tensor(A)).numpy()
    if jax_path == "pallas_interpret":
        rows_fn = jax_bilinear_rows                   # custom_vjp over the kernel
    else:
        CD, NZ = packed.shape[:2]

        def rows_fn(t, c, z, w):
            return jnp.asarray(jax_reference(t, np.clip(c, 0, CD - 2), np.clip(z, 0, NZ - 2), w))
    want = np.asarray(_jax_spectra(t4, cd, z0, jnp.asarray(w4), jnp.asarray(m6), M, rows_fn))
    _assert_per_query(got, want.reshape(got.shape), np.abs(A).sum(axis=(1, 2)),
                      _rows(packed, cd, z0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1c_general_coefficients_match_float64(case):
    """A that is not an outer product: every (corner, component) pair
    carries its own coefficient."""
    packed, _, cd, z0, _, _, _ = _inputs(case, seed=1)
    n, M = cd.shape[0], packed.shape[2]
    A = np.random.default_rng(2).normal(size=(n, 4, 6)).astype(np.float32)
    got = bilinear_contract(packed, torch.as_tensor(cd), torch.as_tensor(z0),
                            torch.as_tensor(A)).numpy()
    rows = _rows(packed, cd, z0)
    want = np.einsum("nck,nckl->nl", A.astype(np.float64),
                     rows.reshape(n, 4, 6, M // 6).astype(np.float64))
    _assert_per_query(got, want, np.abs(A).sum(axis=(1, 2)), rows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k2c_matches_pallas_corner_rows_and_jax_vjp(case):
    packed, t4, cd, z0, w4, m6, G = _inputs(case, seed=3)
    n, M = G.shape[0], packed.shape[2]
    P = contract_corner_dot(packed, torch.as_tensor(cd), torch.as_tensor(z0),
                            torch.as_tensor(G)).numpy()
    rows = _rows(packed, cd, z0)
    g_abs = np.abs(G).sum(-1)
    # the TPU kernel's unblended corner rows (interpret mode), then einsum
    pallas = np.asarray(corner_rows_pallas(t4, jnp.asarray(cd), jnp.asarray(z0),
                                           interpret=True))[..., :M]
    want = np.einsum("nl,nckl->nck", G, pallas.reshape(n, 4, 6, M // 6))
    _assert_per_query(P.reshape(n, 24), want.reshape(n, 24), g_abs, rows)
    # the cotangents of w4 and m6 through the JAX forward, against P
    # contracted with m6 and with w4 as point_spectra's autograd does
    _, vjp = jax.vjp(lambda w, m: _jax_spectra(t4, cd, z0, w, m, M, jax_bilinear_rows),
                     jnp.asarray(w4), jnp.asarray(m6))
    dw4, dm6 = (np.asarray(x) for x in vjp(jnp.asarray(G.reshape(n, -1, 2))))
    _assert_per_query(np.einsum("nck,nk->nc", P, m6), dw4, g_abs * np.abs(m6).sum(-1), rows)
    _assert_per_query(np.einsum("nck,nc->nk", P, w4), dm6, g_abs * np.abs(w4).sum(-1), rows)


def _f64_case(n=6):
    """The first ``n`` clamped-edge queries in float64, indices clamped
    as the wrappers hand them to the autograd pair."""
    packed, _, cd, z0, w4, m6, G = _inputs("clamped_edges")
    CD, NZ, _ = packed.shape
    A = w4[:n, :, None] * m6[:n, None, :]
    return (packed.double(),
            torch.as_tensor(np.clip(cd[:n], 0, CD - 2), dtype=torch.int32),
            torch.as_tensor(np.clip(z0[:n], 0, NZ - 2), dtype=torch.int32),
            torch.as_tensor(A, dtype=torch.float64).requires_grad_(),
            torch.as_tensor(G[:n], dtype=torch.float64).requires_grad_())


@pytest.mark.parametrize("check", [torch.autograd.gradcheck, torch.autograd.gradgradcheck])
@pytest.mark.parametrize("fn", ["BilinearContract", "ContractCornerDot"])
def test_autograd_pair_gradcheck(fn, check):
    """float64 finite differences of each function's backward and double
    backward, which run through the other function."""
    tbl, cd, z0, A, G = _f64_case()
    if fn == "BilinearContract":        # 2 chains × 3 targets
        assert check(lambda a: BilinearContract.apply(tbl, cd.view(2, 3), z0.view(2, 3),
                                                      a.view(2, 3, 4, 6)), (A,))
    else:                               # 3 chains × 2 targets
        assert check(lambda g: ContractCornerDot.apply(tbl, cd.view(3, 2), z0.view(3, 2),
                                                       g.view(3, 2, -1)), (G,))


def test_hessian_runs_through_the_pair_and_table_is_data(monkeypatch):
    tbl, cd, z0, A, _ = _f64_case()
    a = A.detach().reshape(-1)

    def f(contract_fn):
        return lambda x: torch.sum(torch.tanh(contract_fn(tbl, cd, z0, x.reshape(-1, 4, 6))) ** 2)

    want = torch.autograd.functional.hessian(f(bilinear_contract_reference), a)
    k1c, k2c = spy(monkeypatch, bilgather, "_k1c"), spy(monkeypatch, bilgather, "_k2c")
    got = torch.autograd.functional.hessian(f(bilinear_contract), a)
    torch.testing.assert_close(got, want)
    # the forward and every row's double backward are K1c, the first
    # backward K2c
    assert len(k1c) > a.numel() and len(k2c) >= 1
    out = bilinear_contract(tbl.clone().requires_grad_(), cd, z0, A)
    with pytest.raises(RuntimeError, match="table is data"):
        out.sum().backward()


@pytest.mark.parametrize("lead", [(40,), (10, 4), (2, 5, 4)])
def test_launch_counters_stay_zero_on_cpu(lead):
    """(n,) and (..., T) queries: the same values in the caller's shape,
    and no launch counted on the CPU."""
    packed, _, cd, z0, w4, m6, G = _inputs("odd_nf")
    L = G.shape[1]
    cd, z0 = torch.as_tensor(cd).view(lead), torch.as_tensor(z0).view(lead)
    G = torch.as_tensor(G).view(lead + (L,))
    A = torch.as_tensor(w4[:, :, None] * m6[:, None, :]).view(lead + (4, 6)).requires_grad_()
    with counters() as counts:
        out = bilinear_contract(packed, cd, z0, A)
        out.backward(G)
        P = contract_corner_dot(packed, cd, z0, G)
    assert out.shape == G.shape and P.shape == lead + (4, 6)
    assert launches(counts) == {}
    torch.testing.assert_close(A.grad, P, rtol=0, atol=0)
    torch.testing.assert_close(out, bilinear_contract_reference(packed, cd, z0, A), rtol=0,
                               atol=0)
    torch.testing.assert_close(P, contract_corner_dot_reference(
        packed, cd.int(), z0.int(), G), rtol=0, atol=0)
    flat = contract_corner_dot(packed, cd.reshape(-1), z0.reshape(-1), G.reshape(-1, L))
    torch.testing.assert_close(P.reshape(-1, 4, 6), flat, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "odd_segment", "coef_shape", "cotangent_shape",
                                 "index_shapes_differ", "coef_lead_shape", "float_index"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    tbl = torch.zeros((6, 3, 12 * 3))
    cd = torch.zeros(6, dtype=torch.int64)
    A, G = torch.zeros((6, 4, 6)), torch.zeros((6, 6))
    fn, args, kw = {
        "dtype": (bilinear_contract, (tbl.double(), cd, cd, A), {}),
        "odd_segment": (bilinear_contract, (torch.zeros((6, 3, 6 * 3)), cd, cd, A), {}),
        "coef_shape": (bilinear_contract, (tbl, cd, cd, A.reshape(6, 24)), {}),
        "cotangent_shape": (contract_corner_dot, (tbl, cd, cd, G[:, :4]), {}),
        "index_shapes_differ": (contract_corner_dot, (tbl, cd, cd.view(2, 3), G), {}),
        "coef_lead_shape": (bilinear_contract, (tbl, cd.view(2, 3), cd.view(2, 3), A), {}),
        "float_index": (contract_corner_dot, (tbl, cd.float(), cd, G), {}),
    }[bad]
    with pytest.raises(ValueError):
        fn(*args, **kw)


@pytest.fixture(scope="module")
def small_flagship():
    return flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device="cpu")


@pytest.fixture(scope="module")
def flagship_table(small_flagship):
    return small_flagship.composites["seismic"].tables[0]


def _sources(table, n_chains=5, seed=4):
    rng = np.random.default_rng(seed)
    nst = 4
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32))  # noqa: E731
    return dict(m6=t(rng.normal(size=(n_chains, 6))).requires_grad_(),
                east_shift=t(rng.uniform(-2e3, 2e3, n_chains)),
                north_shift=t(rng.uniform(-2e3, 2e3, n_chains)),
                depth=t(rng.uniform(3e3, 18e3, n_chains)).requires_grad_(),
                station_east=t(rng.uniform(4e4, 9e4, 3 * nst)),
                station_north=t(rng.uniform(-9e4, 9e4, 3 * nst)),
                comp_idx=torch.as_tensor(np.repeat([0, 1, 2], nst)))


def test_point_spectra_equals_the_unfused_gather_and_einsum(flagship_table):
    """K1c's forward and its gradient in m6 and depth against K1's rows
    contracted with m6, the parent path of point_spectra."""
    table = flagship_table
    src = _sources(table)
    spec = table.point_spectra(**src)
    de = src["station_east"] - src["east_shift"][:, None]
    dn = src["station_north"] - src["north_shift"][:, None]
    rows = table.gather_spectra(torch.sqrt(de**2 + dn**2), src["depth"], src["comp_idx"])
    m6_ray = rotate_m6_to_ray_frame(src["m6"][:, None, :], torch.atan2(de, dn))
    want = torch.einsum("ctk,ctkfr->ctfr", m6_ray, rows)
    scale = float(want.detach().abs().max())
    torch.testing.assert_close(spec, want, rtol=RTOL, atol=ATOL * scale)
    w = torch.as_tensor(np.random.default_rng(5).normal(size=spec.shape), dtype=torch.float32)
    got = torch.autograd.grad((spec * w).sum(), (src["m6"], src["depth"]))
    ref = torch.autograd.grad((want * w).sum(), (src["m6"], src["depth"]))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * float(r.abs().max()))


def test_point_spectra_saves_no_rows_for_the_backward(flagship_table):
    """What autograd keeps for point_spectra's backward: the table, the
    indices, the 24 coefficients' factors — nothing with 6·nf·2 floats a
    query."""
    table = flagship_table
    src = _sources(table, n_chains=7)
    n = 7 * src["comp_idx"].shape[0]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x) or x, lambda x: x):
        spec = table.point_spectra(**src)
    spec.sum().backward()
    big = [tuple(x.shape) for x in saved
           if x.numel() >= n * 6 * table.nf * 2 and x.data_ptr() != table.packed.data_ptr()]
    assert saved and not big, big


def test_flagship_laplace_hessian_goes_through_the_pair_only(small_flagship, monkeypatch):
    """The Laplace Hessian (reverse over reverse) of the small flagship's
    likelihood at its true source, moment tensor pinned as in
    tests/test_torch_optimize.py, reaches K1c and K2c and none of K1, K2."""
    problem = small_flagship
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    m6 = dict(zip(("mnn", "mee", "mdd", "mne", "mnd", "med"),
                  sdr_to_m6(*flagship.TRUE_SDR).numpy()))
    for name, value in m6.items():
        sl = problem.ordering[name].slc
        lower[sl] = upper[sl] = value
    q_true = problem.ordering.to_array(dict(
        m6, magnitude=flagship.TRUE_MAGNITUDE, depth=flagship.TRUE_DEPTH, time=0.0,
        duration=flagship.TRUE_DURATION, h_any_P_0=0.0, h_any_S_1=0.0))
    k1c, k2c = spy(monkeypatch, bilgather, "_k1c"), spy(monkeypatch, bilgather, "_k2c")
    k1, k2 = spy(monkeypatch, bilgather, "_k1"), spy(monkeypatch, bilgather, "_k2")
    lap = laplace_approximation(logp, q_true, lower, upper, logp_args=(data,), device="cpu")
    assert np.isfinite(lap["log_evidence"]) and lap["curvature_ok"]
    assert len(k1c) > 1 and len(k2c) >= 1 and not k1 and not k2
