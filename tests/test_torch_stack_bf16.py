"""
The kinematic stack on a bfloat16 library on the user's path
(``BEAT_TPU_STACK_DTYPE=bfloat16``) and the arithmetic of the stack's
``mma`` variant, on the CPU.

* A kinematic FFI project written by the JAX package, loaded with the
  variable set: every library of the seismic distributer is bfloat16, and
  the llk equals the JAX package's on the same libraries rounded to
  bfloat16 and stored as float32 (the widening is exact) within the FFI
  llk bar; an explicit ``library_dtype`` wins over the variable; unset (or
  any other value) it changes nothing.
* A plain-torch model of the ``mma`` variant's sums (each weight split
  into bfloat16 hi + lo, products of exact bf16 rows, float32 sums) within
  the card's bar of the plain version, where one rounding of the weights
  is not.
"""

import glob
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beat_tpu.config as jcfg
import beat_tpu_torch.config as pcfg
from beat_tpu_torch.models.distributer import SeismicDistributerComposite
from beat_tpu_torch.models.problem import load_model
from beat_tpu_torch.ops.gfstack import _clamp_cells, group_cells, stack_batched_reference
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_config import jax_llks, kinematic_ffi_project, port_llks

# the FFI slice's per-chain llk bar (tests/test_torch_ffi.py)
LLK_RTOL = 2e-5
# K3/K4 per (chain, target): |err| <= STACK_RTOL · Σ_p |slip_p| · Σ_corners |w| · max|data|
# (tests/test_torch_gpu.py, chip_smoke.py [k3_bf16])
STACK_RTOL = 1e-5


def bf16_rounded(x: np.ndarray) -> np.ndarray:
    """The JAX package's bfloat16 rounding, widened back to float32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def projects(tmp_path_factory):
    """A kinematic FFI project and a copy whose seismic libraries are
    rounded to bfloat16 (stored as float32)."""
    pdir = str(tmp_path_factory.mktemp("kinematic"))
    kinematic_ffi_project(pdir)
    rounded = str(tmp_path_factory.mktemp("kinematic_bf16"))
    shutil.copytree(pdir, rounded, dirs_exist_ok=True)
    files = glob.glob(os.path.join(rounded, "ffi", "linear_gfs", "seismic_*.npz"))
    assert files
    for path in files:
        with np.load(path) as z:
            arrays = dict(z)
        arrays["data"] = bf16_rounded(arrays["data"])
        np.savez_compressed(path, **arrays)
    return pdir, rounded


def library_dtypes(problem) -> set:
    comp = problem.composites["seismic"]
    return {lib.data.dtype for libs in comp.libs for lib in libs.values()}


def points(jp, n=3, seed=0):
    lo, hi = jp.priors.bounds_arrays()
    return np.concatenate([jp.priors.test_array()[None],
                           np.random.default_rng(seed).uniform(lo, hi, (n - 1, lo.size))])


def test_env_bf16_runs_the_project_on_bf16_libraries(projects, monkeypatch):
    pdir, rounded = projects
    monkeypatch.setenv("BEAT_TPU_STACK_DTYPE", "bfloat16")
    pp = load_model(pdir, "ffi", device="cpu")
    assert library_dtypes(pp) == {torch.bfloat16}
    direct = pcfg.problem_from_config(pcfg.load_config(pdir, "ffi"), pdir, device="cpu")
    assert library_dtypes(direct) == {torch.bfloat16}
    monkeypatch.delenv("BEAT_TPU_STACK_DTYPE")
    jp = jcfg.problem_from_config(jcfg.load_config(rounded, "ffi"), rounded)
    Q = points(jp)
    got, want = port_llks(pp, Q), jax_llks(jp, Q)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    np.testing.assert_array_equal(port_llks(direct, Q), got)


def test_explicit_library_dtype_beats_the_env(projects, monkeypatch):
    pdir, _ = projects
    monkeypatch.setenv("BEAT_TPU_STACK_DTYPE", "bfloat16")
    comp = load_model(pdir, "ffi", device="cpu").composites["seismic"]
    libs = [(w, dict(comp.libs[i].items())) for i, w in enumerate(comp.wavemaps)]
    kept = SeismicDistributerComposite(libs, comp.fault, slip_varnames=comp.slip_varnames,
                                       device="cpu", library_dtype=torch.float32)
    assert {lib.data.dtype for ls in kept.libs for lib in ls.values()} == {torch.float32}


@pytest.mark.parametrize("value", [None, "float16", "bf16"])
def test_env_unset_or_other_keeps_the_libraries(projects, monkeypatch, value):
    pdir, _ = projects
    if value is None:
        monkeypatch.delenv("BEAT_TPU_STACK_DTYPE", raising=False)
    else:
        monkeypatch.setenv("BEAT_TPU_STACK_DTYPE", value)
    pp = load_model(pdir, "ffi", device="cpu")
    assert library_dtypes(pp) == {torch.float32}
    monkeypatch.delenv("BEAT_TPU_STACK_DTYPE", raising=False)
    jp = jcfg.problem_from_config(jcfg.load_config(pdir, "ffi"), pdir)
    Q = points(jp, seed=1)
    np.testing.assert_allclose(port_llks(pp, Q), jax_llks(jp, Q), rtol=LLK_RTOL)


def split_weight_stack(data, didx, sidx, slips, rtf=None, stf=None, lo_term=True):
    """The mma variant's arithmetic in plain torch: each folded corner
    weight (slip · rf · sf, ... in float32, as the kernel folds them) as
    bfloat16 hi + lo (``lo_term=False``: hi alone, one rounding), times
    the exact bf16 rows, summed in float32 (in another order than the
    kernel's tensor cores, which the bar covers)."""
    T, P, D, S, N = data.shape
    C = didx.shape[0]
    multilinear = rtf is not None
    d, s = _clamp_cells(data, didx, sidx, multilinear)
    d = d[:, None, :].expand(C, T, P)
    s = s.expand(C, T, P)
    rows = data.float().reshape(T * P * D * S, N)
    tp = (torch.arange(T)[:, None] * P + torch.arange(P)[None, :])[None]   # (1, T, P)
    if multilinear:
        x, y = slips * rtf, slips * (1 - rtf)                                # (C, P)
        sf = stf.expand(C, T, P)
        corners = ((1, 1, x[:, None] * sf), (1, 0, x[:, None] * (1 - sf)),
                   (0, 1, y[:, None] * sf), (0, 0, y[:, None] * (1 - sf)))
    else:
        corners = ((0, 0, slips[:, None].expand(C, T, P)),)
    out = torch.zeros((C, T, N), dtype=torch.float32)
    for dd, ss, w in corners:
        hi = w.to(torch.bfloat16).float()
        lo = (w - hi).to(torch.bfloat16).float() if lo_term else torch.zeros_like(w)
        cell = rows[(tp * D + (d - dd)) * S + (s - ss)]                     # (C, T, P, N)
        out += torch.einsum("ctpn,ctp->ctn", cell, hi) + torch.einsum("ctpn,ctp->ctn", cell, lo)
    return out


@pytest.mark.parametrize("multilinear", [True, False])
def test_split_weight_product_within_the_card_bar(multilinear):
    """hi + lo leaves each weight within 2⁻¹⁸ of itself (the JAX kernel's
    x3 scheme with the library's lo term zero): at most 0.38 of the bar
    from the split if every error aligned, plus float32 sums in another
    order (≈ 4P · 2⁻²⁴ relative); one bf16 rounding of the weights (2⁻⁹)
    would miss the bar."""
    rng = np.random.default_rng(7 + multilinear)
    C, T, P, D, S, N = 48, 3, 60, 6, 9, 16
    data = torch.as_tensor(rng.normal(size=(T, P, D, S, N)), dtype=torch.float32)
    data = data.to(torch.bfloat16)
    # indices beyond the grid on both sides: clamped
    didx = torch.as_tensor(rng.integers(-1, D + 1, (C, P)), dtype=torch.int32)
    sidx = torch.as_tensor(rng.integers(-1, S + 1, (C, T, P)), dtype=torch.int32)
    slips = torch.as_tensor(rng.uniform(0, 3, (C, P)), dtype=torch.float32)
    rtf = stf = None
    if multilinear:
        # on the grid and beyond it: the weights leave [0, 1]
        rtf = torch.as_tensor(rng.uniform(-0.3, 1.3, (C, P)), dtype=torch.float32)
        stf = torch.as_tensor(rng.uniform(-0.3, 1.3, (C, T, P)), dtype=torch.float32)
    ref = stack_batched_reference(data, didx, sidx, slips, rtf, stf)
    wabs = 1.0
    if multilinear:
        wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
    bar = STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1) * data.float().abs().max()
    split = split_weight_stack(data, didx, sidx, slips, rtf, stf)
    worst = float(((split - ref).abs().amax(-1) / bar).max())
    assert worst <= 0.5, worst
    one = split_weight_stack(data, didx, sidx, slips, rtf, stf, lo_term=False)
    assert float(((one - ref).abs().amax(-1) / bar).max()) > 1.0


def test_group_cells_counts_a_groups_distinct_rows():
    """The diagnostic ``chip_smoke.py`` prints for the mma variant: 8 chains
    on one cell read 4 distinct rows, on 8 cells apart 32; a ragged last
    group is left out; shared onsets count as each target's."""
    C, T, P = 17, 2, 3
    didx = torch.full((C, P), 3)
    sidx = torch.full((C, T, P), 5)
    assert group_cells(didx, sidx) == {"rows": 32, "mean": 4.0, "max": 4}
    assert group_cells(didx, sidx[:, :1]) == {"rows": 32, "mean": 4.0, "max": 4}
    apart = torch.arange(C)[:, None].expand(C, P)
    want = {"rows": 32, "mean": 32.0, "max": 32}
    assert group_cells(1 + 2 * apart, sidx) == want
    assert group_cells(didx, (5 + 2 * apart)[:, None, :]) == want
    assert group_cells(didx, -(5 + 2 * apart)[:, None, :]) == want
