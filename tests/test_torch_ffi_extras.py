"""
What the kinematic FFI slice left, against the JAX package on the CPU:
the distributer's per-target station time shifts, its ``spectrum``
domain and per-target hyperparameters (``hp_specific``), the hyper-only
posterior of the distributer and of the Laplacian composite, and the GF
stack on a bfloat16 library (the JAX package's ``BEAT_TPU_STACK_DTYPE``),
held against the interpret-mode Pallas kernel on the same bf16 layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beat_tpu.ffi as jffi
from beat_tpu.covariance import Covariance as JaxCovariance
from beat_tpu.heart.seismic import SeismicDataset as JaxDataset
from beat_tpu.heart.seismic import WaveformMapping as JaxWavemap
from beat_tpu.heart.taper import ArrivalTaper as JaxTaper
from beat_tpu.heart.taper import Filter as JaxFilter
from beat_tpu.models.distributer import SeismicDistributerComposite as JaxDistributer
from beat_tpu.models.laplacian import LaplacianDistributerComposite as JaxLaplacian
from beat_tpu.ops.gfstack import stack_all_pallas
from beat_tpu_torch import flagship
from beat_tpu_torch.convert import seismic_gflibrary_from_numpy
from beat_tpu_torch.covariance import Covariance
from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.models.distributer import SeismicDistributerComposite
from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite
from beat_tpu_torch.ops.gfstack import plan_stack, stack_batched_reference
from test_torch_ffi import FILTER, ONE_PLANE, TAPER, _points, both_setups, stations

# per-chain llk bar of the JAX package's float32 checks (tests/test_float32_llk.py:101)
LLK_RTOL = 2e-5
# the hyper-only terms: one stack, then sums of squares of the same residuals
HYPER_RTOL = 1e-5
# the bf16 stack against the interpret-mode Pallas kernel with the exact
# (mode="highest") selection on the same bf16 layout: the same widened
# samples, float32 products summed in another order (the bar of
# tests/test_torch_gfstack.py for the float32 library)
BF16_RTOL = BF16_ATOL = 2e-5
# the bf16 stack against the float32 one (tests/test_gfstack_pallas.py:176-179)
BF16_LOSS_MAX = 0.02

GRID = dict(duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
            starttime_sampling=0.25)

#: composite options: (wavemap keywords, composite keywords)
CASES = {
    "time_shifts": (dict(station_corrections=True), {}),
    "spectrum": (dict(domain="spectrum"), {}),
    "hp_specific": ({}, dict(hp_specific=True)),
    "all": (dict(station_corrections=True, domain="spectrum"), dict(hp_specific=True)),
}


def _twins(wmap_options, comp_options, interpolation="multilinear", n_maps=1):
    """The distributer of both packages on one random library per
    wavemap, the same observed windows and covariances (in fit space)."""
    st_e, st_n = stations()
    (ptable, _, pfault), (jtable, _, jfault) = both_setups(ONE_PLANE)
    rng = np.random.default_rng(7)
    plibs, jlibs = [], []
    for m in range(n_maps):
        pw = WaveformMapping(
            name="any_P", table=ptable, taper=ArrivalTaper(**TAPER), filterer=Filter(**FILTER),
            mapnumber=m, **wmap_options,
            datasets=[SeismicDataset(station=f"S{i}", channel="Z", east=st_e[i],
                                     north=st_n[i], ydata=np.zeros(ptable.nt))
                      for i in range(len(st_e))])
        jw = JaxWavemap(
            name="any_P", table=jtable, taper=JaxTaper(**TAPER), filterer=JaxFilter(**FILTER),
            mapnumber=m, **wmap_options,
            datasets=[JaxDataset(station=f"S{i}", channel="Z", east=st_e[i], north=st_n[i],
                                 ydata=np.zeros(jtable.nt)) for i in range(len(st_e))])
        data = rng.normal(size=(pw.ntargets, pfault.npatches, 4, 17,
                                pw.nsamples_win)).astype(np.float32)
        obs = rng.normal(size=(pw.ntargets, pw.nsamples_win)).astype(np.float32)
        cov = np.eye(pw.nsamples_fit) * 0.5 + 0.1
        for wmap, cls in ((pw, Covariance), (jw, JaxCovariance)):
            wmap.data_windows = obs
            for ds in wmap.datasets:
                ds.covariance = cls(data=cov)
        plibs.append((pw, {"uparr": seismic_gflibrary_from_numpy(data, **GRID, device="cpu")}))
        jlibs.append((jw, {"uparr": jffi.SeismicGFLibrary(data=jnp.asarray(data), **GRID)}))
    pcomp = SeismicDistributerComposite(plibs, pfault, interpolation=interpolation,
                                        device="cpu", **comp_options)
    jcomp = JaxDistributer(jlibs, jfault, interpolation=interpolation, use_pallas=False,
                           **comp_options)
    return pcomp, jcomp


def _case_points(pcomp, n_chains, seed):
    """Chains over the priors' ranges with every hierarchical and
    hyperparameter the composite names."""
    points = _points(pcomp.fault, n_chains, seed)
    rng = np.random.default_rng(seed + 1)
    for name in pcomp.get_hierarchical_names():
        points[name] = rng.uniform(-1.5, 1.5, n_chains)
    for name in pcomp.get_hypernames():
        points[name] = rng.uniform(-1, 1, n_chains)
    return {k: v.astype(np.float32) for k, v in points.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_llk_matches_jax(case):
    pcomp, jcomp = _twins(*CASES[case], n_maps=2 if case == "all" else 1)
    assert pcomp.get_hypernames() == jcomp.get_hypernames()
    assert pcomp.get_hierarchical_names() == jcomp.get_hierarchical_names()
    assert len(pcomp.get_hierarchical_names()) == (
        sum(w.ntargets for w in pcomp.wavemaps) if "time_shifts" in case or case == "all"
        else 0)
    points = _case_points(pcomp, 12, seed=9)
    want = np.asarray(jax.vmap(lambda pt: jcomp.loglike(pt))(
        {k: jnp.asarray(v) for k, v in points.items()}))
    got = pcomp.loglike({k: torch.as_tensor(v) for k, v in points.items()}).numpy()
    assert got.shape == (12,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    # the synthetics of one result point (windows, also for spectrum wavemaps)
    single = {k: v[0] for k, v in points.items()}
    jsyn, psyn = jcomp.get_synthetics(single), pcomp.get_synthetics(single)
    for mapid, w in jsyn.items():
        np.testing.assert_allclose(psyn[mapid], w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


def test_time_shifts_move_the_onsets():
    """A station time shift moves its own target's onsets only: shifting
    target 1 changes its window and leaves the others bit for bit."""
    pcomp, _ = _twins(*CASES["time_shifts"])
    points = {k: torch.as_tensor(v) for k, v in _case_points(pcomp, 3, seed=2).items()}
    names = pcomp.get_hierarchical_names()
    for n in names:
        points[n] = torch.zeros(3)
    base = pcomp.synthetics_windows(points, 0)
    points[names[1]] = torch.full((3,), 0.75)
    moved = pcomp.synthetics_windows(points, 0)
    keep = [t for t in range(len(names)) if t != 1]
    assert torch.equal(base[:, keep], moved[:, keep])
    assert not torch.allclose(base[:, 1], moved[:, 1])


@pytest.mark.parametrize("case", ["hp_specific", "all"])
def test_hyper_posterior_matches_jax(case):
    """``hyper_loglike`` per chain and the precomputed ``hyper_data`` terms
    of the distributer, and the Laplacian composite's ``hyper_loglike``."""
    pcomp, jcomp = _twins(*CASES[case], n_maps=2 if case == "all" else 1)
    points = _case_points(pcomp, 8, seed=3)
    fixed = {k: v[0] for k, v in _case_points(pcomp, 1, seed=4).items()}
    ppoints = {k: torch.as_tensor(v) for k, v in points.items()}
    jfixed = {k: jnp.asarray(v) for k, v in fixed.items()}
    want = np.asarray(jax.vmap(lambda pt: jcomp.hyper_loglike(pt, jfixed))(
        {k: jnp.asarray(v) for k, v in points.items()}))
    np.testing.assert_allclose(pcomp.hyper_loglike(ppoints, fixed).numpy(), want,
                               rtol=LLK_RTOL)
    jw, jp, jn, jnames = jcomp.hyper_data(jfixed)
    pw, pp, pn, pnames = pcomp.hyper_data(fixed)
    assert pnames == list(jnames)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=HYPER_RTOL)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))

    plap = LaplacianDistributerComposite(pcomp.fault, device="cpu")
    jlap = JaxLaplacian(jcomp.fault)
    want = np.asarray(jax.vmap(lambda pt: jlap.hyper_loglike(pt, jfixed))(
        {k: jnp.asarray(v) for k, v in points.items()}))
    np.testing.assert_allclose(plap.hyper_loglike(ppoints, fixed).numpy(), want,
                               rtol=LLK_RTOL)


def test_estimate_hypers_on_the_static_ffi_problem(tmp_path):
    """The hyper-only posterior of the static FFI flagship (distributer +
    Laplacian) samples, and rewrites both hyperparameters' bounds to
    finite ranges inside the registry's."""
    problem = flagship.build_static_ffi_flagship(**flagship.STATIC_FFI_TEST_SIZE, device="cpu",
                                                 outfolder=str(tmp_path))
    bounds = problem.estimate_hypers(n_steps=200, n_chains=8)
    assert set(bounds) == {"h_SAR", "h_laplacian"}
    for lo, hi in bounds.values():
        assert np.isfinite(lo).all() and np.isfinite(hi).all() and (lo < hi).all()


# -- the bf16 library ---------------------------------------------------------------


@pytest.fixture(scope="module")
def bf16_libs():
    """tests/test_gfstack_pallas.py:149's library in both packages, float32
    and bfloat16."""
    rng = np.random.default_rng(11)
    T, P, D, S, N = 3, 5, 4, 6, 64
    data = rng.normal(size=(T, P, D, S, N)).astype(np.float32)
    base = jffi.SeismicGFLibrary(data=jnp.asarray(data), **GRID)
    jlib16 = base.with_stacking_layout(dtype=jnp.bfloat16)
    plib32 = seismic_gflibrary_from_numpy(data, **GRID, device="cpu")
    plib16 = seismic_gflibrary_from_numpy(data, **GRID, device="cpu", dtype=torch.bfloat16)
    return data, base, jlib16, plib32, plib16


def test_bf16_library_is_the_jax_rounding(bf16_libs):
    data, _, _, plib32, plib16 = bf16_libs
    assert plib16.data.dtype == torch.bfloat16
    assert plib16.data.nbytes * 2 == plib32.data.nbytes
    want = np.asarray(jnp.asarray(data, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(plib16.data.float().numpy(), want)
    np.testing.assert_array_equal(plib32.to_dtype(torch.bfloat16).data.float().numpy(), want)


@pytest.mark.parametrize("interpolation", ["multilinear", "nearest_neighbor"])
def test_bf16_stack_matches_interpret_pallas(bf16_libs, interpolation):
    """The stack on the bf16 library against ``stack_all_pallas`` in
    interpret mode (exact selection) on the same bf16 layout, per chain;
    and against the float32 stack: lossy, within the JAX package's bar."""
    _, base, jlib16, plib32, plib16 = bf16_libs
    rng = np.random.default_rng(12)
    C, T, P = 4, plib16.ntargets, plib16.npatches
    durations = rng.uniform(0.5, 2.0, (C, P)).astype(np.float32)
    starttimes = rng.uniform(0, 1.2, (C, T, P)).astype(np.float32)
    slips = rng.uniform(0, 2, (C, P)).astype(np.float32)
    want = np.asarray(jax.vmap(lambda d, s, w: stack_all_pallas(
        jlib16, d, s, w, interpolation, interpret=True, mode="highest"))(
        jnp.asarray(durations), jnp.asarray(starttimes), jnp.asarray(slips)))
    args = (torch.as_tensor(durations), torch.as_tensor(starttimes), torch.as_tensor(slips),
            interpolation)
    got = plib16.stack_all(*args)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_RTOL,
                               atol=BF16_ATOL * np.abs(want).max())
    got32 = plib32.stack_all(*args).numpy()
    err = np.abs(got.numpy() - got32).max() / np.abs(got32).max()
    assert 0 < err < BF16_LOSS_MAX, err
    # the plain version on the bf16 tensor is the float32 arithmetic on its
    # widened samples, nothing rounded further
    didx, rtf = plib16.durations2idxs(args[0], interpolation)
    sidx, stf = plib16.starttimes2idxs(args[1], interpolation)
    widened = stack_batched_reference(plib16.data.float(), didx, sidx, args[2], rtf, stf)
    assert torch.equal(got, widened)


def test_composite_with_bf16_library():
    """``library_dtype`` converts the composite's libraries; its llk is the
    float32 composite's within the bf16 rounding of the stack."""
    pcomp, _ = _twins({}, {})
    libs = [(w, {"uparr": pcomp.libs[i]["uparr"]}) for i, w in enumerate(pcomp.wavemaps)]
    pcomp16 = SeismicDistributerComposite(libs, pcomp.fault, device="cpu",
                                          library_dtype=torch.bfloat16)
    assert pcomp16.libs[0]["uparr"].data.dtype == torch.bfloat16
    assert pcomp.libs[0]["uparr"].data.dtype == torch.float32
    points = {k: torch.as_tensor(v) for k, v in _case_points(pcomp, 6, seed=5).items()}
    llk32, llk16 = pcomp.loglike(points), pcomp16.loglike(points)
    assert torch.isfinite(llk16).all() and not torch.equal(llk16, llk32)
    s32, s16 = pcomp.synthetics_windows(points, 0), pcomp16.synthetics_windows(points, 0)
    assert float((s16 - s32).abs().max() / s32.abs().max()) < BF16_LOSS_MAX


def test_bf16_plan_at_the_laquila_shape():
    """On a bf16 library at the Laquila shape K3 takes the tensor-core
    variant (6.4 reads a staged row), K4 keeps ``gather`` (it has no
    ``mma``; ``gather`` measured faster than ``tiled``); where ``mma``
    cannot run (N % 8 != 0) K3 stays ``tiled``; float32 libraries are
    unchanged."""
    laquila = (12, 500, 10, 32, 512)
    k3, k4 = (plan_stack(*laquila, 2000, corners, elem_bytes=2) for corners in (4, 1))
    assert (k3.variant, k4.variant) == ("mma", "gather")
    assert (k3.n_tile, k3.chain_tile, k3.stages) == (64, 512, 2)
    assert k3.smem_bytes == 2 * 320 * 64 * 2 + 512 * 8 * 16
    assert plan_stack(12, 500, 10, 32, 508, 2000, 4, elem_bytes=2).variant == "tiled"
    assert plan_stack(*laquila, 2000, 4).variant == "tiled"          # float32: unchanged
    assert plan_stack(*laquila, 2000, 1).variant == "tiled"


def test_mma_plan_rule():
    """``mma`` runs K3 on bf16 libraries only, with 8-sample chunks; K3 on
    bf16 takes it from 3 reads a staged row, ``tiled`` from 1.5 and
    ``gather`` below, on either walk (the measured shapes of the rule's
    comment); asked for K4, ``mma`` refuses, and K4 on bf16 rows takes
    twice the float32 reads for ``tiled``."""
    assert plan_stack(2, 11, 4, 9, 64, 12, 4, elem_bytes=2).variant == "gather"     # 1.3 reads
    assert plan_stack(2, 11, 4, 9, 64, 20, 4, elem_bytes=2).variant == "tiled"      # 2.2
    assert plan_stack(2, 11, 4, 9, 64, 37, 4, elem_bytes=2).variant == "mma"        # 4.1
    for P, C, variant in ((500, 2000, "mma"), (500, 256, "mma"), (500, 192, "tiled"),
                          (500, 128, "tiled"), (80, 128, "tiled"), (40, 2000, "mma"),
                          (40, 512, "mma"), (40, 256, "mma"), (40, 128, "tiled")):
        assert plan_stack(12, P, 10, 32, 512, C, 4, elem_bytes=2).variant == variant
    assert plan_stack(12, 40, 5, 32, 512, 2000, 4, elem_bytes=2).variant == "mma"
    with pytest.raises(ValueError, match="K3 only"):
        plan_stack(12, 500, 10, 32, 512, 2000, 1, variant="mma", elem_bytes=2)
    assert plan_stack(12, 500, 10, 32, 512, 512, 1, elem_bytes=2).variant == "gather"
    assert plan_stack(12, 500, 10, 32, 512, 512, 1).variant == "tiled"
    with pytest.raises(ValueError, match="bfloat16 libraries only"):
        plan_stack(12, 500, 10, 32, 512, 2000, 4, variant="mma")
    with pytest.raises(ValueError, match="16-byte"):
        plan_stack(2, 11, 4, 9, 100, 37, 4, variant="mma", elem_bytes=2)
    with pytest.raises(ValueError, match="do not fit"):
        plan_stack(2, 11, 40, 32, 64, 37, 4, variant="mma", elem_bytes=2)
