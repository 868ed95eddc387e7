"""
The port's kinematic finite-fault (FFI) slice against the JAX package on
the CPU: the fault geometry and smoothing operators, the 5-D library
build, the library files read both ways, the distributer and Laplacian
likelihoods per chain, and the small FFI problem sampled as a whole.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import beat_tpu.ffi as jffi
from beat_tpu.covariance import Covariance as JaxCovariance
from beat_tpu.heart.gftable import build_homogeneous_table as jax_build_table
from beat_tpu.heart.seismic import SeismicDataset as JaxDataset
from beat_tpu.heart.seismic import WaveformMapping as JaxWavemap
from beat_tpu.heart.taper import ArrivalTaper as JaxTaper
from beat_tpu.heart.taper import Filter as JaxFilter
from beat_tpu.models.distributer import SeismicDistributerComposite as JaxDistributer
from beat_tpu.models.laplacian import LaplacianDistributerComposite as JaxLaplacian
from beat_tpu.sources import RectangularSource as JaxRectangularSource
from beat_tpu.sources import tensile_m6 as jax_tensile_m6
from beat_tpu_torch import ffi as pffi
from beat_tpu_torch import flagship
from beat_tpu_torch.convert import fault_geometry_from_numpy, seismic_gflibrary_from_numpy
from beat_tpu_torch.covariance import Covariance
from beat_tpu_torch.heart.gftable import build_homogeneous_table
from beat_tpu_torch.heart.seismic import SeismicDataset, WaveformMapping
from beat_tpu_torch.heart.taper import ArrivalTaper, Filter
from beat_tpu_torch.models.distributer import SeismicDistributerComposite
from beat_tpu_torch.models.laplacian import LaplacianDistributerComposite
from beat_tpu_torch.samplers import SMCParams
from beat_tpu_torch.sources import RectangularSource, tensile_m6
import test_torch_common  # noqa: F401  (the tests' thread policy)

# library build: the same frequency-domain products and inverse-DFT
# matmuls, summed in another order (the JAX package's synthesis bar,
# tests/test_seismic.py:389, plus an absolute part for the tapered ends)
BUILD_RTOL, BUILD_ATOL_REL = 1e-5, 1e-6
# per-chain llk bar of the JAX package's float32 checks
# (tests/test_float32_llk.py:101)
LLK_RTOL = 2e-5

TABLE = dict(distances=np.linspace(10e3, 80e3, 8), depths=np.linspace(1e3, 12e3, 6),
             nt=256, dt=0.25)
TAPER = dict(a=-2.0, b=-1.0, c=20.0, d=22.0)
FILTER = dict(lower_corner=0.02, upper_corner=0.6, order=3)
GRIDS = dict(duration_bounds=(0.5, 2.0), duration_sampling=0.5,
             starttime_bounds=(0.0, 4.0), starttime_sampling=0.25)
ONE_PLANE = [dict(east_shift=0.0, north_shift=0.0, depth=3e3, strike=20.0, dip=70.0,
                  rake=0.0, length=8e3, width=4e3)]
TWO_PLANES = [dict(east_shift=0.0, north_shift=0.0, depth=3e3, strike=20.0, dip=70.0,
                   rake=0.0, length=4e3, width=4e3),
              dict(east_shift=3e3, north_shift=5e3, depth=2e3, strike=35.0, dip=60.0,
                   rake=-20.0, length=4e3, width=4e3)]


def stations(n_st=4):
    """The stations of tests/test_ffi_kinematic.py:30-34."""
    rng = np.random.default_rng(0)
    az = np.linspace(0, 2 * np.pi, n_st, endpoint=False) + 0.4
    dist = rng.uniform(30e3, 60e3, n_st)
    return dist * np.sin(az), dist * np.cos(az)


def both_setups(planes):
    """(table, wavemap, fault) of the setup of tests/test_ffi_kinematic.py
    through the port and through the JAX package."""
    st_e, st_n = stations()
    ptable = build_homogeneous_table(**TABLE, device="cpu")
    jtable = jax_build_table(**TABLE)
    pwmap = WaveformMapping(
        name="any_P", table=ptable, taper=ArrivalTaper(**TAPER), filterer=Filter(**FILTER),
        datasets=[SeismicDataset(station=f"S{i}", channel="Z", east=st_e[i], north=st_n[i],
                                 ydata=np.zeros(ptable.nt)) for i in range(len(st_e))])
    jwmap = JaxWavemap(
        name="any_P", table=jtable, taper=JaxTaper(**TAPER), filterer=JaxFilter(**FILTER),
        datasets=[JaxDataset(station=f"S{i}", channel="Z", east=st_e[i], north=st_n[i],
                             ydata=np.zeros(jtable.nt)) for i in range(len(st_e))])
    pfault = pffi.discretize_sources([RectangularSource(**p) for p in planes], 2e3, 2e3)
    jfault = jffi.discretize_sources([JaxRectangularSource(**p) for p in planes], 2e3, 2e3)
    return (ptable, pwmap, pfault), (jtable, jwmap, jfault)


@pytest.fixture(scope="module")
def one_plane():
    return both_setups(ONE_PLANE)


# -- geometry -----------------------------------------------------------------


@pytest.mark.parametrize("planes", [ONE_PLANE, TWO_PLANES], ids=["one", "two"])
def test_fault_geometry_matches_jax(planes):
    (_, _, pfault), (_, _, jfault) = both_setups(planes)
    assert pfault.npatches == jfault.npatches and pfault.nsubfaults == jfault.nsubfaults
    assert pfault.ordering.slices == jfault.ordering.slices
    for pp, jp in zip(pfault.get_all_patches(), jfault.get_all_patches()):
        np.testing.assert_array_equal(pp.center(), jp.center())
        assert (pp.strike, pp.dip, pp.rake, pp.length, pp.width) == (
            jp.strike, jp.dip, jp.rake, jp.length, jp.width)
    for i in range(pfault.nsubfaults):
        np.testing.assert_array_equal(pfault.get_subfault(i).patch_centers_local(),
                                      jfault.get_subfault(i).patch_centers_local())
        np.testing.assert_array_equal(pfault.get_subfault(i).plane.strikevector,
                                      jfault.get_subfault(i).plane.strikevector)
    np.testing.assert_array_equal(pfault.patch_areas(), jfault.patch_areas())
    slips = np.random.default_rng(0).uniform(0, 2, pfault.npatches)
    assert pfault.moment(slips) == jfault.moment(slips)
    assert pfault.magnitude(slips) == pytest.approx(jfault.magnitude(slips), rel=1e-6)
    for corr in ("nearest_neighbor", "gaussian", "exponential"):
        pop, jop = pfault.get_smoothing_operator(corr), jfault.get_smoothing_operator(corr)
        np.testing.assert_array_equal(pop, jop)
        assert pffi.smoothing_operator_log_determinant(pop) == \
            jffi.laplacian.smoothing_operator_log_determinant(jop)
    # the same fault from the JAX planes' numbers
    conv = fault_geometry_from_numpy([(sf.plane.to_dict(), sf.n_strike, sf.n_dip)
                                      for sf in jfault.subfaults])
    np.testing.assert_array_equal(
        np.stack([p.center() for p in conv.get_all_patches()]),
        np.stack([p.center() for p in jfault.get_all_patches()]))


def test_extended_plane_matches_jax():
    ext = dict(extension_width=0.2, extension_length=0.1)
    pf = pffi.discretize_sources([RectangularSource(**ONE_PLANE[0])], 2e3, 2e3, **ext)
    jf = jffi.discretize_sources([JaxRectangularSource(**ONE_PLANE[0])], 2e3, 2e3, **ext)
    assert (pf.subfaults[0].n_strike, pf.subfaults[0].n_dip) == (
        jf.subfaults[0].n_strike, jf.subfaults[0].n_dip)
    np.testing.assert_array_equal(pf.subfaults[0].patch_centers_enz(),
                                  jf.subfaults[0].patch_centers_enz())


def test_tensile_m6_matches_jax():
    got = tensile_m6(np.array([20.0, 135.0]), np.array([70.0, 50.0]), np.array([4e6, 1e6]))
    want = np.stack([np.asarray(jax_tensile_m6(20.0, 70.0, 4e6)),
                     np.asarray(jax_tensile_m6(135.0, 50.0, 1e6))])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("two", [False, True], ids=["one_subfault", "two_subfaults"])
def test_point2starttimes_matches_jax(two):
    (_, _, pfault), (_, _, jfault) = both_setups(TWO_PLANES if two else ONE_PLANE)
    rng = np.random.default_rng(5)
    sf = pfault.get_subfault(0)
    C = 6
    vel = rng.uniform(2000, 4000, (C, sf.npatches)).astype(np.float32)
    nuc_s = rng.uniform(0, sf.plane.length, C).astype(np.float32)
    nuc_d = rng.uniform(0, sf.plane.width, C).astype(np.float32)
    nuc_s[0], nuc_d[0] = 2000.0, 2000.0           # on a patch edge: round half to even
    time = rng.uniform(-1, 1, C).astype(np.float32)
    want = np.asarray(jax.vmap(lambda v, s, d, t: jfault.point2starttimes(0, v, s, d, t))(
        jnp.asarray(vel), jnp.asarray(nuc_s), jnp.asarray(nuc_d), jnp.asarray(time)))
    got = pfault.point2starttimes(0, torch.as_tensor(vel), torch.as_tensor(nuc_s),
                                  torch.as_tensor(nuc_d), torch.as_tensor(time)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- the library ----------------------------------------------------------------


@pytest.mark.parametrize("component", ["uparr", "uperp", "utens"])
def test_library_build_matches_jax(one_plane, component, tmp_path):
    (ptable, pwmap, pfault), (jtable, jwmap, jfault) = one_plane
    np.testing.assert_array_equal(pwmap.window_starts, jwmap.window_starts)
    # 3 patches per batch: a ragged last batch
    plib = pffi.seis_construct_gf_linear(ptable, pwmap, pfault, component=component, **GRIDS,
                                         batch_patches=3)
    jlib = jffi.seis_construct_gf_linear(jtable, jwmap, jfault, component=component, **GRIDS)
    want = np.asarray(jlib.data)
    assert tuple(plib.data.shape) == want.shape == (4, 8, 4, 17, pwmap.nsamples_win)
    assert (plib.duration_min, plib.duration_sampling, plib.starttime_min,
            plib.starttime_sampling) == (jlib.duration_min, jlib.duration_sampling,
                                         jlib.starttime_min, jlib.starttime_sampling)
    np.testing.assert_allclose(plib.data.numpy(), want, rtol=BUILD_RTOL,
                               atol=BUILD_ATOL_REL * np.abs(want).max())
    if component != "uparr":
        return
    # the .npz library files read both ways
    plib.save(str(tmp_path), "port")
    back = jffi.SeismicGFLibrary.load(str(tmp_path), "port")
    np.testing.assert_array_equal(np.asarray(back.data), plib.data.numpy())
    assert back.starttime_sampling == plib.starttime_sampling
    jlib.save(str(tmp_path), "jax")
    back = pffi.SeismicGFLibrary.load(str(tmp_path), "jax", device="cpu")
    np.testing.assert_array_equal(back.data.numpy(), want)
    assert (back.duration_min, back.duration_sampling) == (jlib.duration_min,
                                                           jlib.duration_sampling)
    np.testing.assert_array_equal(back.reference_times, np.zeros(4))


# -- the likelihoods ------------------------------------------------------------


def _composites(planes, interpolation):
    """The distributer and Laplacian composites of both packages on one
    random library, the same observed windows and covariances."""
    (_, pwmap, pfault), (_, jwmap, jfault) = both_setups(planes)
    rng = np.random.default_rng(7)
    shape = (pwmap.ntargets, pfault.npatches, 4, 17, pwmap.nsamples_win)
    data = rng.normal(size=shape).astype(np.float32)
    grid = dict(duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                starttime_sampling=0.25)
    plib = seismic_gflibrary_from_numpy(data, **grid, device="cpu")
    jlib = jffi.SeismicGFLibrary(data=jnp.asarray(data), **grid)
    obs = rng.normal(size=(pwmap.ntargets, pwmap.nsamples_win)).astype(np.float32)
    cov = np.eye(pwmap.nsamples_win) * 0.5 + 0.1
    for wmap, cls in ((pwmap, Covariance), (jwmap, JaxCovariance)):
        wmap.data_windows = obs
        for ds in wmap.datasets:
            ds.covariance = cls(data=cov)
    pcomp = SeismicDistributerComposite([(pwmap, {"uparr": plib})], pfault,
                                        interpolation=interpolation, device="cpu")
    jcomp = JaxDistributer([(jwmap, {"uparr": jlib})], jfault, interpolation=interpolation,
                           use_pallas=False)
    return (pcomp, LaplacianDistributerComposite(pfault, device="cpu")), \
        (jcomp, JaxLaplacian(jfault))


def _points(fault, n_chains, seed):
    """Chains over the priors' ranges: the onsets run past the 4 s
    starttime grid and the durations past the 2 s duration grid."""
    rng = np.random.default_rng(seed)
    n, k = fault.npatches, fault.nsubfaults
    shape1 = (n_chains, k) if k > 1 else (n_chains,)
    return {
        "uparr": rng.uniform(0, 3, (n_chains, n)),
        "durations": rng.uniform(0.3, 2.6, (n_chains, n)),
        "velocities": rng.uniform(1000, 4000, (n_chains, n)),
        "nucleation_strike": rng.uniform(0, fault.get_subfault(0).plane.length, shape1),
        "nucleation_dip": rng.uniform(0, fault.get_subfault(0).plane.width, shape1),
        "time": rng.uniform(-0.5, 0.5, shape1),
        "h_any_P_0": rng.uniform(-1, 1, n_chains),
        "h_laplacian": rng.uniform(-1, 1, n_chains),
    }


@pytest.mark.parametrize("planes", [ONE_PLANE, TWO_PLANES], ids=["one_subfault",
                                                                  "two_subfaults"])
@pytest.mark.parametrize("interpolation", ["nearest_neighbor", "multilinear"])
def test_llk_matches_vmapped_jax(planes, interpolation):
    (pcomp, plap), (jcomp, jlap) = _composites(planes, interpolation)
    points = {k: v.astype(np.float32) for k, v in _points(pcomp.fault, 12, seed=9).items()}
    jpoints = {k: jnp.asarray(v) for k, v in points.items()}
    ppoints = {k: torch.as_tensor(v) for k, v in points.items()}
    for pc, jc in ((pcomp, jcomp), (plap, jlap)):
        want = np.asarray(jax.vmap(lambda pt: jc.loglike(pt))(jpoints))
        got = pc.loglike(ppoints).numpy()
        assert got.shape == (12,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
    want = np.asarray(jax.vmap(jcomp.point2starttimes)(jpoints))
    np.testing.assert_allclose(pcomp.point2starttimes(ppoints).numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert pcomp.get_hypernames() == jcomp.get_hypernames()
    assert plap.get_hypernames() == jlap.get_hypernames()
    # one result point's synthetics and variance reductions
    single = {k: v[0] for k, v in points.items()}
    jsyn = jcomp.get_synthetics(single)
    psyn = pcomp.get_synthetics(single)
    for mapid, want in jsyn.items():
        np.testing.assert_allclose(psyn[mapid], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    jvr, pvr = jcomp.get_variance_reductions(single), pcomp.get_variance_reductions(single)
    for mapid in jvr:
        assert pvr[mapid] == pytest.approx(jvr[mapid], rel=1e-4)


def test_what_waits_raises_naming_the_roadmap():
    (_, pwmap, pfault), _ = both_setups(ONE_PLANE)
    lib = seismic_gflibrary_from_numpy(
        np.zeros((4, 8, 2, 2, pwmap.nsamples_win), np.float32), 0.5, 0.5, 0.0, 0.25,
        device="cpu")
    pwmap.datasets[0].covariance = Covariance(data=np.eye(pwmap.nsamples_win))
    # what still waits: a gradient through the stack (the JAX op has none)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lib.stack_all(torch.ones(1, 8), torch.ones(1, 4, 8),
                      torch.ones(1, 8, requires_grad=True), "multilinear")
    with pytest.raises(ValueError, match="library"):
        SeismicDistributerComposite([(pwmap, {"uparr": lib})],
                                    pffi.discretize_sources(
                                        [RectangularSource(**TWO_PLANES[0])], 2e3, 2e3),
                                    device="cpu")
    with pytest.raises(NotImplementedError):
        lib.stack_all(torch.ones(1, 8), torch.ones(1, 4, 8), torch.ones(1, 8), "cubic")


# -- the slice as a whole ---------------------------------------------------------


def test_ffi_flagship_smc_reaches_beta_one(tmp_path):
    """The small FFI problem samples to β = 1, and the rupture behind its
    data beats perturbed ones (tests/test_ffi_kinematic.py:149-158)."""
    problem = flagship.build_ffi_flagship(**flagship.FFI_TEST_SIZE, seed=2, device="cpu",
                                          outfolder=str(tmp_path / "ffi"))
    n = problem.composites["seismic"].fault.npatches
    assert problem.ordering.names == ["uparr", "durations", "velocities", "nucleation_strike",
                                      "nucleation_dip", "h_any_P_0", "h_laplacian"]
    assert problem.ordering.size == 3 * n + 4
    logp, data = problem.make_logp_fn()
    true = dict(problem.true_point, h_any_P_0=0.0, h_laplacian=0.0)
    slow = dict(true, uparr=np.asarray(true["uparr"]) * 2.5)
    moved = dict(true, nucleation_strike=7e3)
    q = torch.as_tensor(np.stack([problem.ordering.to_array(p) for p in (true, slow, moved)]),
                        dtype=torch.float32)
    llk = logp(q, data).numpy()
    assert np.isfinite(llk).all() and llk[0] > llk[1] and llk[0] > llk[2]

    q_tr, llk_tr = problem.sample(SMCParams(n_chains=200, n_steps=12, seed=0))
    assert q_tr.shape[1:] == (200, 3 * n + 4) and np.isfinite(llk_tr).all()
    from beat_tpu_torch.backend import SampleStage

    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    assert float(state["beta"]) == 1.0
    # the posterior sits far above the prior's likelihoods
    assert np.median(llk_tr[-1]) > llk[1]
