"""
The port's trans-dimensional Voronoi slip sampler against the JAX
package on the CPU: the nearest-node assignment (masked and not), the
exact reproduction of the uniform prior on k under a constant likelihood
(tests/test_transd.py:36-52, the check of the birth and death
bookkeeping), ``transd_sample_ffi`` on tests/test_transd.py's static
composites with their bars and a stage file both packages read, and the
along-strike atlas of a two-subfault fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import beat_tpu.backend
import beat_tpu.ffi as jffi
import beat_tpu.ffi.transd as jtransd
import beat_tpu.utility
from beat_tpu.covariance import Covariance as JCovariance
from beat_tpu.heart.geodesy import GeodeticDataset as JDataset
from beat_tpu.models.distributer import GeodeticDistributerComposite as JDistributer
from beat_tpu.models.distributer import transd_sample_ffi as jax_transd_sample_ffi
from beat_tpu.ops.voronoi import nearest_voronoi_node as jax_nearest
from beat_tpu.sources import RectangularSource as JRectangularSource
import beat_tpu_torch.backend
import beat_tpu_torch.ffi.transd as ptransd
import beat_tpu_torch.utility
from beat_tpu_torch import convert
from beat_tpu_torch import ffi as pffi
from beat_tpu_torch.ffi.transd import TransDParams, masked_voronoi_slips, transd_sample
from beat_tpu_torch.models.distributer import GeodeticDistributerComposite, transd_sample_ffi
from beat_tpu_torch.ops.voronoi import nearest_voronoi_node, nearest_voronoi_node_numpy
from beat_tpu_torch.sources import RectangularSource
import test_torch_common  # noqa: F401  (the tests' thread policy)

# tests/test_transd.py's bars
K_FREQ_ATOL = 0.045           # every k level's frequency against uniform
COMPOSITE_CORR_MIN = 0.7      # posterior-mean slip against the two-level truth
SUBFAULT_SLIP_ATOL = 0.3      # mean slip per subfault
K_MEAN_MAX = 8.0


# -- nearest nodes ----------------------------------------------------------------


def test_nearest_node_matches_jax():
    rng = np.random.default_rng(0)
    ns, nd = rng.uniform(0, 10, (2, 9)).astype(np.float32)
    ps, pd = rng.uniform(0, 10, (2, 57)).astype(np.float32)
    want = np.asarray(jax_nearest(*map(jnp.asarray, (ns, nd, ps, pd))))
    got = nearest_voronoi_node(*map(torch.as_tensor, (ns, nd, ps, pd)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nearest_voronoi_node_numpy(ns, nd, ps, pd), want)
    # a batch of node sets, one row a chain
    nsb, ndb = rng.uniform(0, 10, (2, 5, 9)).astype(np.float32)
    want_b = np.stack([np.asarray(jax_nearest(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ps),
                                              jnp.asarray(pd))) for a, b in zip(nsb, ndb)])
    got_b = nearest_voronoi_node(*map(torch.as_tensor, (nsb, ndb, ps, pd)))
    np.testing.assert_array_equal(got_b.numpy(), want_b)


def test_masked_slips_match_jax():
    """tests/test_transd.py::test_masked_voronoi_slips, and a chain batch
    against ``vmap`` of the JAX function."""
    rng = np.random.default_rng(0)
    K, N, C = 6, 40, 7
    ns, nd = rng.uniform(0, 10, (2, C, K)).astype(np.float32)
    vals = rng.normal(size=(C, K)).astype(np.float32)
    active = (rng.uniform(size=(C, K)) < 0.6).astype(np.float32)
    active[:, 0] = 1.0
    ps, pd = rng.uniform(0, 10, (2, N)).astype(np.float32)
    want = np.asarray(jax.vmap(jtransd.masked_voronoi_slips, in_axes=(0, 0, 0, 0, None, None))(
        *map(jnp.asarray, (ns, nd, vals, active, ps, pd))))
    got = masked_voronoi_slips(*map(torch.as_tensor, (ns, nd, vals, active, ps, pd)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the host reference of tests/test_transd.py for one chain
    act = np.where(active[0] > 0)[0]
    d2 = (ps[:, None] - ns[0, act][None]) ** 2 + (pd[:, None] - nd[0, act][None]) ** 2
    np.testing.assert_array_equal(got[0].numpy(), vals[0, act[np.argmin(d2, axis=1)]])


# -- the sampler ---------------------------------------------------------------------


def test_prior_reproduction_constant_likelihood():
    """tests/test_transd.py:36-52: with L = const the sampler reproduces
    the uniform prior on k; the birth/death bookkeeping is exact iff it
    does."""
    params = TransDParams(k_max=8, k_min=1, n_chains=96, n_steps=4000, record_every=20, seed=1)
    out = transd_sample(lambda slips: torch.zeros(slips.shape[0]),
                        patch_s=np.linspace(0, 10, 12), patch_d=np.linspace(0, 4, 12),
                        extent_s=(0, 10), extent_d=(0, 4), value_bounds=(0, 1), params=params,
                        device="cpu")
    ks = out["k_trace"].ravel().astype(int)
    assert out["k_trace"].shape == (100, 96) and out["slip_trace"].shape == (100, 96, 12)
    freqs = np.bincount(ks, minlength=params.k_max + 1)[params.k_min:]
    freqs = freqs / freqs.sum()
    np.testing.assert_allclose(freqs, 1.0 / (params.k_max - params.k_min + 1),
                               atol=K_FREQ_ATOL)
    assert out["accept_rate"] > 0.5           # constant L: only the bound rejects
    node_s, node_d, values, active = out["final_state"]
    assert active.shape == (96, 8) and set(np.unique(active)) <= {0.0, 1.0}
    assert (active.sum(1) >= params.k_min).all()


def _composite(planes, true_fn, n_points, seed):
    """tests/test_transd.py's static composite (a LOS-up scene of
    ``n_points`` random points, 3 % noise) in the port; ``true_fn(fault)``
    gives the slips behind the data."""
    rng = np.random.default_rng(seed)
    fault = pffi.discretize_sources([RectangularSource(**p) for p in planes],
                                    patch_length=1e3, patch_width=1e3)
    coords = rng.uniform(-8e3 if len(planes) == 1 else -10e3,
                         8e3 if len(planes) == 1 else 10e3, (n_points, 2))
    los = np.tile([0.0, 0.0, 1.0], (n_points, 1))
    lib = pffi.geo_construct_gf_linear(fault, coords, los, components=("uparr",), device="cpu")
    true = true_fn(fault)
    synth = true @ lib.gf("uparr").double().numpy()
    sd = 0.03 * np.abs(synth).max()
    ds = convert.geodetic_dataset_from_numpy("ifg", "SAR", coords,
                                             synth + rng.normal(0, sd, synth.shape), los,
                                             covariance=np.eye(n_points) * sd**2)
    return GeodeticDistributerComposite([ds], lib, fault, device="cpu"), true


ONE_PLANE = [dict(depth=1e3, dip=60.0, length=6e3, width=4e3)]
TWO_PLANES = [dict(east_shift=-3e3, depth=1e3, strike=90.0, dip=70.0, length=6e3, width=4e3),
              dict(east_shift=3e3, depth=1e3, strike=90.0, dip=70.0, length=6e3, width=4e3)]


def test_transd_ffi_composite(tmp_path):
    """tests/test_transd.py::test_transd_ffi_composite: the deep half slips
    1.5 m, the shallow half 0.3 m; the saved stage loads in both packages
    with the per-patch ordering."""
    comp, true = _composite(ONE_PLANE, lambda f: np.where(
        f.get_subfault(0).patch_centers_local()[:, 1] > 2e3, 1.5, 0.3), 60, seed=4)
    out = transd_sample_ffi(comp, TransDParams(k_max=10, n_chains=96, n_steps=3000,
                                               record_every=20, seed=5),
                            value_bounds=(0.0, 3.0), homepath=str(tmp_path / "run"))
    n = comp.fault.npatches
    mean_slip = out["slip_trace"].reshape(-1, n).mean(axis=0)
    corr = np.corrcoef(mean_slip, true)[0, 1]
    assert corr > COMPOSITE_CORR_MIN, f"slip correlation {corr:.3f}"
    assert 0.0 < out["accept_rate"] < 1.0 and np.isfinite(out["llk_trace"]).all()
    for backend, utility in ((beat_tpu_torch.backend, beat_tpu_torch.utility),
                             (beat_tpu.backend, beat_tpu.utility)):
        handler = backend.SampleStage(str(tmp_path / "run"),
                                      ordering=utility.Ordering([("uparr", (n,))]))
        tr = handler.load_trace(-1)
        assert tr.q_trace.shape == out["slip_trace"].shape and tr.varnames == ["uparr"]
        state = handler.load_state(-1)
        assert state["accept_rate"] == out["accept_rate"]
        np.testing.assert_array_equal(state["k_trace"], out["k_trace"])


def test_transd_ffi_two_subfaults():
    """tests/test_transd.py::test_transd_ffi_two_subfaults: one node field
    spans both planes through the along-strike atlas."""
    def true_fn(fault):
        n0 = fault.get_subfault(0).npatches
        return np.concatenate([np.full(n0, 1.5), np.full(fault.npatches - n0, 0.3)])

    comp, true = _composite(TWO_PLANES, true_fn, 80, seed=6)
    out = transd_sample_ffi(comp, TransDParams(k_max=10, n_chains=96, n_steps=3000,
                                               record_every=20, seed=7),
                            value_bounds=(0.0, 3.0))
    n0 = comp.fault.get_subfault(0).npatches
    mean_slip = out["slip_trace"].reshape(-1, comp.fault.npatches).mean(axis=0)
    np.testing.assert_allclose(mean_slip[:n0].mean(), 1.5, atol=SUBFAULT_SLIP_ATOL)
    np.testing.assert_allclose(mean_slip[n0:].mean(), 0.3, atol=SUBFAULT_SLIP_ATOL)
    assert out["k_trace"].mean() < K_MEAN_MAX


@pytest.mark.parametrize("planes", [ONE_PLANE, TWO_PLANES], ids=["one", "two"])
def test_atlas_matches_jax(planes, monkeypatch):
    """The patch centres, extents and value bounds that
    ``transd_sample_ffi`` hands the sampler, in both packages (the
    registry's bounds of ``uparr`` where none are given)."""
    seen = {}

    def capture(name):
        def sampler(logp, patch_s, patch_d, extent_s, extent_d, value_bounds, params, **kw):
            seen[name] = (np.asarray(patch_s, dtype=np.float64),
                          np.asarray(patch_d, dtype=np.float64), tuple(map(float, extent_s)),
                          tuple(map(float, extent_d)), tuple(map(float, value_bounds)))
            return {}
        return sampler

    monkeypatch.setattr(ptransd, "transd_sample", capture("port"))
    monkeypatch.setattr(jtransd, "transd_sample", capture("jax"))
    comp, _ = _composite(planes, lambda f: np.ones(f.npatches), 20, seed=1)
    jfault = jffi.discretize_sources([JRectangularSource(**p) for p in planes],
                                     patch_length=1e3, patch_width=1e3)
    jlib = jffi.GeodeticGFLibrary(gfs={"uparr": jnp.asarray(comp.gflibrary.gf("uparr").numpy())},
                                  component_names=["uparr"])
    ds = comp.datasets[0]
    jds = JDataset(name=ds.name, typ=ds.typ, coords=ds.coords, displacement=ds.displacement,
                   los_vector=ds.los_vector, covariance=JCovariance(data=ds.covariance.data))
    jax_transd_sample_ffi(JDistributer([jds], jlib, jfault), jtransd.TransDParams())
    transd_sample_ffi(comp, TransDParams())
    for got, want in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(got, want)
    assert len(seen["port"][0]) == comp.fault.npatches
