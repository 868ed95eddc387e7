"""
The port's plots (``beat_tpu_torch.plotting``) on the Agg backend: every
entry of ``plots_catalog`` writes its file for a problem of its mode and
data types (the geodetic problem with GNSS, the FullMT problem, the
kinematic FFI problem, the linear BEM problem, each at its test size
with a stage trace written without sampling), and the numbers the plots
draw equal the JAX package's on the same draws: the draws' moment
tensors (the composite's ``source_m6`` on the problem's device, against
the JAX package's per draw) and their Hudson, lune and decomposition
coordinates and beachball image; the moment-rate functions (against the
JAX package's ``point2starttimes`` and ``half_sinusoid_stf`` on the same
fault, read from the port's ``fault_geometry.pkl``); the fault patches'
corners.  The nucleation star of ``fault_geometry`` differs from the JAX
package's on purpose: its copy scales the nucleation point, already in
metres, by 1e3 (``beat_tpu/plotting/ffi.py:115``).
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.plotting import plots_availability, plots_catalog
from beat_tpu_torch.plotting.common import PlotOptions
from test_torch_common import THREADS  # noqa: F401  (thread policy)


def fake_trace(problem, n_rec=10, n_chains=6, seed=0):
    """A final-stage trace of prior draws, written without sampling."""
    rng = np.random.default_rng(seed)
    lo, hi = problem.priors.bounds_arrays()
    q = rng.uniform(lo, hi, size=(n_rec, n_chains, lo.size)).astype(np.float32)
    llk = rng.normal(size=(n_rec, n_chains)).astype(np.float32)
    SampleStage(problem.outfolder, ordering=problem.ordering).save_stage(
        -1, {"q": q, "llk": llk}, {"beta": 1.0})
    return q.reshape(-1, lo.size)


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    from beat_tpu_torch import flagship as fl

    root = tmp_path_factory.mktemp("plots")
    made = {}

    def get(kind):
        if kind not in made:
            out = str(root / kind)
            if kind == "geodetic":
                p = fl.build_geodetic_flagship(**fl.GEO_TEST_SIZE, gnss_stations=8, device="cpu",
                                               outfolder=out)
            elif kind == "seismic":
                p = fl.build_flagship(**fl.TEST_SIZE, device="cpu", outfolder=out)
            elif kind == "dc":
                p = fl.build_flagship(**fl.TEST_SIZE, device="cpu", outfolder=out,
                                      source="DCSource")
            elif kind == "ffi":
                p = fl.build_ffi_flagship(**fl.FFI_TEST_SIZE, device="cpu", outfolder=out)
            else:
                p = fl.build_bem_flagship(**fl.BEM_TEST_SIZE, device="cpu", outfolder=out)
            made[kind] = p, fake_trace(p)
        return made[kind]

    return get


def _kind(name):
    avail = plots_availability[name]
    if "geometry" not in avail["modes"]:
        return "ffi"
    if avail["datatypes"] == ["geodetic"] or name in ("station_map", "correlation_hist"):
        return "geodetic"
    return "seismic"


CASES = [(name, _kind(name)) for name in sorted(plots_catalog)] + [
    ("slip_distribution_3d", "bem"), ("stage_posteriors", "ffi")]


@pytest.mark.parametrize("name,kind", CASES, ids=[f"{n}-{k}" for n, k in CASES])
def test_every_plot_writes_its_file(problems, name, kind):
    problem, _ = problems(kind)
    path = plots_catalog[name](problem, PlotOptions())
    for p in (path if isinstance(path, list) else [path]):
        assert os.path.getsize(p) > 1000, p
    assert os.path.dirname(path if isinstance(path, str) else path[0]) == os.path.join(
        problem.outfolder, "figures")


@pytest.mark.parametrize("kind", ["seismic", "dc"])
def test_draws_moment_tensors_equal_the_jax_package(problems, kind):
    import beat_tpu.mt_utils as jmt
    import beat_tpu.sources as jsrc
    from beat_tpu.models.seismic import source_m6 as jax_source_m6
    from beat_tpu.plotting.mt import beachball_image as jax_beachball
    from beat_tpu_torch import mt_utils as pmt
    from beat_tpu_torch.plotting.mt import _posterior_m6s, beachball_image

    problem, flat = problems(kind)
    got = _posterior_m6s(problem, PlotOptions(), n_samples=20)
    template = problem.composites["seismic"].sources[0]
    params = {k: v for k, v in template.to_dict().items() if k != "type"}
    jtemplate = getattr(jsrc, type(template).__name__)(**params)
    idx = np.linspace(0, flat.shape[0] - 1, 20).astype(int)
    want = np.stack([np.asarray(jax_source_m6(
        jtemplate, {k: jnp.asarray(v) for k, v in problem.ordering.to_point(q).items()}, 0, 1))
        for q in flat[idx]])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    for fn in ("hudson_coords", "lune_coords"):
        np.testing.assert_allclose([getattr(pmt, fn)(m) for m in got],
                                   [getattr(jmt, fn)(m) for m in got], rtol=1e-12, atol=1e-12)
    for m in got:
        a, b = pmt.decompose(m), jmt.decompose(m)
        for k in ("iso", "dc", "clvd"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(beachball_image(got, 41), jax_beachball(got, 41))


def test_moment_rate_equals_the_jax_package(problems, tmp_path):
    """The moment rates of the draws against the JAX package's
    ``plot_moment_rate`` loop (its ``point2starttimes`` and
    ``half_sinusoid_stf``) on the same fault, which the JAX package reads
    from the port's ``fault_geometry.pkl``."""
    from beat_tpu.sources import half_sinusoid_stf as jax_stf
    from beat_tpu_torch.config import save_fault_geometry
    from beat_tpu_torch.plotting.ffi import moment_rates

    problem, flat = problems("ffi")
    fault = problem.composites["seismic"].fault
    save_fault_geometry(fault, str(tmp_path / "fault_geometry.pkl"))
    with open(tmp_path / "fault_geometry.pkl", "rb") as f:
        jfault = pickle.load(f)
    draws = flat[:5]
    t = np.linspace(0, 30, 300)
    got = moment_rates(problem, fault, draws, t)
    areas = jfault.patch_areas()
    for q, rate_got in zip(draws, got):
        point = problem.ordering.to_point(q)
        uparr = np.atleast_1d(point["uparr"])
        durations = np.atleast_1d(point["durations"])
        nuc_s = np.atleast_1d(point["nucleation_strike"])
        nuc_d = np.atleast_1d(point["nucleation_dip"])
        st = np.concatenate([np.asarray(jfault.point2starttimes(
            i, jfault.ordering.vector2subfault(i, jnp.asarray(point["velocities"])),
            float(nuc_s[min(i, nuc_s.size - 1)]), float(nuc_d[min(i, nuc_d.size - 1)])))
            for i in range(jfault.nsubfaults)])
        want = np.zeros_like(t)
        for p in range(jfault.npatches):
            want += 33e9 * areas[p] * abs(uparr[p]) * np.asarray(jax_stf(
                jnp.asarray(t - st[p]), float(durations[p] if durations.size > 1 else durations)))
        np.testing.assert_allclose(rate_got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(got).max() > 0


def test_fault_drawing_numbers_equal_the_jax_package(problems, tmp_path):
    import beat_tpu.plotting.bem as jbem
    import beat_tpu.plotting.ffi as jffi
    from beat_tpu_torch.config import save_fault_geometry
    from beat_tpu_torch.plotting import bem as pbem
    from beat_tpu_torch.plotting import ffi as pffi

    problem, flat = problems("ffi")
    fault = problem.composites["seismic"].fault
    save_fault_geometry(fault, str(tmp_path / "f.pkl"))
    with open(tmp_path / "f.pkl", "rb") as f:
        jfault = pickle.load(f)
    np.testing.assert_array_equal(pbem.fault_patch_quads(fault), jbem.fault_patch_quads(jfault))
    for p, jp in zip(fault.get_all_patches(), jfault.get_all_patches()):
        np.testing.assert_array_equal(pffi._patch_corners(p), jffi._patch_corners(jp))
    point = problem.ordering.to_point(flat[0])
    sf, jsf = fault.get_subfault(0), jfault.get_subfault(0)
    got = pffi.nucleation_position(sf, point, 0)
    # the JAX package's star: the nucleation point [m] scaled by 1e3 more
    ns = float(np.atleast_1d(point["nucleation_strike"])[0])
    nd = float(np.atleast_1d(point["nucleation_dip"])[0])
    sv, dv = jsf.plane.strikevector, jsf.plane.dipvector
    tl = jffi._patch_corners(jsf.plane)[0]
    star = (tl + np.array([sv[0], sv[1], 0.0]) * ns + np.array([dv[0], dv[1], -dv[2]]) * nd)
    np.testing.assert_allclose(got, star, rtol=1e-12)
    jax_star = (tl + np.array([sv[0], sv[1], 0.0]) * ns * 1e3
                + np.array([dv[0], dv[1], -dv[2]]) * nd * 1e3)
    assert np.linalg.norm(jax_star - tl) > 100 * np.linalg.norm(got - tl)
    # on the fault plane: within the plane's extent of its top-left corner
    assert np.linalg.norm(got - tl) <= np.hypot(sf.plane.length, sf.plane.width)


def test_slip_vectors_scatter_as_the_jax_package():
    """``response_slip_vectors`` puts each boundary condition's block of
    the solution into its mesh's slip column, as the JAX package's does."""
    import types

    from beat_tpu.plotting.bem import response_slip_vectors as jax_vectors
    from beat_tpu_torch.plotting.bem import response_slip_vectors

    meshes = [types.SimpleNamespace(ntriangles=n) for n in (3, 4)]
    bcs = [types.SimpleNamespace(slip_component="normal", source_idxs=[0, 1]),
           types.SimpleNamespace(slip_component="strike", source_idxs=[1])]
    slips = np.arange(11.0)
    engine = types.SimpleNamespace(boundary_conditions=bcs)
    got = response_slip_vectors(engine, types.SimpleNamespace(
        meshes=meshes, slips=torch.as_tensor(slips)))
    want = jax_vectors(engine, types.SimpleNamespace(meshes=meshes, slips=slips))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_colormaps_and_geographic_context_equal_the_jax_package(problems):
    import matplotlib.pyplot as plt

    from beat_tpu.plotting import colormap as jcm
    from beat_tpu.plotting.common import add_geographic_context as jax_context
    from beat_tpu_torch.plotting import colormap as pcm
    from beat_tpu_torch.plotting.common import add_geographic_context

    np.testing.assert_array_equal(pcm.slip_colormap(32, True), jcm.slip_colormap(32, True))
    np.testing.assert_array_equal(pcm.roma_colormap(16, True, reverse=True),
                                  jcm.roma_colormap(16, True, reverse=True))
    event = type("E", (), {"lat": 42.3, "lon": 13.4})()
    texts = []
    for fn in (add_geographic_context, jax_context):
        fig, ax = plt.subplots()
        ax.set_xlim(-30, 30)
        ax.set_ylim(-20, 20)
        fn(ax, event)
        texts.append(sorted(t.get_text() for t in ax.texts))
        plt.close(fig)
    assert texts[0] == texts[1] and any("N" in t for t in texts[0])
