"""
The port's GF table and forward (``beat_tpu_torch.heart.gftable``,
``ops/cplx.py``, ``heart/taper.py``) against the JAX package on the same
numpy inputs, on the CPU.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from beat_tpu.heart.gftable import GreensTable as JaxTable
from beat_tpu.heart.gftable import build_homogeneous_table as jax_build_table
from beat_tpu.heart.gftable import rotate_m6_to_ray_frame as jax_rotate
from beat_tpu.heart.taper import stf_spectrum_pair as jax_stf
from beat_tpu.ops import cplx as jcplx
from beat_tpu_torch.heart.gftable import GreensTable, build_homogeneous_table, rotate_m6_to_ray_frame
from beat_tpu_torch.heart.taper import stf_spectrum_pair
from beat_tpu_torch.ops import cplx
import test_torch_common  # noqa: F401  (the tests' thread policy)

GRID = dict(distances=np.linspace(10e3, 215e3, 11), depths=np.linspace(1e3, 29e3, 5),
            nt=128, dt=0.5)
# gathered spectra: the JAX package's bar (tests/test_seismic.py:349-357)
GATHER_ATOL_REL = 2e-6
# synthesized spectra and windows (tests/test_seismic.py:389-399)
SYNTH_RTOL, SYNTH_ATOL_REL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def tables():
    return build_homogeneous_table(**GRID, device="cpu"), jax_build_table(**GRID)


def test_homogeneous_builder_matches_jax(tables):
    port, jx = tables
    np.testing.assert_allclose(port.spectra.numpy(), np.asarray(jx.spectra), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jx.spectra)).max())


@pytest.mark.parametrize("with_tt", [False, True])
def test_load_reads_jax_saved_table(tmp_path, with_tt):
    jx = jax_build_table(distances=np.linspace(20e3, 60e3, 5), depths=[2e3, 4e3, 6e3],
                         nt=32, dt=0.5)
    if with_tt:
        jx.tt_p = np.random.default_rng(0).uniform(1, 10, (5, 3))
        jx.tt_s = 1.7 * jx.tt_p
    path = str(tmp_path / "gf_table.npz")
    jx.save(path)
    port = GreensTable.load(path, device="cpu")
    np.testing.assert_array_equal(port.spectra.numpy(), np.asarray(jx.spectra))
    np.testing.assert_array_equal(port.distances, jx.distances)
    np.testing.assert_array_equal(port.depths, jx.depths)
    assert (port.dt, port.nt, port.t0, port.vp, port.vs, port.rho) == \
        (jx.dt, jx.nt, jx.t0, jx.vp, jx.vs, jx.rho)
    dist = np.array([21e3, 37.5e3, 60e3])
    np.testing.assert_allclose(port.travel_time("any_S", dist, 3.3e3),
                               np.asarray(jx.travel_time("any_S", jnp.asarray(dist), 3.3e3)),
                               rtol=1e-6)


def test_cplx_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 4, 9, 2)).astype(np.float32)
    phase = rng.normal(size=(4, 9)).astype(np.float32)
    np.testing.assert_allclose(cplx.cmul(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
                               np.asarray(jcplx.cmul(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cplx.cexp(torch.as_tensor(phase)).numpy(),
                               np.asarray(jcplx.cexp(jnp.asarray(phase))), rtol=1e-6, atol=1e-6)
    for nt in (16, 17):
        for mine, theirs in zip(cplx.irfft_basis(nt) + cplx.rfft_basis(nt),
                                jcplx.irfft_basis(nt) + jcplx.rfft_basis(nt)):
            np.testing.assert_array_equal(mine, theirs)
    IC, IS = (torch.as_tensor(m) for m in cplx.irfft_basis(16))
    spec = np.fft.rfft(rng.normal(size=(3, 16)))
    pair = cplx.from_np_complex(spec)
    np.testing.assert_array_equal(pair, jcplx.from_np_complex(spec))
    np.testing.assert_allclose(cplx.irfft_pair(torch.as_tensor(pair), IC, IS).numpy(),
                               np.fft.irfft(spec, n=16), atol=1e-5)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    C, S = cplx.rfft_basis(16)
    np.testing.assert_allclose(
        cplx.amplitude_spectrum(torch.as_tensor(x), torch.as_tensor(C), torch.as_tensor(S)).numpy(),
        np.asarray(jcplx.amplitude_spectrum(jnp.asarray(x), jnp.asarray(C), jnp.asarray(S))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stf_type", ["Boxcar", "Triangular", "HalfSinusoid"])
def test_stf_spectrum_pair_matches_jax(stf_type):
    freqs = np.fft.rfftfreq(128, 0.5).astype(np.float32)   # holds 0.5 Hz: w·d = π at d = 1
    durations = np.array([1.0, 0.3, 2.7, 5e-5], dtype=np.float32)
    got = stf_spectrum_pair(torch.as_tensor(freqs), torch.as_tensor(durations), stf_type)
    for i, d in enumerate(durations):
        want = np.asarray(jax_stf(jnp.asarray(freqs), jnp.float32(d), stf_type))
        assert np.isfinite(got[i].numpy()).all()
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-5, atol=1e-6)


def test_rotate_m6_matches_jax():
    rng = np.random.default_rng(2)
    m6 = rng.normal(size=(5, 6)).astype(np.float32)
    az = rng.uniform(-np.pi, np.pi, 5).astype(np.float32)
    np.testing.assert_allclose(
        rotate_m6_to_ray_frame(torch.as_tensor(m6), torch.as_tensor(az)).numpy(),
        np.asarray(jax_rotate(jnp.asarray(m6), jnp.asarray(az))), rtol=1e-5, atol=1e-6)


def _queries(table, n_chains, n_targets, seed, on_grid=False):
    rng = np.random.default_rng(seed)
    if on_grid:    # grid nodes, the top ones included
        dist = rng.choice(table.distances, (n_chains, n_targets)).astype(np.float32)
        depth = rng.choice(table.depths, n_chains).astype(np.float32)
        dist[:, 0], depth[0] = table.distances[-1], table.depths[-1]
    else:
        dist = rng.uniform(table.distances[0], table.distances[-1],
                           (n_chains, n_targets)).astype(np.float32)
        depth = rng.uniform(table.depths[0], table.depths[-1], n_chains).astype(np.float32)
    comp = rng.integers(0, 3, n_targets).astype(np.int32)
    return dist, depth, comp


@pytest.mark.parametrize("on_grid", [False, True])
def test_gather_spectra_matches_jax(tables, on_grid):
    port, jx = tables
    dist, depth, comp = _queries(port, 3, 8, seed=5, on_grid=on_grid)
    got = port.gather_spectra(torch.as_tensor(dist), torch.as_tensor(depth),
                              torch.as_tensor(comp)).numpy()
    scale = np.abs(np.asarray(jx.spectra)).max()
    for c in range(dist.shape[0]):
        want = np.asarray(jx.gather_spectra(jnp.asarray(dist[c]), jnp.float32(depth[c]),
                                            jnp.asarray(comp)))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=GATHER_ATOL_REL * scale)
    if on_grid:   # a node query returns the table row itself
        i = int(np.searchsorted(port.distances, dist[0, 0]))
        np.testing.assert_allclose(got[0, 0], port.spectra[:, comp[0], i, -1].numpy(),
                                   rtol=2e-6, atol=0)


def test_gather_single_node_axis_matches_jax():
    grid = dict(distances=np.linspace(20e3, 80e3, 4), depths=[7e3], nt=32, dt=0.5)
    port, jx = build_homogeneous_table(**grid, device="cpu"), jax_build_table(**grid)
    dist, depth, comp = _queries(port, 2, 6, seed=9)
    got = port.gather_spectra(torch.as_tensor(dist), torch.as_tensor(depth),
                              torch.as_tensor(comp)).numpy()
    scale = np.abs(np.asarray(jx.spectra)).max()
    for c in range(2):
        want = np.asarray(jx.gather_spectra(jnp.asarray(dist[c]), jnp.float32(depth[c]),
                                            jnp.asarray(comp)))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=GATHER_ATOL_REL * scale)


def test_synthesis_and_fused_windows_match_jax(tables):
    port, jx = tables
    rng = np.random.default_rng(7)
    C, T, W = 3, 6, 42
    m6 = (rng.normal(size=(C, 6)) * 1e17).astype(np.float32)
    east, north = (rng.uniform(-3e3, 3e3, C).astype(np.float32) for _ in range(2))
    depth = rng.uniform(2e3, 25e3, C).astype(np.float32)
    tshift = rng.uniform(-2, 2, C).astype(np.float32)
    # The half-sinusoid STF, π²·cos(wd/2) / (π² − (wd)²), is 0/0 near
    # w·d = π: there a one-ulp difference between XLA's and torch's
    # float32 cos grows to ~1e-5 relative within ~0.01 rad of the pole.
    # So no frequency bin lies that close for these durations; the pole
    # itself (d = 1 s hits a bin exactly and takes the safe branch in
    # both packages) is covered by test_stf_spectrum_pair_matches_jax.
    dur = np.array([1.0, 2.5, 3.7], dtype=np.float32)
    wd = 2 * np.pi * port.freqs.numpy()[None, :] * dur[:, None]
    off_pole = np.abs(np.pi**2 - wd**2) >= 1e-6
    assert np.abs(wd - np.pi)[off_pole].min() > 0.02
    az = rng.uniform(0, 2 * np.pi, T)
    r = rng.uniform(40e3, 150e3, T)
    st_e, st_n = (r * np.sin(az)).astype(np.float32), (r * np.cos(az)).astype(np.float32)
    comp = rng.integers(0, 3, T).astype(np.int32)
    filt = cplx.from_np_complex(np.exp(-1j * rng.uniform(0, 1, port.nf)))
    starts = rng.integers(0, port.nt - W, T)
    taper = np.hanning(W)

    t = torch.as_tensor
    spec = port.synthesize_spectra(t(m6), t(east), t(north), t(depth), t(tshift), t(dur),
                                   t(st_e), t(st_n), t(comp), filter_response=t(filt))
    wins = port.synthesize_windows_fused(spec, *port.windowed_ibasis(starts, taper, W))
    ICw, ISw = jx.windowed_ibasis(starts, taper, W)
    for c in range(C):
        want = np.asarray(jx.synthesize_spectra(
            jnp.asarray(m6[c]), east[c], north[c], jnp.float32(depth[c]), tshift[c], dur[c],
            jnp.asarray(st_e), jnp.asarray(st_n), jnp.asarray(comp),
            filter_response=jnp.asarray(filt)))
        np.testing.assert_allclose(spec[c].numpy(), want, rtol=SYNTH_RTOL,
                                   atol=SYNTH_ATOL_REL * np.abs(want).max())
        want_w = np.asarray(JaxTable.synthesize_windows_fused(jnp.asarray(want), ICw, ISw))
        np.testing.assert_allclose(wins[c].numpy(), want_w, rtol=SYNTH_RTOL,
                                   atol=SYNTH_ATOL_REL * np.abs(want_w).max())
