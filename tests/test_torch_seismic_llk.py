"""
The port's slice as a whole against the JAX package: the small
two-wavemap FullMT flagship (``beat_tpu_torch.flagship``) built through
both packages from the same numpy observations, then the windows, the
weights, the windowed bases and the per-chain log-likelihoods compared.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu.heart.gftable import build_homogeneous_table as jax_build_table
from beat_tpu.heart.seismic import SeismicDataset as JaxDataset
from beat_tpu.heart.seismic import WaveformMapping as JaxWavemap
from beat_tpu.heart.taper import ArrivalTaper as JaxTaper
from beat_tpu.heart.taper import Filter as JaxFilter
from beat_tpu.models.problem import Problem as JaxProblem
from beat_tpu.models.seismic import SeismicGeometryComposite as JaxComposite
from beat_tpu.sources import MTSource as JaxMTSource
from beat_tpu_torch import flagship
from beat_tpu_torch.convert import greens_table_from_numpy, wavemap_data_from_numpy
from beat_tpu_torch.ops import bilgather
from beat_tpu_torch.sources import sdr_to_m6
from test_torch_common import spy

N_CHAINS = 16
# per-chain llk bar of the JAX package's own float32 checks
# (tests/test_float32_llk.py:101, __graft_entry__.py:261)
LLK_RTOL = 2e-5


def _jax_flagship(port_problem):
    """The same flagship through ``beat_tpu``: the port's observations
    (numpy) go into the JAX datasets, so both see identical raw data."""
    comp = port_problem.composites["seismic"]
    ptable = comp.tables[0]
    table = jax_build_table(distances=ptable.distances, depths=ptable.depths,
                            nt=ptable.nt, dt=ptable.dt)
    wavemaps = []
    for i, pw in enumerate(comp.wavemaps):
        dsets = [JaxDataset(station=d.station, channel=d.channel, east=d.east,
                            north=d.north, ydata=d.ydata) for d in pw.datasets]
        wavemaps.append(JaxWavemap(name=pw.name, datasets=dsets, table=table,
                                   taper=JaxTaper(**flagship.TAPER),
                                   filterer=JaxFilter(**flagship.FILTER), mapnumber=i))
    jcomp = JaxComposite(wavemaps, [JaxMTSource(depth=flagship.TRUE_DEPTH,
                                                magnitude=flagship.TRUE_MAGNITUDE)])
    return JaxProblem(flagship.flagship_priors(), {"seismic": jcomp})


@pytest.fixture(scope="module")
def problems():
    port = flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device="cpu")
    return port, _jax_flagship(port)


@pytest.fixture(scope="module")
def chains(problems):
    port, _ = problems
    lower, upper = port.priors.bounds_arrays()
    rng = np.random.default_rng(11)
    q = rng.uniform(lower, upper, size=(N_CHAINS, lower.size)).astype(np.float32)
    # the true source among them: the data's own best fit
    m6 = sdr_to_m6(*flagship.TRUE_SDR).numpy()
    q[0] = port.ordering.to_array(dict(
        zip(("mnn", "mee", "mdd", "mne", "mnd", "med"), m6),
        magnitude=flagship.TRUE_MAGNITUDE, depth=flagship.TRUE_DEPTH, time=0.0,
        duration=flagship.TRUE_DURATION, h_any_P_0=0.0, h_any_S_1=0.0))
    return q


def _jax_llk(problem, q):
    logp, data = problem.make_logp_fn()
    return np.asarray(jax.jit(jax.vmap(lambda x: logp(x, data)))(jnp.asarray(q)))


def test_orderings_match(problems):
    port, jx = problems
    assert port.ordering.names == jx.ordering.names
    np.testing.assert_array_equal(port.priors.bounds_arrays()[0], jx.priors.bounds_arrays()[0])
    np.testing.assert_array_equal(port.priors.bounds_arrays()[1], jx.priors.bounds_arrays()[1])


@pytest.mark.parametrize("w", [0, 1])
def test_windows_weights_and_bases_match(problems, w):
    """Window starts come from numpy travel times in the port and jnp
    ones in the JAX package: a difference would shift a whole window,
    so starts, data windows and weights must be equal exactly."""
    port, jx = problems
    pw = port.composites["seismic"].wavemaps[w]
    jw = jx.composites["seismic"].wavemaps[w]
    np.testing.assert_array_equal(pw.comp_idx, jw.comp_idx)
    np.testing.assert_array_equal(pw.window_starts, jw.window_starts)
    np.testing.assert_array_equal(pw.data_windows, jw.data_windows)
    pdev = port.composites["seismic"].device_data()[w]
    jdev = jx.composites["seismic"]._device[w]
    np.testing.assert_array_equal(pdev["weights"].numpy(), np.asarray(jdev["weights"]))
    np.testing.assert_array_equal(pdev["slog_pdets"].numpy(), np.asarray(jdev["slog_pdets"]))
    np.testing.assert_array_equal(pdev["win_basis_c"].numpy(), np.asarray(jdev["win_basis"][0]))
    np.testing.assert_array_equal(pdev["win_basis_s"].numpy(), np.asarray(jdev["win_basis"][1]))
    np.testing.assert_array_equal(pdev["filter"].numpy(), np.asarray(jdev["filter"]))


@pytest.mark.parametrize("gather", ["default", "dma"])
def test_llk_matches_jax(problems, chains, monkeypatch, gather):
    """Per-chain llk of the batched port against the vmapped JAX logp,
    on the JAX plain gather and on its Pallas kernel (interpret mode)."""
    port, _ = problems
    if gather == "dma":
        monkeypatch.setenv("BEAT_TPU_MM_GATHER", "dma")
    else:
        monkeypatch.delenv("BEAT_TPU_MM_GATHER", raising=False)
    want = _jax_llk(_jax_flagship(port), chains)
    logp, data = port.make_logp_fn()
    k1c = spy(monkeypatch, bilgather, "_k1c")
    got = logp(torch.as_tensor(chains), data).numpy()
    assert k1c == ["cpu"]                   # one fused gather for both wavemaps
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)


def test_llk_from_converted_jax_data(problems, chains):
    """The port's likelihood on device data converted from the JAX
    composite's own dicts gives the JAX llk."""
    port, jx = problems
    want = _jax_llk(jx, chains)
    jdevs = jax.device_get(jx.composites["seismic"]._device)
    t = jdevs[0]["table"]
    table = greens_table_from_numpy(t.spectra, t.distances, t.depths, t.dt, t.nt, t.t0,
                                    t.vp, t.vs, t.rho, device="cpu")
    data = ([wavemap_data_from_numpy(d, table=table, device="cpu") for d in jdevs],)
    logp, _ = port.make_logp_fn()
    got = logp(torch.as_tensor(chains), data).numpy()
    np.testing.assert_allclose(got, want, rtol=LLK_RTOL)
