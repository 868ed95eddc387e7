"""
The port's layered velocity models (``beat_tpu_torch/heart/velocity_model.py``)
against the JAX package's on the same inputs: nd text both ways,
earth flattening, the ak135-f join, ``.npz`` files read by either package,
the earth-model ensembles of one seed, and the travel times of the
vectorized ray tracer against the JAX package's one-receiver tracer.

Bars: the models are the same host float64 code, so their arrays are
equal; the vectorized tracer runs the same bisection on all receivers at
once (its sums reduce along an axis instead of over a 1-D array), rtol
1e-12.
"""

import numpy as np
import pytest

from beat_tpu.heart import velocity_model as jvm
from beat_tpu_torch import convert
from beat_tpu_torch.heart import velocity_model as vm

TT_RTOL = 1e-12


def _pairs():
    """(port model, JAX model) pairs: a homogeneous one, the default
    crust, ak135-f average and the 31-layer flattened crust + ak135."""
    crust_j = jvm.LayeredModel.default_crust()
    joined = jvm.join_nd_with_ak135(crust_j.to_nd())
    return [
        (vm.LayeredModel.homogeneous(), jvm.LayeredModel.homogeneous()),
        (vm.LayeredModel.default_crust(), crust_j),
        (vm.LayeredModel.ak135_f_average(), jvm.LayeredModel.ak135_f_average()),
        (vm.LayeredModel.from_nd(vm.join_nd_with_ak135(vm.LayeredModel.default_crust().to_nd()))
         .earth_flattened(), jvm.LayeredModel.from_nd(joined).earth_flattened()),
    ]


def _assert_same_model(p, j):
    for attr in ("tops", "vp", "vs", "rho"):
        np.testing.assert_array_equal(getattr(p, attr), getattr(j, attr))
    for attr in ("qp", "qs"):
        a, b = getattr(p, attr), getattr(j, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(4))
def test_models_equal_jax(i):
    p, j = _pairs()[i]
    _assert_same_model(p, j)
    assert p.to_nd() == j.to_nd()
    for z in (0.0, 1e3, 20e3, 36e3, 500e3):
        assert p.properties_at(z) == j.properties_at(z)


@pytest.mark.parametrize("i", range(4))
def test_nd_round_trip(i):
    p, _ = _pairs()[i]
    back = vm.LayeredModel.from_nd(p.to_nd())
    np.testing.assert_allclose(back.tops, p.tops, rtol=1e-5)
    np.testing.assert_allclose(back.vp, p.vp, rtol=1e-5)
    np.testing.assert_allclose(back.rho, p.rho, rtol=1e-5)


def test_ak135_texts_and_join_equal_jax():
    crust = vm.LayeredModel.default_crust().to_nd()
    assert vm.ak135_f_average_nd_text() == jvm.ak135_f_average_nd_text()
    assert vm.ak135_f_average_nd_text(200e3) == jvm.ak135_f_average_nd_text(200e3)
    assert vm.join_nd_with_ak135(crust) == jvm.join_nd_with_ak135(crust)
    flat = vm.LayeredModel.from_nd(vm.join_nd_with_ak135(crust)).earth_flattened()
    assert flat.nlayers == 31


def test_npz_files_read_by_either_package(tmp_path):
    p, j = _pairs()[3]
    p.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "jax.npz"))
    _assert_same_model(vm.LayeredModel.load(str(tmp_path / "jax.npz")), j)
    _assert_same_model(p, jvm.LayeredModel.load(str(tmp_path / "port.npz")))
    carried = convert.layered_model_from_numpy(j.tops, j.vp, j.vs, j.rho, j.name, j.qp, j.qs)
    _assert_same_model(carried, j)


def test_ensembles_of_one_seed_equal_jax():
    p, j = _pairs()[1]
    ours = vm.ensemble_earthmodels(p, num_vary=6, rng=np.random.default_rng(7))
    theirs = jvm.ensemble_earthmodels(j, num_vary=6, rng=np.random.default_rng(7))
    for a, b in zip(ours, theirs):
        _assert_same_model(a, b)
    a, cost_a = vm.vary_model(p, 0.2, 0.2, rng=np.random.default_rng(3))
    b, cost_b = jvm.vary_model(j, 0.2, 0.2, rng=np.random.default_rng(3))
    _assert_same_model(a, b)
    assert cost_a == cost_b


@pytest.mark.parametrize("phase", ["p", "s"])
@pytest.mark.parametrize("i", [1, 3])
def test_travel_times_match_jax(i, phase):
    p, j = _pairs()[i]
    distances = np.concatenate([[0.0], np.linspace(1e3, 400e3, 60)])
    for zs in (1e3, 9e3, 21e3, 40e3):
        want = jvm.travel_times(j, zs, distances, phase)
        np.testing.assert_allclose(vm.travel_times(p, zs, distances, phase), want,
                                   rtol=TT_RTOL)
        t, ray_p, _ = vm.first_arrivals(p, zs, distances, phase)
        np.testing.assert_allclose(ray_p, [jvm.first_arrival(j, zs, x, phase)[2]
                                           for x in distances], rtol=TT_RTOL, atol=0.0)
