"""
The gradient path of the port against the JAX package: per-chain
∂llk/∂q of the small FullMT flagship through the port's batched
value-and-grad (the autograd pair of K1c and K2c, plain versions on the
CPU) against ``jax.vmap(jax.grad(logp))`` on both JAX gather paths —
the default XLA gather and the Pallas kernel with its ``custom_vjp``
(interpret mode).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from beat_tpu_torch import flagship
from beat_tpu_torch.ops import bilgather
from beat_tpu_torch.samplers import value_and_grad
from test_torch_seismic_llk import _jax_flagship
from test_torch_common import assert_grad_close, counters, launches, spy

N_CHAINS = 16
# the JAX package's bar between its gather paths' gradients is rtol 5e-3,
# atol 5e-3·max|grad| (tests/test_bilgather.py:219-221); here the atol is
# per parameter (depth's gradient, the one through K2, is 1e-5 of the
# largest), and since the port measures ≤ 4e-5 of each parameter's
# max|grad| against either path (depth's 7e-6), the bar is tightened to
# rtol 1e-3, atol 1e-4·max|grad[:, k]|
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def port():
    return flagship.build_flagship(**flagship.TEST_SIZE, seed=3, device="cpu")


@pytest.fixture(scope="module")
def chains(port):
    """Chains inside the box, 1 % off every bound: JAX's ``clip`` and
    torch's ``clamp`` pass different gradients at exact equality."""
    lower, upper = port.priors.bounds_arrays()
    span = upper - lower
    rng = np.random.default_rng(11)
    return rng.uniform(lower + 0.01 * span, upper - 0.01 * span,
                       size=(N_CHAINS, lower.size)).astype(np.float32)


@pytest.mark.parametrize("gather", ["default", "dma"])
def test_per_chain_gradient_matches_jax(port, chains, monkeypatch, gather):
    if gather == "dma":
        monkeypatch.setenv("BEAT_TPU_MM_GATHER", "dma")
    else:
        monkeypatch.delenv("BEAT_TPU_MM_GATHER", raising=False)
    jlogp, jdata = _jax_flagship(port).make_logp_fn()
    want = np.asarray(jax.jit(jax.vmap(jax.grad(lambda x: jlogp(x, jdata))))(
        jnp.asarray(chains)))
    logp, data = port.make_logp_fn()
    k1c, k2c = spy(monkeypatch, bilgather, "_k1c"), spy(monkeypatch, bilgather, "_k2c")
    with counters() as counts:
        llk, got = value_and_grad(logp, torch.as_tensor(chains), (data,))
    assert not llk.requires_grad and not got.requires_grad
    assert_grad_close(got.numpy(), want, GRAD_RTOL, GRAD_ATOL_REL)
    # the forward went through K1c and the backward through K2c, on the
    # CPU as their plain versions: no kernel launches
    assert k1c == ["cpu"] and k2c == ["cpu"]
    assert launches(counts) == {}
