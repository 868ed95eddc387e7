"""
What the port's tests share: the thread policy of the CPU runs and the
per-parameter bar of the gradient comparisons.  Importing this module
sets torch's intra-op thread count; it holds no tests of its own and
imports neither JAX nor ``beat_tpu``, so the card-only tests use it too.
"""

import numpy as np
import torch

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pool on these small ops slows every worker
THREADS = 1
torch.set_num_threads(THREADS)


def assert_grad_close(got, want, rtol: float, atol_rel: float) -> None:
    """``|got - want| <= rtol·|want| + atol_rel·max|want[:, k]|`` for every
    chain and parameter k.  The absolute part is per parameter because the
    parameters' gradients differ by orders of magnitude: a bar set by the
    largest would pass any error in the smallest (depth's, the one that
    goes through K2)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bar = rtol * np.abs(want) + atol_rel * np.abs(want).max(axis=0)
    worst = np.unravel_index(np.argmax(np.abs(got - want) - bar), got.shape)
    assert (np.abs(got - want) <= bar).all(), (
        f"chain {worst[0]}, parameter {worst[1]}: {got[worst]} against {want[worst]}, "
        f"bar {bar[worst]}")


def spy(monkeypatch, module, name: str) -> list:
    """Put a wrapper in place of ``module.name`` that records the device
    type of each call's first argument and calls through; returns the
    record.  The tests use it to see which plain versions or kernel
    paths a computation went through on the CPU."""
    fn = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(args[0].device.type)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
    return calls
