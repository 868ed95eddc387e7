"""
What the port's tests share: the thread policy of the CPU runs, the
per-parameter bar of the gradient comparisons, the program's counters
over a block (kernel launches among them), and the eikonal solver's
mixed batch and the plain loop's per-chain counts.  Importing this
module sets torch's intra-op thread count; it holds no tests of its own
and imports neither JAX nor ``beat_tpu``, so the card-only tests use it
too.
"""

import contextlib

import numpy as np
import torch

from beat_tpu_torch import profiling

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's spinning thread pool on these small ops slows every worker
THREADS = 1
torch.set_num_threads(THREADS)


def mixed_batch(n_dip, n_strike, n_chains, seed):
    """Slowness (C, n_dip, n_strike) float32 and nucleation indexes of a
    batch that mixes chains that converge early (fast medium, central
    nucleation: chain 0) with chains that converge late (slow medium,
    corner nucleation: chain 1) and random ones."""
    rng = np.random.default_rng(seed)
    vel = rng.uniform(2000.0, 4000.0, size=(n_chains, n_dip, n_strike))
    vel[0] = 4000.0                                    # fast and uniform
    vel[1] = rng.uniform(500.0, 700.0, size=(n_dip, n_strike))   # slow: late convergence
    nuc_d = rng.integers(0, n_dip, n_chains)
    nuc_s = rng.integers(0, n_strike, n_chains)
    nuc_d[0], nuc_s[0] = n_dip // 2, n_strike // 2
    nuc_d[1], nuc_s[1] = 0, 0
    return (1.0 / vel).astype(np.float32), nuc_d, nuc_s


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


@contextlib.contextmanager
def counters():
    """The program's counters over the block: turns spans on and resets
    them, yields a dict that holds the counters when the block ends
    (``launches.<C entry>`` for each kernel launch, see
    ``kernels/build.py::launch``), then puts the previous setting back."""
    before = profiling.enable_spans(True)
    profiling.reset_spans()
    counts = {}
    try:
        yield counts
    finally:
        counts.update(profiling.span_snapshot()["counters"])
        profiling.enable_spans(before)
        profiling.reset_spans()


def launches(counts: dict) -> dict:
    """The kernel launches among ``counts``, by C entry."""
    return {name.removeprefix("launches."): n for name, n in counts.items()
            if name.startswith("launches.")}


def plain_chain_iterations(slowness, nuc_d, nuc_s, patch_size: float, epsilon: float = 0.1,
                           max_iter: int | None = None) -> tuple:
    """The updates each chain runs in ``eikonal_rupture_times_plain``, from
    the plain update iterated without stopping (a chain's updates before
    its stop are those of the masked loop): a chain's count is its first
    update whose summed squared change is not above ``epsilon`` (a NaN
    change stops it too), else ``max_iter``.  Returns the (C,) int32
    counts and the (C, n) float32 changes of the n updates run, n the
    largest count."""
    from beat_tpu_torch.ops.eikonal import _INIT_TIME, _default_max_iter, _upwind_update

    n_chains, n_dip, n_strike = slowness.shape
    if max_iter is None:
        max_iter = _default_max_iter(n_dip, n_strike)
    fh = slowness * patch_size
    nuc = torch.zeros_like(slowness, dtype=torch.bool)
    nuc[torch.arange(n_chains, device=slowness.device), nuc_d.long(), nuc_s.long()] = True
    times = torch.where(nuc, 0.0, torch.full_like(slowness, _INIT_TIME))
    runs = torch.full((n_chains,), max_iter, dtype=torch.int32, device=slowness.device)
    going = torch.ones(n_chains, dtype=torch.bool, device=slowness.device)
    changes = []
    for it in range(max_iter):
        if not bool(going.any()):
            break
        new = torch.where(nuc, 0.0, _upwind_update(times, fh))
        change = torch.sum((new - times) ** 2, dim=(1, 2))
        changes.append(change)
        stops = going & ~(change > epsilon)
        runs[stops] = it + 1
        going &= ~stops
        times = new
    return runs, (torch.stack(changes, dim=1) if changes
                  else slowness.new_zeros((n_chains, 0)))
