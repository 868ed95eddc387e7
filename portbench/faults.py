"""
Faults planted under the timed path, to see ``correct`` come out false
(``tests/test_portbench_faults.py`` on the CPU, ``control.py --fault``
on the card).  Each takes the built problem, breaks the program in
place and returns the function that undoes it.
"""

from __future__ import annotations

import functools

import torch


def _wrap_logp(problem, change):
    original = problem.make_logp_fn

    @functools.wraps(original)
    def make_logp_fn(*a, **k):
        logp, data = original(*a, **k)

        def broken(q, *args):
            return change(logp, q, *args)
        return broken, data

    problem.make_logp_fn = make_logp_fn
    return lambda: setattr(problem, "make_logp_fn", original)


def stuck_step(problem):
    """Every Metropolis step returns its state unchanged."""
    from beat_tpu_torch.samplers import metropolis

    original = metropolis.metropolis_step

    def step(logp_fn, state, *a, **k):
        return state

    metropolis.metropolis_step = step
    return lambda: setattr(metropolis, "metropolis_step", original)


def half_batch(problem):
    """The likelihood evaluates the first half of the chains only and
    gives the others the mean over that half."""
    def change(logp, q, *args):
        n = q.shape[0]
        first = logp(q[: (n + 1) // 2], *args)
        return torch.cat([first, first.mean().expand(n - first.shape[0])])
    return _wrap_logp(problem, change)


def altered_answer(problem):
    """Every seventh chain's log-likelihood comes out 1e-3 of its size off."""
    def change(logp, q, *args):
        out = logp(q, *args).clone()
        out[::7] += 1e-3 * out[::7].abs() + 1.0
        return out
    return _wrap_logp(problem, change)


FAULTS = {"stuck_step": stuck_step, "half_batch": half_batch, "altered_answer": altered_answer}
