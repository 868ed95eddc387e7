"""
Trans-dimensional Voronoi slip sampling, reversible-jump MCMC (port of
``beat_tpu/ffi/transd.py``), batched over a leading chain axis.

The variable-dimension state of every chain lives in fixed-shape
(C, K_max) tensors, node slots with an ``active`` mask.  A patch's slip
is the value of its nearest active node (inactive nodes sit at +inf
distance in one masked argmin, :func:`masked_voronoi_slips`).  The
moves are those of Bodin & Sambridge (2009): a value perturbation, a
node move, a birth (position and value drawn from the prior) and a
death.  With a uniform prior on k, uniform node positions and births
from the prior, the acceptance is the likelihood ratio; the
constant-likelihood run reproduces the uniform prior on k, which is the
exact check of the birth and death bookkeeping.

Every chain draws its own move each step: all four cheap proposals are
formed for the whole batch and ``torch.where`` keeps each chain's own,
so the likelihood runs once per chain and step.  One Gumbel-max draw
over the (C, K) slots picks the slot of every move (an active one for
value, move and death, an inactive one for a birth).  An invalid
proposal (out of bounds, k at k_min or k_max) is rejected with −inf,
never clipped.  The state is recorded once per ``record_every`` steps.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from beat_tpu_torch.device import DTYPE, resolve
from beat_tpu_torch.ops.voronoi import squared_distances

logger = logging.getLogger("beat_tpu_torch.ffi.transd")

VALUE, MOVE, BIRTH, DEATH = 0, 1, 2, 3


def masked_voronoi_slips(node_s: torch.Tensor, node_d: torch.Tensor, values: torch.Tensor,
                         active: torch.Tensor, patch_s: torch.Tensor,
                         patch_d: torch.Tensor) -> torch.Tensor:
    """Patch slips = the value of the nearest ACTIVE node.

    node_s, node_d, values, active : (..., K) node slots (active 0/1)
    patch_s, patch_d : (N,) patch centres
    Returns (..., N)."""
    d2 = squared_distances(node_s, node_d, patch_s, patch_d)
    d2 = torch.where(active[..., None, :] > 0, d2, torch.inf)
    idx = torch.argmin(d2, dim=-1)
    return torch.gather(values, -1, idx)


@dataclass
class TransDParams:
    """Sampler configuration (the JAX package's ``TransDParams``).

    k_max : node-slot capacity; k_min >= 1.
    value_step, move_step_frac : the value and node-move step scales as
        fractions of the value range and of the plane's extents."""

    k_max: int = 20
    k_min: int = 1
    n_chains: int = 128
    n_steps: int = 2000
    value_step: float = 0.1
    move_step_frac: float = 0.1
    record_every: int = 10
    seed: int = 0


def _masked_choice(gumbel: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(C,) a uniform slot among ``mask`` per row (Gumbel-max)."""
    return torch.argmax(torch.where(mask, gumbel, -torch.inf), dim=-1)


def transd_sample(logp_fn: Callable, patch_s, patch_d, extent_s: tuple, extent_d: tuple,
                  value_bounds: tuple, params: TransDParams, *, device,
                  logp_args: tuple = ()) -> dict:
    """
    Run the trans-dimensional sampler.

    logp_fn : ``(slips (C, N), *logp_args) -> (C,)`` log-likelihood.
    patch_s, patch_d : (N,) patch centres on the fault plane.
    extent_s, extent_d : (lo, hi) node-position bounds.
    value_bounds : (lo, hi) uniform prior on node values.

    Returns a dict of numpy arrays over the second half of the records:
    ``k_trace (n_rec, C)``, ``slip_trace (n_rec, C, N)``, ``llk_trace
    (n_rec, C)``, the ``final_state`` (node_s, node_d, values, active)
    and ``accept_rate``.
    """
    dev = resolve(device)
    K, C = params.k_max, params.n_chains
    ps = torch.as_tensor(np.asarray(patch_s), dtype=DTYPE, device=dev)
    pd = torch.as_tensor(np.asarray(patch_d), dtype=DTYPE, device=dev)
    s_lo, s_hi = (float(x) for x in extent_s)
    d_lo, d_hi = (float(x) for x in extent_d)
    v_lo, v_hi = (float(x) for x in value_bounds)
    move_s = params.move_step_frac * (s_hi - s_lo)
    move_d = params.move_step_frac * (d_hi - d_lo)
    value_step = params.value_step * (v_hi - v_lo)

    # the start: k_min .. k_min + 2 active nodes a chain, uniform everywhere
    rng = np.random.default_rng(params.seed)
    k0 = rng.integers(params.k_min, min(params.k_min + 3, K) + 1, size=C)
    active0 = (np.arange(K)[None, :] < k0[:, None]).astype(np.float32)
    node_s0 = rng.uniform(s_lo, s_hi, (C, K)).astype(np.float32)
    node_d0 = rng.uniform(d_lo, d_hi, (C, K)).astype(np.float32)
    values0 = rng.uniform(v_lo, v_hi, (C, K)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(params.seed)

    def to_dev(x):
        return torch.as_tensor(x, device=dev)

    node_s, node_d, values, active = map(to_dev, (node_s0, node_d0, values0, active0))

    def chain_logp(ns, nd, vals, act):
        return logp_fn(masked_voronoi_slips(ns, nd, vals, act, ps, pd), *logp_args)

    def rand(*shape):
        return torch.rand(shape, generator=gen, dtype=DTYPE, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=DTYPE, device=dev)

    every = max(int(params.record_every), 1)
    n_rec = params.n_steps // every
    k_tr = torch.empty((n_rec, C), dtype=DTYPE, device=dev)
    slip_tr = torch.empty((n_rec, C, ps.shape[0]), dtype=DTYPE, device=dev)
    llk_tr = torch.empty((n_rec, C), dtype=DTYPE, device=dev)
    n_acc = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        llk = chain_logp(node_s, node_d, values, active)
        for step in range(n_rec * every):
            moves = torch.randint(0, 4, (C, 1), generator=gen, device=dev)
            is_value, is_move, is_birth, is_death = (moves == m for m in range(4))
            k = active.sum(dim=-1, keepdim=True)
            on = active > 0
            gumbel = -torch.log(-torch.log(rand(C, K)))
            slot_on = torch.nn.functional.one_hot(_masked_choice(gumbel, on), K).bool()
            slot_off = torch.nn.functional.one_hot(_masked_choice(gumbel, ~on), K).bool()
            dv, dsd, u = value_step * randn(C, 1), randn(C, 2), rand(C, 3)
            # the four proposals at once; each chain keeps its own move's
            v_new = values + dv
            s_new = node_s + move_s * dsd[:, :1]
            d_new = node_d + move_d * dsd[:, 1:]
            born = is_birth & slot_off
            p_values = torch.where(is_value & slot_on, v_new, values)
            p_values = torch.where(born, v_lo + u[:, 2:] * (v_hi - v_lo), p_values)
            p_s = torch.where(is_move & slot_on, s_new, node_s)
            p_s = torch.where(born, s_lo + u[:, :1] * (s_hi - s_lo), p_s)
            p_d = torch.where(is_move & slot_on, d_new, node_d)
            p_d = torch.where(born, d_lo + u[:, 1:2] * (d_hi - d_lo), p_d)
            p_active = torch.where(born, 1.0, torch.where(is_death & slot_on, 0.0, active))

            def picked(x):
                return torch.sum(torch.where(slot_on, x, 0.0), dim=-1, keepdim=True)

            v_j, s_j, d_j = picked(v_new), picked(s_new), picked(d_new)
            ok = torch.where(is_value, (v_j >= v_lo) & (v_j <= v_hi),
                 torch.where(is_move, (s_j >= s_lo) & (s_j <= s_hi)
                             & (d_j >= d_lo) & (d_j <= d_hi),
                             torch.where(is_birth, k < K, k > params.k_min)))[:, 0]
            llk_prop = chain_logp(p_s, p_d, p_values, p_active)
            # births from the prior, a uniform prior on k: the ratio is L'/L
            log_r = torch.where(ok, llk_prop - llk, -torch.inf)
            accept = torch.log(rand(C)) < log_r
            keep = accept[:, None]
            node_s = torch.where(keep, p_s, node_s)
            node_d = torch.where(keep, p_d, node_d)
            values = torch.where(keep, p_values, values)
            active = torch.where(keep, p_active, active)
            llk = torch.where(accept, llk_prop, llk)
            n_acc += accept.sum()
            if (step + 1) % every == 0:
                rec = step // every
                k_tr[rec] = active.sum(dim=-1)
                slip_tr[rec] = masked_voronoi_slips(node_s, node_d, values, active, ps, pd)
                llk_tr[rec] = llk

    half = slice(n_rec // 2, None)              # the first half is burn-in
    out = {
        "k_trace": k_tr[half].cpu().numpy(),
        "slip_trace": slip_tr[half].cpu().numpy(),
        "llk_trace": llk_tr[half].cpu().numpy(),
        "final_state": tuple(x.cpu().numpy() for x in (node_s, node_d, values, active)),
        "accept_rate": int(n_acc) / max(n_rec * every * C, 1),
    }
    logger.info("trans-d sampling done: accept %.3f, k mean %.2f", out["accept_rate"],
                float(out["k_trace"].mean()) if out["k_trace"].size else float("nan"))
    return out
