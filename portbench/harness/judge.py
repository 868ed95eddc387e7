"""
The comparison that decides ``correct``: what the timed calls wrote to
their stage files, held against the plain reference and against the
stage arithmetic of transitional MCMC, once the window has closed.

Numbers (each with its limit in the cell's file, ``limits``):

``llk_gap``         the widest gap, over a sample of rows drawn from the
                    seed (the start population and the traces of every
                    stage of every call), between the program's
                    log-likelihood of a row and the reference's, over the
                    sum of the magnitudes of the reference's terms
``beta_gap``        the widest gap between a stage's β and the β the
                    bisection gives from the stage before it
``resample_miss``   parents whose number of children no systematic
                    resample of the stage's importance weights gives
``accept_miss``     moves that the trace shows and the acceptance count
                    does not (or the reverse), the start of each stage
                    taken as the parents' rows of the stage before: a
                    wrong row gather shows here
``still_share``     the share of the last Metropolis stage's chains whose
                    last recorded row is still their start row (cells
                    whose sound chains move: there a stuck step shows)
``fit_shortfall``   (converged cells) how far the reference's
                    log-likelihood of the final stage's best row falls
                    below the true source's, over the latter's scale,
                    each with its noise scales h at their best for its
                    residuals: a population that never moved fits far
                    worse than the source behind the data
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from portbench.reference.common import (importance_weights, next_beta,
                                        systematic_count_violations)


def load_stages(homepath: str) -> list:
    """Every stage a call wrote, in order: dicts of the state's arrays,
    ``beta`` and the trace's ``q`` and ``llk``."""
    stages = []
    for d in glob.glob(os.path.join(homepath, "stage_*")):
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(d, "state.npz")) as z:
            st = {k: z[k] for k in z.files}
        with np.load(os.path.join(d, "trace.npz")) as z:
            st["q"], st["llk"] = z["q"], z["llk"]
        st.update(meta["scalars"])
        stages.append(st)
    return sorted(stages, key=lambda s: int(s["stage"]))


def stage_checks(stages: list, traffic: dict) -> dict:
    """β, resampling and acceptance against the stage arithmetic."""
    out = {"beta_gap": 0.0, "resample_miss": 0, "accept_miss": 0, "still_share": 0.0}
    if not stages or float(stages[0]["beta"]) != 0.0:
        out["beta_gap"] = float("inf")
        return out
    every = max(int(traffic["buffer_thinning"]), 1)
    for prev, st in zip(stages, stages[1:]):
        beta = float(st["beta"])
        expected = next_beta(float(prev["beta"]), prev["likelihoods"], traffic["coef_variation"])
        out["beta_gap"] = max(out["beta_gap"], abs(beta - expected))
        weights = importance_weights(float(prev["beta"]), beta, prev["likelihoods"])
        parents = st["resampling_indexes"]
        out["resample_miss"] += systematic_count_violations(weights, parents)
        n_chains = parents.size
        n_steps = int(traffic["n_steps"])
        accepted = int(round(float(st["acceptance"][-1]) * n_steps * n_chains))
        start = prev["population"][parents].astype(np.float32)
        seq = np.concatenate([start[None], st["q"]], axis=0)
        moved = int(np.any(seq[1:] != seq[:-1], axis=-1).sum())
        out["still_share"] = float(np.mean(np.all(st["q"][-1] == start, axis=-1)))
        if every == 1:
            out["accept_miss"] += abs(moved - accepted)
        else:
            out["accept_miss"] += max(0, moved - accepted) + max(0, accepted - every * moved)
    return out


def sample_rows(stages_by_call: list, n_rows: int, rng: np.random.Generator) -> tuple:
    """``(q (R, dim), llk (R,))``: rows drawn from the seed over every
    start population and every trace record of every call."""
    pools = []
    for stages in stages_by_call:
        if stages:
            pools.append((stages[0]["population"][None], stages[0]["likelihoods"][None]))
        for st in stages[1:]:
            pools.append((st["q"], st["llk"]))
    sizes = np.array([q.shape[0] * q.shape[1] for q, _ in pools])
    picks = rng.choice(sizes.sum(), size=min(n_rows, int(sizes.sum())), replace=False)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    q_rows, llk_rows = [], []
    for k in np.sort(picks):
        i = int(np.searchsorted(offsets, k, side="right") - 1)
        q, llk = pools[i]
        r, c = divmod(int(k - offsets[i]), q.shape[1])
        q_rows.append(q[r, c])
        llk_rows.append(llk[r, c])
    return np.asarray(q_rows, dtype=np.float32), np.asarray(llk_rows, dtype=np.float64)


def reference_llk(reference, q: np.ndarray, block: int) -> tuple:
    """The reference's ``(llk, scale, alternative)`` of rows, in blocks."""
    parts = [reference.llk(q[i:i + block]) for i in range(0, len(q), block)]
    llk = np.concatenate([p[0] for p in parts])
    scale = np.concatenate([p[1] for p in parts])
    alt = (np.concatenate([p[2] for p in parts]) if len(parts[0]) > 2
           else np.full_like(llk, np.nan))
    return llk, scale, alt


def llk_gaps(port_llk: np.ndarray, llk: np.ndarray, scale: np.ndarray,
             alt: np.ndarray) -> np.ndarray:
    gap = np.abs(port_llk - llk) / scale
    alt_gap = np.abs(port_llk - alt) / scale
    return np.where(np.isfinite(alt_gap), np.minimum(gap, alt_gap), gap)


def judge(cfg_module, config: dict, inputs: dict, homepaths: list, traffic: dict,
          cell: dict, rng: np.random.Generator, device) -> dict:
    """The numbers of the comparison: ``{name: value}``."""
    stages_by_call = [load_stages(h) for h in homepaths]
    numbers = {"beta_gap": 0.0, "resample_miss": 0, "accept_miss": 0, "still_share": 0.0}
    for stages in stages_by_call:
        for k, v in stage_checks(stages, traffic).items():
            numbers[k] = max(numbers[k], v) if k in ("beta_gap", "still_share") else numbers[k] + v
    judge_cfg = cell["judge"]
    q, port_llk = sample_rows(stages_by_call, judge_cfg["rows"], rng)
    reference = cfg_module.Reference(config, inputs, device)
    llk, scale, alt = reference_llk(reference, q, judge_cfg["block"])
    numbers["llk_gap"] = float(np.max(llk_gaps(port_llk, llk, scale, alt)))
    if judge_cfg.get("fit"):
        t_llk, t_scale = reference.profile_llk(cfg_module.true_row(config)[None])
        shortfall = []
        for stages in stages_by_call:
            final = stages[-1]
            r, c = np.unravel_index(int(np.argmax(final["llk"])), final["llk"].shape)
            b_llk, _ = reference.profile_llk(final["q"][r, c][None])
            shortfall.append(float((t_llk[0] - b_llk[0]) / t_scale[0]))
        numbers["fit_shortfall"] = max(shortfall)
    del reference
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return numbers
