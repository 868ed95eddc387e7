"""
Stage checkpoints of the samplers (copied from ``beat_tpu/backend.py``,
trimmed to what the port calls).

The files are those of the JAX package, so either package reads the
other's runs: the ``.npz`` container, its members and their decompressed
bytes are numpy's (``np.savez_compressed``), but each member's deflate
stream is written in chunks on a pool of host threads
(:mod:`beat_tpu_torch.npzwrite`), so its compressed bytes differ:

    <homepath>/stage_<n>/trace.npz   q (n_rec, n_chains, dim) f32, llk f32
    <homepath>/stage_<n>/state.npz   the array entries of the stage state
    <homepath>/stage_<n>/meta.json   scalars, trace shapes, varnames

``stage_-1`` is the final (β = 1) stage.  A stage is valid iff its npz
files load and their shapes match ``meta.json``.

The posterior summary of a stage — mean, sd, highest-density interval,
bulk effective sample size and split-R̂ per variable — and the bounds a
later run imports from it are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile

import numpy as np

from beat_tpu_torch.npzwrite import savez_deflated, shared_pool
from beat_tpu_torch.profiling import count, span

logger = logging.getLogger("beat_tpu_torch.backend")


def _atomic_save(path: str, **arrays) -> int:
    """Write an npz atomically (tmp file + rename) so crashes can't corrupt;
    returns the bytes deflated on the pool (:func:`savez_deflated`)."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    # the suffix marks a write that never finished, as the JAX package's does
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        pooled = savez_deflated(tmp, arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return pooled


class StageTrace:
    """In-memory view of one stage's sampled trace."""

    def __init__(self, q_trace: np.ndarray, llk_trace: np.ndarray, varnames=None,
                 ordering=None):
        # q_trace: (n_records, n_chains, dim); llk_trace: (n_records, n_chains)
        self.q_trace = q_trace
        self.llk_trace = llk_trace
        self.varnames = varnames or []
        self.ordering = ordering

    @property
    def n_chains(self) -> int:
        return self.q_trace.shape[1]

    @property
    def n_records(self) -> int:
        return self.q_trace.shape[0]

    def get_values(self, varname: str, combine: bool = True, burn: int = 0, thin: int = 1):
        """One variable's samples, (n_records·n_chains, ...) combined or
        (n_records, n_chains, ...)."""
        if self.ordering is None or varname not in self.ordering:
            raise KeyError(varname)
        spec = self.ordering[varname]
        vals = self.q_trace[burn::thin, :, spec.slc]
        if spec.shape == ():
            vals = vals[..., 0]
        if combine:
            vals = vals.reshape((-1,) + vals.shape[2:])
        return vals

    def end_points(self):
        """Last sample of every chain: (population (n_chains, dim), llks)."""
        return self.q_trace[-1], self.llk_trace[-1]


class SampleStage:
    """Stage directory manager."""

    def __init__(self, homepath: str, ordering=None):
        self.homepath = homepath
        self.ordering = ordering
        os.makedirs(homepath, exist_ok=True)

    def stage_path(self, stage: int) -> str:
        return os.path.join(self.homepath, f"stage_{stage}")

    def _trace_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "trace.npz")

    def _state_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "state.npz")

    def _meta_file(self, stage: int) -> str:
        return os.path.join(self.stage_path(stage), "meta.json")

    def save_stage(self, stage: int, trace: dict, state: dict) -> None:
        """Persist one finished stage.

        trace: {"q": (n_rec, n_chains, dim), "llk": (n_rec, n_chains)}
        state: json-serialisable scalars + numpy arrays (split here)."""
        arrays = {k: np.asarray(v) for k, v in state.items() if isinstance(v, np.ndarray)}
        scalars = {k: v for k, v in state.items() if not isinstance(v, np.ndarray)}
        traced = {"q": np.asarray(trace["q"], dtype=np.float32),
                  "llk": np.asarray(trace["llk"], dtype=np.float32)}
        with span("stage.write", stage=stage, workers=shared_pool()[1]):
            count("stage.bytes", sum(a.nbytes for a in (*traced.values(), *arrays.values())))
            count("stage.pool_bytes", _atomic_save(self._trace_file(stage), **traced)
                  + _atomic_save(self._state_file(stage), **arrays))
            meta = {
                "scalars": scalars,
                "shape_q": list(np.asarray(trace["q"]).shape),
                "shape_llk": list(np.asarray(trace["llk"]).shape),
                "varnames": list(self.ordering.names) if self.ordering is not None else [],
            }
            with open(self._meta_file(stage), "w") as f:
                json.dump(meta, f, indent=1)
        logger.info("Saved stage %i to %s", stage, self.stage_path(stage))

    def load_trace(self, stage: int) -> StageTrace:
        with np.load(self._trace_file(stage)) as z:
            q, llk = z["q"], z["llk"]
        meta = self._load_meta(stage)
        return StageTrace(q, llk, varnames=meta.get("varnames"), ordering=self.ordering)

    def load_state(self, stage: int) -> dict:
        meta = self._load_meta(stage)
        state = dict(meta.get("scalars", {}))
        with np.load(self._state_file(stage)) as z:
            for k in z.files:
                state[k] = z[k]
        return state

    def _load_meta(self, stage: int) -> dict:
        with open(self._meta_file(stage)) as f:
            return json.load(f)

    def check_stage(self, stage: int) -> bool:
        """Validate a stage checkpoint: files load, shapes match the meta."""
        try:
            meta = self._load_meta(stage)
            with np.load(self._trace_file(stage)) as z:
                ok = (list(z["q"].shape) == meta["shape_q"]
                      and list(z["llk"].shape) == meta["shape_llk"])
            with np.load(self._state_file(stage)):
                pass
            return bool(ok)
        except Exception as e:  # corrupt/missing files of any kind
            logger.warning("Stage %i invalid: %s", stage, e)
            return False

    def highest_sampled_stage(self) -> int:
        """Largest valid stage number on disk, -1 for a valid final stage,
        or -2 if none."""
        stages = []
        if not os.path.isdir(self.homepath):
            return -2
        for name in os.listdir(self.homepath):
            if name.startswith("stage_"):
                try:
                    stages.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        if -1 in stages and self.check_stage(-1):
            return -1
        valid = sorted(s for s in stages if s >= 0 and self.check_stage(s))
        return valid[-1] if valid else -2

    def rm_all(self) -> None:
        if os.path.isdir(self.homepath):
            shutil.rmtree(self.homepath)
        os.makedirs(self.homepath, exist_ok=True)


# ---------------------------------------------------------------------------
# Posterior summary
# ---------------------------------------------------------------------------


def hdi(samples: np.ndarray, prob: float = 0.94) -> tuple:
    """Highest-density interval of 1-d samples."""
    x = np.sort(np.asarray(samples).ravel())
    n = x.size
    m = max(1, int(np.floor(prob * n)))
    widths = x[m:] - x[: n - m]
    if widths.size == 0:
        return float(x[0]), float(x[-1])
    i = int(np.argmin(widths))
    return float(x[i]), float(x[i + m])


def effective_sample_size(chains: np.ndarray) -> float:
    """Bulk ESS of (n_draws, n_chains) samples by the initial positive
    sequence of the autocorrelations."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, m = x.shape
    if n < 4:
        return float(n * m)
    means = x.mean(axis=0)
    w = x.var(axis=0, ddof=1).mean()
    if w == 0:
        return float(n * m)
    acov = np.zeros((n, m))
    for j in range(m):
        c = x[:, j] - means[j]
        acov[:, j] = np.correlate(c, c, mode="full")[n - 1:] / n
    rho = 1.0 - (w - acov.mean(axis=1)) / w
    t, s = 1, 0.0
    while t + 1 < n:
        pair = rho[t] + rho[t + 1]
        if pair < 0:
            break
        s += pair
        t += 2
    tau = 1.0 + 2.0 * rho[0] if n < 3 else -1.0 + 2.0 * (rho[0] + s)
    tau = max(tau, 1.0 / np.log10(n * m + 10))
    return float(n * m / tau)


def rhat(chains: np.ndarray) -> float:
    """Gelman-Rubin split-R̂ over (n_draws, n_chains); NaN with fewer than
    two draws per split half."""
    x = np.asarray(chains, dtype=np.float64)
    if x.ndim == 1 or x.shape[1] == 1:
        half = x.reshape(-1)
        x = np.stack([half[: half.size // 2], half[half.size // 2: 2 * (half.size // 2)]],
                     axis=1)
    n, m = x.shape
    half = n // 2
    if half < 2:
        return float("nan")
    splits = np.concatenate([x[:half], x[half: 2 * half]], axis=1)
    n, m = splits.shape
    w = splits.var(axis=0, ddof=1).mean()
    b = n * splits.mean(axis=0).var(ddof=1)
    if w == 0:
        return 1.0
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def summarize_trace(trace: StageTrace, prob: float = 0.94) -> dict:
    """Per-variable posterior summary (mean, sd, hdi, ess, r_hat); vector
    variables give one entry per component, ``name[k]``."""
    if trace.ordering is None:
        raise ValueError("trace needs an ordering for summaries")
    out = {}
    for spec in trace.ordering.vmap:
        block = trace.q_trace[:, :, spec.slc]  # (n_rec, n_chains, k)
        for k in range(block.shape[-1]):
            s = block[:, :, k]
            name = spec.name if spec.shape == () else f"{spec.name}[{k}]"
            lo, hi = hdi(s, prob)
            out[name] = {
                "mean": float(s.mean()),
                "sd": float(s.std(ddof=1)),
                f"hdi_{int(prob*100)}%_lower": lo,
                f"hdi_{int(prob*100)}%_upper": hi,
                "ess": effective_sample_size(s),
                "r_hat": rhat(s),
            }
    return out


def extract_bounds_from_summary(summary: dict, varname: str, shape=(), roundto: int = 2,
                                alpha: float = 0.06) -> tuple:
    """HDI bounds of a summarised variable, rounded outwards to
    ``roundto`` decimals: the priors a later run imports."""
    size = int(np.prod(shape, dtype=int)) if shape else 1
    lows, highs = [], []
    for k in range(size):
        rec = summary[varname if not shape else f"{varname}[{k}]"]
        keys = [key for key in rec if key.startswith("hdi_")]
        lows.append(np.floor(min(rec[key] for key in keys) * 10**roundto) / 10**roundto)
        highs.append(np.ceil(max(rec[key] for key in keys) * 10**roundto) / 10**roundto)
    return np.array(lows), np.array(highs)
