"""
Structured profiling: per-stage timing registry and torch profiler hooks
(port of ``beat_tpu/profiling.py``).

* :class:`TimingRegistry` / :func:`stage_timer` — the samplers record
  each stage's wall-clock and evaluation count; ``timings.report()``
  gives a structured dict (also written beside the stages as
  ``timings.json`` when sampling with a homepath).
* :func:`time_method` — decorator recording call durations.
* :func:`torch_trace` — a ``torch.profiler`` trace around a block,
  written as a Chrome trace (``trace_<ns>.json``) into ``logdir``; activated
  for sampling runs by ``BEAT_TPU_PROFILE_DIR`` or ``sample --profile``.
* :func:`annotate` — a named region of such a trace
  (``torch.profiler.record_function``).
* :func:`slope_time` / :func:`time_per_sample` — seconds per evaluation
  of a chain-batched logp by the two-length slope method, with CUDA
  events on the card.  ``time_per_sample`` passes the data to the logp
  as arguments on every call (the JAX package's closes over them).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from dataclasses import dataclass, field

logger = logging.getLogger("beat_tpu_torch.profiling")


@dataclass
class StageRecord:
    name: str
    wall_s: float
    n_evals: int | None = None
    extra: dict = field(default_factory=dict)

    @property
    def evals_per_s(self):
        if not self.n_evals or self.wall_s <= 0:
            return None
        return self.n_evals / self.wall_s


@dataclass
class TimingRegistry:
    """Accumulates named timing records for the current process."""

    records: list = field(default_factory=list)

    def add(self, name, wall_s, n_evals=None, **extra):
        rec = StageRecord(name, wall_s, n_evals, extra)
        self.records.append(rec)
        return rec

    def reset(self):
        self.records.clear()

    def report(self) -> dict:
        """Structured report: per-record rows + totals."""
        rows = []
        for r in self.records:
            row = {"name": r.name, "wall_s": round(r.wall_s, 6)}
            if r.n_evals:
                row["n_evals"] = r.n_evals
                rate = r.evals_per_s   # None when wall_s is degenerate
                if rate is not None:
                    row["evals_per_s"] = round(rate, 1)
            row.update(r.extra)
            rows.append(row)
        total = sum(r.wall_s for r in self.records)
        evals = sum(r.n_evals or 0 for r in self.records)
        return {"stages": rows, "total_wall_s": round(total, 6), "total_evals": evals}

    def summary(self) -> str:
        rep = self.report()
        lines = [f"{row['name']:<24} {row['wall_s']:>10.3f} s"
                 + (f"  {row['evals_per_s']:>12.1f} evals/s" if "evals_per_s" in row else "")
                 for row in rep["stages"]]
        lines.append(f"{'total':<24} {rep['total_wall_s']:>10.3f} s")
        return "\n".join(lines)

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)


#: process-global registry the samplers record into
timings = TimingRegistry()


@contextlib.contextmanager
def stage_timer(name: str, n_evals: int | None = None, registry=None, **extra):
    """Record a named stage's wall-clock into the registry."""
    reg = registry if registry is not None else timings
    t0 = time.perf_counter()
    try:
        yield
    finally:
        rec = reg.add(name, time.perf_counter() - t0, n_evals, **extra)
        logger.debug("%s: %.3f s%s", name, rec.wall_s,
                     f" ({rec.evals_per_s:.1f} evals/s)" if rec.evals_per_s else "")


def time_method(fn):
    """Decorator recording each call's duration."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with stage_timer(fn.__qualname__):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def torch_trace(logdir: str | None = None):
    """A ``torch.profiler`` trace around a block, written to
    ``<logdir>/trace_<ns>.json`` (Chrome trace format, one file a block,
    named by the time it ended; the CUDA activity is recorded when a card
    is present).  ``logdir=None`` resolves from
    ``BEAT_TPU_PROFILE_DIR``; without either it does nothing."""
    logdir = logdir or os.environ.get("BEAT_TPU_PROFILE_DIR")
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    path = os.path.join(logdir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("torch profiler trace -> %s", path)


def annotate(name: str):
    """A named region inside a traced block (shows in the trace's
    timeline)."""
    import torch

    return torch.profiler.record_function(name)


def slope_time(run, n_lo: int = 2, n_hi: int = 32, reps: int = 3, device=None) -> float:
    """
    Seconds per iteration by the two-length slope method: the best of
    ``reps`` timings of ``run(n_hi, rep)`` less that of ``run(n_lo, rep)``,
    over ``n_hi - n_lo``; what a call costs whatever its length cancels.
    ``run(n, rep)`` runs ``n`` iterations; both lengths are run once
    first (warm-up).  On a CUDA ``device`` the time is read from CUDA
    events around the call, otherwise from the host clock.
    """
    import torch

    cuda = device is not None and torch.device(device).type == "cuda"
    run(n_lo, 0)
    run(n_hi, 0)

    def once(n, rep):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            run(n, rep)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        run(n, rep)
        return time.perf_counter() - t0

    def timed(n):
        return min(once(n, r + 1) for r in range(reps))

    return max((timed(n_hi) - timed(n_lo)) / (n_hi - n_lo), 1e-12)


def time_per_sample(logp_fn, q, logp_args=(), n_lo: int = 2, n_hi: int = 32) -> float:
    """
    Seconds per evaluation of a chain-batched ``logp_fn(q (C, dim),
    *logp_args) -> (C,)`` of all chains in ``q`` by :func:`slope_time` on
    ``q``'s device; the data are passed to ``logp_fn`` on every call.
    Each repetition moves ``q`` by a tiny amount so no evaluation repeats
    the previous one's inputs exactly.
    """
    import torch

    def run(n, rep):
        x = q + 1e-7 * rep
        with torch.no_grad():
            acc = torch.zeros((), dtype=q.dtype, device=q.device)
            for _ in range(n):
                acc = acc + 1e-20 * logp_fn(x + acc, *logp_args).sum()
        float(acc)          # wait for the device

    return slope_time(run, n_lo, n_hi, device=q.device)
