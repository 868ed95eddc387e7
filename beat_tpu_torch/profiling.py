"""
Structured profiling: the per-stage timing registry, the program's spans
and counters, and torch profiler hooks (port of ``beat_tpu/profiling.py``,
with the spans added).

* :class:`TimingRegistry` / :func:`stage_timer` — the samplers record
  each stage's wall-clock and evaluation count; ``timings.report()``
  gives a structured dict (also written beside the stages as
  ``timings.json`` when sampling with a homepath).  A stage timer given
  a ``span_name`` records the same interval as that span too.
* :func:`span` / :func:`count` — named intervals and integer counters
  where the work happens (the SMC stage, the stage files, the Metropolis
  step, the FullMT forward, the eikonal, the kinematic library's build
  and its stack, and each kernel launch, counted once in
  ``kernels/build.py::launch`` as ``launches.<C entry>``).  Off by default:
  ``span`` then returns one shared no-op object and ``count`` returns at
  once; :func:`spans_enabled` says which.
  :func:`enable_spans` turns them on; each span then records its name,
  start and end (``time.perf_counter_ns``), its parent on its thread, its
  thread and the inversion it belongs to, and, opened inside a profiled
  block, enters ``torch.profiler.record_function(name)``, so the block's
  trace shows it beside the CUDA records.  :func:`carry` runs a function on another
  thread as part of the current inversion.  Records stay in memory until
  :func:`reset_spans`; :func:`span_snapshot` returns them with the
  counters and per name the count, total and self seconds, and
  :func:`span_summary` prints that table.
* :func:`torch_trace` — a ``torch.profiler`` trace around a block,
  written as a Chrome trace (``trace_<ns>.json``) into ``logdir``; activated
  for sampling runs by ``BEAT_TPU_PROFILE_DIR`` or ``sample --profile``.
* :func:`slope_time` / :func:`time_per_sample` — seconds per evaluation
  of a chain-batched logp by the two-length slope method, with CUDA
  events on the card.  ``time_per_sample`` passes the data to the logp
  as arguments on every call (the JAX package's closes over them).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

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


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

#: whether spans and counters record (:func:`enable_spans`)
_on = False
_lock = threading.Lock()
_local = threading.local()      # .stack: open spans of the thread; .inversion: carried id
_ids = itertools.count(1)
_records: list = []
_counters: dict = {}


class _NoSpan:
    """What :func:`span` returns while spans are off: one shared object
    that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()


class Span:
    """One recorded interval (see :func:`span`)."""

    __slots__ = ("name", "attrs", "root", "id", "parent", "thread", "inversion",
                 "start_ns", "end_ns", "_region")

    def __init__(self, name: str, attrs: dict, root: bool = False):
        self.name, self.attrs, self.root = name, attrs, root
        self.start_ns = self.end_ns = None

    def open(self, t_ns: int) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.thread = threading.get_ident()
        if self.root:
            self.inversion = self.id
        else:
            self.inversion = top.inversion if top is not None else getattr(_local, "inversion",
                                                                           None)
        # a profile records a region only if it was recording when the region
        # opened; entering one outside a profile costs ~14 us and records nothing
        if torch._C._autograd._profiler_enabled():
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        else:
            self._region = None
        stack.append(self)
        self.start_ns = t_ns
        return self

    def close(self, t_ns: int) -> None:
        self.end_ns = t_ns
        _local.stack.pop()
        if self._region is not None:
            self._region.__exit__(None, None, None)
            self._region = None
        with _lock:
            _records.append(self)

    def __enter__(self):
        return self.open(time.perf_counter_ns())

    def __exit__(self, *exc):
        self.close(time.perf_counter_ns())
        return None

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "thread": self.thread,
                "inversion": self.inversion, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs)}


def span(name: str, root: bool = False, **attrs):
    """A context manager around one named interval of the program.

    Off (the default), it returns one shared no-op object.  On, it
    records a :class:`Span`: name, ``attrs``, start and end, the span
    open around it on this thread (its parent), the thread, and the id of
    the inversion it belongs to: its own id with ``root=True`` (an
    inversion's outermost span), else its parent's, else the one
    :func:`carry` brought to this thread.  Opened while a
    ``torch.profiler`` profile records, it also enters
    ``torch.profiler.record_function(name)``.  Spans never
    read the device, so they change no result and add no
    synchronisation."""
    if not _on:
        return _NO_SPAN
    return Span(name, attrs, root)


def count(name: str, n: int = 1) -> None:
    """Add the host integer ``n`` to counter ``name`` (nothing while spans
    are off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def carry(fn):
    """``fn``, to be run on another thread as part of the inversion open
    on this one (the SMC's stage saver): spans it opens there carry the
    inversion's id.  ``fn`` itself while spans are off or no inversion is
    open."""
    if not _on:
        return fn
    stack = getattr(_local, "stack", None)
    inversion = stack[-1].inversion if stack else getattr(_local, "inversion", None)
    if inversion is None:
        return fn

    def carried(*args, **kwargs):
        before = getattr(_local, "inversion", None)
        _local.inversion = inversion
        try:
            return fn(*args, **kwargs)
        finally:
            _local.inversion = before

    return carried


def spans_enabled() -> bool:
    """Whether spans and counters record: a counter that needs a read of
    the device asks this first, so nothing syncs while they are off."""
    return _on


def enable_spans(on: bool = True) -> bool:
    """Turn spans and counters on or off; returns the previous setting.
    Records made so far stay (see :func:`reset_spans`)."""
    global _on
    before, _on = _on, bool(on)
    return before


def reset_spans() -> None:
    """Drop every closed span and every counter (spans open now are kept
    when they close)."""
    with _lock:
        _records.clear()
        _counters.clear()


def span_snapshot() -> dict:
    """The spans closed so far and the counters, with per span name its
    ``count``, ``total_s`` and ``self_s`` (its time less what its child
    spans on its thread cover)::

        {"spans": [Span.as_dict()...], "counters": {name: int},
         "by_name": {name: {"count", "total_s", "self_s"}}}
    """
    with _lock:
        records = list(_records)
        counters = dict(_counters)
    children_ns = defaultdict(int)
    for s in records:
        if s.parent is not None:
            children_ns[s.parent] += s.end_ns - s.start_ns
    by_name = {}
    for s in records:
        dur = s.end_ns - s.start_ns
        row = by_name.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur / 1e9
        row["self_s"] += max(dur - children_ns.get(s.id, 0), 0) / 1e9
    return {"spans": [s.as_dict() for s in records], "counters": counters, "by_name": by_name}


def span_summary(snapshot: dict | None = None) -> str:
    """Per span name its count, total and self seconds, then the
    counters, as lines of text."""
    snap = span_snapshot() if snapshot is None else snapshot
    lines = [f"{'span':<24} {'count':>8} {'total':>12} {'self':>12}"]
    for name, row in sorted(snap["by_name"].items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(f"{name:<24} {row['count']:>8d} {row['total_s']:>10.3f} s "
                     f"{row['self_s']:>10.3f} s")
    for name, value in sorted(snap["counters"].items()):
        lines.append(f"{name:<24} {value:>8d}")
    return "\n".join(lines)


@contextlib.contextmanager
def stage_timer(name: str, n_evals: int | None = None, registry=None,
                span_name: str | None = None, span_attrs: dict | None = None, **extra):
    """Record a named stage's wall-clock into the registry; with
    ``span_name`` the same interval is also recorded as that span
    (attributes ``span_attrs`` and ``extra``) while spans are on."""
    reg = registry if registry is not None else timings
    t0 = time.perf_counter_ns()
    rec_span = (Span(span_name, dict(span_attrs or {}, **extra)).open(t0)
                if span_name and _on else None)
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        if rec_span is not None:
            rec_span.close(t1)
        rec = reg.add(name, (t1 - t0) / 1e9, n_evals, **extra)
        logger.debug("%s: %.3f s%s", name, rec.wall_s,
                     f" ({rec.evals_per_s:.1f} evals/s)" if rec.evals_per_s else "")


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


def slope_time(run, n_lo: int = 2, n_hi: int = 32, reps: int = 3, device=None) -> float:
    """
    Seconds per iteration by the two-length slope method: the best of
    ``reps`` timings of ``run(n_hi, rep)`` less that of ``run(n_lo, rep)``,
    over ``n_hi - n_lo``; what a call costs whatever its length cancels.
    ``run(n, rep)`` runs ``n`` iterations; both lengths are run once
    first (warm-up).  On a CUDA ``device`` the time is read from CUDA
    events around the call, otherwise from the host clock.
    """
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
    def run(n, rep):
        x = q + 1e-7 * rep
        with torch.no_grad():
            acc = torch.zeros((), dtype=q.dtype, device=q.device)
            for _ in range(n):
                acc = acc + 1e-20 * logp_fn(x + acc, *logp_args).sum()
        float(acc)          # wait for the device

    return slope_time(run, n_lo, n_hi, device=q.device)
