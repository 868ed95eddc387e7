"""
Spans and counters of a traced run, from the benchmark's side: the
program's layer entry points are wrapped by attribute while a
:class:`Spans` is open, each call inside a ``torch.profiler``
``record_function`` of the layer's name, and the profiler is run over a
short sub-window of Metropolis steps.

Spans (the names the trace reduction reads):

``smc_stage``        a stage of ``samplers/smc.py`` (its ``stage_timer``)
``save_stage``       ``backend.SampleStage.save_stage`` (the saver thread);
                     its host seconds are summed over the whole window
``metropolis_stage`` ``samplers.metropolis.run_metropolis_stage``
``metropolis_step``  one lockstep step (``metropolis_step``)
``logp``             the Problem's batched log-likelihood
``k1c``              ``ops.bilgather.bilinear_contract`` (K1c)
``k3``               ``ops.gfstack.stack_batched`` (K3 / K4)
``eikonal``          ``SeismicDistributerComposite.point2starttimes``
``portbench_window`` the profiled sub-window itself

During the sub-window the K1c and K3 wrappers keep their index
arguments, so the roofline counts see what each call selected.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

import torch

WINDOW_SPAN = "portbench_window"
#: attempts at a sub-window whose trace holds device records
TRACE_ATTEMPTS = 5


class Spans:
    """Wraps the program's entry points (``install``) and runs the
    profiler over ``steps`` Metropolis steps, from step ``skip`` of the
    ``stage``-th Metropolis stage after :meth:`arm`; a trace without
    device records is taken again at the next stage, TRACE_ATTEMPTS
    times at most."""

    def __init__(self, trace_dir: str, stage: int, skip: int, steps: int, device):
        self.trace_dir = trace_dir
        self.stage, self.skip, self.steps = int(stage), int(skip), int(steps)
        self.device = device
        self.save_seconds = 0.0
        self._lock = threading.Lock()
        self._patches = []
        self.armed = False
        self.stage_count = 0
        self.step_in_stage = -1
        self.profile = None
        self.attempts = 0
        self.traces = []          # (path, k1c calls, k3 calls, steps) of each sub-window
        self._k1c, self._k3 = [], []

    # -- patching ---------------------------------------------------------------

    def _patch(self, owner, name, wrapper):
        original = getattr(owner, name)
        self._patches.append((owner, name, original))
        setattr(owner, name, wrapper(original))

    def install(self):
        """Wrap the entry points; :meth:`uninstall` puts them back.  Must run
        before the problem is built: tables and libraries keep the K1c and
        K3 wrappers they are built with."""
        from beat_tpu_torch import backend
        from beat_tpu_torch.ffi import gflibrary
        from beat_tpu_torch.heart import gftable
        from beat_tpu_torch.models import distributer, problem
        from beat_tpu_torch.ops import bilgather, gfstack
        from beat_tpu_torch.samplers import metropolis, smc

        def span(name):
            def wrap(fn):
                @functools.wraps(fn)
                def inner(*a, **k):
                    with torch.profiler.record_function(name):
                        return fn(*a, **k)
                return inner
            return wrap

        def stage_timer(fn):
            @contextlib.contextmanager
            def inner(*a, **k):
                with fn(*a, **k), torch.profiler.record_function("smc_stage"):
                    yield
            return inner

        def save_stage(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("save_stage"):
                        return fn(*a, **k)
                finally:
                    with self._lock:
                        self.save_seconds += time.perf_counter() - t0
            return inner

        def metropolis_stage(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                if self.armed:
                    self.stage_count += 1
                    self.step_in_stage = -1
                try:
                    with torch.profiler.record_function("metropolis_stage"):
                        return fn(*a, **k)
                finally:
                    self._stop()
            return inner

        def step(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                self.step_in_stage += 1
                if (self.armed and self.profile is None and self.stage_count == self.stage
                        and self.step_in_stage == self.skip):
                    self._start()
                with torch.profiler.record_function("metropolis_step"):
                    out = fn(*a, **k)
                if self.profile is not None:
                    self._steps_done += 1
                    if self._steps_done >= self.steps:
                        self._stop()
                return out
            return inner

        def make_logp_fn(fn):
            @functools.wraps(fn)
            def inner(*a, **k):
                logp, data = fn(*a, **k)
                return span("logp")(logp), data
            return inner

        def capture(name, store):
            def wrap(fn):
                @functools.wraps(fn)
                def inner(*a, **k):
                    if self.profile is not None:
                        store.append((a, k))
                    with torch.profiler.record_function(name):
                        return fn(*a, **k)
                return inner
            return wrap

        self._patch(smc, "stage_timer", stage_timer)
        self._patch(backend.SampleStage, "save_stage", save_stage)
        self._patch(smc, "run_metropolis_stage", metropolis_stage)
        self._patch(metropolis, "metropolis_step", step)
        self._patch(problem.Problem, "make_logp_fn", make_logp_fn)
        self._patch(distributer.SeismicDistributerComposite, "point2starttimes",
                    span("eikonal"))
        k1c = capture("k1c", self._k1c)
        for owner in (bilgather, gftable):
            self._patch(owner, "bilinear_contract", k1c)
        k3 = capture("k3", self._k3)
        for owner in (gfstack, gflibrary):
            self._patch(owner, "stack_batched", k3)
        return self

    def uninstall(self):
        self._stop()
        for owner, name, original in reversed(self._patches):
            setattr(owner, name, original)
        self._patches.clear()

    # -- the profiled sub-window ---------------------------------------------------

    def arm(self):
        """Count Metropolis stages from here and profile the configured
        sub-window."""
        self.armed = True
        self.stage_count = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self._k1c.clear()
        self._k3.clear()
        self._steps_done = 0
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()

    def _stop(self):
        if self.profile is None:
            return
        self._sync()
        self._window.__exit__(None, None, None)
        self.profile.__exit__(None, None, None)
        self.attempts += 1
        path = os.path.join(self.trace_dir, f"portbench_trace_{self.attempts}.json")
        self.profile.export_chrome_trace(path)
        self.profile = None
        self.traces.append((path, list(self._k1c), list(self._k3), self._steps_done))
        self._k1c.clear()
        self._k3.clear()
        from portbench.harness.trace import has_device_records
        if has_device_records(path) or self.attempts >= TRACE_ATTEMPTS:
            self.armed = False
        else:
            self.stage += 1          # CUPTI dropped the records: the next stage


def warm_profiler(device):
    """One tiny profile, so that the profiler's own start-up falls in
    set-up."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities):
        torch.ones(8, device=device).sum().item()
