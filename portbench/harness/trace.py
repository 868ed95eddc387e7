"""
The reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: the profiled sub-window, the device's busy time and idle
gaps in it, the CUDA calls that hand work to the device, and the device
time of each benchmark span.

Device time goes to a span through the profiler's launch correlation:
a kernel, copy or fill belongs to the spans that were open, on the
launching thread, around the CUDA call that launched it; so a kernel
keeps its span whatever it is named.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

from portbench.harness.spans import WINDOW_SPAN

#: the CUDA calls by which a host thread hands work to the device (as
#: ``chip_smoke.py`` counts them)
DEVICE_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                "cuMemset", "cudaGraphLaunch")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("user_annotation",)
#: the spans a device operation or an idle gap is named by (innermost first)
SPAN_NAMES = ("k1c", "k3", "eikonal", "logp", "metropolis_step", "metropolis_stage",
              "smc_stage", "save_stage")
TOP = 10


def _events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def has_device_records(path: str) -> bool:
    return any(e.get("cat") in DEVICE_CATS for e in _events(path))


@dataclass
class TraceSummary:
    """Seconds unless said; ``None`` where the trace holds no device record."""

    window_s: float
    busy_s: float | None
    launches: int
    span_host_s: dict = field(default_factory=dict)      # span -> summed host seconds
    span_device_s: dict = field(default_factory=dict)    # span -> device seconds inside it
    device_ops: list = field(default_factory=list)       # [(name, s)], most time first
    idle_gaps: list = field(default_factory=list)        # [(name, s)], longest first


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path: str) -> TraceSummary:
    """The summary of one sub-window's trace."""
    events = _events(path)
    windows = [e for e in events if e.get("cat") in SPAN_CATS and e["name"] == WINDOW_SPAN]
    if not windows:
        raise ValueError(f"{path}: no {WINDOW_SPAN} span")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    spans = defaultdict(list)        # tid -> [(ts, end, name)]
    for e in events:
        if e.get("cat") in SPAN_CATS and e["name"] in SPAN_NAMES:
            spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    host = defaultdict(float)
    for tid, lst in spans.items():
        lst.sort()
        for a, b, name in lst:
            host[name] += (min(b, w1) - max(a, w0)) / 1e6 if b > w0 and a < w1 else 0.0

    def open_spans(tid, ts):
        """Names of the spans open on ``tid`` at ``ts``, innermost first."""
        found = [(a, name) for a, b, name in spans.get(tid, ()) if a <= ts <= b]
        return [name for a, name in sorted(found, reverse=True)]

    launch_spans = {}
    launches = 0
    for e in events:
        if e.get("cat") in RUNTIME_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_spans[corr] = open_spans(e["tid"], e["ts"])
            if e["name"].startswith(DEVICE_CALLS) and w0 <= e["ts"] <= w1:
                launches += 1

    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    span_dev = defaultdict(float)
    by_op = defaultdict(float)
    intervals = []
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        intervals.append((a, b))
        names = launch_spans.get(e.get("args", {}).get("correlation"), [])
        for name in set(names):
            span_dev[name] += (b - a) / 1e6
        by_op[f"{names[0] if names else 'other'}/{e['name'][:100]}"] += (b - a) / 1e6
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e6 if busy else None

    # idle gaps, named by the innermost span open on the main thread
    main_tid = windows[0]["tid"]
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            names = open_spans(main_tid, prev + 1e-3)
            gaps.append(("/".join(reversed(names[:3])) or "host", (a - prev) / 1e6))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_s, launches=launches, span_host_s=dict(host),
        span_device_s=dict(span_dev),
        device_ops=sorted(by_op.items(), key=lambda x: -x[1])[:TOP],
        idle_gaps=[[n, s] for n, s in gaps[:TOP]])


def first_with_device(traces: list):
    """``(summary, k1c calls, k3 calls, steps)`` of the first sub-window
    whose trace holds device records, or None."""
    for path, k1c, k3, steps in traces:
        if has_device_records(path):
            return summarize(path), k1c, k3, steps
    return None

