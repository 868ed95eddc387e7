"""
The program's spans and counters (``beat_tpu_torch.profiling``) on one
cell of the benchmark: what they read, and what they cost when on.

    python3 tools/bench_torch_spans.py --workload fullmt-smc --seed 7 \\
        [--seconds 10] [--pairs 3] [--trace] [--small --device cpu]

One process, one cell, through ``portbench``'s harness (its set-up, its
calls and their seeds).  After set-up, windows of back-to-back calls
alternate spans off and spans on, without a profiler: ``--pairs`` of
each, the two of a pair on the same call seeds, the order swapped every
pair.  Each window prints ``evals_per_s``; each spans-on window also
prints what the spans read over it:

``save_wait_share``       main-thread seconds in ``smc.save_wait`` over
                          the window, per cent
``stage_write_mb_per_s``  ``stage.bytes`` / 1e6 over the seconds in
                          ``stage.write``
``pool_share``            ``stage.pool_bytes`` over ``stage.bytes``: the
                          share deflated in chunks on the writer's pool
                          (``pool_workers``: its size, the writes'
                          ``workers`` attribute)
``write_step_slowdown``   the mean ``metropolis.step`` that overlaps a
                          ``stage.write`` on another thread over the mean
                          of those that overlap none, less 1, per cent
                          (None where either set is empty)
``eikonal_iter_us``       seconds in ``eikonal.solve`` × 1e6 over
                          ``eikonal.iterations``, the plain loop's
                          iterations run (None where a solve took the
                          kernel, or none ran)
``eikonal_fused_share``   ``launches.beat_eikonal_f32`` over
                          ``eikonal.solves``: the share of the onset solves
                          that the one-launch kernel took (None where
                          nothing was solved)
``mma_call_share``        ``gfstack.mma_calls`` over ``gfstack.calls``: the
                          share of the stack's calls that ran K3's ``mma``
                          variant (None where nothing was stacked)
``fold_call_share``       ``launches.beat_gf_stack_fold_f32`` over
                          ``gfstack.calls``: the share of the stack's calls
                          that ran ``tiled_fed``, its entries folded once a
                          call (None where nothing was stacked)

and the last spans-on window's stage files are judged, after every window
has run, as the benchmark judges a run.  Spans are on through set-up in
both runs, for ``library_gb``: ``gflibrary.bytes`` / 1e9, the kinematic
libraries the set-up built (None where it built none).  With ``--trace``
a second run follows: spans on from before its set-up, one window traced
as the benchmark's ``--trace 1`` run traces it, and from that trace
``pair_arith_share`` (device seconds launched inside ``fullmt.filter``
or ``fullmt.phasors`` over those inside the benchmark's ``logp`` span)
and the breakdown by the program's spans.
``--small`` runs the cell at the benchmark tests' CPU sizes.  The last
line of standard output is one JSON object of everything printed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import threading
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the program's spans the trace's device operations and idle gaps are
#: named by, with the benchmark's own (innermost first)
PROGRAM_SPANS = ("fullmt.queries", "fullmt.filter", "fullmt.phasors", "fullmt.idft",
                 "fullmt.misfit", "eikonal.solve", "gfstack.stack", "metropolis.propose",
                 "metropolis.accept", "metropolis.step", "smc.fetch", "smc.transition",
                 "smc.save_wait", "smc.stage", "stage.write", "smc.sample", "gflibrary.build")
PAIR_SPANS = ("fullmt.filter", "fullmt.phasors")


def _dur(s) -> int:
    return s["end_ns"] - s["start_ns"]


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def span_readings(snap: dict, t0_ns: int, t1_ns: int, main_thread: int) -> dict:
    """The span readings of one window ``[t0_ns, t1_ns]`` (None
    where the window has nothing to read)."""
    spans = snap["spans"]
    window = t1_ns - t0_ns
    waits = sum(_overlap(s["start_ns"], s["end_ns"], t0_ns, t1_ns) for s in spans
                if s["name"] == "smc.save_wait" and s["thread"] == main_thread)
    writes = [s for s in spans if s["name"] == "stage.write"]
    write_ns = sum(_dur(s) for s in writes)
    written = snap["counters"].get("stage.bytes", 0)
    pooled = snap["counters"].get("stage.pool_bytes", 0)
    steps = [s for s in spans if s["name"] == "metropolis.step"]
    during, clear = [], []
    for st in steps:
        hit = any(w["thread"] != st["thread"]
                  and _overlap(w["start_ns"], w["end_ns"], st["start_ns"], st["end_ns"])
                  for w in writes)
        (during if hit else clear).append(_dur(st))
    solve_ns = sum(_dur(s) for s in spans if s["name"] == "eikonal.solve")
    iterations = snap["counters"].get("eikonal.iterations", 0)
    solves = snap["counters"].get("eikonal.solves", 0)
    fused = snap["counters"].get("launches.beat_eikonal_f32", 0)
    stacks = snap["counters"].get("gfstack.calls", 0)
    return {
        "save_wait_share": 100.0 * waits / window if window > 0 else None,
        "stage_write_mb_per_s": (written / 1e6) / (write_ns / 1e9) if write_ns else None,
        "pool_share": pooled / written if written else None,
        "pool_workers": sorted({w["attrs"].get("workers") for w in writes} - {None}),
        "write_step_slowdown": (100.0 * (sum(during) * len(clear) / (sum(clear) * len(during))
                                         - 1.0) if during and clear else None),
        "eikonal_iter_us": solve_ns / 1e3 / iterations if iterations and not fused else None,
        "eikonal_fused_share": fused / solves if solves else None,
        "mma_call_share": (snap["counters"].get("gfstack.mma_calls", 0) / stacks
                           if stacks else None),
        "fold_call_share": (snap["counters"].get("launches.beat_gf_stack_fold_f32", 0) / stacks
                            if stacks else None),
        "steps_during_write": len(during), "steps_clear": len(clear),
        "stage_bytes": written, "eikonal_iterations": iterations,
    }


def library_gb(snap: dict) -> float | None:
    """``gflibrary.bytes`` / 1e9 of a snapshot taken after set-up."""
    built = snap["counters"].get("gflibrary.bytes", 0)
    return built / 1e9 if built else None


def program_summary(path: str):
    """The benchmark's ``TraceSummary`` of a trace, with the program's span
    names beside the benchmark's: device operations and idle gaps are
    named by the innermost of either."""
    from portbench.harness import trace as trace_mod

    names = trace_mod.SPAN_NAMES
    trace_mod.SPAN_NAMES = PROGRAM_SPANS + tuple(names)
    try:
        return trace_mod.summarize(path)
    finally:
        trace_mod.SPAN_NAMES = names


def pair_arith_share(summary) -> float | None:
    """Device seconds launched inside the pair-arithmetic spans over those
    launched inside ``logp``, from a trace summarised with the program's
    span names."""
    dev = summary.span_device_s
    if not dev.get("logp"):
        return None
    return 100.0 * sum(dev.get(n, 0.0) for n in PAIR_SPANS) / dev["logp"]


def run_window(run, seconds: float, seeds: tuple) -> dict:
    """Back-to-back calls, as the benchmark's window runs them, on the
    call seeds ``derive_seed(seed, *seeds, i)``."""
    from beat_tpu_torch.profiling import timings
    from portbench.harness.cell import derive_seed

    mark = len(timings.records)
    calls = []
    t0_ns = time.perf_counter_ns()
    while True:
        calls.append(run.sample(run.params(seed=derive_seed(run.seed, *seeds, len(calls)))))
        if (time.perf_counter_ns() - t0_ns) / 1e9 >= seconds:
            break
    t1_ns = time.perf_counter_ns()
    stages = [s for s in timings.records[mark:] if s.name.startswith("smc_stage_")]
    evals = sum(s.n_evals or 0 for s in stages) + run.record.traffic["n_chains"] * len(calls)
    window_s = (t1_ns - t0_ns) / 1e9
    return {"t0_ns": t0_ns, "t1_ns": t1_ns, "calls": calls, "window_s": window_s,
            "evals_per_s": evals / window_s, "failed": sum(c["failed"] for c in calls)}


def judge(run, calls: list, salt: int) -> dict:
    """The benchmark's comparison of these calls' stage files: each
    number beside its limit, and whether all are within."""
    import numpy as np

    from portbench.harness import judge as judge_mod

    r = run.record
    homes = [c["home"] for c in calls if not c["failed"]]
    rng = np.random.default_rng(np.random.SeedSequence([run.seed % 2**64, 3, salt]))
    numbers = judge_mod.judge(run.cfg, r.config, run.inputs, homes, r.traffic, r.cell_file,
                              rng, run.device) if homes else {}
    limits = r.cell_file["limits"]
    checks = {k: [numbers.get(k), lim] for k, lim in limits.items()}
    ok = bool(homes) and len(homes) == len(calls) and all(
        v is not None and v <= lim for v, lim in checks.values())
    return {"correct": ok, "checks": checks}


def remove(calls: list):
    for c in calls:
        shutil.rmtree(c["home"], ignore_errors=True)


def release(run):
    """Close a run and free its problem (the next run builds its own)."""
    import gc

    import torch

    run.close()
    run.__dict__.pop("problem", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def on_cost(cell, args, device, out: dict):
    from beat_tpu_torch import profiling
    from portbench.harness.cell import CellRun
    from portbench.tests.sizes import overrides

    run = CellRun(cell, args.seed, args.seconds, False, device=device, t_start=T_START,
                  overrides=overrides(cell) if args.small else None)
    windows, judged = [], None
    try:
        profiling.enable_spans(True)
        run.setup()
        out["library_gb"] = library_gb(profiling.span_snapshot())
        profiling.enable_spans(False)
        out["setup_s"] = run.record.setup_s
        for pair in range(args.pairs):
            order = (False, True) if pair % 2 == 0 else (True, False)
            for on in order:
                profiling.enable_spans(on)
                profiling.reset_spans()
                w = run_window(run, args.seconds, (2, pair))
                profiling.enable_spans(False)
                row = {"pair": pair, "spans": on, "evals_per_s": w["evals_per_s"],
                       "window_s": w["window_s"], "calls": len(w["calls"]),
                       "failed": w["failed"]}
                if on:
                    snap = profiling.span_snapshot()
                    row.update(span_readings(snap, w["t0_ns"], w["t1_ns"],
                                             threading.main_thread().ident))
                    row["by_name"] = snap["by_name"]
                    row["counters"] = snap["counters"]
                # the last spans-on window is judged once every window has run,
                # so that no window follows a comparison; no other's files stay
                if on:
                    if judged is not None:
                        remove(judged["calls"])
                    judged = dict(row=row, calls=w["calls"])
                else:
                    remove(w["calls"])
                print(json.dumps({k: v for k, v in row.items() if k != "by_name"}),
                      flush=True)
                windows.append(row)
        if judged is not None:
            judged["row"].update(judge(run, judged["calls"], args.pairs))
            out["judged"] = {k: judged["row"][k] for k in ("pair", "correct", "checks")}
            print(json.dumps(out["judged"]), flush=True)
            remove(judged["calls"])
    finally:
        profiling.enable_spans(False)
        profiling.reset_spans()
        release(run)
    out["windows"] = windows
    for on in (False, True):
        rates = [w["evals_per_s"] for w in windows if w["spans"] == on]
        out[f"evals_per_s_{'on' if on else 'off'}"] = rates
    pairs = {}
    for w in windows:
        pairs.setdefault(w["pair"], {})[w["spans"]] = w["evals_per_s"]
    out["on_cost_pct"] = [100.0 * (p[False] / p[True] - 1.0) for p in pairs.values()]


def traced(cell, args, device, out: dict):
    """One run as the benchmark's ``--trace 1`` run, with the program's
    spans on from before set-up and reset when the window opens."""
    from beat_tpu_torch import profiling
    from portbench.harness.cell import CellRun
    from portbench.harness.trace import has_device_records
    from portbench.tests.sizes import overrides

    profiling.enable_spans(True)
    run = CellRun(cell, args.seed + 1, args.seconds, True, device=device, t_start=T_START,
                  overrides=overrides(cell) if args.small else None)
    try:
        run.setup()
        built = library_gb(profiling.span_snapshot())
        profiling.reset_spans()
        t0_ns = time.perf_counter_ns()
        run.window()
        t1_ns = time.perf_counter_ns()
        snap = profiling.span_snapshot()
        profiling.enable_spans(False)
        row = span_readings(snap, t0_ns, t1_ns, threading.main_thread().ident)
        row["library_gb"] = built
        paths = [p for p, *_ in run.spans.traces]
        found = [p for p in paths if has_device_records(p)] or paths[:1]
        if found:
            summary = program_summary(found[0])
            row["pair_arith_share"] = pair_arith_share(summary)
            row["span_device_s"] = summary.span_device_s
            row["breakdown"] = {"device_ops": summary.device_ops,
                                "idle_gaps": summary.idle_gaps}
            row["busy_s"], row["trace_window_s"] = summary.busy_s, summary.window_s
        row["by_name"] = snap["by_name"]
        row["counters"] = snap["counters"]
        row["evals_per_s"] = run.record.evals / run.record.window_s
        row.update(judge(run, run.record.calls, 99))
    finally:
        profiling.enable_spans(False)
        profiling.reset_spans()
        release(run)
    print(json.dumps({k: v for k, v in row.items() if k not in ("by_name", "breakdown")}),
          flush=True)
    out["traced"] = row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--small", action="store_true", help="the benchmark tests' CPU sizes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench.harness.catalog import find_cell, load_benchmark

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(load_benchmark(ROOT), args.workload)
    out = {"workload": args.workload, "seed": args.seed, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu")}
    if args.pairs:
        on_cost(cell, args, device, out)
    if args.trace:
        traced(cell, args, device, out)
    print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
