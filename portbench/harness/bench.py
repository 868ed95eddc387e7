"""
The command line of the benchmark:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It runs on the machine it is started on, on the card, and nowhere else:
without CUDA, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.  It checks at exit that neither JAX nor
the JAX package was imported.  The last line of standard output is
the result; the numbers compared, each beside its limit, are the last
lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

from portbench.harness.catalog import ROOT, cell_metrics, find_cell, load_benchmark
from portbench.harness.guard import forbidden_modules

def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int) -> int:
    print(f"portbench: {message}", file=sys.stderr, flush=True)
    return code


def card_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result_line(record, metrics: dict, correct: bool, traced: bool, checks: list) -> dict:
    import torch

    dev = record.device
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
              "memory_peak_bytes": int(record.peak_bytes or 0)}
    out = {"correct": correct, "attempted": len(record.calls), "failed": record.failed,
           "metrics": metrics, "device": device}
    if traced and record.trace is not None and record.trace.busy_s:
        device["busy_s"] = record.trace.busy_s
        device["window_s"] = record.trace.window_s
        out["breakdown"] = {"device_ops": [[n, s] for n, s in record.trace.device_ops],
                            "idle_gaps": record.trace.idle_gaps}
    out["checks"] = {name: {"value": finite(value), "limit": limit}
                     for name, value, limit in checks}
    return out


def finite(value):
    """A number for the JSON line: None where the comparison could not
    read one (no call finished, a stage missing)."""
    return value if value is not None and math.isfinite(value) else None


def main(argv, t_start: float) -> int:
    args = parse(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        return fail(f"no BENCHMARK.json at {ROOT}", 2)
    bench = load_benchmark()
    try:
        cell = find_cell(bench, args.workload)
    except KeyError as err:
        return fail(str(err), 2)

    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"the cell needs {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} present", 3)
    try:
        import beat_tpu_torch  # noqa: F401 - the program under test
    except ImportError as err:
        return fail(f"the program is not in this checkout: {err}", 2)

    from portbench.harness.catalog import read_metrics
    from portbench.harness.cell import CellRun, checks, is_correct

    print(f"portbench: {args.workload} seed {args.seed} on {card_limit()}", file=sys.stderr,
          flush=True)
    run = CellRun(cell, args.seed, args.seconds, bool(args.trace),
                  device=torch.device("cuda", 0), t_start=t_start)
    record = run.run()
    key = "per_layer" if args.trace else "end_to_end"
    metrics = read_metrics(cell_metrics(bench, cell["name"], key), record)
    found = forbidden_modules(sys.modules)
    if found:
        return fail(f"modules of JAX or the JAX package were imported: {sorted(found)}", 4)
    compared = checks(record)
    line = result_line(record, metrics, is_correct(record), bool(args.trace), compared)
    for call in record.calls:
        if call.get("error"):
            print(f"portbench: call seed {call['seed']} failed: {call['error']}",
                  file=sys.stderr)
    print(f"portbench: observed data made by the reference in {record.inputs_s:.3f} s, "
          f"outside setup_s", file=sys.stderr)
    for name, value, limit in compared:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
