"""
The readings the ``llk_gap`` limit of a cell on a bfloat16 library is
set from, on the card:

    python3 tools/ffi_bf16_controls.py --seeds 1 2 3 [--workload ffi-smc-bf16]

For each seed, one process-local run with a window of one call, as
``portbench/control.py`` makes it, prints one JSON line: the comparison's
numbers of the program (the lower readings), and on the rows the
comparison drew, held against the float64 reference, the llk gap of two
controls put in the program's place: ``tf32`` (``control.py``'s: the
reference's products in TF32) and ``bf16_weights`` (the reference with
each folded interpolation weight rounded once to bfloat16, the stack the
``mma`` K3 would give without the low half of its split weights).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CONTROLS = ("tf32", "bf16_weights")


def control_gaps(run, record) -> dict:
    """The widest llk gap of each control against the float64 reference
    on the rows the comparison drew."""
    import numpy as np
    import torch

    from portbench.harness import judge

    stages = [judge.load_stages(c["home"]) for c in record.calls if not c["failed"]]
    rng = np.random.default_rng(np.random.SeedSequence([run.seed % 2**64, 3]))
    q, _ = judge.sample_rows(stages, record.cell_file["judge"]["rows"], rng)
    block = record.cell_file["judge"]["block"]
    exact = run.cfg.Reference(record.config, run.inputs, run.device)
    llk, scale, _ = judge.reference_llk(exact, q, block)
    del exact
    gaps = {}
    for precision in CONTROLS:
        low = run.cfg.Reference(record.config, run.inputs, run.device, precision=precision)
        got, _, _ = judge.reference_llk(low, q, block)
        del low
        if run.device.type == "cuda":
            torch.cuda.empty_cache()
        gaps[precision] = float(np.max(np.abs(got - llk) / scale))
    return gaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="ffi-smc-bf16")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench.harness.catalog import find_cell, load_benchmark
    from portbench.harness.cell import CellRun

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = find_cell(load_benchmark(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = CellRun(cell, seed, 0.0, False, device=device, t_start=t0)
        try:
            run.setup()
            run.window()
            record = run.record
            run.judge()
            line = {"workload": cell["name"], "seed": seed, "numbers": record.numbers,
                    "failed": record.failed, "controls": control_gaps(run, record),
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
        finally:
            run.close()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
