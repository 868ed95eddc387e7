"""
The readings the limits of ``correct`` are set from, on the card at a
cell's own size (the benchmark's own runs do not make them):

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--fault stuck_step]

For each seed, one process makes one run with a window of one call and
prints, as a JSON line, the comparison's numbers of the program (the
lower readings) and the control's: the plain reference computed in TF32
(operands of its matrix products rounded to 10 mantissa bits, float32
sums), put in the program's place on the same rows and held against the
float64 reference.  ``--fault`` plants a fault of ``portbench/faults.py``
in the program first (its readings are upper readings of the numbers the
control does not reach).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_gap(run, record) -> tuple:
    """The widest llk gap of the TF32 reference against the float64 one
    on the rows the comparison drew, and each call's acceptance rates."""
    import numpy as np

    from portbench.harness import judge

    stages = [judge.load_stages(c["home"]) for c in record.calls if not c["failed"]]
    rng = np.random.default_rng(np.random.SeedSequence([run.seed % 2**64, 3]))
    q, _ = judge.sample_rows(stages, record.cell_file["judge"]["rows"], rng)
    block = record.cell_file["judge"]["block"]
    exact = run.cfg.Reference(record.config, run.inputs, run.device)
    llk, scale, _ = judge.reference_llk(exact, q, block)
    del exact
    low = run.cfg.Reference(record.config, run.inputs, run.device, precision="tf32")
    ctl, _, _ = judge.reference_llk(low, q, block)
    acceptance = [[float(st["acceptance"][-1]) for st in call[1:]] for call in stages]
    return float(np.max(np.abs(ctl - llk) / scale)), acceptance


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    import torch

    from portbench import faults
    from portbench.harness.catalog import find_cell, load_benchmark
    from portbench.harness.cell import CellRun

    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 3
    bench = load_benchmark()
    cell = find_cell(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        planted = [faults.FAULTS[args.fault]] if args.fault else []
        run = CellRun(cell, seed, 0.0, False, device=torch.device("cuda", 0),
                      t_start=t0, faults=planted)
        try:
            run.setup()
            run.window()
            record = run.record
            run.judge()
            line = {"workload": cell["name"], "seed": seed, "fault": args.fault,
                    "numbers": record.numbers, "failed": record.failed}
            gap, line["acceptance"] = control_gap(run, record)
            if args.fault is None:
                line["control_llk_gap"] = gap
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
        finally:
            run.close()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
