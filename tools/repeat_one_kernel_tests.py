#!/usr/bin/env python3
"""
Run the card tests that count the device operations of one kernel call
(``tests/test_torch_gpu.py``: ``test_k5_call_is_one_kernel`` with int64
and int32 indices, ``test_k3_main_path_call_is_one_kernel_and_one_allocation``)
several times on one NVIDIA GPU, and print how many runs of each passed:

    python3 tools/repeat_one_kernel_tests.py [--runs 10]

Each run profiles its call in a fresh process (about 20 s a run on an
H100 host: the process start, torch's CUDA init and the kernel load).
Exits non-zero if any run failed.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("repeat_one_kernel_tests: CUDA is not available", file=sys.stderr)
        return 2
    import test_torch_gpu as tg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    cuda = torch.device("cuda", 0)
    cases = {"k5_int64": lambda: tg.test_k5_call_is_one_kernel(cuda, torch.int64),
             "k5_int32": lambda: tg.test_k5_call_is_one_kernel(cuda, torch.int32),
             "k3_main_path": lambda: tg.test_k3_main_path_call_is_one_kernel_and_one_allocation(
                 cuda)}
    passes = {}
    for name, case in cases.items():
        passes[name] = 0
        for run in range(args.runs):
            try:
                case()
                passes[name] += 1
            except AssertionError as e:
                print(f"{name} run {run}: FAILED {str(e)[:500]}", flush=True)
    print(json.dumps({"runs": args.runs, "passes": passes}))
    return 0 if all(n == args.runs for n in passes.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
