#!/usr/bin/env python3
"""
Where the time of the port's tiled GF-stack kernel (K3/K4,
``beat_tpu_torch/csrc/gfstack.cu``) goes, on one NVIDIA GPU.

    python3 tools/bench_torch_gfstack.py [--shape T P D S N] [--chains C]

No kernel profiler runs on every machine, so the kernel is built several
times with parts of it left out (``-DBEAT_ABLATE``: the fold of the
per-chain entries, the copies of the cell tiles, the sums) and each build
is timed with CUDA events on the same random operands, beside the whole
kernel and the ``gather`` variant.  The ablated builds compute nothing of
use; only the whole kernel is held against ``gather`` (bit for bit).
Prints the card's name and power limit and one JSON line of milliseconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BUILDS = {"whole": 0, "no_fold": 1, "no_copies": 2, "sums_only": 3, "no_sums": 4,
          "copies_only": 5}


def main() -> int:
    import torch

    from beat_tpu_torch.kernels.build import launch, load
    from beat_tpu_torch.ops.gfstack import plan_stack, stack_operands

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=5, default=(12, 500, 10, 32, 512),
                    metavar=("T", "P", "D", "S", "N"))
    ap.add_argument("--chains", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_gfstack: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    T, P, D, S, N = args.shape
    C = args.chains
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randn((T, P, D, S, N), generator=gen, device=dev)
    didx = torch.randint(1, D, (C, P), generator=gen, device=dev, dtype=torch.int32)
    sidx = torch.randint(1, S, (C, 1, P), generator=gen, device=dev, dtype=torch.int32)
    slips = 3 * torch.rand((C, P), generator=gen, device=dev)
    rtf = torch.rand((C, P), generator=gen, device=dev)
    stf = torch.rand((C, 1, P), generator=gen, device=dev)
    out = torch.empty((C, T, N), device=dev)

    def run(lib, plan, corners):
        ops = (didx, sidx, slips) + ((rtf, stf) if corners == 4 else ())
        tensors, strides = stack_operands(*ops)
        entry = (lib.beat_gf_stack_multilinear_f32 if corners == 4
                 else lib.beat_gf_stack_nearest_f32)
        rc = launch(dev, entry, data.data_ptr(), *(x.data_ptr() for x in tensors),
                    out.data_ptr(), C, T, P, D, S, N, *strides, int(plan.variant == "tiled"),
                    plan.lanes, plan.chunk_shift)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def ms(fn):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    result = {"shape": list(args.shape), "chains": C}
    for corners, name in ((4, "k3"), (1, "k4")):
        tiled = plan_stack(T, P, D, S, N, C, corners, variant="tiled")
        gather = plan_stack(T, P, D, S, N, C, corners, variant="gather")
        whole, _ = load("gfstack")
        run(whole, gather, corners)
        want = out.clone()
        run(whole, tiled, corners)
        torch.cuda.synchronize()
        r = {"tiled_equals_gather": bool(torch.equal(out, want)),
             "gather": ms(lambda: run(whole, gather, corners))}
        for build, mask in BUILDS.items():
            lib, _ = load("gfstack", (f"-DBEAT_ABLATE={mask}",) if mask else ())
            r[build] = ms(lambda: run(lib, tiled, corners))
        result[name] = r
    print(json.dumps(result))
    return 0 if all(result[k]["tiled_equals_gather"] for k in ("k3", "k4")) else 1


if __name__ == "__main__":
    sys.exit(main())
