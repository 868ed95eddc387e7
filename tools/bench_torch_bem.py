#!/usr/bin/env python3
"""
What one (receiver, element, quadrature point) triple of the port's BEM
assembly (``beat_tpu_torch/bem/tde.py``) costs on one NVIDIA GPU.

    python3 tools/bench_torch_bem.py [--triples N ...]

For the stress evaluation (the nested ``torch.func.jacfwd`` of the
Mindlin kernel) and the surface displacement (one ``jacfwd`` of the
Boussinesq–Cerruti kernel), each at a few chunk sizes: the peak device
memory a triple holds (what ``tde.STRESS_TRIPLE_BYTES`` and
``tde.DISPLACEMENT_TRIPLE_BYTES`` size the chunks by), the ns a triple
by CUDA events, the CUDA calls a chunk makes and the share of its time
the device's kernels take (``torch.profiler``).  Prints the card's name
and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from beat_tpu_torch.bem import tde
    from beat_tpu_torch.device import require_cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--triples", type=int, nargs="+", default=[100_000, 400_000])
    args = ap.parse_args()
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    mu, nu = 33e9, 0.25
    kinds = {
        "stress": lambda x, xi, m: tde._displacement_gradient(x, xi, m, mu, nu, "halfspace"),
        "surface": lambda x, xi, m: tde._surface_point_displacement(x, xi, m, mu, nu),
    }
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for kind, fn in kinds.items():
        for n in args.triples if kind == "stress" else [10 * t for t in args.triples]:
            x = torch.rand((n, 3), generator=gen, device=dev, dtype=tde.FLOAT) * 2e3
            xi = torch.rand((n, 3), generator=gen, device=dev, dtype=tde.FLOAT) * 2e3 + 1e3
            m = torch.rand((n, 3, 3), generator=gen, device=dev, dtype=tde.FLOAT)
            if kind == "surface":
                x[:, 2] = 0.0

            def run():
                return torch.func.vmap(fn)(x, xi, m)

            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            events = prof.key_averages()
            kernel_ms = sum(e.self_device_time_total for e in events
                            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            calls = sum(e.count for e in events
                        if e.device_type == torch.autograd.DeviceType.CPU
                        and e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
            out[f"{kind}_{n}"] = {"triples": n, "peak_bytes_per_triple": round(peak / n, 1),
                                  "ns_per_triple": round(1e6 * ms / n, 2), "ms": round(ms, 3),
                                  "kernel_ms": round(kernel_ms, 3), "launches": calls}
            print(kind, out[f"{kind}_{n}"], flush=True)
            del x, xi, m
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "bem_triples": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
