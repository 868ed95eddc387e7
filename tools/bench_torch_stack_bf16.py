#!/usr/bin/env python3
"""
K3 and K4 on a bfloat16 library on one NVIDIA GPU: every variant that
can run (K3: ``mma``, ``tiled``, ``gather``; K4: ``tiled``, ``gather``)
held against the plain version and timed in turns.

    python3 tools/bench_torch_stack_bf16.py [--case T P D S N C ...] [--k3-only] [--ablate]

For each case (default the Laquila shape of
``examples/laquila_scale_ffi.py`` with 2000 chains) a random library in
bfloat16 and random onsets on and beyond its grids, as ``chip_smoke.py``
[k3_bf16] draws them.  Each variant must sit within the stack's bar,
1e-5 · Σ_p |slip| · Σ_corners |w| · max|data| per (chain, target), of
the plain version and equal itself on a second call; ``tiled`` and
``gather`` must be equal.  Prints the card's name and power limit, the
build's register and shared-memory report of the mma kernel, and one
JSON line a case: the variant ``plan_stack`` picks, the row reuse it
reads (chains of a tile · corners / D·S), milliseconds per variant (CUDA
events, the variants in turns a, b, c, c, b, a) and the distinct cells of
each 8-chain group's 32 rows of K3.  ``--ablate`` also times builds of
the mma kernel with parts left out (``-DBEAT_ABLATE``: the fold of the
entries, the tile copies, the sums, the products, the ldmatrix loads), as
``tools/bench_torch_gfstack.py`` does for ``tiled``: such builds compute
nothing of use.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {"k3": ("mma", "tiled", "gather"), "k4": ("tiled", "gather")}
STACK_RTOL = 1e-5
#: --ablate: the builds of the mma kernel timed beside the whole one
BUILDS = {"no_fold": ("-DBEAT_ABLATE=1",), "no_copies": ("-DBEAT_ABLATE=2",),
          "sums_only": ("-DBEAT_ABLATE=3",), "no_sums": ("-DBEAT_ABLATE=4",),
          "copies_only": ("-DBEAT_ABLATE=5",), "no_mma": ("-DBEAT_ABLATE=8",),
          "no_ldmatrix": ("-DBEAT_ABLATE=16",)}


def main() -> int:
    import torch

    from beat_tpu_torch.ffi import SeismicGFLibrary
    from beat_tpu_torch.kernels.build import build, launch, load
    from beat_tpu_torch.ops.gfstack import (_ENTRIES, _VARIANT_CODES, _clamp_cells,
                                            group_cells, plan_stack, stack_batched,
                                            stack_batched_reference, stack_operands)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", type=int, nargs=6, action="append",
                    metavar=("T", "P", "D", "S", "N", "C"),
                    help="a library shape and a chain count (repeatable; default the "
                         "Laquila shape with 2000 chains)")
    ap.add_argument("--k3-only", action="store_true", help="leave K4 out")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_stack_bf16: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    # every build at once, one nvcc each
    defines = [()] + (list(BUILDS.values()) if args.ablate else [])
    with ThreadPoolExecutor(max_workers=len(defines)) as pool:
        infos = list(pool.map(lambda d: build("gfstack", d), defines))
    print("\n".join(line for line in infos[0].log.splitlines()
                    if "gf_stack_mma" in line or "registers" in line or "spill" in line),
          flush=True)

    def ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    def one_case(T, P, D, S, N, C):
        gen = torch.Generator(device=dev).manual_seed(13)
        lib = SeismicGFLibrary(torch.empty((T, P, D, S, N), dtype=torch.bfloat16, device=dev),
                               duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                               starttime_sampling=0.25, device=dev, dtype=torch.bfloat16)
        for t in range(T):                              # a target at a time: float32 temporaries
            lib.data[t] = torch.randn((P, D, S, N), generator=gen, device=dev)

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

        durations = uniform((C, P), 0.2, 0.5 * D + 0.5)
        starttimes = uniform((C, T, P), -0.5, 0.25 * S + 1.0)
        slips = uniform((C, P), 0.0, 3.0)
        result, ok = {"shape": [T, P, D, S, N], "chains": C}, True
        kernels = (("k3", "multilinear"),) + (() if args.k3_only else (("k4", "nearest_neighbor"),))
        for name, interpolation in kernels:
            didx, rtf = lib.durations2idxs(durations, interpolation)
            sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
            corners = 4 if rtf is not None else 1
            ref = stack_batched_reference(lib.data, didx, sidx, slips, rtf, stf)
            wabs = 1.0
            if rtf is not None:
                wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
            bar = (STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1)
                   * lib.data.float().abs().max())
            r = {"plan": plan_stack(T, P, D, S, N, C, corners, elem_bytes=2).variant,
                 "reuse": min(C, 512) * corners / (D * S)}
            variants = []
            for v in VARIANTS[name]:
                try:
                    plan_stack(T, P, D, S, N, C, corners, variant=v, elem_bytes=2)
                    variants.append(v)
                except ValueError:                      # cannot run at this shape
                    pass
            outs = {}
            for v in variants:
                got = stack_batched(lib.data, didx, sidx, slips, rtf, stf, variant=v)
                again = stack_batched(lib.data, didx, sidx, slips, rtf, stf, variant=v)
                torch.cuda.synchronize()
                r[f"{v}_worst_err_over_bar"] = float(((got - ref).abs().amax(-1) / bar).max())
                r[f"{v}_deterministic"] = bool(torch.equal(got, again))
                ok &= r[f"{v}_worst_err_over_bar"] <= 1.0 and r[f"{v}_deterministic"]
                outs[v] = got
            if "tiled" in outs:
                r["tiled_equals_gather"] = bool(torch.equal(outs["tiled"], outs["gather"]))
                ok &= r["tiled_equals_gather"]
            del outs, ref
            runs = {v: (lambda v=v: stack_batched(lib.data, didx, sidx, slips, rtf, stf,
                                                  variant=v)) for v in variants}
            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                times[v].append(ms(runs[v]))
            r.update({f"{v}_ms": sum(x) / len(x) for v, x in times.items()})
            r["fastest"] = min(variants, key=lambda v: r[f"{v}_ms"])
            if corners == 4:
                r["group_cells"] = group_cells(*_clamp_cells(lib.data, didx, sidx, True))
            if args.ablate and corners == 4:
                plan = plan_stack(T, P, D, S, N, C, corners, variant="mma", elem_bytes=2)
                tensors, strides = stack_operands(didx, sidx, slips, rtf, stf)
                out = torch.empty((C, T, N), device=dev)

                def run(built):
                    entry = getattr(built, _ENTRIES[torch.bfloat16][0])
                    rc = launch(dev, entry, lib.data.data_ptr(),
                                *(x.data_ptr() for x in tensors), out.data_ptr(),
                                C, T, P, D, S, N, *strides, _VARIANT_CODES["mma"], plan.lanes,
                                plan.chunk_shift)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

                whole, _ = load("gfstack")
                r["ablate"] = {"whole": ms(lambda: run(whole))}
                for build_name, build_defines in BUILDS.items():
                    ablated, _ = load("gfstack", build_defines)
                    r["ablate"][build_name] = ms(lambda: run(ablated))
                r["ablate"]["whole_again"] = ms(lambda: run(whole))
            result[name] = r
        print(json.dumps(result), flush=True)
        return ok

    ok = True
    for case in args.case or [(12, 500, 10, 32, 512, 2000)]:
        ok &= one_case(*case)
        torch.cuda.empty_cache()
    return 0 if ok else 1

if __name__ == "__main__":
    sys.exit(main())
