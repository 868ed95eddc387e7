#!/usr/bin/env python3
"""
K3 and K4 (``beat_tpu_torch/csrc/gfstack.cu``) on one NVIDIA GPU, on a
float32 and a bfloat16 library: every variant that can run (K3: ``tiled``,
``gather`` and, on bfloat16, ``mma``; K4: ``tiled``, ``gather``) held
against the plain version and timed in turns.

    python3 tools/bench_torch_stack.py [--case T P D S N C ...] [--k3-only] [--ablate]
                                       [--shared-onsets]

For each case (default the L'Aquila shape of
``examples/laquila_scale_ffi.py`` with 2000 chains) a random float32
library, its bfloat16 copy, and random onsets on and beyond its grids:
per target, or with ``--shared-onsets`` every target's the same, (C, 1,
P), as the kinematic FFI forward hands them to K3.  There float32
``tiled`` K3 is ``tiled_fed``: its entries folded once a call and fed to
its blocks by bulk copies; ``tiled_block`` is the ``tiled`` body, each
block folding its own entries, timed in turns with it.
Each variant must sit within the stack's bar, 1e-5 · Σ_p |slip| ·
Σ_corners |w| · max|data| per (chain, target), of the plain version on
the same library and equal itself on a second call; ``tiled`` and
``gather`` must be equal.  Prints the card's name and power limit, the
build's register and shared-memory report of the kernels, and one JSON
line a case: per storage type and kernel the variant ``plan_stack``
picks, the row reuse it reads (chains of a tile · corners / D·S),
milliseconds per variant (CUDA events, the variants in turns a, b, c, c,
b, a) and, for K3, the distinct cells of each 8-chain group's 32 rows.
No kernel profiler runs on every machine, so ``--ablate`` also times
builds of the body the plan picks (``tiled`` or ``mma``) with parts of it
left out (``-DBEAT_ABLATE``: the fold of the per-chain entries, the tile
copies, the sums and, for ``mma``, the products and the ldmatrix loads),
beside the whole build; such builds compute nothing of use.  The fed
``tiled`` body (``tiled_fed``) is timed as the fold's launch and the
stack's: ``no_fold`` leaves the fold's launch out (its entries stay those
of the whole build's fold), ``no_copies`` the bulk copies after the first
two of each kind, and ``halfway`` is the build whose variant 3 runs the
halfway design instead (the entries folded once a call, each block's
summing threads copying them and the cell tiles by cp.async; equal to the
fed body bit for bit), timed against the whole build in four rounds of
turns (whole, halfway, halfway, whole).
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
#: --ablate: the builds timed beside the whole one, by the body they cut
BUILDS = {"no_fold": 1, "no_copies": 2, "sums_only": 3, "no_sums": 4, "copies_only": 5,
          "no_mma": 8, "no_ldmatrix": 16, "halfway": 32}
ABLATED = {"tiled": ("no_fold", "no_copies", "sums_only", "no_sums", "copies_only"),
           "mma": ("no_fold", "no_copies", "sums_only", "no_sums", "copies_only", "no_mma",
                   "no_ldmatrix")}
ABLATED["tiled_fed"] = ABLATED["tiled"]


def main() -> int:
    import torch

    from beat_tpu_torch.ffi import SeismicGFLibrary
    from beat_tpu_torch.kernels.build import build, launch, load
    from beat_tpu_torch.ops.gfstack import (_ENTRIES, _VARIANT_CODES, _clamp_cells,
                                            _fold_shape, _launch, group_cells, plan_stack,
                                            stack_batched_reference, stack_operands)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", type=int, nargs=6, action="append",
                    metavar=("T", "P", "D", "S", "N", "C"),
                    help="a library shape and a chain count (repeatable; default the "
                         "L'Aquila shape with 2000 chains)")
    ap.add_argument("--k3-only", action="store_true", help="leave K4 out")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--shared-onsets", action="store_true",
                    help="every target on the same onsets, (C, 1, P)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_stack: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    # every build at once, one nvcc each
    defines = [()] + ([(f"-DBEAT_ABLATE={m}",) for m in BUILDS.values()] if args.ablate else [])
    with ThreadPoolExecutor(max_workers=len(defines)) as pool:
        infos = list(pool.map(lambda d: build("gfstack", d), defines))
    print("\n".join(line for line in infos[0].log.splitlines()
                    if "gf_stack" in line or "registers" in line or "spill" in line),
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

    def one_kernel(lib, durations, starttimes, slips, interpolation):
        """One kernel on one library: its variants held and timed, the
        plan's body ablated."""
        T, P, D, S, N = lib.data.shape
        C = durations.shape[0]
        elem = lib.data.element_size()
        didx, rtf = lib.durations2idxs(durations, interpolation)
        sidx, stf = lib.starttimes2idxs(starttimes, interpolation)
        corners = 4 if rtf is not None else 1
        ref = stack_batched_reference(lib.data, didx, sidx, slips, rtf, stf)
        wabs = 1.0
        if rtf is not None:
            wabs = (rtf.abs() + (1 - rtf).abs())[:, None, :] * (stf.abs() + (1 - stf).abs())
        bar = STACK_RTOL * (slips.abs()[:, None, :] * wabs).sum(-1) * lib.data.float().abs().max()
        shared = sidx.shape[1] == 1
        plan = plan_stack(T, P, D, S, N, C, corners, elem_bytes=elem, shared_onsets=shared)
        body = plan.variant
        r = {"plan": body, "reuse": min(C, 512) * corners / (D * S)}
        plans = {}
        for v in VARIANTS["k3" if corners == 4 else "k4"]:
            try:
                plans[v] = plan_stack(T, P, D, S, N, C, corners, variant=v, elem_bytes=elem,
                                      shared_onsets=shared)
            except ValueError:                      # cannot run at this shape or type
                pass
        if "tiled" in plans and plans["tiled"].variant == "tiled_fed":
            plans["tiled_block"] = plan_stack(T, P, D, S, N, C, corners, variant="tiled",
                                              elem_bytes=elem)
        variants = list(plans)
        ok, outs = True, {}
        for v in variants:
            got = _launch(lib.data, didx, sidx, slips, rtf, stf, plans[v])
            again = _launch(lib.data, didx, sidx, slips, rtf, stf, plans[v])
            torch.cuda.synchronize()
            r[f"{v}_worst_err_over_bar"] = float(((got - ref).abs().amax(-1) / bar).max())
            r[f"{v}_deterministic"] = bool(torch.equal(got, again))
            ok &= r[f"{v}_worst_err_over_bar"] <= 1.0 and r[f"{v}_deterministic"]
            outs[v] = got
        for v in ("tiled", "tiled_block"):
            if v in outs:
                r[f"{v}_equals_gather"] = bool(torch.equal(outs[v], outs["gather"]))
                ok &= r[f"{v}_equals_gather"]
        outs_fed = outs.get("tiled") if body == "tiled_fed" else None
        del outs, ref
        runs = {v: (lambda v=v: _launch(lib.data, didx, sidx, slips, rtf, stf, plans[v]))
                for v in variants}
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            times[v].append(ms(runs[v]))
        r.update({f"{v}_ms": sum(x) / len(x) for v, x in times.items()})
        r["fastest"] = min(variants, key=lambda v: r[f"{v}_ms"])
        if corners == 4:
            r["group_cells"] = group_cells(*_clamp_cells(lib.data, didx, sidx, True))
        if args.ablate and body in ABLATED:
            tensors, strides = stack_operands(didx, sidx, slips, rtf, stf)
            out = torch.empty((C, T, N), device=dev)
            entry_name = _ENTRIES[lib.data.dtype][0 if corners == 4 else 1]
            fed = body == "tiled_fed"
            folded = torch.empty(_fold_shape(C, P, plan), device=dev) if fed else None

            def run(built):
                rc = 0
                if fed:
                    rc = launch(dev, built.beat_gf_stack_fold_f32,
                                *(x.data_ptr() for x in tensors), folded.data_ptr(), C, P, D,
                                S, strides[0], strides[1], strides[3], strides[4], strides[5],
                                plan.lanes, plan.chunk_shift)
                rc = rc or launch(dev, getattr(built, entry_name), lib.data.data_ptr(),
                                  *(x.data_ptr() for x in tensors), out.data_ptr(), C, T, P, D,
                                  S, N, *strides, _VARIANT_CODES[body], plan.lanes,
                                  plan.chunk_shift, folded.data_ptr() if fed else None)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            whole, _ = load("gfstack")
            r["ablate"] = {"body": body, "whole": ms(lambda: run(whole))}
            for build_name in ABLATED[body]:
                ablated, _ = load("gfstack", (f"-DBEAT_ABLATE={BUILDS[build_name]}",))
                r["ablate"][build_name] = ms(lambda: run(ablated))
            r["ablate"]["whole_again"] = ms(lambda: run(whole))
            if fed:
                half, _ = load("gfstack", (f"-DBEAT_ABLATE={BUILDS['halfway']}",))
                run(half)
                torch.cuda.synchronize()
                r["ablate"]["halfway_equals_fed"] = bool(torch.equal(out, outs_fed))
                turns = {"whole": [], "halfway": []}
                for _ in range(4):
                    for name in ("whole", "halfway", "halfway", "whole"):
                        turns[name].append(ms(lambda: run(whole if name == "whole" else half)))
                r["ablate"]["turns"] = turns
        return r, ok

    def one_case(T, P, D, S, N, C):
        gen = torch.Generator(device=dev).manual_seed(13)
        lib32 = SeismicGFLibrary(torch.randn((T, P, D, S, N), generator=gen, device=dev),
                                 duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
                                 starttime_sampling=0.25, device=dev)

        def uniform(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

        durations = uniform((C, P), 0.2, 0.5 * D + 0.5)
        starttimes = uniform((C, 1 if args.shared_onsets else T, P), -0.5, 0.25 * S + 1.0)
        slips = uniform((C, P), 0.0, 3.0)
        result = {"shape": [T, P, D, S, N], "chains": C, "shared_onsets": args.shared_onsets}
        ok = True
        kernels = (("k3", "multilinear"),) + (() if args.k3_only else (("k4", "nearest_neighbor"),))
        for dtype in (torch.float32, torch.bfloat16):
            lib = lib32 if dtype == torch.float32 else lib32.to_dtype(dtype)
            key = str(dtype).removeprefix("torch.")
            result[key] = {}
            for name, interpolation in kernels:
                result[key][name], kernel_ok = one_kernel(lib, durations, starttimes, slips,
                                                          interpolation)
                ok &= kernel_ok
            del lib
        print(json.dumps(result), flush=True)
        return ok

    ok = True
    for case in args.case or [(12, 500, 10, 32, 512, 2000)]:
        ok &= one_case(*case)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
