#!/usr/bin/env python3
"""
Times the port's fused gather kernels K1c and K2c
(``beat_tpu_torch/csrc/bilgather.cu``) on one NVIDIA GPU, at the FullMT
main path's shape, for queries laid out as the forward issues them.

    python3 tools/bench_torch_contract.py [--source other.cu ...] [--define BEAT_ABLATE=n ...]

The table is random at the real size (618 × 15 rows of 6156 floats), the
queries are 2000 chains × 30 targets, chain-major, in three layouts: each
target's chains on 8 depth cells (``prior``: the flagship's depth prior
over the table's 2 km depth step), on 2 (``posterior``), or anywhere
(``random``).  Each build — the repository's source, the source built
with ``-D<define>`` for each ``--define`` (``BEAT_ABLATE``: parts left
out), and each ``--source`` file with the same C entries (a copy of
``bilgather.cu`` with other tile sizes, say) — is timed with CUDA events in turns with the
repository's build (a, b, b, a) on the same operands, and its result's
largest difference from the repository's is printed beside its time.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_source(path: str):
    """An extra kernel source with bilgather.cu's C entries, built as the
    repository's sources are and loaded with the same signatures."""
    from beat_tpu_torch.kernels.build import BUILD_DIR, NVCC_FLAGS, SIGNATURES, nvcc_path

    text = open(path, "rb").read()
    out = BUILD_DIR / f"libbench-{hashlib.sha256(text).hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(out), path],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    for fn, (restype, argtypes) in SIGNATURES["bilgather"].items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def main() -> int:
    import torch

    from beat_tpu_torch.kernels.build import launch, load

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[])
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch_contract: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    CD, NZ, nf, C, T = 618, 15, 513, 2000, 30
    L, n = 2 * nf, C * T
    gen = torch.Generator(device=dev).manual_seed(0)
    tbl = torch.randn((CD, NZ, 6 * L), generator=gen, device=dev)
    A = torch.randn((n, 4, 6), generator=gen, device=dev)
    G = torch.randn((n, L), generator=gen, device=dev)

    def queries(layout):
        if layout == "random":
            cd = torch.randint(0, CD - 1, (C, T), generator=gen, device=dev)
            z0 = torch.randint(0, NZ - 1, (C, T), generator=gen, device=dev)
        else:
            cells = 8 if layout == "prior" else 2
            cd = torch.randint(0, CD - 1, (1, T), generator=gen, device=dev).expand(C, T)
            z0 = 1 + torch.randint(0, cells, (C, T), generator=gen, device=dev)
        return cd.to(torch.int32).contiguous(), z0.to(torch.int32).contiguous()

    builds = {"repo": load("bilgather")[0]}
    for d in args.define:
        builds[f"-D{d}"] = load("bilgather", (f"-D{d}",))[0]
    for path in args.source:
        builds[os.path.basename(path)] = build_source(path)

    def runner(lib, kernel, cd, z0):
        out = torch.empty((n, L) if kernel == "k1c" else (n, 4, 6), device=dev)
        entry = (lib.beat_bilinear_contract_f32 if kernel == "k1c"
                 else lib.beat_contract_corner_dot_f32)
        x = A if kernel == "k1c" else G

        def run():
            rc = launch(dev, entry, tbl.data_ptr(), cd.data_ptr(), z0.data_ptr(), x.data_ptr(),
                        out.data_ptr(), n, T, NZ, L)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
            return out
        return run

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

    result = {}
    for layout in ("prior", "posterior", "random"):
        cd, z0 = queries(layout)
        for kernel in ("k1c", "k2c"):
            base = runner(builds["repo"], kernel, cd, z0)
            ref = base().clone()
            row = {}
            for name, lib in builds.items():
                other = runner(lib, kernel, cd, z0)
                diff = float((other() - ref).abs().max())
                a1, b1 = ms(base), ms(other)
                b2, a2 = ms(other), ms(base)
                row[name] = {"ms": 0.5 * (b1 + b2), "repo_ms": 0.5 * (a1 + a2),
                             "max_abs_diff": diff}
            result[f"{kernel}_{layout}"] = row
            print(kernel, layout, json.dumps(row), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
