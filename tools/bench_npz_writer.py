"""
The stage-file writer's rate on this host: ``np.savez_compressed``,
``np.savez`` (stored) and ``beat_tpu_torch.npzwrite.savez_deflated`` at
a range of pool sizes and chunk sizes, on a trace shaped like the
kinematic FFI cells' stage traces.

    python3 tools/bench_npz_writer.py [--records 4] [--chains 5000] \\
        [--dim 1504] [--moved 0.16] [--workers 1,2,4,7] \\
        [--chunks 262144,1048576,4194304] [--reps 2] [--dir DIR]

The trace is float32 (records, chains, dim): the first record uniform,
each later one the previous with a share ``--moved`` of the chains
drawn anew, as a Metropolis trace keeps a chain's row until it moves.
Each writer writes it ``--reps`` times into ``--dir`` (a temporary
directory under ``TMPDIR`` by default, removed at the end); the best
rate is kept.  Every chunked file is checked against numpy's: member
names, decompressed bytes and the arrays ``np.load`` gives.  One JSON
line per writer; the last line holds the host (usable cores, CPU model)
and every row.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import sys
import tempfile
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from beat_tpu_torch import npzwrite  # noqa: E402


def make_trace(records: int, chains: int, dim: int, moved: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    q = np.empty((records, chains, dim), np.float32)
    q[0] = rng.uniform(0.0, 5.0, (chains, dim))
    for r in range(1, records):
        q[r] = q[r - 1]
        hit = rng.random(chains) < moved
        q[r, hit] = rng.uniform(0.0, 5.0, (int(hit.sum()), dim))
    return {"q": q, "llk": rng.normal(size=(records, chains)).astype(np.float32)}


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def best_seconds(write, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        write()
        best = min(best, time.perf_counter() - t0)
    return best


def same_members(path: str, want: str) -> bool:
    with zipfile.ZipFile(path) as got, zipfile.ZipFile(want) as ref:
        if got.testzip() is not None or got.namelist() != ref.namelist():
            return False
        return all(got.read(n) == ref.read(n) for n in ref.namelist())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--records", type=int, default=4)
    p.add_argument("--chains", type=int, default=5000)
    p.add_argument("--dim", type=int, default=1504)
    p.add_argument("--moved", type=float, default=0.16)
    p.add_argument("--workers", default="1,2,4,7")
    p.add_argument("--chunks", default=str(npzwrite.CHUNK))
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dir", default=None)
    args = p.parse_args(argv)

    arrays = make_trace(args.records, args.chains, args.dim, args.moved, args.seed)
    nbytes = sum(a.nbytes for a in arrays.values())
    workdir = tempfile.mkdtemp(dir=args.dir, prefix="npz_writer_")
    rows = []

    def row(**kw):
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    try:
        ref = os.path.join(workdir, "numpy.npz")
        s = best_seconds(lambda: np.savez_compressed(ref, **arrays), args.reps)
        ref_size = os.path.getsize(ref)
        row(writer="savez_compressed", mb_per_s=nbytes / 1e6 / s, size=ref_size)
        stored = os.path.join(workdir, "stored.npz")
        s = best_seconds(lambda: np.savez(stored, **arrays), args.reps)
        row(writer="savez", mb_per_s=nbytes / 1e6 / s, size=os.path.getsize(stored))
        os.remove(stored)

        chunk_before, shared_before = npzwrite.CHUNK, npzwrite._shared
        try:
            for chunk in (int(c) for c in args.chunks.split(",")):
                for workers in (int(w) for w in args.workers.split(",")):
                    npzwrite.CHUNK = chunk
                    executor = ThreadPoolExecutor(workers) if workers > 1 else None
                    npzwrite._shared = (executor, workers)
                    path = os.path.join(workdir, "chunked.npz")
                    try:
                        s = best_seconds(lambda: npzwrite.savez_deflated(path, arrays),
                                         args.reps)
                    finally:
                        if executor is not None:
                            executor.shutdown()
                    size = os.path.getsize(path)
                    ok = same_members(path, ref)
                    with np.load(path) as z:
                        ok = ok and all(np.array_equal(z[k], v) for k, v in arrays.items())
                    row(writer="savez_deflated", chunk=chunk, workers=workers,
                        mb_per_s=nbytes / 1e6 / s, size=size, size_ratio=size / ref_size,
                        same=ok)
                    os.remove(path)
        finally:
            npzwrite.CHUNK, npzwrite._shared = chunk_before, shared_before
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    print(json.dumps({"host_cores": cores, "cpu": cpu_model(), "bytes": nbytes,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
