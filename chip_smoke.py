#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``beat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's main path — the geometry-mode FullMT moment-tensor
inversion with SMC — at real size (206 × 15 × nt 1024 GF table, 10
stations / 30 targets, 2000 chains), in phases that each print one
line; any failure ends the run non-zero:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: kernel K1 (``beat_tpu_torch/csrc/bilgather.cu``) from source;
3. K1 against its plain PyTorch version at the main path's shapes
   (60,000 queries), max |err| <= 1e-6 · max|ref|, and both times;
4. the 2000-chain log-likelihood through K1 against the plain gather,
   rtol 2e-5;
5. ``Problem.sample()`` with SMC (2000 chains, 60 steps per stage): it
   must reach β = 1 with finite llks, launch K1, and recover the true
   depth (±500 m) and magnitude (±0.05);
6. a JSON line per kernel, then ``{"ok": true, "device": ...}`` last.

It needs CUDA and exits non-zero without it; it never falls back to
the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

os.environ.pop("BEAT_TPU_PLATFORM", None)   # beat_tpu would import jax

N_CHAINS = 2000
N_STEPS = 60
K1_RTOL = 1e-6          # K1 vs plain: max |err| <= K1_RTOL · max|ref|
LLK_RTOL = 2e-5         # the JAX package's per-chain llk bar
DEPTH_TOL, MAG_TOL = 500.0, 0.05


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_queries(table, n: int, gen):
    """Random K1 queries over all three channel blocks, with top-edge
    nodes (fd or fz exactly 1.0) among them."""
    import torch

    nd, nz = table.distances.size, table.depths.size
    dev = table.packed.device
    comp = torch.randint(0, 3, (n,), generator=gen, device=dev)
    d0 = torch.randint(0, nd - 1, (n,), generator=gen, device=dev)
    z0 = torch.randint(0, nz - 1, (n,), generator=gen, device=dev)
    fd = torch.rand(n, generator=gen, device=dev)
    fz = torch.rand(n, generator=gen, device=dev)
    edge = torch.arange(n, device=dev) % 7 == 0
    d0 = torch.where(edge, nd - 2, d0)
    fd = torch.where(edge, 1.0, fd)
    z0 = torch.where(edge, nz - 2, z0)
    fz = torch.where(edge, 1.0, fz)
    w4 = torch.stack([(1 - fd) * (1 - fz), (1 - fd) * fz, fd * (1 - fz), fd * fz], dim=-1)
    return comp * (table.packed.shape[0] // 3) + d0, z0, w4


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU "
              "and does not fall back to the CPU", file=sys.stderr)
        return 2

    from beat_tpu.backend import SampleStage
    from beat_tpu_torch.device import require_cuda
    from beat_tpu_torch.flagship import REAL_SIZE, TRUE_DEPTH, TRUE_MAGNITUDE, build_flagship
    from beat_tpu_torch.kernels.build import load
    from beat_tpu_torch.ops.bilgather import bilinear_rows, bilinear_rows_reference
    from beat_tpu_torch.samplers import SMCParams

    # 1. device
    dev = require_cuda()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    say("device", name=json.dumps(name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build K1 from the checkout's sources
    _, info = load("bilgather")
    say("build", kernel="bilgather", cached=info.cached, seconds=f"{info.seconds:.2f}",
        path=os.path.relpath(info.path))
    for line in info.log.splitlines():
        if "ptxas" in line:
            print("  " + line.strip(), flush=True)

    # the real-size problem (its data synthesis already runs K1)
    t0 = time.perf_counter()
    workdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    problem = build_flagship(**REAL_SIZE, seed=0, device=dev,
                             outfolder=os.path.join(workdir.name, "smc"))
    torch.cuda.synchronize()
    comp = problem.composites["seismic"]
    table = comp.tables[0]
    n_targets = sum(w.ntargets for w in comp.wavemaps)
    n_queries = N_CHAINS * n_targets
    say("problem", table=tuple(table.packed.shape),
        table_MB=f"{table.packed.numel() * 4 / 1e6:.1f}", targets=n_targets,
        chains=N_CHAINS, k1_queries=n_queries, seconds=f"{time.perf_counter() - t0:.1f}")

    # 3. K1 against its plain version at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(1)
    cd, z0, w4 = k1_queries(table, n_queries, gen)
    got = bilinear_rows(table.packed, cd, z0, w4)
    ref = bilinear_rows_reference(table.packed, cd, z0, w4)
    torch.cuda.synchronize()
    max_err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    del got, ref
    k1_ms = cuda_ms(lambda: bilinear_rows(table.packed, cd, z0, w4), iters=20)
    plain_ms = cuda_ms(lambda: bilinear_rows_reference(table.packed, cd, z0, w4), iters=5)
    moved_gb = n_queries * 5 * table.packed.shape[2] * 4 / 1e9
    say("k1", queries=n_queries, max_abs_err=f"{max_err:.3e}", max_ref=f"{scale:.3e}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{plain_ms:.4f}", GB_moved=f"{moved_gb:.2f}",
        GBps=f"{moved_gb / k1_ms * 1e3:.0f}")
    if not max_err <= K1_RTOL * scale:
        raise SystemExit(f"K1 disagrees with its plain version: {max_err} > {K1_RTOL}·{scale}")
    del cd, z0, w4
    torch.cuda.empty_cache()

    # 4. 2000-chain log-likelihood: K1 against the plain gather
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(2).uniform(
        lower, upper, size=(N_CHAINS, lower.size)), dtype=torch.float32, device=dev)
    before = bilinear_rows.launches
    llk = logp(q, data)
    launched = bilinear_rows.launches - before
    logp_ms = cuda_ms(lambda: logp(q, data), iters=10)
    table.rows_fn = bilinear_rows_reference
    try:
        llk_plain = logp(q, data)
    finally:
        table.rows_fn = bilinear_rows
    torch.cuda.synchronize()
    rel = float(((llk - llk_plain).abs() / llk_plain.abs()).max())
    say("llk", chains=N_CHAINS, max_rel_err=f"{rel:.3e}", k1_launches=launched,
        logp_ms=f"{logp_ms:.3f}", finite=bool(torch.isfinite(llk).all()))
    if not (rel <= LLK_RTOL and launched > 0 and torch.isfinite(llk).all()):
        raise SystemExit("llk parity failed (or K1 was not launched)")
    del llk, llk_plain, q
    torch.cuda.empty_cache()

    # 5. the main path: SMC at 2000 chains
    bilinear_rows.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bilinear_rows.launches
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    say("smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]), k1_launches=launches,
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{state['acceptance'][-1]:.3f}")
    workdir.cleanup()
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("SMC did not reach beta = 1 with finite llks")
    if launches == 0:
        raise SystemExit("the SMC run never launched K1")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"posterior misses the truth: depth {depth}, Mw {mag}")

    # 6. results
    print(json.dumps({"kernels": [{
        "name": "bilinear_rows", "route": "cuda",
        "source": "beat_tpu_torch/csrc/bilgather.cu",
        "replaces": "beat_tpu/ops/bilgather.py:47",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
