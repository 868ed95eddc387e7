#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``beat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs the port's main paths — the geometry-mode FullMT moment-tensor
inversion at real size (206 × 15 × nt 1024 GF table, 10 stations / 30
targets, 2000 chains) with random-walk SMC, with MALA-SMC, with HMC and
with MAP + Laplace — in phases that each print one line; any failure
ends the run non-zero:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: kernels K1 and K2 (``beat_tpu_torch/csrc/bilgather.cu``) from
   source;
3. [k1] K1 against its plain PyTorch version at the main path's shapes
   (60,000 queries), max |err| <= 1e-6 · max|ref|; its time, the plain
   time, the one-call library time (``embedding_bag``) and its bound;
4. [k2] K2 against its plain version on the same queries with a random
   cotangent, per query |err| <= 1e-5 · Σ_j|g_ij| · max_c|row_cj|; its
   time, the plain time, the one-call library time (the per-sample-weights
   backward of ``embedding_bag``) and its bound;
5. [llk] the 2000-chain log-likelihood through K1 against the plain
   gather, rtol 2e-5;
6. [grad] the 2000-chain gradient ∂llk/∂q through K1 and K2 against the
   plain gather's, per parameter rtol 5e-3 and atol 5e-3 · that
   parameter's max|grad|; one evaluation profiled ([grad_profile]);
7. [smc] ``Problem.sample()`` with SMC (2000 chains, 60 steps per
   stage): β = 1 with finite llks, K1 launched, the true depth (±500 m)
   and magnitude (±0.05) recovered;
8. [mala_smc] the same with ``proposal_name="MALA"``, which must launch
   K2 as well;
9. [hmc] one 10-step HMC stage (5 leapfrog steps, the step size
   retuned after 5) at β = 1 from the MALA-SMC posterior: acceptance in
   (0, 1], finite positions and llks;
10. [map] ``map_estimate`` (32 restarts, 150 steps, from the test point)
    within 600 m of the depth and 0.15 of Mw, then
    ``laplace_approximation`` with a finite evidence and K1 launched in
    the Hessian;
11. a JSON line of the kernels, then ``{"ok": true, "device": ...}`` last.

Every launch count is read from counters set to 0 just before the path
it counts.  It needs CUDA and exits non-zero without it; it never falls
back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

os.environ.pop("BEAT_TPU_PLATFORM", None)

N_CHAINS = 2000
N_STEPS = 60
K1_RTOL = 1e-6          # K1 vs plain: max |err| <= K1_RTOL · max|ref|
K2_RTOL = 1e-5          # K2 vs plain, per query: see phase 4 above
LLK_RTOL = 2e-5         # the JAX package's per-chain llk bar
GRAD_RTOL = 5e-3        # the JAX package's bar between its gather paths' gradients
DEPTH_TOL, MAG_TOL = 500.0, 0.05
MAP_DEPTH_TOL, MAP_MAG_TOL = 600.0, 0.15        # tests/test_optimize.py:115-116
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
FP32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores


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


def bound_ms(n_bytes: float, n_flops: float) -> tuple:
    """The least time the card could take for the work: ``(ms, "bytes" or
    "operations")``, whichever bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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

    from torch.profiler import ProfilerActivity, profile

    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.device import DTYPE, require_cuda
    from beat_tpu_torch.flagship import REAL_SIZE, TRUE_DEPTH, TRUE_MAGNITUDE, build_flagship
    from beat_tpu_torch.kernels.build import load
    from beat_tpu_torch.ops.bilgather import (bilinear_rows, bilinear_rows_reference,
                                              corner_dot, corner_dot_reference,
                                              corner_rows_reference)
    from beat_tpu_torch.optimize import laplace_approximation, map_estimate
    from beat_tpu_torch.samplers import (MetropolisState, SMCParams, run_metropolis_stage,
                                         value_and_grad)

    # 1. device
    dev = require_cuda()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    say("device", name=json.dumps(name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build K1 and K2 (one source) from the checkout's sources
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
    tbl = table.packed
    CD, NZ, M = tbl.shape
    n_targets = sum(w.ntargets for w in comp.wavemaps)
    n_queries = N_CHAINS * n_targets
    say("problem", table=tuple(tbl.shape), table_MB=f"{tbl.numel() * 4 / 1e6:.1f}",
        targets=n_targets, chains=N_CHAINS, k1_queries=n_queries,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # 3. K1 against its plain version and the one-call library version
    gen = torch.Generator(device=dev).manual_seed(1)
    cd, z0, w4 = k1_queries(table, n_queries, gen)
    got = bilinear_rows(tbl, cd, z0, w4)
    ref = bilinear_rows_reference(tbl, cd, z0, w4)
    row = cd * NZ + z0
    idx4 = torch.stack([row, row + 1, row + NZ, row + NZ + 1], dim=1)
    flat = tbl.reshape(CD * NZ, M)
    lib = torch.nn.functional.embedding_bag(idx4, flat, per_sample_weights=w4, mode="sum")
    torch.cuda.synchronize()
    k1_err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    lib_err = float((lib - ref).abs().max())
    del got, ref, lib
    k1_ms = cuda_ms(lambda: bilinear_rows(tbl, cd, z0, w4), iters=20)
    k1_plain_ms = cuda_ms(lambda: bilinear_rows_reference(tbl, cd, z0, w4), iters=5)
    k1_lib_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
        idx4, flat, per_sample_weights=w4, mode="sum"), iters=20)
    # bytes: the table rows these queries touch, indices and weights, the output
    rows_read = int(torch.unique(idx4).numel())
    k1_bound, k1_by = bound_ms(rows_read * M * 4 + n_queries * (4 + 4 + 16)
                               + n_queries * M * 4, n_queries * M * 7)
    say("k1", queries=n_queries, max_abs_err=f"{k1_err:.3e}", max_ref=f"{scale:.3e}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}", library_ms=f"{k1_lib_ms:.4f}",
        library_max_abs_err=f"{lib_err:.3e}", table_rows_read=rows_read,
        bound_ms=f"{k1_bound:.4f}", bound_by=k1_by, share_of_bound=f"{k1_bound / k1_ms:.3f}")
    if not k1_err <= K1_RTOL * scale:
        raise SystemExit(f"K1 disagrees with its plain version: {k1_err} > {K1_RTOL}·{scale}")

    # 4. K2 against its plain version: the same queries, a random cotangent.
    # The one-call library version is the per-sample-weights backward of
    # K1's embedding_bag yardstick (sum mode): one bag of 4 rows per query.
    g = torch.randn((n_queries, M), generator=gen, device=dev)
    offsets = torch.arange(0, 4 * n_queries, 4, device=dev)
    offset2bag = torch.arange(n_queries, device=dev).repeat_interleave(4)
    ind = idx4.reshape(-1)

    def k2_library():
        return torch.ops.aten._embedding_bag_per_sample_weights_backward(
            g, flat, ind, offsets, offset2bag, 0, -1)

    got = corner_dot(tbl, cd, z0, g)
    lib = k2_library().view(n_queries, 4)
    rows = corner_rows_reference(tbl, cd, z0)
    ref = torch.einsum("nj,ncj->nc", g, rows)
    bar = K2_RTOL * g.abs().sum(-1) * rows.abs().amax(dim=(1, 2))
    err = (got - ref).abs().amax(-1)
    k2_err = float(err.max())
    k2_worst = float((err / bar).max())
    lib_worst = float(((lib - ref).abs().amax(-1) / bar).max())
    del got, lib, ref, rows, bar, err
    torch.cuda.empty_cache()
    k2_ms = cuda_ms(lambda: corner_dot(tbl, cd, z0, g), iters=20)
    k2_plain_ms = cuda_ms(lambda: corner_dot_reference(tbl, cd, z0, g), iters=5)
    k2_lib_ms = cuda_ms(k2_library, iters=20)
    # bytes: the touched table rows, indices, the cotangent, the (n, 4) output
    k2_bound, k2_by = bound_ms(rows_read * M * 4 + n_queries * (4 + 4)
                               + n_queries * M * 4 + n_queries * 16, n_queries * 4 * M * 2)
    say("k2", queries=n_queries, max_abs_err=f"{k2_err:.3e}",
        worst_err_over_bar=f"{k2_worst:.3e}", ms=f"{k2_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", library_ms=f"{k2_lib_ms:.4f}",
        library_worst_err_over_bar=f"{lib_worst:.3e}", bound_ms=f"{k2_bound:.4f}",
        bound_by=k2_by, share_of_bound=f"{k2_bound / k2_ms:.3f}")
    if not k2_worst <= 1.0:
        raise SystemExit(f"K2 disagrees with its plain version: worst err/bar {k2_worst}")
    if not lib_worst <= 1.0:
        raise SystemExit(f"K2's library yardstick computes another function: {lib_worst}")
    del cd, z0, w4, g, idx4, flat, ind, offsets, offset2bag
    torch.cuda.empty_cache()

    # 5. 2000-chain log-likelihood: K1 against the plain gather
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

    # 6. 2000-chain gradient through K1 and K2 against the plain gather's;
    # queries kept off the box edges, where clamp passes no gradient
    span = upper - lower
    q = torch.as_tensor(np.random.default_rng(3).uniform(
        lower + 0.01 * span, upper - 0.01 * span, size=(N_CHAINS, lower.size)),
        dtype=DTYPE, device=dev)
    bilinear_rows.launches = corner_dot.launches = 0
    _, grad = value_and_grad(logp, q, (data,))
    torch.cuda.synchronize()
    grad_launches = (bilinear_rows.launches, corner_dot.launches)
    vg_ms = cuda_ms(lambda: value_and_grad(logp, q, (data,)), iters=5)
    table.rows_fn = bilinear_rows_reference
    try:
        _, grad_plain = value_and_grad(logp, q, (data,))
    finally:
        table.rows_fn = bilinear_rows
    # the bar per parameter (column): the columns' scales differ by orders
    # of magnitude, and only depth's gradient passes through K2
    diff = (grad - grad_plain).abs()
    col_max = grad_plain.abs().amax(0)
    bar = GRAD_RTOL * grad_plain.abs() + GRAD_RTOL * col_max
    worst = float((diff / bar.clamp_min(torch.finfo(bar.dtype).tiny)).max())
    grad_ok = bool(torch.isfinite(grad).all() and (diff <= bar).all())
    dz = problem.ordering["depth"].slc
    say("grad", chains=N_CHAINS, max_abs_err=f"{float(diff.max()):.3e}",
        max_abs_grad=f"{float(col_max.max()):.3e}", worst_err_over_bar=f"{worst:.3e}",
        depth_max_abs_err=f"{float(diff[:, dz].max()):.3e}",
        depth_max_abs_grad=f"{float(col_max[dz].max()):.3e}", k1_launches=grad_launches[0],
        k2_launches=grad_launches[1], value_and_grad_ms=f"{vg_ms:.3f}",
        forward_ms=f"{logp_ms:.3f}", peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    if not (grad_ok and min(grad_launches) > 0):
        raise SystemExit("gradient parity failed (or K1/K2 were not launched)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        value_and_grad(logp, q, (data,))
        torch.cuda.synchronize()
    # kernels only: the operators' own rows repeat their kernels' device time
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    kernel_ms = {e.key: e.self_device_time_total / 1e3 for e in kernels}
    say("grad_profile", kernel_ms=f"{sum(kernel_ms.values()):.3f}", kernels=len(kernels),
        k1_ms=f"{sum(v for k, v in kernel_ms.items() if 'bilinear_rows_kernel' in k):.4f}",
        k2_ms=f"{sum(v for k, v in kernel_ms.items() if 'corner_dot_kernel' in k):.4f}",
        top=json.dumps([[k[:70], round(v, 4)] for k, v in list(kernel_ms.items())[:10]]))
    del q, grad, grad_plain, diff, bar
    torch.cuda.empty_cache()

    # 7. the slice-1 main path: random-walk SMC at 2000 chains
    bilinear_rows.launches = corner_dot.launches = 0
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
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("SMC did not reach beta = 1 with finite llks")
    if launches == 0:
        raise SystemExit("the SMC run never launched K1")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"posterior misses the truth: depth {depth}, Mw {mag}")

    # 8. the slice-2 main path: MALA-SMC at 2000 chains
    problem.outfolder = os.path.join(workdir.name, "mala_smc")
    bilinear_rows.launches = corner_dot.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q_tr, llk_tr = problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0,
                                            proposal_name="MALA"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mala_launches = (bilinear_rows.launches, corner_dot.launches)
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)
    est = problem.ordering.to_point(q_tr[-1].mean(axis=0))
    depth, mag = float(np.asarray(est["depth"])), float(np.asarray(est["magnitude"]))
    smc_log_z = float(state["log_evidence"])
    say("mala_smc", chains=N_CHAINS, steps=N_STEPS, wall_s=f"{wall:.2f}",
        stages=len(state["acceptance"]), beta=float(state["beta"]),
        k1_launches=mala_launches[0], k2_launches=mala_launches[1],
        peak_GB=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}",
        acceptance_final=f"{state['acceptance'][-1]:.3f}", log_evidence=f"{smc_log_z:.3f}")
    if not (float(state["beta"]) == 1.0 and np.isfinite(llk_tr).all()):
        raise SystemExit("MALA-SMC did not reach beta = 1 with finite llks")
    if min(mala_launches) == 0:
        raise SystemExit("the MALA-SMC run never launched K1 or K2")
    if abs(depth - TRUE_DEPTH) >= DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAG_TOL:
        raise SystemExit(f"MALA-SMC posterior misses the truth: depth {depth}, Mw {mag}")

    # 9. one HMC stage at beta = 1 from the MALA-SMC population and covariance
    lo = torch.as_tensor(lower, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper, dtype=DTYPE, device=dev)
    start = MetropolisState(
        q=torch.as_tensor(state["population"], dtype=DTYPE, device=dev),
        llk=torch.as_tensor(state["likelihoods"], dtype=DTYPE, device=dev),
        scaling=torch.ones(N_CHAINS, dtype=DTYPE, device=dev),
        accepted=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev),
        acc_total=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev))
    cov_chol = torch.as_tensor(np.linalg.cholesky(state["cov"]), dtype=DTYPE, device=dev)
    hmc_steps, n_leapfrog = 10, 5
    bilinear_rows.launches = corner_dot.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _ = run_metropolis_stage(
        logp, start, 1.0, cov_chol, lo, hi, n_steps=hmc_steps,
        generator=torch.Generator(device=dev).manual_seed(0), proposal_name="HMC",
        tune_interval=5, logp_args=(data,), n_leapfrog=n_leapfrog)
    torch.cuda.synchronize()
    hmc_ms = (time.perf_counter() - t0) * 1e3 / hmc_steps
    hmc_acc = float(final.acc_total.mean()) / hmc_steps
    hmc_finite = bool(torch.isfinite(final.q).all() and torch.isfinite(final.llk).all())
    say("hmc", chains=N_CHAINS, steps=hmc_steps, n_leapfrog=n_leapfrog,
        ms_per_transition=f"{hmc_ms:.2f}", acceptance=f"{hmc_acc:.3f}", finite=hmc_finite,
        k1_launches=bilinear_rows.launches, k2_launches=corner_dot.launches)
    if not (0.0 < hmc_acc <= 1.0 and hmc_finite):
        raise SystemExit("HMC stage failed: acceptance outside (0, 1] or non-finite state")
    del start, final
    torch.cuda.empty_cache()

    # 10. MAP + Laplace
    bilinear_rows.launches = corner_dot.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_map, llk_map, all_llks = map_estimate(logp, lower, upper, n_restarts=32, n_steps=150,
                                            seed=0, logp_args=(data,),
                                            start=problem.priors.test_array()[None],
                                            device=dev)
    map_s = time.perf_counter() - t0
    map_launches = (bilinear_rows.launches, corner_dot.launches)
    bilinear_rows.launches = corner_dot.launches = 0
    t0 = time.perf_counter()
    lap = laplace_approximation(logp, q_map, lower, upper, logp_args=(data,), device=dev)
    lap_s = time.perf_counter() - t0
    lap_launches = (bilinear_rows.launches, corner_dot.launches)
    point = problem.ordering.to_point(q_map)
    depth, mag = float(point["depth"]), float(point["magnitude"])
    say("map", restarts=32, steps=150, wall_s=f"{map_s:.2f}", laplace_s=f"{lap_s:.2f}",
        depth_m=f"{depth:.1f}", magnitude=f"{mag:.4f}", llk_map=f"{llk_map:.3f}",
        restart_llk_spread=f"{float(all_llks.max() - np.median(all_llks)):.3f}",
        curvature_ok=lap["curvature_ok"], laplace_log_evidence=f"{lap['log_evidence']:.3f}",
        laplace_minus_smc=f"{lap['log_evidence'] - smc_log_z:.3f}",
        k1_launches=map_launches[0], k2_launches=map_launches[1],
        hessian_k1_launches=lap_launches[0], hessian_k2_launches=lap_launches[1])
    workdir.cleanup()
    if abs(depth - TRUE_DEPTH) >= MAP_DEPTH_TOL or abs(mag - TRUE_MAGNITUDE) >= MAP_MAG_TOL:
        raise SystemExit(f"MAP misses the truth: depth {depth}, Mw {mag}")
    if not np.isfinite(lap["log_evidence"]):
        raise SystemExit("Laplace log-evidence is not finite")
    if lap_launches[0] == 0:
        raise SystemExit("the Laplace Hessian never launched K1")

    # 11. results: launches from each kernel's main path (SMC for K1,
    # MALA-SMC for K2), with every path's count beside them
    print(json.dumps({"kernels": [
        {"name": "bilinear_rows", "route": "cuda", "source": "beat_tpu_torch/csrc/bilgather.cu",
         "replaces": "beat_tpu/ops/bilgather.py:47", "launches": launches,
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms,
         "launches_by_path": {"smc": launches, "mala_smc": mala_launches[0],
                              "map": map_launches[0], "laplace": lap_launches[0]}},
        {"name": "corner_dot", "route": "cuda", "source": "beat_tpu_torch/csrc/bilgather.cu",
         "replaces": "beat_tpu/ops/bilgather.py:154", "launches": mala_launches[1],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2_lib_ms,
         "launches_by_path": {"mala_smc": mala_launches[1], "map": map_launches[1],
                              "laplace": lap_launches[1]}}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
