#!/usr/bin/env python3
"""
Wall-clock of the port's FullMT gradient samplers at real size on one
NVIDIA GPU, as ``chip_smoke.py`` [mala_smc] and [hmc] run them: MALA-SMC
(2000 chains, 60 steps a stage, to β = 1) and one 10-transition HMC stage
(5 leapfrog steps, the step size retuned after 5) at β = 1 from its
posterior.

    python3 tools/bench_torch_samplers.py [--root DIR]

``--root`` names the checkout whose ``beat_tpu_torch`` is timed (default:
this one).  Two commits are compared on one card by unpacking the other
with ``git archive`` into a directory that ``.gitignore`` lists and
running the two in turns, one process each (a, b, b, a, ...).  Before the
clock starts, one value-and-grad over the prior builds the kernels and
warms the libraries.  Prints the card's name and power limit and one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

N_CHAINS, N_STEPS = 2000, 60
HMC_STEPS, N_LEAPFROG = 10, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_samplers: CUDA is not available", file=sys.stderr)
        return 2
    import beat_tpu_torch
    from beat_tpu_torch.backend import SampleStage
    from beat_tpu_torch.device import DTYPE
    from beat_tpu_torch.flagship import REAL_SIZE, build_flagship
    from beat_tpu_torch.samplers import (MetropolisState, SMCParams, run_metropolis_stage,
                                         value_and_grad)

    if not beat_tpu_torch.__file__.startswith(root + os.sep):
        raise SystemExit(f"imported {beat_tpu_torch.__file__}, not the package under {root}")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    workdir = tempfile.TemporaryDirectory(prefix="bench_samplers_")
    t0 = time.perf_counter()
    problem = build_flagship(**REAL_SIZE, seed=0, device=dev,
                             outfolder=os.path.join(workdir.name, "mala_smc"))
    logp, data = problem.make_logp_fn()
    lower, upper = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(3).uniform(lower, upper,
                                                         size=(N_CHAINS, lower.size)),
                        dtype=DTYPE, device=dev)
    value_and_grad(logp, q, (data,))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    problem.sample(SMCParams(n_chains=N_CHAINS, n_steps=N_STEPS, seed=0, proposal_name="MALA"))
    torch.cuda.synchronize()
    mala_s = time.perf_counter() - t0
    state = SampleStage(problem.outfolder, ordering=problem.ordering).load_state(-1)

    start = MetropolisState(
        q=torch.as_tensor(state["population"], dtype=DTYPE, device=dev),
        llk=torch.as_tensor(state["likelihoods"], dtype=DTYPE, device=dev),
        scaling=torch.ones(N_CHAINS, dtype=DTYPE, device=dev),
        accepted=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev),
        acc_total=torch.zeros(N_CHAINS, dtype=DTYPE, device=dev))
    cov_chol = torch.as_tensor(np.linalg.cholesky(state["cov"]), dtype=DTYPE, device=dev)
    lo = torch.as_tensor(lower, dtype=DTYPE, device=dev)
    hi = torch.as_tensor(upper, dtype=DTYPE, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _ = run_metropolis_stage(
        logp, start, 1.0, cov_chol, lo, hi, n_steps=HMC_STEPS,
        generator=torch.Generator(device=dev).manual_seed(0), proposal_name="HMC",
        tune_interval=5, logp_args=(data,), n_leapfrog=N_LEAPFROG)
    torch.cuda.synchronize()
    hmc_ms = (time.perf_counter() - t0) * 1e3 / HMC_STEPS
    print(json.dumps({"root": os.path.relpath(root), "setup_s": setup_s, "mala_smc_s": mala_s,
                      "mala_smc_stages": len(state["acceptance"]), "beta": float(state["beta"]),
                      "hmc_ms_per_transition": hmc_ms,
                      "hmc_acceptance": float(final.acc_total.mean()) / HMC_STEPS}), flush=True)
    workdir.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
