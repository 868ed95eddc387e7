"""
The rank program of the port's multi-process tests
(``tests/test_torch_parallel.py`` on the CPU, one card test in
``tests/test_torch_gpu.py``), and :func:`launch`, which starts it.

Each rank is a fresh interpreter started with torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); it joins the process group through
``beat_tpu_torch.parallel.init_distributed``, runs the cases its spec
names and pickles its results to ``<outdir>/rank<r>.pkl``.  It imports
neither JAX nor the JAX package: the tests hold its results against
those.

    python tests/torch_parallel_ranks.py <spec.json>
"""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# the Gaussian of tests/test_parallel.py:26-30 and its start population
N_CHAINS, DIM = 32, 3
#: (proposal, steps, seed) of the sharded Metropolis stages
METROPOLIS_CASES = (("MultivariateNormal", 20, 7), ("MALA", 20, 11), ("HMC", 12, 13))
#: tests/test_parallel.py:87-90, 109-110: SMC and PT settings
SMC = dict(n_chains=64, n_steps=15, seed=9)
PT = dict(n_chains=16, n_chains_posterior=4, n_samples=400, swap_interval=(6, 10), seed=5)
#: the FullMT project's sampler at test size
FULLMT_SMC = dict(n_chains=64, n_steps=20, seed=0)
#: tests/test_parallel.py:158-160: the target-sharded library
GF_SHAPE = dict(C=8, T=8, P=6, D=4, S=8, N=64)
GF_MESH = (2, 2)
#: chains of the card test's likelihood
GPU_LLK_CHAINS = 64


# ---------------------------------------------------------------------------
# what both sides compute (the pytest process runs these without a mesh)
# ---------------------------------------------------------------------------


def gauss_logp(x):
    return -0.5 * (x * x).sum(-1) / 0.04


def smc_logp(x):
    return -0.5 * ((x - 1.5) ** 2).sum(-1) / 0.04


def pt_logp(x):
    return -0.5 * ((x - 1.0) ** 2).sum(-1) / 0.09


def metropolis_run(proposal: str, n_steps: int, seed: int, mesh=None):
    """The Metropolis stage of tests/test_parallel.py:32-46 (MALA and HMC
    :267-325) from the same start population: ``(q, llk)`` of the whole
    population (gathered), and the rows this rank held."""
    import numpy as np
    import torch

    from beat_tpu_torch.parallel import (CHAIN_AXIS, all_gather, chain_block,
                                         shard_chain_state)
    from beat_tpu_torch.samplers import init_metropolis_state, run_metropolis_stage

    q0 = np.random.default_rng(0).uniform(-1, 1, size=(N_CHAINS, DIM)).astype(np.float32)
    state = init_metropolis_state(gauss_logp, torch.as_tensor(q0))
    rows = chain_block(mesh, N_CHAINS)
    if mesh is not None:
        state = shard_chain_state(state, mesh)
    final, _ = run_metropolis_stage(
        gauss_logp, state, 1.0, torch.eye(DIM) * 0.1, torch.full((DIM,), -2.0),
        torch.full((DIM,), 2.0), n_steps=n_steps,
        generator=torch.Generator().manual_seed(seed), proposal_name=proposal,
        tune_interval=10, n_leapfrog=4,
        block=None if mesh is None else (rows.start, N_CHAINS))
    return (all_gather(final.q, mesh, CHAIN_AXIS).numpy(),
            all_gather(final.llk, mesh, CHAIN_AXIS).numpy(), tuple(final.q.shape))


def smc_run(homepath: str, mesh=None, n_chains: int = SMC["n_chains"]):
    import numpy as np

    from beat_tpu_torch.samplers import SMCParams, smc_sample

    params = SMCParams(**dict(SMC, n_chains=n_chains))
    return smc_sample(smc_logp, np.zeros(2), np.full(2, 3.0), params, device="cpu",
                      homepath=homepath, mesh=mesh)


def pt_run(mesh=None, n_chains: int = PT["n_chains"]):
    import numpy as np

    from beat_tpu_torch.samplers import PTParams, pt_sample

    params = PTParams(**dict(PT, n_chains=n_chains))
    return pt_sample(pt_logp, np.zeros(2), np.full(2, 3.0), params, device="cpu", mesh=mesh)


def gf_inputs():
    """The library data and chain inputs of tests/test_parallel.py:158-170,
    as numpy."""
    import numpy as np

    C, T, P, D, S, N = (GF_SHAPE[k] for k in "CTPDSN")
    rng = np.random.default_rng(0)
    data = rng.normal(size=(T, P, D, S, N)).astype(np.float32)
    durations = rng.uniform(0.5, 2.0, (C, P)).astype(np.float32)
    starttimes = rng.uniform(0, 1.5, (C, T, P)).astype(np.float32)
    slips = rng.uniform(0, 2, (C, P)).astype(np.float32)
    dobs = rng.normal(size=(T, N)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (T,)).astype(np.float32)
    return data, durations, starttimes, slips, dobs, w


#: the library grid of tests/test_parallel.py:162-163
GF_GRID = dict(duration_min=0.5, duration_sampling=0.5, starttime_min=0.0,
               starttime_sampling=0.25)


def gf_partial_llk(lib, durations, starttimes, slips, dobs, w):
    """The weighted misfit of a block of targets for a block of chains."""
    r = dobs - lib.stack_all(durations, starttimes, slips, "multilinear")
    return -0.5 * (w[:, None] * r * r).sum((-2, -1))


# ---------------------------------------------------------------------------
# the cases, run on every rank
# ---------------------------------------------------------------------------


def case_meshes(out: dict, outdir: str) -> None:
    from beat_tpu_torch import parallel

    n = parallel.n_ranks()
    out["n_ranks"], out["io"] = n, parallel.is_io_process()
    for key, make in (("chain", lambda: parallel.make_chain_mesh(n + 1)),
                      ("gf", lambda: parallel.make_gf_mesh(n, 2))):
        try:
            make()
        except ValueError as e:
            out[f"{key}_error"] = str(e)
    mesh = parallel.make_chain_mesh()
    out["chain_mesh"] = (tuple(mesh.mesh_dim_names), parallel.axis_size(mesh, "chains"),
                         parallel.axis_index(mesh, "chains"))


def case_metropolis(out: dict, outdir: str) -> None:
    from beat_tpu_torch.parallel import make_chain_mesh

    mesh = make_chain_mesh()
    out["metropolis"] = {name: metropolis_run(name, steps, seed, mesh)
                         for name, steps, seed in METROPOLIS_CASES}


def case_smc(out: dict, outdir: str) -> None:
    from beat_tpu_torch import backend
    from beat_tpu_torch.parallel import make_chain_mesh

    saves = []
    save_stage = backend.SampleStage.save_stage

    def counted(self, stage, *args, **kwargs):
        saves.append(stage)
        return save_stage(self, stage, *args, **kwargs)

    backend.SampleStage.save_stage = counted
    try:
        out["smc"] = smc_run(os.path.join(outdir, "smc"), make_chain_mesh())
    finally:
        backend.SampleStage.save_stage = save_stage
    out["smc_saves"] = saves


def case_guards(out: dict, outdir: str) -> None:
    from beat_tpu_torch.parallel import make_chain_mesh, n_ranks

    mesh = make_chain_mesh()
    odd = 3 * n_ranks() + 1
    for key, run in (("smc", lambda: smc_run(None, mesh, n_chains=odd)),
                     ("pt", lambda: pt_run(mesh, n_chains=odd))):
        try:
            run()
        except ValueError as e:
            out[f"{key}_guard"] = str(e)


def case_pt(out: dict, outdir: str) -> None:
    from beat_tpu_torch.parallel import make_chain_mesh

    q, llk, history = pt_run(make_chain_mesh())
    out["pt"] = (q, llk, history["betas"])


def case_auto_mesh(out: dict, outdir: str) -> None:
    """``Problem._auto_mesh`` under the process group: the chain mesh over
    every rank, or none for a chain count the ranks do not divide."""
    from beat_tpu_torch.models.problem import Problem
    from beat_tpu_torch.parameter import PriorSet

    problem = Problem(PriorSet(), {}, device="cpu")
    mesh = problem._auto_mesh(FULLMT_SMC["n_chains"])
    out["auto_mesh"] = (mesh.size(), problem._auto_mesh(FULLMT_SMC["n_chains"] + 1))


def case_cli_sample(out: dict, outdir: str) -> None:
    """``beat-tpu-torch sample <outdir>/project`` as torchrun runs it: the
    command line joins the process group itself (the launch does not)
    and ``Problem.sample()`` shards the chains; counts each rank's stage
    writes."""
    from beat_tpu_torch import backend
    from beat_tpu_torch.apps.cli import main

    saves = []
    save_stage = backend.SampleStage.save_stage

    def counted(self, stage, *args, **kwargs):
        saves.append(stage)
        return save_stage(self, stage, *args, **kwargs)

    backend.SampleStage.save_stage = counted
    try:
        out["cli_rc"] = main(["sample", os.path.join(outdir, "project")])
    finally:
        backend.SampleStage.save_stage = save_stage
    out["cli_saves"] = saves


def case_gf_logp(out: dict, outdir: str) -> None:
    import torch

    from beat_tpu_torch.ffi import SeismicGFLibrary
    from beat_tpu_torch.parallel import (CHAIN_AXIS, all_gather, make_gf_mesh,
                                         sharded_gf_logp, target_sharding)

    data, *inputs = gf_inputs()
    mesh = make_gf_mesh(*GF_MESH)
    lib = target_sharding(mesh)(SeismicGFLibrary(data, **GF_GRID, device="cpu"))
    sharded = sharded_gf_logp(mesh, gf_partial_llk, in_specs=(
        None, ("chains",), ("chains", "targets"), ("chains",), ("targets",), ("targets",)))
    got = sharded(lib, *(torch.as_tensor(x) for x in inputs))
    out["gf_logp"] = all_gather(got, mesh, CHAIN_AXIS).numpy()
    out["gf_local"] = (lib.ntargets, lib.data.untyped_storage().nbytes(), tuple(got.shape))


def gpu_llk_inputs(dev):
    """``(logp, data, q)``: the test-size FullMT problem on ``dev`` and
    GPU_LLK_CHAINS draws from its priors."""
    import numpy as np
    import torch

    from beat_tpu_torch.flagship import TEST_SIZE, build_flagship

    problem = build_flagship(**TEST_SIZE, seed=5, device=dev)
    logp, data = problem.make_logp_fn()
    lo, hi = problem.priors.bounds_arrays()
    q = torch.as_tensor(np.random.default_rng(2).uniform(lo, hi, (GPU_LLK_CHAINS, lo.size)),
                        dtype=torch.float32, device=dev)
    return logp, data, q


def case_gpu_llk(out: dict, outdir: str) -> None:
    """The test-size FullMT llk of GPU_LLK_CHAINS chains on the card,
    each rank its block through K1c, gathered."""
    import torch

    from beat_tpu_torch import profiling
    from beat_tpu_torch.device import resolve
    from beat_tpu_torch.parallel import CHAIN_AXIS, all_gather, chain_sharding, make_chain_mesh

    dev = resolve("cuda")
    logp, data, q = gpu_llk_inputs(dev)
    mesh = make_chain_mesh()
    profiling.enable_spans()
    profiling.reset_spans()
    with torch.no_grad():
        llk = logp(chain_sharding(mesh)(q), data)
    out["gpu_llk"] = all_gather(llk, mesh, CHAIN_AXIS).cpu().numpy()
    out["gpu_k1c_launches"] = profiling.span_snapshot()["counters"].get(
        "launches.beat_bilinear_contract_f32", 0)
    out["gpu_device"] = str(llk.device)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def rank_main(spec_path: str) -> None:
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from beat_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    out = {"rank": rank}
    if spec["join"]:
        init_distributed(device=spec["device"], backend=spec["backend"],
                         timeout=timedelta(seconds=spec["deadline"]))
        try:
            for name in spec["cases"]:
                CASES[name](out, spec["outdir"])
            dist.barrier()
        finally:
            dist.destroy_process_group()
    else:
        for name in spec["cases"]:
            CASES[name](out, spec["outdir"])
    out["imported_jax"] = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                                 or m == "beat_tpu" or m.startswith("beat_tpu."))
    with open(os.path.join(spec["outdir"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ---------------------------------------------------------------------------
# the launcher, called by the tests
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(n_ranks: int, cases, outdir, *, device: str = "cpu", backend: str | None = None,
           join: bool = True, env: dict | None = None, deadline: float = 120.0) -> list:
    """Run ``cases`` on ``n_ranks`` ranks started together; returns each
    rank's results.  With ``join`` each rank joins the process group
    before its cases, else a case does (the command line).  ``env`` is
    added to the ranks' environment.  A rank that fails ends the others
    at once; ranks still running ``deadline`` seconds after the start are
    killed.  Either raises AssertionError with the ranks' error output."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    spec = outdir / "spec.json"
    spec.write_text(json.dumps({"cases": list(cases), "outdir": str(outdir), "device": device,
                                "backend": backend, "join": join, "deadline": deadline}))
    base = {k: v for k, v in os.environ.items() if k != "BEAT_TPU_PLATFORM"}
    env = dict(base, **(env or {}))
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n_ranks))
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    procs, logs = [], []
    try:
        for r in range(n_ranks):
            log = open(outdir / f"rank{r}.log", "w+")
            logs.append(log)
            # ranks sharing one card over gloo all sit on cuda:0
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(spec)], cwd=outdir, stdout=log,
                stderr=subprocess.STDOUT, env=dict(env, RANK=str(r), LOCAL_RANK="0")))
        t_end = time.monotonic() + deadline
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.returncode not in (None, 0)]
            if failed or time.monotonic() > t_end:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        tails = []
        for r, log in enumerate(logs):
            log.seek(0)
            tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                         + log.read()[-3000:])
            log.close()
    assert all(p.returncode == 0 for p in procs), (
        f"ranks failed or outlived their {deadline} s deadline:\n" + "\n".join(tails))
    results = []
    for r in range(n_ranks):
        with open(outdir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    rank_main(sys.argv[1])
