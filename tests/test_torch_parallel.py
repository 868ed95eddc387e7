"""
The port's runtime (``beat_tpu_torch/parallel.py``) on the CPU over gloo:
chains sharded over ranks through the Metropolis stages, SMC, parallel
tempering and ``Problem.sample()``, each equal to the one-process run
(the JAX package's answer there is an invariance,
``tests/test_parallel.py``), and the GF library split by targets on a
(2, 2) mesh against the JAX package's ``sharded_gf_logp`` and its
unsharded llk.

Two launches of 2 ranks and one of 4 run every case
(``torch_parallel_ranks.py``, started with torchrun's variables, each
under a deadline after which its ranks are killed; in the second, the
command line joins the process group itself, as under ``torchrun ... -m
beat_tpu_torch.apps.cli sample``); the tests assert on their parts.
The rank program imports neither JAX nor ``beat_tpu``; JAX is imported
inside the tests that hold the port against it.
"""

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from beat_tpu_torch import parallel
from beat_tpu_torch.backend import SampleStage

# tests/test_parallel.py:45-46, 91-92, 113-114: sharded against one device
Q_ATOL, LLK_ATOL = 1e-6, 1e-5
# the JAX package's per-chain float32 llk bar (tests/test_parallel.py:204)
LLK_RTOL = 2e-5
# the FullMT posterior mean against the truth (chip_smoke.py's [smc] bars)
DEPTH_TOL, MAG_TOL = 500.0, 0.05
#: seconds a launch's ranks may run before they are killed
DEADLINE = 120.0

TWO_RANK_CASES = ("meshes", "metropolis", "smc", "guards", "pt", "auto_mesh")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("two_ranks")
    return outdir, ranks.launch(2, TWO_RANK_CASES, outdir, deadline=DEADLINE)


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    """The test-size FullMT problem written as a project, sampled once in
    this process (a copy) and once by ``beat-tpu-torch sample`` on 2
    ranks: ``(project, one-process copy, ranks' results)``."""
    import shutil

    from beat_tpu_torch.flagship import TEST_SIZE, build_flagship, write_fullmt_project
    from beat_tpu_torch.models.problem import load_model

    outdir = tmp_path_factory.mktemp("cli_ranks")
    problem = build_flagship(**TEST_SIZE, seed=0, device="cpu")
    write_fullmt_project(problem, str(outdir / "project"), ranks.FULLMT_SMC)
    shutil.copytree(outdir / "project", outdir / "one")
    results = ranks.launch(2, ("cli_sample",), outdir, join=False,
                           env={"BEAT_TPU_PLATFORM": "cpu"}, deadline=DEADLINE)
    load_model(str(outdir / "one"), "geometry", device="cpu").sample()
    return outdir / "project", outdir / "one", results


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return ranks.launch(4, ("gf_logp",), tmp_path_factory.mktemp("four_ranks"),
                        deadline=DEADLINE)


def test_ranks_import_neither_jax_nor_the_jax_package(two_ranks, cli_ranks, four_ranks):
    results = two_ranks[1] + cli_ranks[2] + four_ranks
    assert [r["rank"] for r in results] == [0, 1, 0, 1, 0, 1, 2, 3]
    assert all(r["imported_jax"] == [] for r in results)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_pad_chains_equals_jax(n_devices):
    from beat_tpu.parallel import pad_chains as jax_pad_chains

    for n in range(0, 41):
        assert parallel.pad_chains(n, n_devices) == jax_pad_chains(n, n_devices)


def test_meshes_beyond_the_ranks_raise_as_in_jax(two_ranks):
    for r in two_ranks[1]:
        assert r["n_ranks"] == 2 and r["io"] == (r["rank"] == 0)
        assert r["chain_error"].startswith(
            "requested a 3-device mesh but only 2 device(s) are available")
        assert r["gf_error"].startswith("requested a 2x2 mesh but only 2 device(s) are available")
        assert r["chain_mesh"] == (("chains",), 2, r["rank"])


def test_no_process_group_builds_no_mesh():
    """Without a process group nothing falls back to a one-rank mesh."""
    assert parallel.n_ranks() == 1 and parallel.is_io_process()
    with pytest.raises(ValueError, match="requested a 2-device mesh but only 1 device"):
        parallel.make_chain_mesh(2)
    with pytest.raises(ValueError, match="no process group"):
        parallel.make_chain_mesh()
    x = torch.arange(6.0)
    assert parallel.all_gather(x, None) is x and parallel.all_reduce_sum(x, None) is x
    assert parallel.chain_block(None, 6) == slice(0, 6)


def test_init_distributed_refuses_what_it_cannot_join(monkeypatch):
    """No rank or world size (torchrun's variables unset), a CPU group on
    NCCL, or a card that is not there: each raises before any group
    exists."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="needs rank and world_size"):
        parallel.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="backend 'nccl' on the CPU"):
        parallel.init_distributed(device="cpu", backend="nccl", rank=0, world_size=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.init_distributed(rank=0, world_size=1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("proposal,n_steps,seed", ranks.METROPOLIS_CASES)
def test_metropolis_stage_sharded_equals_one_process(two_ranks, proposal, n_steps, seed):
    q1, llk1, _ = ranks.metropolis_run(proposal, n_steps, seed)
    for r in two_ranks[1]:
        q2, llk2, local_shape = r["metropolis"][proposal]
        assert local_shape == (ranks.N_CHAINS // 2, ranks.DIM)     # the state was sharded
        np.testing.assert_allclose(q2, q1, rtol=0, atol=Q_ATOL)
        np.testing.assert_allclose(llk2, llk1, rtol=0, atol=LLK_ATOL)


def test_smc_sharded_equals_one_process_and_rank0_writes(two_ranks, tmp_path):
    from beat_tpu.backend import SampleStage as JaxSampleStage

    outdir, results = two_ranks
    q1, llk1 = ranks.smc_run(str(tmp_path / "one"))
    for r in results:
        q2, llk2 = r["smc"]
        np.testing.assert_allclose(q2, q1, rtol=0, atol=Q_ATOL)
        np.testing.assert_allclose(llk2, llk1, rtol=0, atol=LLK_ATOL)
    # the stage files are written once, by rank 0, and equal the one-process run's
    assert results[1]["smc_saves"] == []
    assert results[0]["smc_saves"][0] == 0 and results[0]["smc_saves"][-1] == -1
    one = SampleStage(str(tmp_path / "one")).load_trace(-1)
    two = JaxSampleStage(str(outdir / "smc")).load_trace(-1)
    np.testing.assert_allclose(two.q_trace, one.q_trace, rtol=0, atol=Q_ATOL)
    np.testing.assert_allclose(two.llk_trace, one.llk_trace, rtol=0, atol=LLK_ATOL)


@pytest.mark.parametrize("sampler", ["smc", "pt"])
def test_mesh_size_guards_raise(two_ranks, sampler):
    for r in two_ranks[1]:
        assert "n_chains=7 must be a multiple of the mesh size 2" in r[f"{sampler}_guard"]


def test_pt_sharded_equals_one_process(two_ranks):
    q1, llk1, history1 = ranks.pt_run()
    for r in two_ranks[1]:
        q2, llk2, betas2 = r["pt"]
        np.testing.assert_allclose(q2, q1, rtol=0, atol=Q_ATOL)
        np.testing.assert_allclose(llk2, llk1, rtol=0, atol=LLK_ATOL)
        np.testing.assert_allclose(betas2, history1["betas"])


def test_sharded_gf_logp_equals_jax(four_ranks):
    """The library split by targets on the port's (2, 2) mesh against the
    JAX package's ``sharded_gf_logp`` on its (2, 4) mesh and its unsharded
    ``vmap(stack_all)`` llk (tests/test_parallel.py:152-204)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from beat_tpu.ffi import SeismicGFLibrary
    from beat_tpu.parallel import make_gf_mesh, sharded_gf_logp, target_sharding

    data, durations, starttimes, slips, dobs, w = ranks.gf_inputs()
    lib = SeismicGFLibrary(data=jnp.asarray(data), **ranks.GF_GRID)

    def full_llk(lib, durations, starttimes, slips, dobs, w):
        def one(d, s, u):
            r = dobs - lib.stack_all(d, s, u, "multilinear")
            return -0.5 * jnp.sum(w[:, None] * r * r)

        return jax.vmap(one)(durations, starttimes, slips)

    args = tuple(jnp.asarray(x) for x in (durations, starttimes, slips, dobs, w))
    want = np.asarray(jax.jit(full_llk)(lib, *args))
    mesh = make_gf_mesh(2, 4)
    lib_spec = jax.tree_util.tree_map(lambda _: P("targets"), lib)
    sharded = sharded_gf_logp(mesh, full_llk, in_specs=(
        lib_spec, P("chains"), P("chains", "targets"), P("chains"), P("targets"),
        P("targets")))
    jax_sharded = np.asarray(sharded(jax.device_put(lib, target_sharding(mesh)), *args))

    T = ranks.GF_SHAPE["T"]
    for r in four_ranks:
        # each rank held its block of targets, a copy of that block alone
        assert r["gf_local"] == (T // 2, data.nbytes // 2, (ranks.GF_SHAPE["C"] // 2,))
        np.testing.assert_allclose(r["gf_logp"], jax_sharded, rtol=LLK_RTOL)
        np.testing.assert_allclose(r["gf_logp"], want, rtol=LLK_RTOL)


def test_auto_mesh_shards_only_what_the_ranks_divide(two_ranks):
    from beat_tpu_torch.models.problem import Problem
    from beat_tpu_torch.parameter import PriorSet

    assert Problem(PriorSet(), {}, device="cpu")._auto_mesh(64) is None     # one rank: none
    for r in two_ranks[1]:
        assert r["auto_mesh"] == (2, None)


def test_cli_sample_on_two_ranks_equals_one_process(cli_ranks):
    """``Problem.sample()`` of a project through the command line on 2
    ranks: the first population's llks per chain equal the one-process
    run's, rank 0 alone writes, and the posterior finds the truth."""
    from beat_tpu_torch.flagship import TRUE_DEPTH, TRUE_MAGNITUDE
    from beat_tpu_torch.models.problem import load_model

    project, one, results = cli_ranks
    problem = load_model(str(project), "geometry", device="cpu")
    two = SampleStage(problem.outfolder, ordering=problem.ordering)
    first = SampleStage(str(one / "geometry"), ordering=problem.ordering).load_state(0)
    np.testing.assert_allclose(two.load_state(0)["likelihoods"], first["likelihoods"],
                               rtol=LLK_RTOL)
    assert [r["cli_rc"] for r in results] == [0, 0]
    assert results[0]["cli_saves"][0] == 0 and results[0]["cli_saves"][-1] == -1
    assert results[1]["cli_saves"] == []
    trace = two.load_trace(-1)
    assert float(two.load_state(-1)["beta"]) == 1.0 and np.isfinite(trace.llk_trace).all()
    assert trace.q_trace.shape[1] == ranks.FULLMT_SMC["n_chains"]
    est = problem.ordering.to_point(trace.q_trace[-1].mean(axis=0))
    assert abs(float(est["depth"]) - TRUE_DEPTH) < DEPTH_TOL
    assert abs(float(est["magnitude"]) - TRUE_MAGNITUDE) < MAG_TOL


def test_shardings_cut_this_ranks_block():
    """The sharding helpers without a process group are the identity;
    with a mesh their blocks are the ones the samplers use (checked on
    the ranks above)."""
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(parallel.chain_sharding(None)(x), x)
    assert torch.equal(parallel.target_sharding(None, axis=1)(x), x)
    assert parallel.replicated(None)(x) is x
    from beat_tpu_torch.samplers import MetropolisState

    state = MetropolisState(x, x[:, 0], x[:, 1], x[:, 2], x[:, 0])
    assert all(torch.equal(a, b) for a, b in zip(parallel.shard_chain_state(state, None), state))
