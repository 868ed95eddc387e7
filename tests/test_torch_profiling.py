"""
The port's timers (``beat_tpu_torch.profiling``): the registry and its
report as the JAX package's, the stage timer and the method decorator,
the ``torch.profiler`` trace written as a Chrome trace, the slope timer
and ``time_per_sample`` with the data passed as arguments (the JAX
package's closes over them), and the samplers' records: one entry per
SMC stage, dumped beside the stages as ``timings.json``, and PT's.
"""

import json
import os

import numpy as np
import pytest
import torch

from beat_tpu_torch import profiling
from test_torch_common import THREADS  # noqa: F401  (thread policy)


def test_registry_report_equals_the_jax_package():
    from beat_tpu import profiling as jprof

    records = [("a", 0.5, 100, {"beta": 0.1}), ("b", 1.25, None, {}), ("c", 0.0, 5, {})]
    got, want = profiling.TimingRegistry(), jprof.TimingRegistry()
    for reg in (got, want):
        for name, wall, n, extra in records:
            reg.add(name, wall, n, **extra)
    assert got.report() == want.report()
    assert got.summary() == want.summary()
    got.reset()
    assert got.report() == {"stages": [], "total_wall_s": 0.0, "total_evals": 0}


def test_stage_timer_and_time_method(tmp_path):
    reg = profiling.TimingRegistry()
    with profiling.stage_timer("work", n_evals=10, registry=reg, beta=0.5):
        sum(range(1000))
    assert reg.records[0].name == "work" and reg.records[0].extra == {"beta": 0.5}

    @profiling.time_method
    def step(x):
        return x + 1

    mark = len(profiling.timings.records)
    assert step(1) == 2
    assert profiling.timings.records[mark].name.endswith("step")
    reg.dump(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["total_evals"] == 10


def test_torch_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("BEAT_TPU_PROFILE_DIR", raising=False)
    with profiling.torch_trace() as logdir:
        assert logdir is None
    with profiling.torch_trace(str(tmp_path / "prof")) as logdir:
        with profiling.annotate("region"):
            torch.ones(8).sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        trace = json.load(f)
    assert name.startswith("trace_") and any(e.get("name") == "region"
                                             for e in trace["traceEvents"])


def test_time_per_sample_passes_the_data_as_arguments():
    """The slope method's seconds per evaluation: the logp sees its data
    argument on every call, and a costlier logp takes longer."""
    seen = []

    def logp(q, data, reps):
        seen.append(data is DATA)
        x = q
        for _ in range(reps):
            x = torch.sin(x) @ data
        return x.sum(-1)

    DATA = torch.eye(64)
    q = torch.rand((256, 64))
    cheap = profiling.time_per_sample(logp, q, logp_args=(DATA, 1), n_lo=1, n_hi=4)
    dear = profiling.time_per_sample(logp, q, logp_args=(DATA, 40), n_lo=1, n_hi=4)
    assert all(seen) and len(seen) > 10
    assert 0 < cheap < dear
    assert profiling.slope_time(lambda n, rep: None, 1, 3) == pytest.approx(1e-12, abs=1e-6)


def test_samplers_record_their_timings(tmp_path):
    """One record per SMC stage (its evaluations and β), dumped beside the
    stages; PT adds its sampling time."""
    from beat_tpu_torch.samplers import PTParams, SMCParams, smc_sample
    from beat_tpu_torch.samplers.pt import pt_sample

    def logp(q):
        return -0.5 * ((q - 2.0) ** 2).sum(-1) / 0.04

    lo, hi = np.zeros(2), np.full(2, 5.0)
    mark = len(profiling.timings.records)
    smc_sample(logp, lo, hi, SMCParams(n_chains=32, n_steps=10, seed=1), device="cpu",
               homepath=str(tmp_path / "smc"))
    stages = [r for r in profiling.timings.records[mark:]]
    assert stages and stages[-1].name == "smc_stage_-1" and stages[-1].extra["beta"] == 1.0
    assert all(r.n_evals == 320 for r in stages)
    dumped = json.load(open(tmp_path / "smc" / "timings.json"))
    assert [row["name"] for row in dumped["stages"]] == [r.name for r in stages]
    stage_dirs = [d for d in os.listdir(tmp_path / "smc") if d.startswith("stage_")]
    assert len(dumped["stages"]) == len(stage_dirs) - 1     # stage_0 is the prior draw
    mark = len(profiling.timings.records)
    pt_sample(logp, lo, hi, PTParams(n_chains=4, n_chains_posterior=2, n_samples=20,
                                     swap_interval=(10, 10)), device="cpu")
    assert [r.name for r in profiling.timings.records[mark:]] == ["pt_sampling"]
