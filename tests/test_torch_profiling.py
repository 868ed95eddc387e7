"""
The port's timers (``beat_tpu_torch.profiling``): the registry and its
report as the JAX package's, the stage timer, the ``torch.profiler``
trace written as a Chrome trace, the slope timer and ``time_per_sample``
with the data passed as arguments (the JAX package's closes over them),
and the samplers' records: one entry per SMC stage, dumped beside the
stages as ``timings.json``, and PT's.

The spans and counters: off, nothing is recorded and no profiler region
entered; on, parents, self seconds, counters and the inversion's id
carried to another thread; and the samplers with spans on (a Gaussian
toy under each kernel, the FullMT and the kinematic FFI problems at test
size) record every span and counter of the program and write stage
files equal, bit for bit, to those of the same seed with spans off.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from beat_tpu_torch import profiling
from test_torch_common import THREADS  # noqa: F401  (thread policy)
from test_torch_common import plain_chain_iterations


@pytest.fixture
def spans_on():
    """Spans on and empty for one test, then off and empty again."""
    before = profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        yield
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()


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
    """The stage timer's record; spans off, its ``span_name`` records
    nothing."""
    reg = profiling.TimingRegistry()
    with profiling.stage_timer("work", n_evals=10, registry=reg, span_name="smc.stage",
                               span_attrs={"stage": 1}, beta=0.5):
        sum(range(1000))
    assert reg.records[0].name == "work" and reg.records[0].extra == {"beta": 0.5}
    assert reg.records[0].wall_s > 0 and profiling.span_snapshot()["spans"] == []
    reg.dump(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["total_evals"] == 10


def test_stage_timer_records_one_interval_as_a_span(spans_on):
    reg = profiling.TimingRegistry()
    with profiling.span("outer"):
        with profiling.stage_timer("smc_stage_3", n_evals=4, registry=reg,
                                   span_name="smc.stage", span_attrs={"stage": 3}, beta=0.25):
            time.sleep(0.002)
    spans = {s["name"]: s for s in profiling.span_snapshot()["spans"]}
    stage = spans["smc.stage"]
    assert stage["attrs"] == {"stage": 3, "beta": 0.25}
    assert stage["parent"] == spans["outer"]["id"]
    # the record's wall-clock is the span's interval, read once
    assert reg.records[0].wall_s == (stage["end_ns"] - stage["start_ns"]) / 1e9
    assert reg.records[0].extra == {"beta": 0.25}


def test_torch_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("BEAT_TPU_PROFILE_DIR", raising=False)
    with profiling.torch_trace() as logdir:
        assert logdir is None
    before = profiling.enable_spans(True)
    try:
        with profiling.torch_trace(str(tmp_path / "prof")) as logdir:
            with profiling.span("region"):
                torch.ones(8).sum()
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()
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


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def test_spans_off_record_nothing_and_enter_no_region():
    from torch.profiler import ProfilerActivity, profile

    assert profiling.enable_spans(False) is False        # off unless turned on
    profiling.reset_spans()
    first = profiling.span("off.region", k=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with first, profiling.span("off.inner"):
            torch.ones(8).sum()
            profiling.count("off.counter", 3)
    assert first is profiling.span("another")          # one shared no-op object
    names = {e.name for e in prof.events()}
    assert "aten::sum" in names and not names & {"off.region", "off.inner"}
    assert profiling.span_snapshot() == {"spans": [], "counters": {}, "by_name": {}}

    def fn():
        return 1

    assert profiling.carry(fn) is fn


def test_spans_on_record_parents_self_time_counters_and_threads(spans_on):
    seen = {}

    def saver():
        with profiling.span("stage.write", stage=1):
            profiling.count("stage.bytes", 100)
        seen["thread"] = threading.get_ident()

    with profiling.span("smc.sample", root=True) as root:
        with profiling.span("smc.transition"):
            with profiling.span("leaf"):
                time.sleep(0.003)
            time.sleep(0.002)
        worker = threading.Thread(target=profiling.carry(saver))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        profiling.count("stage.bytes", 20)
    stray = threading.Thread(target=saver)       # not carried: no inversion
    stray.start()
    stray.join(timeout=30)
    assert not stray.is_alive()

    snap = profiling.span_snapshot()
    spans = snap["spans"]
    by = {}
    for s in spans:
        by.setdefault(s["name"], []).append(s)
    (top,), (mid,), (leaf,) = by["smc.sample"], by["smc.transition"], by["leaf"]
    assert top["id"] == root.id and top["inversion"] == top["id"] and top["parent"] is None
    assert mid["parent"] == top["id"] and leaf["parent"] == mid["id"]
    assert {mid["inversion"], leaf["inversion"]} == {top["id"]}
    carried, loose = by["stage.write"]
    assert carried["inversion"] == top["id"] and carried["parent"] is None
    assert carried["thread"] != top["thread"] and carried["attrs"] == {"stage": 1}
    assert loose["inversion"] is None
    assert snap["counters"] == {"stage.bytes": 220}

    def dur(s):
        return s["end_ns"] - s["start_ns"]

    rows = snap["by_name"]
    assert rows["stage.write"]["count"] == 2 and rows["leaf"]["count"] == 1
    assert rows["leaf"]["self_s"] == rows["leaf"]["total_s"] == dur(leaf) / 1e9
    assert rows["smc.transition"]["self_s"] == pytest.approx((dur(mid) - dur(leaf)) / 1e9,
                                                             rel=1e-12)
    assert rows["smc.transition"]["self_s"] >= 0.0015
    # the other thread's write is no child of the root: only the transition is
    assert rows["smc.sample"]["self_s"] == pytest.approx((dur(top) - dur(mid)) / 1e9,
                                                         rel=1e-12)
    text = profiling.span_summary(snap)
    assert "smc.transition" in text and "stage.bytes" in text and "220" in text
    profiling.reset_spans()
    assert profiling.span_snapshot()["spans"] == []


#: every span and counter that one SMC inversion records, beside those of
#: the forward it runs
SMC_SPANS = {"smc.sample", "smc.transition", "smc.fetch", "smc.save_wait", "smc.stage",
             "stage.write", "metropolis.step", "metropolis.propose", "metropolis.accept"}
FULLMT_SPANS = {"fullmt.queries", "fullmt.filter", "fullmt.phasors", "fullmt.idft",
                "fullmt.misfit"}


def _stage_files(home) -> dict:
    """{relative path: contents} of a run's stage files (the arrays of
    each ``.npz``, ``meta.json`` as text)."""
    out = {}
    for stage in sorted(d for d in os.listdir(home) if d.startswith("stage_")):
        for name in sorted(os.listdir(os.path.join(home, stage))):
            path = os.path.join(home, stage, name)
            if name.endswith(".npz"):
                with np.load(path) as z:
                    out[f"{stage}/{name}"] = {k: z[k] for k in z.files}
            else:
                with open(path) as f:
                    out[f"{stage}/{name}"] = f.read()
    return out


def _assert_same_files(got: dict, want: dict):
    assert sorted(got) == sorted(want) and any(k.endswith("trace.npz") for k in want)
    for key, value in want.items():
        if isinstance(value, dict):
            assert sorted(got[key]) == sorted(value), key
            for name, array in value.items():
                assert got[key][name].dtype == array.dtype, (key, name)
                np.testing.assert_array_equal(got[key][name], array, err_msg=f"{key}:{name}")
        else:
            assert got[key] == value, key


def _check_inversion_spans(snap, n_calls: int = 1):
    """Every span of the calls belongs to one of their inversions, the
    saver thread's included; the steps each hold one proposal and one
    accept."""
    spans = snap["spans"]
    roots = [s for s in spans if s["name"] == "smc.sample"]
    assert len(roots) == n_calls
    ids = {s["id"] for s in roots}
    assert all(s["inversion"] in ids for s in spans)
    steps = {s["id"] for s in spans if s["name"] == "metropolis.step"}
    for phase in ("metropolis.propose", "metropolis.accept"):
        parents = [s["parent"] for s in spans if s["name"] == phase]
        assert sorted(parents) == sorted(steps), phase
    main = roots[0]["thread"]
    writes = [s for s in spans if s["name"] == "stage.write"]
    assert any(s["thread"] != main for s in writes)      # the saver's


def _run_twice(run, tmp_path):
    """``run(home)`` with spans off, then on: (files off, files on, the
    spans-on snapshot)."""
    run(str(tmp_path / "off"))
    before = profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        run(str(tmp_path / "on"))
        snap = profiling.span_snapshot()
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()
    return _stage_files(tmp_path / "off"), _stage_files(tmp_path / "on"), snap


@pytest.mark.parametrize("kernel", ["MultivariateNormal", "MALA", "HMC"])
def test_spans_change_no_sampler_result(tmp_path, kernel):
    """A Gaussian toy to β = 1 under each kernel: spans on give the stage
    files and the trace of spans off, bit for bit, and one step span a
    step with its proposal and accept inside."""
    from beat_tpu_torch.samplers import SMCParams, smc_sample

    def logp(q):
        return -0.5 * ((q - 2.0) ** 2).sum(-1) / 0.04

    lo, hi = np.zeros(2), np.full(2, 5.0)
    params = SMCParams(n_chains=32, n_steps=6, tune_interval=3, seed=4, proposal_name=kernel,
                       n_leapfrog=2)
    traces = []

    def run(home):
        traces.append(smc_sample(logp, lo, hi, params, device="cpu", homepath=home))

    off, on, snap = _run_twice(run, tmp_path)
    _assert_same_files(on, off)
    for a, b in zip(traces[0], traces[1]):
        np.testing.assert_array_equal(a, b)
    assert SMC_SPANS <= set(snap["by_name"])
    n_stages = len([k for k in off if k.endswith("trace.npz")]) - 1      # stage_0: the prior
    assert snap["by_name"]["metropolis.step"]["count"] == n_stages * params.n_steps
    assert snap["by_name"]["smc.stage"]["count"] == n_stages
    _check_inversion_spans(snap)


def test_spans_on_a_fullmt_inversion(tmp_path):
    """The FullMT problem at test size, capped at three stages: every span
    and counter of the SMC, the stage files and the FullMT forward, and
    stage files equal to those of spans off."""
    from beat_tpu_torch.flagship import TEST_SIZE, build_flagship
    from beat_tpu_torch.samplers import SMCParams

    problem = build_flagship(**TEST_SIZE, seed=3, device="cpu",
                             outfolder=str(tmp_path / "setup"))
    params = SMCParams(n_chains=24, n_steps=4, max_stages=3, seed=11)

    def run(home):
        problem.outfolder = home
        with pytest.raises(RuntimeError, match="did not reach beta=1"):
            problem.sample(params)

    off, on, snap = _run_twice(run, tmp_path)
    _assert_same_files(on, off)
    assert SMC_SPANS | FULLMT_SPANS <= set(snap["by_name"])
    n_arrays = sum(a.nbytes for files in off.values() if isinstance(files, dict)
                   for a in files.values())
    assert snap["counters"]["stage.bytes"] == n_arrays
    # the stage-0 save and the joins at the cap
    waits = [s["attrs"]["stage"] for s in snap["spans"] if s["name"] == "smc.save_wait"]
    assert waits == [0, 3]
    _check_inversion_spans(snap)


def test_spans_on_a_kinematic_ffi_inversion(tmp_path):
    """The kinematic FFI problem at test size: the eikonal's span and its
    counters beside the SMC's, and stage files equal to those of spans
    off."""
    from beat_tpu_torch.flagship import FFI_TEST_SIZE, build_ffi_flagship
    from beat_tpu_torch.samplers import SMCParams

    problem = build_ffi_flagship(**FFI_TEST_SIZE, seed=2, device="cpu",
                                 outfolder=str(tmp_path / "setup"))
    params = SMCParams(n_chains=24, n_steps=4, max_stages=2, seed=5)

    def run(home):
        problem.outfolder = home
        with pytest.raises(RuntimeError, match="did not reach beta=1"):
            problem.sample(params)

    off, on, snap = _run_twice(run, tmp_path)
    _assert_same_files(on, off)
    assert SMC_SPANS | {"eikonal.solve"} <= set(snap["by_name"])
    counters = snap["counters"]
    solves = snap["by_name"]["eikonal.solve"]["count"]
    assert counters["eikonal.solves"] == solves
    # one evaluation a step and the start population's, one solve each
    assert solves == params.n_steps + 1
    assert solves <= counters["eikonal.iterations"]
    assert "launches.beat_eikonal_f32" not in counters      # the CPU takes the plain version
    assert "eikonal.kernel_max_iterations" not in counters
    _check_inversion_spans(snap)


def test_eikonal_counts_its_iterations(spans_on):
    """One solve counts the iterations it ran, the masked no-ops up to the
    next check included, and solves as with spans off."""
    from beat_tpu_torch.ops.eikonal import CHECK_EVERY, eikonal_rupture_times

    rng = np.random.default_rng(0)
    slowness = torch.as_tensor(rng.uniform(0.3, 0.5, (3, 5, 9)), dtype=torch.float32)
    args = (slowness, 2.0, torch.tensor([0, 2, 4]), torch.tensor([0, 4, 8]))
    got = eikonal_rupture_times(*args)
    counters = profiling.span_snapshot()["counters"]
    assert counters["eikonal.solves"] == 1 and "launches.beat_eikonal_f32" not in counters
    assert "eikonal.kernel_max_iterations" not in counters
    n = counters["eikonal.iterations"]
    assert n % CHECK_EVERY == 0 and n >= 5 + 9 - 2
    profiling.enable_spans(False)
    np.testing.assert_array_equal(eikonal_rupture_times(*args).numpy(), got.numpy())
    # capped below the iterations it needs, a solve counts the cap
    profiling.enable_spans(True)
    profiling.reset_spans()
    eikonal_rupture_times(*args, max_iter=n - 3)
    assert profiling.span_snapshot()["counters"]["eikonal.iterations"] == n - 3


def test_eikonal_counts_a_fused_solve(monkeypatch):
    """A solve routed to the kernel (stood in for here by the plain
    version's onsets and per-chain counts) counts ``eikonal.solves``, and
    as ``eikonal.kernel_max_iterations`` the largest per-chain count, read
    only while spans are on and after the ``eikonal.solve`` span has
    closed; ``eikonal.iterations`` stays the plain loop's.  (The launch
    itself is counted by the launcher: ``test_launcher_counts_each_launch_once``.)"""
    from beat_tpu_torch.ops import eikonal as eik

    rng = np.random.default_rng(1)
    slowness = torch.as_tensor(rng.uniform(0.3, 0.5, (3, 5, 9)), dtype=torch.float32)
    args = (slowness, 2.0, torch.tensor([0, 2, 4]), torch.tensor([0, 4, 8]))
    before = profiling.enable_spans(False)
    times = eik.eikonal_rupture_times_plain(*args)
    runs = plain_chain_iterations(args[0], args[2], args[3], args[1])[0]
    reads = []

    class Counts(torch.Tensor):
        def max(self, *a, **kw):        # records the solve spans closed by then
            solve = profiling.span_snapshot()["by_name"].get("eikonal.solve", {})
            reads.append(solve.get("count", 0))
            return super().max(*a, **kw)

    monkeypatch.setattr(eik, "fused_route", lambda *a: True)
    monkeypatch.setattr(eik, "eikonal_rupture_times_fused",
                        lambda *a, **kw: (times, runs.as_subclass(Counts)))
    try:
        assert eik.eikonal_rupture_times(*args) is times and not reads
        assert profiling.span_snapshot()["counters"] == {}
        profiling.enable_spans(True)
        profiling.reset_spans()
        assert eik.eikonal_rupture_times(*args) is times and reads == [1]
        counters = profiling.span_snapshot()["counters"]
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()
    assert counters == {"eikonal.solves": 1, "eikonal.kernel_max_iterations": int(runs.max())}
    assert len(set(runs.tolist())) > 1


def test_launcher_counts_each_launch_once(monkeypatch):
    """Every kernel launch goes through ``kernels/build.py::launch``,
    which counts it once as ``launches.<C entry>`` while spans are on and
    counts nothing while they are off, nor a launch whose entry returns an
    error (a stand-in entry here: the CPU has no card)."""
    from beat_tpu_torch.kernels import build

    calls = []

    def beat_gather_rows_f32(*args):
        calls.append(args)
        return 0 if args[0] else 700

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(build, "_stream", lambda torch_, device: 7)
    card = torch.device("cuda", 0)
    before = profiling.enable_spans(False)
    try:
        assert build.launch(card, beat_gather_rows_f32, 1, 2) == 0
        assert profiling.span_snapshot()["counters"] == {}
        profiling.enable_spans(True)
        profiling.reset_spans()
        for _ in range(3):
            build.launch(card, beat_gather_rows_f32, 1, 2)
        assert build.launch(card, beat_gather_rows_f32, 0, 2) == 700
        counters = profiling.span_snapshot()["counters"]
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()
    assert counters == {"launches.beat_gather_rows_f32": 3}
    assert calls == [(1, 2, 7)] * 4 + [(0, 2, 7)]


# ---------------------------------------------------------------------------
# what the spans read (tools/bench_torch_spans.py)
# ---------------------------------------------------------------------------


def _hand_span(name, start_ms, end_ms, thread=1, **attrs):
    return {"name": name, "id": 0, "parent": None, "thread": thread, "inversion": 1,
            "start_ns": int(start_ms * 1e6), "end_ns": int(end_ms * 1e6), "attrs": attrs}


def test_span_readings_on_hand_built_intervals():
    """Known intervals give known readings; None where a reading has
    nothing to read."""
    from tools.bench_torch_spans import span_readings

    spans = [
        _hand_span("smc.save_wait", 100, 200), _hand_span("smc.save_wait", 900, 1100),
        _hand_span("smc.save_wait", 300, 400, thread=2),         # not the main thread's
        _hand_span("stage.write", 150, 450, thread=2),
        _hand_span("metropolis.step", 160, 260),                  # overlaps the write
        _hand_span("metropolis.step", 500, 550), _hand_span("metropolis.step", 600, 650),
        _hand_span("eikonal.solve", 700, 701), _hand_span("eikonal.solve", 800, 801),
    ]
    snap = {"spans": spans, "counters": {"stage.bytes": 6_000_000, "eikonal.iterations": 40,
                                         "eikonal.solves": 4}}
    got = span_readings(snap, 0, int(1000e6), main_thread=1)
    assert got["save_wait_share"] == pytest.approx(20.0)          # 100 + 100 of 1000 ms
    assert got["stage_write_mb_per_s"] == pytest.approx(20.0)     # 6 MB in 0.3 s
    assert got["write_step_slowdown"] == pytest.approx(100.0)     # 100 ms against 50
    assert (got["steps_during_write"], got["steps_clear"]) == (1, 2)
    assert got["eikonal_iter_us"] == pytest.approx(50.0)          # 2 ms over 40
    assert got["eikonal_fused_share"] == 0.0
    # three of the four solves on the kernel: its time is not the plain loop's
    snap["counters"]["launches.beat_eikonal_f32"] = 3
    got = span_readings(snap, 0, int(1000e6), main_thread=1)
    assert got["eikonal_fused_share"] == pytest.approx(0.75)
    assert got["eikonal_iter_us"] is None

    # a write on the step's own thread slows no step; nothing else to read
    alone = span_readings({"spans": [_hand_span("metropolis.step", 0, 10),
                                     _hand_span("stage.write", 0, 5)], "counters": {}},
                          0, int(1e9), main_thread=1)
    assert alone["write_step_slowdown"] is None and alone["eikonal_iter_us"] is None
    assert alone["eikonal_fused_share"] is None
    assert alone["save_wait_share"] == 0.0 and alone["stage_write_mb_per_s"] == 0.0
    empty = span_readings({"spans": [], "counters": {}}, 0, int(1e9), main_thread=1)
    assert empty["stage_write_mb_per_s"] is None and empty["write_step_slowdown"] is None


def _trace_events(path, spans, launches):
    """A Chrome trace of user annotations ``(name, ts, dur)`` on one host
    thread and kernels ``(launch ts, kernel ts, dur)``, in microseconds."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": dur, "tid": 1,
               "pid": 1} for n, ts, dur in spans]
    for corr, (at, ts, dur) in enumerate(launches, start=1):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at,
                       "dur": 2, "tid": 1, "pid": 1, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"kernel_{corr}", "ts": ts,
                       "dur": dur, "tid": 7, "pid": 0, "args": {"correlation": corr}})
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_pair_arith_share_and_the_breakdown_by_program_spans(tmp_path):
    """A small trace with the program's spans: the pair arithmetic's share
    of ``logp``'s device time, device operations named by the innermost
    program span, and the benchmark's own readings of the trace as they
    were."""
    from portbench.harness import trace
    from tools.bench_torch_spans import pair_arith_share, program_summary

    spans = [("portbench_window", 0, 1000), ("metropolis_step", 50, 900),
             ("metropolis.step", 60, 880), ("logp", 100, 800),
             ("fullmt.phasors", 200, 100), ("fullmt.filter", 400, 50),
             ("fullmt.idft", 500, 100)]
    path = _trace_events(tmp_path / "t.json", spans,
                         [(250, 260, 30), (420, 430, 10), (550, 560, 60), (970, 975, 5)])
    got = program_summary(path)
    assert pair_arith_share(got) == pytest.approx(40.0)           # (30 + 10) of 100 us
    assert got.device_ops[0] == ("fullmt.idft/kernel_3", pytest.approx(60e-6))
    assert ("fullmt.phasors/kernel_1", pytest.approx(30e-6)) in got.device_ops
    assert ("other/kernel_4", pytest.approx(5e-6)) in got.device_ops
    assert got.idle_gaps[0] == ["metropolis_step/metropolis.step/logp", pytest.approx(355e-6)]
    assert ["metropolis.step/logp/fullmt.phasors", pytest.approx(140e-6)] in got.idle_gaps
    plain = trace.summarize(path)
    for key in ("window_s", "busy_s", "launches"):
        assert getattr(got, key) == getattr(plain, key)
    for name, seconds in plain.span_device_s.items():
        assert got.span_device_s[name] == seconds
    assert trace.SPAN_NAMES == plain_names()
    # no logp span, no share
    bare = _trace_events(tmp_path / "b.json", [("portbench_window", 0, 100)], [(10, 20, 5)])
    assert pair_arith_share(program_summary(bare)) is None


def plain_names():
    return ("k1c", "k3", "eikonal", "logp", "metropolis_step", "metropolis_stage",
            "smc_stage", "save_stage")


def test_the_benchmark_fixture_reads_the_same_with_program_spans():
    """Every key of the benchmark's ``TraceSummary`` on its committed
    fixture reads the same when the program's span names are added."""
    from dataclasses import asdict
    from pathlib import Path

    from portbench.harness import trace
    from tools.bench_torch_spans import program_summary

    fixture = str(Path(__file__).resolve().parents[1] / "portbench" / "tests" / "data"
                  / "trace_fixture.json")
    assert asdict(program_summary(fixture)) == asdict(trace.summarize(fixture))
