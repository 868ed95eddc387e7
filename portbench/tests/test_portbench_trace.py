"""The trace reduction and the metric readers on a recorded trace
fixture (``data/trace_fixture.json``: a 1 ms sub-window with one
Metropolis step, a K1c launch inside ``k1c``, one inside ``logp`` only,
a copy after the step and a saver thread's span)."""

import json
from pathlib import Path

import pytest
import torch

from portbench.counts import k1c
from portbench.counts.peaks import FP32_FLOPS_PER_S, least_seconds
from portbench.harness import catalog, trace
from portbench.harness.cell import RunRecord

FIXTURE = str(Path(__file__).parent / "data" / "trace_fixture.json")


def test_summary_of_the_fixture():
    s = trace.summarize(FIXTURE)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)
    assert s.launches == 3                     # two launches and a copy, not the sync
    assert s.span_device_s["k1c"] == pytest.approx(200e-6)
    assert s.span_device_s["logp"] == pytest.approx(300e-6)
    assert s.span_device_s["metropolis_step"] == pytest.approx(300e-6)
    assert "save_stage" not in s.span_device_s
    assert s.span_host_s["save_stage"] == pytest.approx(600e-6)
    assert s.device_ops[0] == ("k1c/bilinear_contract_kernel", pytest.approx(200e-6))
    assert s.idle_gaps[0] == ["host", pytest.approx(300e-6)]       # 500-800 us
    assert [g[1] for g in s.idle_gaps[1:]] == pytest.approx([150e-6, 100e-6, 100e-6])
    assert s.idle_gaps[3][0] == "metropolis_step"     # 300-400 us: logp has closed
    assert trace.has_device_records(FIXTURE)


def record(**kw):
    config = json.loads((catalog.PORTBENCH / "configs" / "fullmt.json").read_text())
    traffic = {"n_chains": 2000}
    cell = {"name": "fullmt-smc", "config": "fullmt"}
    r = RunRecord(cell, config, traffic, {}, torch.device("cpu"), **kw)
    return r


def test_readers_on_the_fixture():
    table = torch.empty(0)
    cd = torch.tensor([[0, 1], [0, 1]])
    z0 = torch.tensor([[0, 0], [1, 1]])
    call = ((torch.empty((6, 4, 60)), cd, z0, None), {})
    r = record(trace=trace.summarize(FIXTURE), trace_steps=1, k1c_calls=[call],
               window_s=10.0, stage_s=7.5, save_s=2.0, evals=4_000_000, calls=[
                   {"converged": True, "failed": False}] * 2, setup_s=3.0,
               peak_bytes=2_500_000_000)
    del table

    def read(name):
        return catalog.load_module("metrics", name).read(r)

    assert read("device_idle_share") == pytest.approx(65.0)
    assert read("launches_per_step") == pytest.approx(3.0)
    assert read("smc_host_share") == pytest.approx(25.0)
    assert read("stage_write_share") == pytest.approx(20.0)
    assert read("evals_per_s") == pytest.approx(400_000.0)
    assert read("inversion_s") == pytest.approx(5.0)
    assert read("peak_device_gb") == pytest.approx(2.5)
    assert read("setup_s") == 3.0
    assert read("eikonal_share") is None and read("k3_roofline") is None
    # rows: queries (0,0),(1,0),(0,1),(1,1) in a 4-deep packed table: corners
    # of each are row, row+1, row+4, row+5 -> 9 distinct rows of 60 floats
    n_bytes, flops, _ = k1c.call_work(*call)
    assert n_bytes == 9 * 60 * 4 + 4 * 8 + 4 * 24 * 4 + 4 * 10 * 4 and flops == 2 * 24 * 10 * 4
    assert read("k1c_roofline") == pytest.approx(100 * least_seconds(n_bytes, flops) / 200e-6)
    flops_llk = catalog.load_module("counts", "fullmt").llk_flops(r.config)
    assert read("step_mfu") == pytest.approx(100 * flops_llk * 2000 / (1e-3 * FP32_FLOPS_PER_S))


def test_readers_leave_out_what_they_cannot_read():
    r = record(window_s=5.0, calls=[{"converged": False, "failed": False}])
    for name in ("k1c_roofline", "k3_roofline", "device_idle_share", "step_mfu",
                 "launches_per_step", "eikonal_share", "stage_write_share", "inversion_s",
                 "peak_device_gb"):
        assert catalog.load_module("metrics", name).read(r) is None, name
