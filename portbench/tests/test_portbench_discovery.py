"""A cell, its traffic mix and a per-layer metric added as new files and
entries only, in a copy of the folder, are found and run: no file that
is there changes."""

import json
import shutil
import time

from portbench.harness import catalog
from portbench.harness.cell import CellRun, is_correct
from portbench.tests.sizes import overrides

METRIC = '''"""Calls the window attempted (a test metric)."""


def read(record):
    return float(len(record.calls))
'''


def test_new_cell_and_metric_from_new_files(tmp_path, monkeypatch):
    copy = tmp_path / "portbench"
    shutil.copytree(catalog.PORTBENCH, copy, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    before = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    traffic = json.loads((copy / "traffic" / "smc_rw_2000x300.json").read_text())
    traffic.update(n_chains=32, n_steps=6, why="a short mix for the test")
    (copy / "traffic" / "smc_rw_32x6.json").write_text(json.dumps(traffic))
    cell_file = json.loads((copy / "workloads" / "fullmt-smc.json").read_text())
    cell_file["judge"]["fit"] = False          # 6 steps a stage do not reach the source
    del cell_file["limits"]["fit_shortfall"]
    (copy / "workloads" / "fullmt-short.json").write_text(json.dumps(cell_file))
    (copy / "metrics" / "calls_attempted.py").write_text(METRIC)
    monkeypatch.setattr(catalog, "PORTBENCH", copy)

    bench = catalog.load_benchmark()
    bench["workloads"].append({"name": "fullmt-short", "config": "fullmt",
                               "traffic": "smc_rw_32x6", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_attempted", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "SMC host loop",
                               "moves": "evals_per_s", "workloads": ["fullmt-short"]})
    cell = catalog.find_cell(bench, "fullmt-short")
    small = overrides(catalog.find_cell(bench, "fullmt-smc"))
    small["traffic"] = {}
    run = CellRun(cell, 99, 0.0, False, device="cpu", t_start=time.perf_counter(),
                  overrides=small)
    record = run.run()
    assert record.traffic["n_chains"] == 32 and is_correct(record)
    metrics = catalog.read_metrics(catalog.cell_metrics(bench, "fullmt-short", "per_layer"),
                                   record)
    assert metrics["calls_attempted"] == {"value": 1.0, "unit": "calls"}
    assert "calls_attempted" not in {m["name"] for m in catalog.cell_metrics(
        bench, "fullmt-smc", "per_layer")}
    after = {p.relative_to(copy): p.read_bytes() for p in copy.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
