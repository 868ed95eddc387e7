"""``BENCHMARK.json`` against the contract's shape, and every name in it
resolved to its files."""

import json
import re

import pytest

from portbench.harness import catalog

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
BENCH = catalog.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion"
                   r"|per_tok)")


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_texts_are_valid(key):
    names = [entry["name"] for entry in BENCH[key]]
    assert len(names) == len(set(names))
    for entry in BENCH[key]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
            assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert TEXT.match(entry[text]), entry[text]


def test_configs_state_their_source_and_cuts():
    for entry in BENCH["configs"]:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"] == f"portbench/configs/{entry['name']}.json"
        cfg = json.loads((catalog.ROOT / entry["file"]).read_text())
        assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
        assert not any(WIDTH.search(k) for k in entry["reduced"])
        assert cfg["assumed"] and cfg["dtype"] == "float32"


def test_workloads_are_one_chip_cells_of_known_configs():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
    assert {w["config"] for w in BENCH["workloads"]} == configs


def test_metrics_keys_bounds_and_moves():
    names = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in names
        for cell in m.get("workloads", cells):
            reported = catalog.cell_metrics(BENCH, cell, "end_to_end")
            assert m["moves"] in {x["name"] for x in reported}
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    w = catalog.find_cell(BENCH, cell)
    pb = catalog.PORTBENCH
    traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    assert traffic["n_chains"] >= 2 and traffic["expect"] in ("converge", "cap")
    cell_file = json.loads((pb / "workloads" / f"{cell}.json").read_text())
    assert {"trace", "judge", "limits"} <= set(cell_file)
    assert {"llk_gap", "beta_gap", "resample_miss", "accept_miss"} <= set(cell_file["limits"])
    module = catalog.load_module("configs", w["config"])
    for fn in ("make_inputs", "build_problem", "Reference"):
        assert hasattr(module, fn)
    assert catalog.load_module("counts", w["config"]).llk_flops(
        json.loads((pb / "configs" / f"{w['config']}.json").read_text())) > 0
    e2e = catalog.cell_metrics(BENCH, cell, "end_to_end")
    layer = catalog.cell_metrics(BENCH, cell, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(catalog.load_module("metrics", m["name"]).read)

