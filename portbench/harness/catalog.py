"""
Where the benchmark finds its parts, by the names in ``BENCHMARK.json``:

* a configuration: ``configs/<config>.json`` (its sizes) and
  ``configs/<config>.py`` (its assembly; its plain reference under
  ``reference/``);
* a traffic mix: ``traffic/<traffic>.json``;
* a cell: ``workloads/<cell>.json`` (its profiled sub-window, its
  comparison and the limits of its numbers);
* a metric: ``metrics/<metric>.py``, whose ``read(record)`` returns the
  value or None where the run has nothing to read;
* the work of a kernel or of one likelihood: ``counts/<name>.py``.

Adding one of these is adding its file and its entry.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded from its
    file (a name may hold dots)."""
    path = PORTBENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    key = f"portbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def read_metrics(metrics: list, record) -> dict:
    """``{name: {"value", "unit"}}`` of the metrics whose readers find
    something in ``record``."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
