"""
One run of one cell: set-up, the measured window of back-to-back
inversions, the traced sub-window, the comparison, and the record the
metric readers read.

The window runs ``Problem.sample(SMCParams(...))`` calls back to back:
it opens at the first call and closes at the end of the first call that
ends at or after ``seconds``.  Each call has a seed derived from the
run's seed and its index, and writes its stage files to a fresh
directory under ``TMPDIR``; the directories are judged once the window
has closed and the program's state is freed, then deleted.  A call that
stops at the traffic's stage cap (``expect: "cap"``) ends as expected;
any other exception, or a non-finite log-likelihood, fails the call.
"""

from __future__ import annotations

import gc
import json
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench.harness import judge as judge_mod
from portbench.harness import catalog

CAP_MESSAGE = "SMC did not reach beta=1"


def derive_seed(seed: int, *path: int) -> int:
    """A 62-bit seed from the run's seed and a path of indexes."""
    state = np.random.SeedSequence([int(seed) % 2**64, *path]).generate_state(2, np.uint32)
    return int(state[0]) << 30 ^ int(state[1])


@dataclass
class RunRecord:
    """What a run measured; the metric readers read it."""

    cell: dict
    config: dict
    traffic: dict
    cell_file: dict
    device: torch.device
    setup_s: float = 0.0
    inputs_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)
    evals: int = 0
    stage_s: float = 0.0
    save_s: float | None = None
    peak_bytes: int | None = None
    trace: object = None
    k1c_calls: list = field(default_factory=list)
    k3_calls: list = field(default_factory=list)
    trace_steps: int = 0
    numbers: dict = field(default_factory=dict)

    @property
    def converged(self) -> int:
        return sum(1 for c in self.calls if c["converged"])

    @property
    def failed(self) -> int:
        return sum(1 for c in self.calls if c["failed"])


class CellRun:
    """``faults``: callables ``(problem) -> undo`` applied to the built
    problem (``portbench/faults.py``: the tests break the timed path with
    them); ``close`` undoes them."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, *, device,
                 t_start: float, overrides: dict | None = None, faults=()):
        self.seed, self.seconds, self.traced = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        overrides = overrides or {}

        def data(kind, name):
            return json.loads((catalog.PORTBENCH / kind / f"{name}.json").read_text())

        config = dict(data("configs", cell["config"]), **overrides.get("config", {}))
        traffic = dict(data("traffic", cell["traffic"]), **overrides.get("traffic", {}))
        cell_file = data("workloads", cell["name"])
        for key, value in overrides.get("cell", {}).items():
            cell_file[key] = dict(cell_file.get(key, {}), **value)
        self.cfg = catalog.load_module("configs", cell["config"])
        self.record = RunRecord(cell, config, traffic, cell_file, self.device)
        self.faults = faults
        self.tmp = Path(tempfile.mkdtemp(prefix="portbench_"))
        self.spans = None
        self._undo = []

    # -- phases -------------------------------------------------------------------

    def params(self, **changes):
        from beat_tpu_torch.samplers.smc import SMCParams

        t = dict(self.record.traffic, **changes)
        return SMCParams(n_chains=t["n_chains"], n_steps=t["n_steps"],
                         coef_variation=t["coef_variation"], tune_interval=t["tune_interval"],
                         proposal_name=t["proposal_name"], buffer_thinning=t["buffer_thinning"],
                         max_stages=t["max_stages"], seed=t["seed"])

    def sample(self, params, cap_ok: bool = False) -> dict:
        """One call into a fresh directory: its record.  ``cap_ok``: the
        stage cap ends the call as expected whatever the traffic says."""
        home = tempfile.mkdtemp(prefix="call_", dir=self.tmp)
        self.problem.outfolder = home
        rec = {"home": home, "seed": params.seed, "converged": False, "failed": False}
        t0 = time.perf_counter()
        try:
            _, llk = self.problem.sample(params)
            rec["converged"] = True
            rec["failed"] = not bool(np.all(np.isfinite(llk)))
        except RuntimeError as err:
            expected = ((cap_ok or self.record.traffic["expect"] == "cap")
                        and CAP_MESSAGE in str(err))
            rec["failed"] = not expected
            if not expected:
                rec["error"] = repr(err)
        except Exception:  # noqa: BLE001 - a failed call is counted, the run goes on
            rec["failed"] = True
            rec["error"] = traceback.format_exc()[-1500:]
        self._sync()
        rec["seconds"] = time.perf_counter() - t0
        return rec

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        r = self.record
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, 0]))
        t0 = time.perf_counter()
        self.inputs = self.cfg.make_inputs(r.config, rng)
        r.inputs_s = time.perf_counter() - t0
        if self.traced:
            from portbench.harness.spans import Spans, warm_profiler

            t = r.cell_file["trace"]
            self.spans = Spans(str(self.tmp), t["stage"], t["skip"], t["steps"],
                               self.device).install()
            warm_profiler(self.device)
        self.problem = self.cfg.build_problem(r.config, self.inputs, device=self.device,
                                              outfolder=str(self.tmp / "setup"))
        layout = [(n, s) for n, s, *_ in r.config["priors"]]
        priors = self.problem.priors.parameters
        got = [(n, priors[n].dimension) for n in self.problem.ordering.names]
        if got != layout:
            raise RuntimeError(f"the program's flat layout {got} is not the configuration's "
                               f"{layout}")
        self._undo = [fault(self.problem) for fault in self.faults]
        warm = r.traffic["warmup"]
        rec = self.sample(self.params(n_steps=warm["n_steps"], max_stages=warm["max_stages"],
                                      seed=derive_seed(self.seed, 1)), cap_ok=True)
        shutil.rmtree(rec["home"], ignore_errors=True)
        if rec["failed"]:
            raise RuntimeError(f"warm-up call failed: {rec.get('error')}")
        self._sync()
        r.setup_s = time.perf_counter() - self.t_start - r.inputs_s

    def window(self):
        from beat_tpu_torch.profiling import timings

        r = self.record
        mark = len(timings.records)
        if self.spans is not None:
            self.spans.save_seconds = 0.0
            self.spans.arm()
        t0 = time.perf_counter()
        while True:
            rec = self.sample(self.params(seed=derive_seed(self.seed, 2, len(r.calls))))
            r.calls.append(rec)
            if time.perf_counter() - t0 >= self.seconds:
                break
        r.window_s = time.perf_counter() - t0
        stages = [s for s in timings.records[mark:] if s.name.startswith("smc_stage_")]
        r.stage_s = sum(s.wall_s for s in stages)
        r.evals = sum(s.n_evals or 0 for s in stages) + r.traffic["n_chains"] * len(r.calls)
        if self.device.type == "cuda":
            r.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        if self.spans is not None:
            from portbench.harness.trace import first_with_device, summarize

            r.save_s = self.spans.save_seconds
            self.spans.uninstall()
            found = first_with_device(self.spans.traces)
            if found is None and self.spans.traces and self.device.type != "cuda":
                path, k1c, k3, steps = self.spans.traces[0]
                found = summarize(path), k1c, k3, steps
            if found is not None:
                r.trace, r.k1c_calls, r.k3_calls, r.trace_steps = found

    def judge(self):
        """The comparison, after the program's state is freed."""
        r = self.record
        del self.problem
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        homes = [c["home"] for c in r.calls if not c["failed"]]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed % 2**64, 3]))
        if homes:
            r.numbers = judge_mod.judge(self.cfg, r.config, self.inputs, homes, r.traffic,
                                        r.cell_file, rng, self.device)

    def close(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        if self.spans is not None:
            self.spans.uninstall()
        shutil.rmtree(self.tmp, ignore_errors=True)

    def run(self) -> RunRecord:
        try:
            self.setup()
            self.window()
            self.judge()
        finally:
            self.close()
        return self.record


def checks(record: RunRecord) -> list:
    """``[(name, value, limit)]`` of the comparison: every number of the
    cell's ``limits`` (None where it was not read), and the failed calls
    against 0."""
    out = [("failed_calls", record.failed, 0)]
    for name, limit in record.cell_file["limits"].items():
        out.append((name, record.numbers.get(name), limit))
    return out


def is_correct(record: RunRecord) -> bool:
    """Every number read and within its limit (a missing one fails)."""
    return bool(record.calls) and all(v is not None and v <= lim
                                      for _, v, lim in checks(record))


