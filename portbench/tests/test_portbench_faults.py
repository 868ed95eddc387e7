"""Whole runs of each cell at test size on the CPU (the look for a card
skipped), sound and with the timed path broken underneath: the sound run
comes out correct, each fault the cell can show comes out not correct.

A step that returns its state unchanged is caught in ``fullmt-smc`` by
``fit_shortfall`` and in the FFI cells by ``still_share``.  No cell runs
on more than one chip, so there is no exchange to leave out."""

import time

import pytest

from portbench import faults
from portbench.harness import catalog
from portbench.harness.cell import CellRun, checks, is_correct
from portbench.tests.sizes import overrides

BENCH = catalog.load_benchmark()
SOUND_AND_FAULTS = {"fullmt-smc": (None, "stuck_step", "half_batch", "altered_answer"),
                    "ffi-smc": (None, "stuck_step", "half_batch", "altered_answer"),
                    "ffi-smc-fulltrace": (None, "stuck_step", "half_batch", "altered_answer")}
CASES = [(cell, fault) for cell, faults_ in SOUND_AND_FAULTS.items() for fault in faults_]


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_correct_comes_out_false_under_each_fault(cell_name, fault):
    cell = catalog.find_cell(BENCH, cell_name)
    planted = [faults.FAULTS[fault]] if fault else []
    run = CellRun(cell, 2**32 + 17, 0.0, False, device="cpu",
                  t_start=time.perf_counter(), overrides=overrides(cell), faults=planted)
    record = run.run()
    assert record.calls and record.failed == 0
    assert is_correct(record) == (fault is None), checks(record)
    # the reference's synthesis of the observed data is timed apart from set-up
    assert record.inputs_s > 0 and record.setup_s > 0
