"""The ``ffi-smc-bf16`` cell at test size on the CPU (the look for a card
skipped): whole runs, sound and with each fault of ``portbench/faults.py``
planted under the timed path; the sound run comes out correct, each
fault not.  Its plain reference against the program and against the
controls: TF32 and the interpolation weights rounded once to bfloat16."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import faults
from portbench.harness import catalog, judge
from portbench.harness.cell import CellRun, checks, is_correct
from portbench.tests import sizes

BENCH = catalog.load_benchmark()
CELL = catalog.find_cell(BENCH, "ffi-smc-bf16")
#: the cell at test size: ``ffi-smc``'s cuts of the configuration, traffic
#: and sub-windows (``tests/sizes.py``), on the bfloat16 configuration
OVERRIDES = {"config": sizes.small_config(CELL["config"]),
             "traffic": sizes.TRAFFIC["ffi-smc"], "cell": sizes.CELL["ffi-smc"]}


def limit() -> float:
    path = catalog.PORTBENCH / "workloads" / f"{CELL['name']}.json"
    return json.loads(path.read_text())["limits"]["llk_gap"]


@pytest.mark.parametrize("fault", [None, "stuck_step", "half_batch", "altered_answer"])
def test_correct_comes_out_false_under_each_fault(fault):
    planted = [faults.FAULTS[fault]] if fault else []
    run = CellRun(CELL, 2**32 + 29, 0.0, False, device="cpu", t_start=time.perf_counter(),
                  overrides=OVERRIDES, faults=planted)
    record = run.run()
    assert record.calls and record.failed == 0
    assert is_correct(record) == (fault is None), checks(record)
    assert record.inputs_s > 0 and record.setup_s > 0


def setup(seed: int):
    module = catalog.load_module("configs", CELL["config"])
    config = dict(sizes.config(CELL["config"]), **OVERRIDES["config"])
    return module, config, module.make_inputs(config, np.random.default_rng(seed))


def prior_rows(config, n, seed):
    lo = np.concatenate([[p[2]] * p[1] for p in config["priors"]])
    hi = np.concatenate([[p[3]] * p[1] for p in config["priors"]])
    return np.random.default_rng(seed).uniform(lo, hi, (n, lo.size)).astype(np.float32)


def gap(reference, q, llk) -> float:
    want, scale, alt = judge.reference_llk(reference, q, 16)
    return float(judge.llk_gaps(llk, want, scale, alt).max())


@pytest.mark.parametrize("seed", [3, 4])
def test_the_program_on_its_bf16_library_passes_and_the_controls_fail(seed, tmp_path):
    module, config, inputs = setup(seed)
    q = prior_rows(config, 48, seed + 100)
    problem = module.build_problem(config, inputs, device="cpu", outfolder=str(tmp_path))
    lib = problem.composites["seismic"].libs[0]["uparr"]
    assert lib.data.dtype == torch.bfloat16
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        port = logp(torch.as_tensor(q), data).double().numpy()
    exact = module.Reference(config, inputs, "cpu")
    assert gap(exact, q, port) <= limit()
    for precision in ("tf32", "bf16_weights"):
        control = judge.reference_llk(module.Reference(config, inputs, "cpu", precision), q,
                                      16)[0]
        assert gap(exact, q, control) > limit(), precision


def test_the_reference_library_is_its_cells_rounded_once():
    """Each cell of the reference's library is the bfloat16 nearest its
    float64 window (ties to even), and a float64 value one step of
    float32 above a tie rounds up, where rounding through float32 would
    round it to even."""
    from portbench.reference.laquila_ffi_bf16 import bf16_round

    module, config, inputs = setup(5)
    ref = module.Reference(config, inputs, "cpu")
    spec = ref.G[1][:, None, :] * (ref.stf[2] * ref.phasor)[None]
    cells = spec.real @ ref.basis_c[1] + spec.imag @ ref.basis_s[1]
    lib = ref.library[1, :, 2].double()
    step = torch.ldexp(torch.ones_like(cells), torch.frexp(cells)[1] - 9)   # half a bf16 ulp
    assert float(((lib - cells).abs() - step).max()) <= 1e-12 * float(cells.abs().max())
    assert lib.abs().max() > 0
    tie = torch.tensor([1.0 + 2**-8 + 2**-30], dtype=torch.float64)
    assert float(bf16_round(tie)) == 1.0 + 2**-7
    assert float(tie.float().to(torch.bfloat16)) == 1.0
