"""The whole step's share of the card's float32 peak in the profiled
sub-window, per cent: the floating-point work of one chain's
log-likelihood (``counts/<config>.py``) times the evaluations in the
sub-window, over its seconds times 67 TFLOP/s."""

from portbench.counts.peaks import FP32_FLOPS_PER_S
from portbench.harness.catalog import load_module


def read(record):
    t = record.trace
    if t is None or t.busy_s is None or not record.trace_steps or t.window_s <= 0:
        return None
    flops = load_module("counts", record.cell["config"]).llk_flops(record.config)
    evals = record.trace_steps * record.traffic["n_chains"]
    return 100.0 * flops * evals / (t.window_s * FP32_FLOPS_PER_S)
