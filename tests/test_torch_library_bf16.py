"""
The kinematic library built straight into bfloat16, and what the
program's spans and the benchmark read of the stack on it (CPU, test
sizes, seeded).

* ``seis_construct_gf_linear(..., dtype=torch.bfloat16)`` equals the
  float32 build followed by ``to_dtype(torch.bfloat16)`` bit for bit,
  with no float32 library converted on the way; the float32 build is the
  default's, bit for bit.
* The program on the bfloat16 library of ``portbench``'s
  ``laquila_ffi_bf16`` configuration passes its cell's ``llk_gap`` limit
  against that configuration's plain reference, which stacks a library
  rounded to bfloat16, and fails it against ``laquila_ffi``'s, which
  stacks none.
* The spans and counters of the stack (``gfstack.stack``,
  ``gfstack.calls``, ``gfstack.mma_calls``) and of the build
  (``gflibrary.build``, ``gflibrary.bytes``); nothing while spans are off;
  the readings ``tools/bench_torch_spans.py`` makes of them, and the
  benchmark's ``k3_mma_roofline``, which reads bfloat16 libraries only.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from beat_tpu_torch import ffi, profiling
from beat_tpu_torch.ffi import gflibrary
from beat_tpu_torch.ops import gfstack
from test_torch_common import THREADS  # noqa: F401  (thread policy)


@pytest.fixture(scope="module")
def cell():
    """The ``ffi-smc-bf16`` cell's configurations at the benchmark tests'
    CPU size, inputs of one seed, and its ``llk_gap`` limit."""
    from portbench.harness import catalog
    from portbench.tests import sizes

    small = sizes.small_config("laquila_ffi_bf16")
    config = dict(sizes.config("laquila_ffi_bf16"), **small)
    bf16 = catalog.load_module("configs", "laquila_ffi_bf16")
    f32 = catalog.load_module("configs", "laquila_ffi")
    inputs = bf16.make_inputs(config, np.random.default_rng(3))
    limits = json.loads((catalog.PORTBENCH / "workloads" / "ffi-smc-bf16.json").read_text())
    return SimpleNamespace(config=config, inputs=inputs, bf16=bf16, f32=f32,
                           limit=limits["limits"]["llk_gap"])


@pytest.fixture(scope="module")
def build_args(cell, tmp_path_factory):
    """The arguments with which ``laquila_ffi``'s assembly calls the
    library build."""
    captured = {}
    build = ffi.seis_construct_gf_linear

    def capture(*args, **kwargs):
        captured.update(args=args, kwargs=kwargs)
        return build(*args, **kwargs)

    ffi.seis_construct_gf_linear = capture
    try:
        cell.f32.build_problem(cell.config, cell.inputs, device="cpu",
                               outfolder=str(tmp_path_factory.mktemp("setup")))
    finally:
        ffi.seis_construct_gf_linear = build
    return captured["args"], captured["kwargs"]


def _counting_conversions(monkeypatch) -> list:
    calls = []
    convert = gflibrary._converted

    def counted(data, dtype):
        calls.append(dtype)
        return convert(data, dtype)

    monkeypatch.setattr(gflibrary, "_converted", counted)
    return calls


@pytest.mark.parametrize("batch_patches", [8, 5])
def test_bf16_build_equals_the_float32_build_converted(build_args, monkeypatch,
                                                        batch_patches):
    args, kwargs = build_args
    kwargs = dict(kwargs, batch_patches=batch_patches)
    f32 = gflibrary.seis_construct_gf_linear(*args, **kwargs)
    conversions = _counting_conversions(monkeypatch)
    bf16 = gflibrary.seis_construct_gf_linear(*args, **kwargs, dtype=torch.bfloat16)
    assert conversions == [] and bf16.data.dtype == torch.bfloat16
    want = f32.to_dtype(torch.bfloat16)
    assert torch.equal(bf16.data.view(torch.int16), want.data.view(torch.int16))
    for key in ("duration_min", "duration_sampling", "starttime_min", "starttime_sampling",
                "component"):
        assert getattr(bf16, key) == getattr(f32, key)
    assert bf16.stack_fn is gfstack.stack_batched


def test_float32_build_is_the_default_build(build_args, monkeypatch):
    args, kwargs = build_args
    conversions = _counting_conversions(monkeypatch)
    default = gflibrary.seis_construct_gf_linear(*args, **kwargs)
    f32 = gflibrary.seis_construct_gf_linear(*args, **kwargs, dtype=torch.float32)
    assert conversions == []
    assert default.data.dtype == f32.data.dtype == torch.float32
    assert torch.equal(default.data.view(torch.int32), f32.data.view(torch.int32))
    with pytest.raises(ValueError, match="library dtype"):
        gflibrary.seis_construct_gf_linear(*args, **kwargs, dtype=torch.float16)


def _prior_rows(config, n, seed):
    lo = np.concatenate([[p[2]] * p[1] for p in config["priors"]])
    hi = np.concatenate([[p[3]] * p[1] for p in config["priors"]])
    return np.random.default_rng(seed).uniform(lo, hi, (n, lo.size)).astype(np.float32)


def test_program_on_the_bf16_library_passes_its_reference_only(cell, tmp_path):
    from portbench.harness import judge

    problem = cell.bf16.build_problem(cell.config, cell.inputs, device="cpu",
                                      outfolder=str(tmp_path))
    assert problem.composites["seismic"].libs[0]["uparr"].data.dtype == torch.bfloat16
    q = _prior_rows(cell.config, 48, 103)
    logp, data = problem.make_logp_fn()
    with torch.no_grad():
        port = logp(torch.as_tensor(q), data).double().numpy()

    def gap(reference):
        llk, scale, alt = judge.reference_llk(reference, q, 16)
        return float(judge.llk_gaps(port, llk, scale, alt).max())

    assert gap(cell.bf16.Reference(cell.config, cell.inputs, "cpu")) <= cell.limit
    assert gap(cell.f32.Reference(cell.config, cell.inputs, "cpu")) > cell.limit


@pytest.fixture
def spans_on():
    before = profiling.enable_spans(True)
    profiling.reset_spans()
    try:
        yield
    finally:
        profiling.enable_spans(before)
        profiling.reset_spans()


def _stack_operands(dtype, C=5, T=2, P=3, D=4, S=6, N=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    data = torch.randn((T, P, D, S, N), generator=g).to(dtype)
    didx = torch.randint(1, D, (C, P), generator=g, dtype=torch.int32)
    sidx = torch.randint(1, S, (C, T, P), generator=g, dtype=torch.int32)
    slips = torch.rand((C, P), generator=g)
    rtf, stf = torch.rand((C, P), generator=g), torch.rand((C, T, P), generator=g)
    return data, didx, sidx, slips, rtf, stf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_span_records_variant_and_dtype_and_counts_calls(spans_on, dtype):
    ops = _stack_operands(dtype)
    got = gfstack.stack_batched(*ops)
    gfstack.stack_batched(*ops[:4])                      # K4: counted as a call too
    snap = profiling.span_snapshot()
    stacks = [s for s in snap["spans"] if s["name"] == "gfstack.stack"]
    name = str(dtype).removeprefix("torch.")
    assert [s["attrs"] for s in stacks] == [{"variant": "plain", "dtype": name}] * 2
    assert snap["counters"] == {"gfstack.calls": 2}
    # a launch of the mma variant (the card's, planned for bfloat16) counts both
    with gfstack._span(ops[0], "mma"):
        pass
    assert profiling.span_snapshot()["counters"] == {"gfstack.calls": 3,
                                                     "gfstack.mma_calls": 1}
    profiling.enable_spans(False)
    profiling.reset_spans()
    assert torch.equal(gfstack.stack_batched(*ops), got)
    with gfstack._span(ops[0], "mma"):
        pass
    assert profiling.span_snapshot() == {"spans": [], "counters": {}, "by_name": {}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_span_records_dtype_and_the_stored_bytes(build_args, spans_on, dtype):
    args, kwargs = build_args
    lib = gflibrary.seis_construct_gf_linear(*args, **kwargs, dtype=dtype)
    snap = profiling.span_snapshot()
    builds = [s for s in snap["spans"] if s["name"] == "gflibrary.build"]
    assert [s["attrs"] for s in builds] == [{"dtype": str(dtype).removeprefix("torch.")}]
    assert snap["counters"]["gflibrary.bytes"] == lib.data.numel() * (
        2 if dtype == torch.bfloat16 else 4)
    profiling.enable_spans(False)
    profiling.reset_spans()
    gflibrary.seis_construct_gf_linear(*args, **kwargs, dtype=dtype)
    assert profiling.span_snapshot()["counters"] == {}


def test_bench_tool_reads_mma_share_and_library_size():
    from tools.bench_torch_spans import PROGRAM_SPANS, library_gb, span_readings

    def stack(variant):
        return {"name": "gfstack.stack", "id": 0, "parent": None, "thread": 1,
                "inversion": 1, "start_ns": 0, "end_ns": 10,
                "attrs": {"variant": variant, "dtype": "bfloat16"}}

    snap = {"spans": [stack("mma")] * 3 + [stack("tiled")],
            "counters": {"gfstack.calls": 4, "gfstack.mma_calls": 3,
                         "gflibrary.bytes": 1_966_080_000}}
    got = span_readings(snap, 0, 100, main_thread=1)
    assert got["mma_call_share"] == 0.75
    assert library_gb(snap) == pytest.approx(1.96608)
    none = span_readings({"spans": [], "counters": {}}, 0, 100, main_thread=1)
    assert none["mma_call_share"] is None and library_gb({"counters": {}}) is None
    assert PROGRAM_SPANS.index("gfstack.stack") < PROGRAM_SPANS.index("metropolis.step")
    assert "gflibrary.build" in PROGRAM_SPANS


def test_k3_mma_roofline_reads_bf16_libraries_only():
    from portbench.counts import k3
    from portbench.counts.peaks import least_seconds
    from portbench.harness import catalog

    metric = catalog.load_module("metrics", "k3_mma_roofline")
    f32_call = (_stack_operands(torch.float32), {})
    bf16_call = (_stack_operands(torch.bfloat16, seed=1), {})
    trace = SimpleNamespace(span_device_s={"k3": 2e-6})
    record = SimpleNamespace(trace=trace, k3_calls=[bf16_call, bf16_call])
    least = least_seconds(*k3.call_work(*bf16_call))
    assert metric.read(record) == pytest.approx(100.0 * 2 * least / 2e-6)
    _, _, peak = k3.call_work(*bf16_call)
    assert peak == 989e12
    assert metric.read(SimpleNamespace(trace=trace, k3_calls=[bf16_call, f32_call])) is None
    assert metric.read(SimpleNamespace(trace=trace, k3_calls=[])) is None
    assert metric.read(SimpleNamespace(trace=None, k3_calls=[bf16_call])) is None
