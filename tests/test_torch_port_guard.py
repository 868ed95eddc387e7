"""
Guards of the port's boundaries: ``beat_tpu_torch`` imports neither JAX
nor anything of the JAX package ``beat_tpu``, its stage files and the
JAX package's read each other, and ``chip_smoke.py`` fails without a GPU
instead of running on the CPU.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite's JAX side; the guards run in subprocesses)
import numpy as np
import pytest
import torch  # noqa: F401

import beat_tpu.backend
import beat_tpu.utility
import beat_tpu_torch.backend
import beat_tpu_torch.utility
from test_torch_common import THREADS

REPO = Path(__file__).resolve().parent.parent

TINY_SLICE = """
import sys
from beat_tpu_torch.flagship import TEST_SIZE, build_flagship
from beat_tpu_torch.samplers import SMCParams
problem = build_flagship(**TEST_SIZE, seed=1, device="cpu", outfolder=sys.argv[1])
q_tr, llk_tr = problem.sample(SMCParams(n_chains=16, n_steps=2, seed=0))
assert q_tr.shape[1:] == (16, len(problem.ordering.names)), q_tr.shape
from beat_tpu_torch.flagship import FFI_TEST_SIZE, build_ffi_flagship
ffi = build_ffi_flagship(**FFI_TEST_SIZE, seed=1, device="cpu", outfolder=sys.argv[1] + "_ffi")
q_tr, llk_tr = ffi.sample(SMCParams(n_chains=16, n_steps=2, seed=0))
assert q_tr.shape[1:] == (16, ffi.ordering.size), q_tr.shape
from beat_tpu_torch.flagship import (GEO_TEST_SIZE, STATIC_FFI_TEST_SIZE,
                                     build_geodetic_flagship, build_static_ffi_flagship)
geo = build_geodetic_flagship(**GEO_TEST_SIZE, device="cpu", outfolder=sys.argv[1] + "_geo")
q_tr, llk_tr = geo.sample(SMCParams(n_chains=16, n_steps=2, seed=0))
static = build_static_ffi_flagship(**STATIC_FFI_TEST_SIZE, device="cpu",
                                   outfolder=sys.argv[1] + "_static")
q_tr, llk_tr = static.sample(SMCParams(n_chains=16, n_steps=2, seed=0))
assert q_tr.shape[1:] == (16, static.ordering.size), q_tr.shape
from beat_tpu_torch.flagship import (JOINT_TEST_SIZE, build_joint_flagship,
                                     build_transd_flagship)
from beat_tpu_torch.ffi.transd import TransDParams
from beat_tpu_torch.samplers import PTParams
joint = build_joint_flagship(**JOINT_TEST_SIZE, device="cpu", outfolder=sys.argv[1] + "_joint")
q_tr, llk_tr, history = joint.sample(PTParams(n_chains=4, n_chains_posterior=2, n_samples=20,
                                              swap_interval=(10, 10)))
assert q_tr.shape == (20, 2, joint.ordering.size), q_tr.shape
transd = build_transd_flagship(**STATIC_FFI_TEST_SIZE, device="cpu",
                               outfolder=sys.argv[1] + "_transd")
out = transd.sample(TransDParams(k_max=4, n_chains=8, n_steps=20, record_every=5))
assert out["slip_trace"].shape == (2, 8, 8), out["slip_trace"].shape
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
jax_package = sorted(m for m in sys.modules if m == "beat_tpu" or m.startswith("beat_tpu."))
assert not jax_package, jax_package
print("OK")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "BEAT_TPU_PLATFORM"}
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, even on a machine that has one
    env["OMP_NUM_THREADS"] = str(THREADS)  # the tests' thread policy
    env.update(extra)
    return env


def test_tiny_slice_runs_without_importing_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", TINY_SLICE, str(tmp_path / "smc")],
                          cwd=tmp_path, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


PORT_FILES = sorted((REPO / "beat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
#: the modules of the kinematic FFI slice, which the scan must reach
FFI_MODULES = ("ffi/fault.py", "ffi/gflibrary.py", "ffi/laplacian.py", "ops/eikonal.py",
               "ops/gfstack.py", "ops/rowgather.py", "models/distributer.py",
               "models/laplacian.py")
#: the modules of the geodetic slice, which the scan must reach too
GEO_MODULES = ("heart/geodesy.py", "heart/okada.py", "heart/corrections.py",
               "heart/statictable.py", "models/geodetic.py", "ffi/discretization.py")
#: the samplers of parallel tempering and of the trans-dimensional FFI
SAMPLER_MODULES = ("samplers/pt.py", "ops/voronoi.py", "ffi/transd.py")
#: the runtime: chains and targets sharded over ranks
RUNTIME_MODULES = ("parallel.py",)
#: the command line, the importers, the timers and the plots
CLI_MODULES = ("apps/cli.py", "apps/commands.py", "apps/completion.py", "apps/beatdown.py",
               "info.py", "profiling.py", "upgrade.py", "inputf.py", "interop.py",
               "plotting/__init__.py", "plotting/common.py", "plotting/colormap.py",
               "plotting/marginals.py", "plotting/seismic.py", "plotting/geodetic.py",
               "plotting/mt.py", "plotting/ffi.py", "plotting/bem.py")


def _importers(pattern: str) -> list:
    regex = re.compile(pattern, re.MULTILINE)
    scanned = {str(f.relative_to(REPO / "beat_tpu_torch")) for f in PORT_FILES[:-1]}
    assert len(PORT_FILES) > 10 and scanned.issuperset(FFI_MODULES + GEO_MODULES
                                                       + SAMPLER_MODULES + CLI_MODULES
                                                       + RUNTIME_MODULES)
    return [str(f.relative_to(REPO)) for f in PORT_FILES if regex.search(f.read_text())]


def test_no_port_file_imports_jax():
    assert _importers(r"^\s*(import jax|from jax)\b") == []


def test_no_port_file_imports_the_jax_package():
    # "beat_tpu" must end there: beat_tpu_torch itself is allowed
    pattern = r"^\s*(import beat_tpu|from beat_tpu)(\.|\s|,|$)"
    assert _importers(pattern) == []
    assert re.search(pattern, "from beat_tpu_torch.ops import x\nimport beat_tpu_torch",
                     re.MULTILINE) is None
    assert re.search(pattern, "x = 1\n    from beat_tpu.backend import SampleStage",
                     re.MULTILINE) is not None


def test_rank_program_imports_neither_jax_nor_the_jax_package():
    """The ranks of the multi-process tests run the port alone."""
    text = (REPO / "tests" / "torch_parallel_ranks.py").read_text()
    for pattern in (r"^\s*(import jax|from jax)\b",
                    r"^\s*(import beat_tpu|from beat_tpu)(\.|\s|,|$)"):
        assert re.search(pattern, text, re.MULTILINE) is None, pattern


_C_TYPES = {"int": "c_int", "int64_t": "c_int64", "float": "c_float", "void*": "c_void_p"}


@pytest.mark.parametrize("source", sorted(p.stem for p in (REPO / "beat_tpu_torch" / "csrc")
                                          .glob("*.cu")))
def test_kernel_signatures_match_the_sources(source):
    """Every ``extern "C"`` entry of a kernel source is declared in
    ``SIGNATURES`` with the same argument types, and nothing else is (a
    text check: nothing is compiled here)."""
    import ctypes

    from beat_tpu_torch.kernels.build import SIGNATURES

    text = (REPO / "beat_tpu_torch" / "csrc" / f"{source}.cu").read_text()
    entries = re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)', text)
    assert entries and {name for _, name, _ in entries} == set(SIGNATURES[source])
    for restype, name, args in entries:
        want = []
        for arg in args.split(","):
            ctype = arg.replace("const", "").split()[:-1]        # drop the name
            ctype = "void*" if "*" in "".join(ctype) else ctype[0]
            want.append(getattr(ctypes, _C_TYPES[ctype]))
        got_restype, got_args = SIGNATURES[source][name]
        assert got_restype is getattr(ctypes, _C_TYPES[restype])
        assert got_args == want, name


@pytest.mark.parametrize("writer,reader", [(beat_tpu_torch.backend, beat_tpu.backend),
                                           (beat_tpu.backend, beat_tpu_torch.backend)],
                         ids=["port_writes", "jax_writes"])
def test_stage_files_cross_read(tmp_path, writer, reader):
    rng = np.random.default_rng(0)
    names = [("x", (3,)), ("depth", ())]
    q = rng.normal(size=(5, 7, 4)).astype(np.float32)
    llk = rng.normal(size=(5, 7)).astype(np.float32)
    state = {"beta": 0.25, "stage": 3, "cov": rng.normal(size=(4, 4)),
             "population": rng.normal(size=(7, 4)), "log_evidence": np.float64(-12.5)}
    w_order = (beat_tpu_torch.utility if writer is beat_tpu_torch.backend
               else beat_tpu.utility).Ordering(names)
    r_order = (beat_tpu_torch.utility if reader is beat_tpu_torch.backend
               else beat_tpu.utility).Ordering(names)
    writer.SampleStage(str(tmp_path), ordering=w_order).save_stage(3, {"q": q, "llk": llk},
                                                                    state)
    handler = reader.SampleStage(str(tmp_path), ordering=r_order)
    assert handler.highest_sampled_stage() == 3
    trace = handler.load_trace(3)
    np.testing.assert_array_equal(trace.q_trace, q)
    np.testing.assert_array_equal(trace.llk_trace, llk)
    assert trace.varnames == ["x", "depth"]
    got = handler.load_state(3)
    assert got["beta"] == 0.25 and got["stage"] == 3 and got["log_evidence"] == -12.5
    np.testing.assert_array_equal(got["cov"], state["cov"])
    np.testing.assert_array_equal(got["population"], state["population"])


PROJECT_LIFECYCLE = """
import sys
from beat_tpu_torch.backend import SampleStage
from beat_tpu_torch.ffi.fault import FaultGeometry
from beat_tpu_torch.models.problem import load_model
from beat_tpu_torch.samplers import SMCParams
for pdir, mode, derived in ((sys.argv[1], "geometry", "strike1"), (sys.argv[2], "ffi",
                                                                   "magnitude")):
    problem = load_model(pdir, mode, device="cpu")
    try:
        problem.sample(SMCParams(n_chains=16, n_steps=2, max_stages=2, seed=0))
    except RuntimeError as e:              # the stage cap ends the run
        assert "did not reach beta=1" in str(e), e
    stage = SampleStage(problem.outfolder, ordering=problem.ordering).highest_sampled_stage()
    assert stage >= 0, stage
    summary = problem.summarize(stage)
    assert all(any(k.split("[")[0] == name for k in summary)
               for name in problem.ordering.names), sorted(summary)
    values = problem.derived_samples(stage, max_samples=8)[derived]
    assert values.shape == (8,), values.shape
    if mode == "ffi":
        assert isinstance(problem.composites["geodetic"].fault, FaultGeometry)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
jax_package = sorted(m for m in sys.modules if m == "beat_tpu" or m.startswith("beat_tpu."))
assert not jax_package, jax_package
print("OK")
"""


def test_project_lifecycle_runs_without_importing_jax(tmp_path):
    """Projects the JAX package wrote (a moment-tensor waveform project and
    a static FFI one with its pickled fault) loaded, sampled, summarized
    and their derived samples computed by the port, with neither ``jax``
    nor ``beat_tpu`` imported."""
    from test_torch_config import seismic_project, static_ffi_project

    seismic, ffi = str(tmp_path / "seismic"), str(tmp_path / "ffi")
    seismic_project(seismic, source="MTSource")
    static_ffi_project(ffi)
    proc = subprocess.run([sys.executable, "-c", PROJECT_LIFECYCLE, seismic, ffi],
                          cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


class _Reduces:
    """Pickles as a call of ``fn(*args)``."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("protocol", [2, 4, 5])
def test_fault_reader_refuses_classes_outside_its_allow_list(tmp_path, protocol):
    """``fault_geometry.pkl`` is read by an unpickler that maps the JAX
    package's fault classes to the port's, passes the names of numpy's
    array and scalar reconstruction and refuses any other name — numpy's
    own loaders and builtins callables too."""
    import builtins
    import pickle

    import beat_tpu.sources
    import beat_tpu_torch.config
    from beat_tpu.ffi import discretize_sources
    from beat_tpu_torch.ffi.fault import FaultGeometry, SubfaultGrid
    from beat_tpu_torch.sources import RectangularSource

    path = tmp_path / "fault_geometry.pkl"
    ref = beat_tpu.sources.RectangularSource(depth=2e3, strike=20.0, dip=70.0, length=4e3,
                                             width=2e3)
    with open(path, "wb") as f:
        pickle.dump(discretize_sources([ref], 2e3, 2e3), f, protocol=protocol)
    fault = beat_tpu_torch.config.load_fault_geometry(str(path))
    assert isinstance(fault, FaultGeometry) and isinstance(fault.subfaults[0], SubfaultGrid)
    assert isinstance(fault.subfaults[0].plane, RectangularSource) and fault.npatches == 2
    arrays = {"a": np.arange(6.0).reshape(2, 3), "s": np.float32(1.5)}
    with open(path, "wb") as f:
        pickle.dump(arrays, f, protocol=protocol)
    back = beat_tpu_torch.config.load_fault_geometry(str(path))
    np.testing.assert_array_equal(back["a"], arrays["a"])
    assert back["s"] == arrays["s"] and back["s"].dtype == np.float32
    np.save(tmp_path / "inner.npy", np.array([{"x": 1}], dtype=object))
    for obj in (beat_tpu.sources.DCSource(), {"fault": beat_tpu.sources.MTSource()},
                os.getcwd, _Reduces(np.load, str(tmp_path / "inner.npy"), None, True),
                _Reduces(builtins.eval, "1 + 1"), _Reduces(builtins.exec, "pass")):
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=protocol)
        with pytest.raises(pickle.UnpicklingError, match="not a fault class"):
            beat_tpu_torch.config.load_fault_geometry(str(path))


def test_chip_smoke_fails_without_cuda(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
                          env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("structure", ["variance", "exponential", "non-toeplitz", "import"])
def test_host_module_copies_compute_what_the_originals_do(structure):
    """The port's copies of the numpy host modules give the JAX package's
    numbers exactly: noise covariances, weights, log-determinants, the
    seed proposal covariance, PSD repair and the prior layout."""
    import beat_tpu.covariance as jcov
    import beat_tpu.parameter as jpar
    import beat_tpu_torch.covariance as pcov
    import beat_tpu_torch.parameter as ppar

    rng = np.random.default_rng(4)
    y, noise = rng.normal(size=40), rng.normal(size=12)
    want = jcov.SeismicNoiseAnalyser(structure).get_data_covariance(y, 0.5, noise=noise)
    got = pcov.SeismicNoiseAnalyser(structure).get_data_covariance(y, 0.5, noise=noise)
    np.testing.assert_array_equal(got, want)
    jc, pc = jcov.Covariance(data=want), pcov.Covariance(data=got)
    np.testing.assert_array_equal(pc.chol_inverse, jc.chol_inverse)
    assert pc.log_pdet == jc.log_pdet
    lo, hi = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.0])
    np.testing.assert_array_equal(pcov.init_proposal_covariance(lo, hi),
                                  jcov.init_proposal_covariance(lo, hi))
    bad = rng.normal(size=(5, 5))
    np.testing.assert_array_equal(beat_tpu_torch.utility.ensure_cov_psd(bad),
                                  beat_tpu.utility.ensure_cov_psd(bad))
    for name in ("mnn", "depth", "h_any_P_0"):
        p, j = ppar.Parameter.from_defaults(name, 2), jpar.Parameter.from_defaults(name, 2)
        np.testing.assert_array_equal(p.lower, j.lower)
        np.testing.assert_array_equal(p.upper, j.upper)
