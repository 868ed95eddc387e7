"""
Guards of the port's boundaries: ``beat_tpu_torch`` never imports JAX,
and ``chip_smoke.py`` fails without a GPU instead of running on the CPU.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the suite's JAX side; the guards run in subprocesses)
import torch  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

TINY_SLICE = """
import sys
from beat_tpu_torch.flagship import TEST_SIZE, build_flagship
from beat_tpu_torch.samplers import SMCParams
problem = build_flagship(**TEST_SIZE, seed=1, device="cpu", outfolder=sys.argv[1])
q_tr, llk_tr = problem.sample(SMCParams(n_chains=16, n_steps=2, seed=0))
assert q_tr.shape[1:] == (16, len(problem.ordering.names)), q_tr.shape
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("OK")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "BEAT_TPU_PLATFORM"}
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""      # no card, even on a machine that has one
    env.update(extra)
    return env


def test_tiny_slice_runs_without_importing_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", TINY_SLICE, str(tmp_path / "smc")],
                          cwd=tmp_path, env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


def test_no_port_file_imports_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)\b", re.MULTILINE)
    files = sorted((REPO / "beat_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


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
