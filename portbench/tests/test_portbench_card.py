"""Card-only checks of the benchmark (``python -m pytest portbench/tests -m gpu``
on a machine with an NVIDIA GPU): a checkout that holds only
``BENCHMARK.json`` and the benchmark's folder has no program to run, and
the run says so and prints no result."""

import shutil
import subprocess
import sys

import pytest

from portbench.harness import catalog

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")


def test_no_result_without_the_program(cuda, tmp_path):
    shutil.copy(catalog.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(catalog.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fullmt-smc",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "program is not in this checkout" in out.stderr
