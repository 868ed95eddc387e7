"""The import guard, and the benchmark's refusal to run off the card."""

import ast
import subprocess
import sys

import pytest

from portbench.harness import catalog
from portbench.harness.guard import FORBIDDEN, PROGRAM, forbidden_modules, top_level


def imports(path) -> set:
    """Top-level names a source file imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(top_level(node.module))
    return out


def test_names_are_compared_whole_by_their_top_level():
    mods = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "beat_tpu", "beat_tpu.models",
            "beat_tpu_torch", "beat_tpu_torch.models", "jaxtyping", "beat_tpu_extra", "numpy"]
    assert forbidden_modules(mods) == {"jax", "jax.numpy", "jaxlib.xla", "flax.linen",
                                       "beat_tpu", "beat_tpu.models"}


@pytest.mark.parametrize("path", sorted(p.relative_to(catalog.PORTBENCH).as_posix()
                                        for p in catalog.PORTBENCH.rglob("*.py")))
def test_no_file_imports_jax_and_the_references_import_no_program(path):
    names = imports(catalog.PORTBENCH / path)
    assert not names & FORBIDDEN
    if path.startswith("reference/"):
        assert PROGRAM not in names


def test_the_references_load_nothing_of_the_program():
    code = ("import sys; import portbench.reference.fullmt, portbench.reference.laquila_ffi; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'beat_tpu_torch', 'beat_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=catalog.ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "fullmt-smc",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=catalog.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr
