"""The benchmark imports neither JAX nor the JAX package, and the
reference imports nothing of the program; the command refuses to run
without a card."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        tops = _imports(path)
        assert not tops & {"repro_torch", "bench"}, path
        assert tops <= {"__future__", "dataclasses", "fractions", "numpy",
                        "torch"}, (path, tops)


def test_top_level_names_are_compared_whole():
    assert "repro_torch" not in harness.FORBIDDEN
    before = set(sys.modules)
    sys.modules["repro_fake_mod"] = sys.modules["json"]
    try:
        assert harness.loaded_forbidden() == []
        sys.modules["jaxlib.fake"] = sys.modules["json"]
        assert harness.loaded_forbidden() == ["jaxlib"]
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]


def test_the_command_needs_a_card():
    """Here, with no CUDA card, the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "beir-nq-b256-k10", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 2, out.stderr
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
