"""Nothing the benchmark runs loads the JAX stack or the JAX package,
and the plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys

from conftest import REPO
from gdrbench import harness

BENCH = REPO / "gdrbench"


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"gdr_tpu_torch", "gdr_tpu", "jax",
                                     "flax"}, path


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & harness.FORBIDDEN, path


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("gdr_tpu_torch", "gdr_tpu_torch.models", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gdr_tpu.models.gdr", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert harness.forbidden_modules() == ["gdr_tpu.models.gdr", "jax"]


def test_run_without_a_card_or_the_program_prints_no_result(tmp_path):
    """Here there is no card; in a directory that holds only the
    benchmark's files there is no program either.  Both exit non-zero
    and print nothing on standard output."""
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "gdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", bare / "BENCHMARK.json")
    for cwd in (REPO, bare):
        out = subprocess.run(
            [sys.executable, "gdrbench/run.py", "--workload", "serve-b32",
             "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and not out.stdout.strip(), out
