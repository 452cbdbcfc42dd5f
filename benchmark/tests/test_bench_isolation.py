"""Nothing under ``benchmark/`` imports JAX, its libraries or the JAX
package, and the reference imports nothing of the program; a run on a
machine without the card fails and prints no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "jointpose"}


def imported_tops(path: Path) -> set[str]:
    """Top-level names (before the first dot) of every import in a file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "jointpose_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "contextlib", "math", "torch", "benchmark"}


def test_the_comparison_is_of_whole_top_level_names():
    assert imported_tops(BENCH / "loops" / "closed_batch.py").isdisjoint(FORBIDDEN)
    assert "jointpose_torch".split(".")[0] not in FORBIDDEN


def test_a_run_without_the_card_fails_naming_it_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "flagship.offline_b128", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr
