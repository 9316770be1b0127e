"""Nothing under gpubench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared whole:
fastsmc_tpu_torch begins with fastsmc_tpu)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fastsmc_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "contextlib",
                                       "dataclasses", "numpy", "torch"}
    # relative imports stay inside reference/
    tree = ast.parse(path.read_text())
    assert all(n.level == 1 for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level)


def test_guard_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import fastsmc_tpu_torch\nfrom jax import numpy\n")
    assert top_level_imports(f) & FORBIDDEN == {"jax"}
