"""What the harness may import and read: no JAX, no JAX package, no
program code in the reference, nothing of the JAX package's benchmarks."""
import ast

import pytest

from _tiny import BENCH

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "_out" not in p.parts)
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(imports(path)) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    assert set(imports(path)) <= {"torch", "math", "typing", "__future__"}


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_reads_the_jax_packages_benchmarks(path):
    strings = [n.value for n in ast.walk(ast.parse(path.read_text()))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [s for s in strings if "benchmarks" in s or "BENCH_" in s]


def test_the_sources_were_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "dense.py", "moe.py", "program.py"} <= names
