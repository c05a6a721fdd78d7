"""Nothing in portbench imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program); the
reference's files import nothing of the program; nothing reads the JAX
package's benchmark or its records."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the plain reference and what it reads: no part of the program
REFERENCE = ("reference.py", "queries.py", "graphs.py", "peaks.py",
             "traffic.py")


def top_imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_files_import_nothing_of_the_program(name):
    assert "repro_torch" not in top_imports(HERE / name)


def test_top_level_names_are_compared_whole():
    assert "repro_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_benchmark(path):
    if path.name == Path(__file__).name:
        return
    text = path.read_text()
    assert "benchmarks/" not in text and "BENCH_" not in text
