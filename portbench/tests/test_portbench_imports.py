"""No module of the benchmark imports JAX, the JAX package, or the JAX
package's benchmark; the references import nothing of the program.  Names
compare by their top-level part, whole, so ``ae_waveforms_tpu_torch`` is
not taken for ``ae_waveforms_tpu``."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ae_waveforms_tpu", "benchmarks", "bench"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "ae_waveforms_tpu_torch" not in top_level_imports(path)


def test_the_whole_name_is_compared():
    assert "ae_waveforms_tpu_torch".split(".")[0] not in FORBIDDEN
