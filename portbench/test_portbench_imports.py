"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
the reference imports nothing of the program, and a program module
imports the program only inside its functions."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    names = set(top_level_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "repro_torch" not in names, names
    assert names <= {"__future__", "contextlib", "dataclasses", "math",
                     "typing", "torch", "portbench"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "portbench"):
            assert node.module.startswith("portbench.reference"), node.module


@pytest.mark.parametrize("path", sorted((HERE / "programs").glob("*.py")),
                         ids=lambda p: p.name)
def test_program_modules_import_the_program_inside_functions(path):
    """A program module imports the program only when its mapping runs."""
    tree = ast.parse(path.read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            top.add(node.module.split(".", 1)[0])
    assert top <= {"__future__", "dataclasses", "math", "typing"}, top


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    """The run's check on ``sys.modules``: ``repro`` and JAX by their
    whole top-level name, never the port ``repro_torch``."""
    import sys
    import types

    from portbench import harness
    loaded = {m.split(".", 1)[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "reprox", types.ModuleType("reprox"))
    assert "reprox" not in harness.loaded_forbidden()
    assert "repro_torch" not in harness.loaded_forbidden()
    assert ("repro" in harness.loaded_forbidden()) == ("repro" in loaded)
    monkeypatch.setitem(sys.modules, "repro.comm",
                        types.ModuleType("repro.comm"))
    assert "repro" in harness.loaded_forbidden()
