"""What the benchmark's modules import, compared by whole top-level
names: the JAX package's name is a prefix of the measured package's."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(harness.__file__).resolve().parent


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules(sub: str = ""):
    return sorted((BENCH / sub).rglob("*.py"))


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("sub", ["reference", "traffic"])
def test_reference_and_traffic_import_nothing_of_the_port(sub):
    for path in modules(sub):
        names = top_level_imports(path)
        assert "soccerplayershapepose_torch" not in names, path
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "numpy", "torch", "benchmark"}, (path, names)


def test_whole_names_are_compared(monkeypatch):
    assert "soccerplayershapepose_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "soccerplayershapepose_torch_x",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "require_cards", lambda chips: None)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    rc = harness.main(["--workload", "frame.f1", "--seed", "1",
                       "--seconds", "1"])
    assert rc == harness.EXIT_FORBIDDEN
    assert capsys.readouterr().out == ""
