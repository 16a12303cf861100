"""The import check compares whole top-level names, and the reference
imports nothing of the program."""

import ast
import sys
import types

from portbench import harness


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudtik_tpu_torch_fake",
                        types.ModuleType("cloudtik_tpu_torch_fake"))
    monkeypatch.setitem(sys.modules, "jaxfoo", types.ModuleType("jaxfoo"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cloudtik_tpu.ops",
                        types.ModuleType("cloudtik_tpu.ops"))
    assert harness.forbidden_modules() == ["cloudtik_tpu"]
    monkeypatch.setitem(sys.modules, "optax", types.ModuleType("optax"))
    assert harness.forbidden_modules() == ["cloudtik_tpu", "optax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_no_program():
    for path in (harness.PB / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "typing", "math", "portbench"), \
                (path.name, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), name


def test_nothing_of_the_benchmark_imports_jax():
    for path in harness.PB.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, \
                (path, name)
