"""Nothing of the benchmark imports JAX, flax or the JAX package: each
import's top-level name is compared whole (``repro_torch`` is allowed,
``repro`` is not)."""
import ast

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted((REPO / "perfbench").rglob("*.py"))


def top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    from perfbench import harness
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def test_references_import_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").glob("*.py"):
        assert "repro_torch" not in set(top_names(path)), path
