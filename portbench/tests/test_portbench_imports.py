"""The import rule, by whole top-level name: nothing under portbench/
imports jax, jaxlib, flax or the JAX package dmi_tpu (dmi_tpu_torch begins
with dmi_tpu and is not it), and portbench/reference/ imports nothing of
the system under test either."""

import ast
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    assert not top_names(path) & {"jax", "jaxlib", "flax", "dmi_tpu"}


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert not top_names(path) & {"dmi_tpu_torch", "dmi_tpu", "jax"}
    assert "dmi_tpu" not in path.read_text()


def test_whole_name_rule(monkeypatch):
    import types

    import dmi_tpu_torch  # noqa: F401  (begins with dmi_tpu, is not it)
    from portbench import harness as hx

    assert hx.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert hx.forbidden_modules() == ["jax"]
