"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (``stormx_torch`` is not ``stormx``)."""

import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "stormx"}


def modules():
    for d, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), PKG)


def imported(path):
    """Top-level names of every import in the file, at any depth."""
    with open(os.path.join(PKG, path)) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in modules() if p.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(path):
    assert "stormx_torch" not in imported(path)
    assert not imported(path) & FORBIDDEN


def test_the_check_sees_an_import():
    """The scan is not blind: it finds the program where it is imported."""
    assert "stormx_torch" in imported(os.path.join("systems", "common.py"))
