"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program: an AST walk over every module,
comparing whole top-level names (``cryovit_tpu_torch`` begins with
``cryovit_tpu``)."""

from __future__ import annotations

import ast

import pytest
from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "cryovit_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "cryovit_tpu_torch" not in set(_imports(path))


def test_the_walk_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom cryovit_tpu.ops import x\nimport cryovit_tpu_torch\n")
    assert set(_imports(bad)) == {"jax", "cryovit_tpu", "cryovit_tpu_torch"}
    assert set(_imports(bad)) & FORBIDDEN == {"jax", "cryovit_tpu"}
