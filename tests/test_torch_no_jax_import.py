"""Static scan: the PyTorch port and chip_smoke.py import neither JAX nor
the JAX package.

The port must run on a machine without JAX, and must not pull in
`deeplearning4j_tpu` (whose package import loads JAX), not even its
pure-Python modules: it keeps its own copies. Every import statement, and
every `importlib.import_module` / `__import__` call with a literal name, of
every file in deeplearning4j_tpu_torch/ and of chip_smoke.py is checked.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "deeplearning4j_tpu_torch")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names
                if n.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "deeplearning4j_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            yield node.lineno, ("." * node.level) + (node.module or "")
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.lineno, node.args[0].value


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = [(line, mod) for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom deeplearning4j_tpu.serving import "
           "engine\nimport importlib\nimportlib.import_module('jax')\n"
           "from deeplearning4j_tpu_torch import convert\n")
    found = [m for _, m in _imports(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax.numpy", "deeplearning4j_tpu.serving", "jax"]
    assert len(_files()) > 20
