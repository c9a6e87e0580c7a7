"""The PyTorch port stands alone: importing it and every one of its
modules pulls in neither JAX nor the JAX package, and no source file of
the port (nor ``chip_smoke.py``) names them in an import.  Importing
compiles nothing."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dmlc_core_tpu_torch")

_PROBE = r"""
import importlib, pkgutil, sys
import dmlc_core_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "dmlc_core_tpu"))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15
    assert bad == "[]", f"port imported {bad}"
    assert "kernels: built" not in out.stderr       # nothing compiled


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, fs in os.walk(PKG):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "optax",
                                           "dmlc_core_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {m}"


def test_every_module_names_its_counterpart_or_role():
    """Each module's docstring says which JAX module it ports, or why it
    has none."""
    for path in _sources():
        if path.endswith("chip_smoke.py"):
            continue
        doc = ast.get_docstring(ast.parse(open(path).read())) or ""
        assert "dmlc_core_tpu/" in doc or "counterpart" in doc.lower(), \
            os.path.relpath(path, REPO)
