"""The port stands alone: no module of soc_tpu_torch, and not chip_smoke.py,
imports soc_tpu, jax, jaxlib, flax or optax, at the top of a module or
lazily inside a function. Checked twice: statically, over the source of
every module, and by importing every module in a fresh interpreter and
reading sys.modules.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "soc_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PACKAGE):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _foreign(name):
    return any(name == m or name.startswith(m + ".")
               for m in ("soc_tpu", "jax", "jaxlib", "flax", "optax"))


def _imported_names(tree):
    """Absolute module names of every Import/ImportFrom in the tree,
    nested ones (lazy imports inside functions) included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_soc_tpu_or_jax_import_in_source(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    bad = [n for n in _imported_names(tree) if _foreign(n)]
    assert not bad, "%s imports %s" % (path, bad)


def test_no_soc_tpu_or_jax_module_loaded():
    """Importing every module of the package (and the modules chip_smoke.py
    imports) loads no soc_tpu, jax, jaxlib, flax or optax module."""
    code = """
import importlib, pkgutil, sys
sys.path.insert(0, %r)
import soc_tpu_torch
for m in pkgutil.walk_packages(soc_tpu_torch.__path__, "soc_tpu_torch."):
    if m.name != "soc_tpu_torch.__main__":
        importlib.import_module(m.name)
import chip_smoke
print("\\n".join(sorted(sys.modules)))
""" % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = out.stdout.split()
    assert "soc_tpu_torch.parallel.product" in loaded
    assert "soc_tpu_torch.bench" in loaded
    bad = [m for m in loaded if _foreign(m)]
    assert not bad, bad
