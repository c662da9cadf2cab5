"""The PyTorch/CUDA port imports nothing of JAX or of the JAX package.

Every module of ``yugabyte_db_tpu_torch`` and ``chip_smoke.py`` must import
in a fresh interpreter where ``jax`` and ``yugabyte_db_tpu`` are blocked on
``sys.meta_path``, and no source file of the port names either package in
an import statement.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "yugabyte_db_tpu_torch"
BLOCKED = ("jax", "jaxlib", "yugabyte_db_tpu")

_GUARDED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = {blocked!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import yugabyte_db_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = _GUARDED_IMPORT.format(blocked=BLOCKED,
                                  smoke=str(ROOT / "chip_smoke.py"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[-1])
    assert n_modules == len(list(PORT.rglob("*.py"))) - 1  # minus __init__


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (
                f"{path.name}:{node.lineno} imports {name}")
