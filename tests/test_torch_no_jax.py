"""The port never imports JAX: importing every module of e2e_asr_tpu_torch,
and chip_smoke.py, in a fresh interpreter leaves `jax` out of sys.modules
(the machine with the GPU has no JAX). Of the port, chip_smoke.py and
tools/prof_port.py, only `e2e_asr_tpu_torch/shared.py` names a module of
the JAX package, and only its JAX-free ones."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED_FROM = {"e2e_asr_tpu.config", "e2e_asr_tpu.data.text"}

PROBE = """
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import e2e_asr_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names + ["chip_smoke"]:
    importlib.import_module(name)
assert len(names) >= 15, names
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_only_shared_names_the_jax_package():
    root = pathlib.Path(ROOT)
    files = sorted((root / "e2e_asr_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "tools" / "prof_port.py"]
    assert len(files) >= 18
    for path in files:
        old = {m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "jaxlib", "e2e_asr_tpu")}
        want = SHARED_FROM if path.name == "shared.py" else set()
        assert old == want, (path.relative_to(root), old)
