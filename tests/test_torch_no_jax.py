"""The port never imports JAX nor any module of the JAX package: importing
every module of e2e_asr_tpu_torch (its command line `cli.main`,
`tools.beam_grid`, the GRU kernels' `kernels.gru_seq` and
`kernels.dec_train_gru`, and the transducer's `kernels.transducer`,
`core.transducer_loss`, `models.transducer` and `eval.transducer_beam`,
and the transformer encoder's `models.transformer_encoder` and
`kernels.mhsa` among them), chip_smoke.py and tools/prof_port.py in a
fresh interpreter leaves `jax` and every `e2e_asr_tpu` module out of
sys.modules (the machine with the GPU has no JAX), and no file of the
port, chip_smoke.py or tools/ names a module of either."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import e2e_asr_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
sys.path.insert(0, "tools")
for name in names + ["chip_smoke", "prof_port"]:
    importlib.import_module(name)
assert len(names) >= 20, names
assert {"e2e_asr_tpu_torch.cli.main",
        "e2e_asr_tpu_torch.tools.beam_grid",
        "e2e_asr_tpu_torch.kernels.gru_seq",
        "e2e_asr_tpu_torch.kernels.dec_train_gru",
        "e2e_asr_tpu_torch.kernels.transducer",
        "e2e_asr_tpu_torch.core.transducer_loss",
        "e2e_asr_tpu_torch.models.transducer",
        "e2e_asr_tpu_torch.eval.transducer_beam",
        "e2e_asr_tpu_torch.models.transformer_encoder",
        "e2e_asr_tpu_torch.kernels.mhsa"} <= set(names), names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "e2e_asr_tpu"))
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


def test_no_file_names_the_jax_package():
    root = pathlib.Path(ROOT)
    files = sorted((root / "e2e_asr_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", *sorted((root / "tools").glob("*.py"))]
    assert len(files) >= 25
    for path in files:
        old = {m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "jaxlib", "e2e_asr_tpu")}
        assert not old, (path.relative_to(root), old)
