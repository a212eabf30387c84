"""The port stands without jax: its package imports with jax blocked, and
chip_smoke.py imports neither jax nor tfhe_tpu and fails without a card."""
import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
import tfhe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tfhe_tpu_torch.__path__, "tfhe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "tfhe_tpu" not in sys.modules, "the JAX package was imported"
print(len(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    proc = _run([sys.executable, "-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 12


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "tfhe_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "tfhe_tpu"}, roots


def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path):
    """Alone in an empty directory the script must exit nonzero and print no
    result; so must it in the repository on a machine without a CUDA card."""
    import torch
    cases = [(str(tmp_path), shutil.copy(os.path.join(ROOT, "chip_smoke.py"), str(tmp_path)))]
    if not torch.cuda.is_available():
        cases.append((ROOT, "chip_smoke.py"))
    for cwd, script in cases:
        proc = _run([sys.executable, script], cwd)
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok"' not in proc.stdout
