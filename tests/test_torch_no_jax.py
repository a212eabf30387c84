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
print(" ".join(names))
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_with_jax_blocked():
    proc = _run([sys.executable, "-c", _IMPORT_ALL], ROOT)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 33
    assert {"tfhe_tpu_torch.arith", "tfhe_tpu_torch.cipher", "tfhe_tpu_torch.ops.cmux_packed",
            "tfhe_tpu_torch.utils.phasesim", "tfhe_tpu_torch.linalg", "tfhe_tpu_torch.io",
            "tfhe_tpu_torch.apps", "tfhe_tpu_torch.apps.linreg", "tfhe_tpu_torch.apps.alice",
            "tfhe_tpu_torch.apps.cloud", "tfhe_tpu_torch.apps.verify", "tfhe_tpu_torch.apps.cli",
            "tfhe_tpu_torch.utils.profiling", "tfhe_tpu_torch.parallel",
            "tfhe_tpu_torch.parallel.mesh", "tfhe_tpu_torch.parallel.cannon",
            "tfhe_tpu_torch.parallel.dryrun", "tfhe_tpu_torch.oracle",
            "tfhe_tpu_torch.native_ref", "tfhe_tpu_torch.ref_oracle"} <= names


def test_dryrun_ranks_import_no_jax(tmp_path):
    """A spawned rank of the dry run imports neither jax nor tfhe_tpu: run
    from a directory where both names resolve to modules that raise, the dry
    run's first shape must still pass on two ranks."""
    for name in ("jax", "jaxlib", "tfhe_tpu"):
        (tmp_path / f"{name}.py").write_text(f"raise ImportError('{name} was imported')\n")
    code = ("import sys; sys.modules['jax'] = None\n"
            "from tfhe_tpu_torch.parallel import dryrun\n"
            "lines = dryrun.run(2, dryrun.dryrun_multichip, (1,), device='cpu', threads=1)\n"
            "assert 'tfhe_tpu' not in sys.modules\n"
            "print(lines[0][0])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "dryrun[1/6]" in proc.stdout and "values OK" in proc.stdout


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
