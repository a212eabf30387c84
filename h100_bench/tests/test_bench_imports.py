"""Nothing under h100_bench imports jax or the JAX package, by top-level
name compared whole (the port's name begins with the JAX package's), and the
plain reference and the benchmark's keys import nothing of the port."""
import ast
import os
import subprocess
import sys

from conftest import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tfhe_tpu"}
PLAIN = ("reference.py", "keys.py", "roofline.py")


def _tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: FORBIDDEN & set(_tops(p)) for p in _sources()}
    assert not {p: f for p, f in found.items() if f}
    for kind in ("gate_chain", "cipher_ops", "matmul"):
        assert "tfhe_tpu_torch" in set(_tops(os.path.join(HERE, "senders", f"{kind}.py")))


def test_the_reference_imports_nothing_of_the_program():
    for name in PLAIN:
        assert not {"tfhe_tpu_torch", "tfhe_tpu"} & set(_tops(os.path.join(HERE, name))), name


def test_the_harness_loads_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['tfhe_tpu'] = None\n"
            f"sys.path[:0] = [{HERE!r}, {ROOT!r}]\n"
            "import run, control, harness\n"
            "from tfhe_tpu_torch import gates, linalg, cipher\n"
            "from tfhe_tpu_torch.parallel import mesh\n"
            "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['jax', 'tfhe_tpu']"    # the two stubs above, no others
