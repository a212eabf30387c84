"""The direction of the port's imports: ``config`` reads flags and imports
nothing of the port, and ``arith`` reaches the kernels' wrappers only through
``gates`` and ``core.bootstrap``, never an ``ops`` module. The files are read
with ``ast``, as tests/test_torch_no_jax.py reads chip_smoke.py, so that an
import inside a function counts as one at the top."""
import ast
import os

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tfhe_tpu_torch")


def _imports(rel: str) -> set:
    """Every module the package's file `rel` imports anywhere, by absolute
    name; ``from a import b`` names both a and a.b (b may be a module)."""
    package = ["tfhe_tpu_torch"] + rel.split("/")[:-1]
    with open(os.path.join(PKG, rel)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names.add(mod)
            names.update(f"{mod}.{a.name}" for a in node.names)
    return names


# (file, a module it imports, the prefix of the modules it must not import)
@pytest.mark.parametrize("rel,imports,never", [
    ("config.py", "torch", "tfhe_tpu"),
    ("arith.py", "tfhe_tpu_torch.core.bootstrap", "tfhe_tpu_torch.ops"),
])
def test_imports_run_one_way(rel, imports, never):
    names = _imports(rel)
    assert imports in names                      # the reading sees the file's imports
    assert not [n for n in names if n.startswith(never)], names
