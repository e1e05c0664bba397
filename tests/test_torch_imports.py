"""Import guard of the port: no module of ``src/repro_torch``, neither
``chip_smoke.py``, a reading script under ``tools/`` nor an
``examples/*_torch.py`` imports JAX or anything of the JAX package
``repro`` — only ``repro_torch`` is allowed. An AST scan, so lazy imports
inside functions count too."""

import ast
from pathlib import Path

import jax  # noqa: F401  (the scan below must not need it, but runs beside it)
import numpy as np  # noqa: F401
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py"))


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def _violations(path: Path) -> list:
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _banned(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and _banned(node.args[0].value)):
            bad.append(node.args[0].value)
    return bad


def test_port_files_exist():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert _violations(path) == []


def test_guard_catches_reference_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.models import decode\n"
                 "def g():\n    import repro.kernels.ref\n"
                 "from repro_torch import configs\n")
    assert _violations(f) == ["jax.numpy", "repro.models", "repro.kernels.ref"]
