"""The port stands alone: no module of ``deeplearning4j_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, its libraries, or the JAX package.

Checked on the source with ``ast`` rather than through ``sys.modules``:
a process may well have JAX imported already for other reasons.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "deeplearning4j_tpu"}
FILES = sorted((ROOT / "deeplearning4j_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _top_level_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_modules_to_check():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("chip_smoke.py",
                 "deeplearning4j_tpu_torch/kernels/flash_attention.py",
                 "deeplearning4j_tpu_torch/models/generation.py"):
        assert must in names and (ROOT / must).exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
