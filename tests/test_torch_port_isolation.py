"""The port stands alone: no module of ``deeplearning4j_tpu_torch`` and
not ``chip_smoke.py`` imports JAX, its libraries, or the JAX package; and
every import in the port that names ``deeplearning4j_tpu_torch.…`` —
function-level and inside ``try`` blocks too, and the module paths the
flight recorder looks up in ``sys.modules`` — names a module (or a name
in a module) that exists in the port, so a lazy import cannot fail
silently into an ``except`` at run time.

Checked on the source with ``ast`` rather than through ``sys.modules``:
a process may well have JAX imported already for other reasons.
"""
import ast
import importlib
import importlib.util
import re
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
                 "deeplearning4j_tpu_torch/kernels/rnn_cell.py",
                 "deeplearning4j_tpu_torch/models/generation.py",
                 "deeplearning4j_tpu_torch/optim/adamw.py",
                 "deeplearning4j_tpu_torch/parallel/generation.py",
                 "deeplearning4j_tpu_torch/parallel/inference.py",
                 "deeplearning4j_tpu_torch/serving/__init__.py",
                 "deeplearning4j_tpu_torch/serving/session.py",
                 "deeplearning4j_tpu_torch/resilience/__init__.py",
                 "deeplearning4j_tpu_torch/resilience/faults.py",
                 "deeplearning4j_tpu_torch/resilience/policy.py",
                 "deeplearning4j_tpu_torch/resilience/qos.py",
                 "deeplearning4j_tpu_torch/async_runtime.py",
                 *(f"deeplearning4j_tpu_torch/nn/{m}.py"
                   for m in ("activations", "weights", "losses", "params",
                             "_precision", "_step_tail", "_network",
                             "weightnoise", "multilayer", "graph",
                             "graph_conf", "transferlearning",
                             "conf/configuration",
                             "conf/layers", "conf/inputs",
                             "conf/preprocessors", "conf/dropout")),
                 *(f"deeplearning4j_tpu_torch/{m}.py"
                   for m in ("optim/updaters", "optim/schedules",
                             "optim/transforms", "optim/listeners",
                             "optim/earlystopping", "optim/solvers",
                             "ops/standard", "data/dataset",
                             "data/iterators", "data/normalizers",
                             "data/mnist", "data/vision",
                             "eval/classification", "eval/regression",
                             "utils/serialization",
                             "modelimport/dl4j_zip",
                             "models/zoo/base", "models/zoo/resnet",
                             "models/zoo/cnn_small")),
                 *(f"deeplearning4j_tpu_torch/observability/{m}.py"
                   for m in ("__init__", "registry", "trace_store",
                             "tracing", "slo", "numerics", "compile_watch",
                             "cost_model", "straggler", "device_memory",
                             "flight_recorder", "train_metrics"))):
        assert must in names and (ROOT / must).exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


PORT = "deeplearning4j_tpu_torch"
_MODULE_PATH = re.compile(rf"^{PORT}(\.\w+)+$")


def _port_references(path: Path):
    """(module, name or None, line) for every import of a port module
    anywhere in ``path`` (``from M import name`` gives each name) and for
    every string constant that is a dotted port module path."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] == PORT:
                    yield alias.name, None, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.split(".")[0] == PORT:
            for alias in node.names:
                yield node.module, alias.name, node.lineno
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _MODULE_PATH.match(node.value):
            yield node.value, None, node.lineno


def _resolves(module: str, name) -> bool:
    if importlib.util.find_spec(module) is None:
        return False
    if name is None:
        return True
    return (hasattr(importlib.import_module(module), name)
            or importlib.util.find_spec(f"{module}.{name}") is not None)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_name_modules_that_exist(path):
    missing = [f"{path.relative_to(ROOT)}:{line}: {module}"
               + (f" import {name}" if name else "")
               for module, name, line in _port_references(path)
               if not _resolves(module, name)]
    assert not missing, missing


def test_unresolved_lazy_import_is_caught(tmp_path):
    """The check sees an import inside a function's ``try`` block."""
    src = tmp_path / "lazy.py"
    src.write_text("def f():\n    try:\n        from "
                   f"{PORT}.resilience import elastic\n"
                   "    except Exception:\n        pass\n")
    refs = list(_port_references(src))
    assert refs == [(f"{PORT}.resilience", "elastic", 3)]
    assert not _resolves(*refs[0][:2])
