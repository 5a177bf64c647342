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
                             "flight_recorder", "train_metrics")),
                 *(f"deeplearning4j_tpu_torch/{m}.py"
                   for m in ("ops/registry", "ops/dtypes",
                             "autodiff/__init__", "autodiff/samediff",
                             "autodiff/passes", "autodiff/validation",
                             "autodiff/flatgraph", "modelimport/tf_proto",
                             "modelimport/tf_skeleton", "modelimport/common",
                             "modelimport/tfimport",
                             "modelimport/tf_v1_control_flow",
                             "profiler/op_profiler",
                             "tools/bert_skeleton", "ops/extended",
                             "ops/longtail", "ops/tranche4", "ops/tranche5",
                             "ops/tranche6", "modelimport/onnx_proto",
                             "modelimport/onnximport",
                             "tools/onnx_resnet", "parallel/mesh",
                             "parallel/master", "parallel/sharding",
                             "parallel/compression", "parallel/trainer",
                             "parallel/__init__", "kernels/threshold",
                             "modelimport/hdf5", "modelimport/keras",
                             "modelimport/__init__", "tools/keras_h5",
                             "data/record_reader_iterator",
                             "utils/resources",
                             *(f"datavec/{m}" for m in (
                                 "__init__", "writable", "schema",
                                 "records", "transform", "local",
                                 "distributed", "image", "arrow")),
                             *(f"ndarray/{m}" for m in (
                                 "__init__", "dtypes", "random", "ndarray",
                                 "indexing", "surface", "surface4",
                                 "surface5", "factory", "executioner",
                                 "parity")),
                             "ops/transforms", "interop/__init__",
                             "interop/runners"))):
        assert must in names and (ROOT / must).exists()


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_imports(path):
    bad = sorted(set(_top_level_imports(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the skeleton tool freezes a TF BERT; nothing of the package imports it,
# and it imports TF and transformers inside its functions only
TF_TOOL = ROOT / "deeplearning4j_tpu_torch" / "tools" / "bert_skeleton.py"
# the interop runners gate on TF and onnxruntime as the reference's do:
# each imports its runtime inside its constructor only
INTEROP = ROOT / "deeplearning4j_tpu_torch" / "interop" / "runners.py"
TF_NAMES = {"tensorflow", "transformers", "keras", "tf_keras", "h5py",
            "onnx", "onnxruntime"}


def _module_level_imports(path: Path):
    """The top packages of the imports run when ``path`` is imported (its
    module body, not its functions)."""
    def walk(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                yield node.module.split(".")[0]
            for field in ("body", "orelse", "finalbody", "handlers"):
                yield from walk(getattr(node, field, []) or [])
    return set(walk(ast.parse(path.read_text(), filename=str(path)).body))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_tensorflow_in_the_package(path):
    """No module of the port imports TF, transformers, h5py or the onnx
    packages anywhere; the skeleton tool TF and transformers, and the
    interop runners TF and onnxruntime, only inside their functions."""
    names = (_module_level_imports(path) if path in (TF_TOOL, INTEROP)
             else set(_top_level_imports(path)))
    assert not names & TF_NAMES, f"{path.relative_to(ROOT)}: {names & TF_NAMES}"


def test_graph_engine_and_importer_import_no_jax_or_tf():
    """Importing the graph engine, the TF importer and the op profiler in
    a fresh interpreter pulls in neither JAX, nor TF, nor the JAX
    package; and the importer reads a GraphDef from bytes there."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import deeplearning4j_tpu_torch.autodiff\n"
        "import deeplearning4j_tpu_torch.modelimport.tfimport as t\n"
        "import deeplearning4j_tpu_torch.profiler.op_profiler\n"
        "import deeplearning4j_tpu_torch.modelimport.onnximport\n"
        "import deeplearning4j_tpu_torch.tools.onnx_resnet\n"
        "from deeplearning4j_tpu_torch.modelimport import tf_skeleton\n"
        "gd = tf_skeleton.fill_skeleton(tf_skeleton.load_skeleton("
        "'bert_mini_b2_t8'), 0)\n"
        "sd = t.TFGraphMapper.import_graph(gd.SerializeToString(), "
        "device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tensorflow', 'transformers', 'h5py', 'onnx', "
        "'ml_dtypes', 'deeplearning4j_tpu'))\n"
        "print(len(sd.ops()), bad)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n_ops, bad = out.stdout.strip().split(" ", 1)
    assert int(n_ops) > 100 and bad == "[]", out.stdout


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


# the imports a module of the port may make only inside the functions
# that need them, as the JAX package's DataVec does: where those
# functions live (the card's machine has none of these packages)
LAZY = {"PIL": {"deeplearning4j_tpu_torch/datavec/image.py",
                "deeplearning4j_tpu_torch/data/vision.py"},
        "pyarrow": {"deeplearning4j_tpu_torch/datavec/arrow.py"},
        "h5py": set()}


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_pil_pyarrow_and_h5py_only_lazily(path):
    """No module imports PIL, pyarrow or h5py when it is imported; PIL
    and pyarrow are imported inside functions of the modules the JAX
    package imports them in (DataVec's image and Arrow modules, the Tiny
    ImageNet reader), and h5py nowhere."""
    rel = path.relative_to(ROOT).as_posix()
    eager = _module_level_imports(path) & set(LAZY)
    assert not eager, f"{rel} imports {eager} at module level"
    for name in set(_top_level_imports(path)) & set(LAZY):
        assert rel in LAZY[name], f"{rel} imports {name}"


def test_keras_import_and_datavec_import_nothing_heavy():
    """Importing the Keras importer, the HDF5 reader, the Keras tool,
    DataVec and its iterators in a fresh interpreter pulls in none of
    JAX, the JAX package, TF, h5py, PIL or pyarrow; and the reader reads
    the tool's char-LSTM there."""
    import subprocess
    import sys
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        code = (
            "import sys; sys.path.insert(0, %r)\n"
            "from deeplearning4j_tpu_torch.modelimport import "
            "KerasModelImport\n"
            "from deeplearning4j_tpu_torch.modelimport import hdf5\n"
            "from deeplearning4j_tpu_torch.tools import keras_h5\n"
            "import deeplearning4j_tpu_torch.datavec\n"
            "import deeplearning4j_tpu_torch.datavec.image\n"
            "import deeplearning4j_tpu_torch.data.record_reader_iterator\n"
            "keras_h5.write_char_lstm(%r)\n"
            "net = KerasModelImport.import_keras_sequential_model_and_weights("
            "%r, device='cpu')\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tensorflow', 'keras', 'h5py', 'PIL', "
            "'pyarrow', 'deeplearning4j_tpu'))\n"
            "print(net.numParams(), bad)\n") % (
                str(ROOT), f"{d}/c.h5", f"{d}/c.h5")
        out = subprocess.run([sys.executable, "-I", "-c", code],
                             capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) == (4 * 256 * (47 + 256 + 1) + 4 * 256 * (256 + 256 + 1)
                      + 47 * (256 + 1))
    assert bad == "[]", out.stdout


def test_nd4j_imports_nothing_heavy():
    """Importing the port's ND4J (the ``nd`` factory, ``Transforms``, the
    executioner, the interop runners) in a fresh interpreter pulls in none
    of JAX, the JAX package, TF, onnxruntime or ml_dtypes; and an NDArray
    computes and writes npy bytes there."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from deeplearning4j_tpu_torch import nd\n"
        "from deeplearning4j_tpu_torch.ndarray import Nd4j, NDArrayIndex\n"
        "from deeplearning4j_tpu_torch.ops.transforms import Transforms\n"
        "import deeplearning4j_tpu_torch.interop\n"
        "nd.setDefaultDevice('cpu')\n"
        "a = nd.arange(6.0).reshape(2, 3)\n"
        "a.get(NDArrayIndex.point(1)).addi(1)\n"
        "out = Nd4j.getExecutioner().exec('relu', Transforms.tanh(a))\n"
        "b = Nd4j.fromByteArray(Nd4j.toByteArray(out))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tensorflow', 'onnxruntime', 'ml_dtypes', "
        "'deeplearning4j_tpu'))\n"
        "print(float(b.sumNumber()), bad)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    total, bad = out.stdout.strip().split(" ", 1)
    assert abs(float(total) - 4.7248480) < 1e-5 and bad == "[]", out.stdout
