"""Twin harness of the ND4J tests (``test_torch_ndarray*.py``): one case
of the JAX package's ``tests/test_ndarray.py`` or
``tests/test_ndarray_surface.py`` runs AS WRITTEN twice, once over each
package, and the two runs are held to each other value for value.

The port's run sees the port's modules under the reference's names: the
test function's module globals (``nd``, ``NDArray``, ``Nd4j``, ``T``,
``Transforms``) are swapped for the port's counterparts, and the
reference's module names in ``sys.modules`` point at the port's modules
while it runs, so the tests' function-level imports
(``from deeplearning4j_tpu.ndarray import factory as nd``) load the port.

Each run records every value the test body receives from the ND4J
surface: each call of a public NDArray method (and operator and
property), of an ``nd``/``Nd4j``/``Transforms``/``BooleanIndexing``
function and of the executioner, that the body itself makes (calls made
inside another recorded call are not recorded again), with its result
snapshotted (arrays as numpy, values as values) or the type of what it
raised. The two records must have the same length and agree entry by
entry: shapes, dtypes, ints, bools and strings exactly, floats at
atol = rtol = 1e-6, or 1e-5 for reductions and products (``RED_NAMES``).
A case listed in ``RANDOM`` draws random numbers, which the two packages
draw from different generators (threefry against torch's Philox/MT): its
float values are compared in distribution by the test's own assertions
only, everything else as above.
"""
from __future__ import annotations

import contextlib
import inspect
import sys
import types

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.interop as R_interop
import deeplearning4j_tpu.ndarray as R_ndarray
import deeplearning4j_tpu.ndarray.dtypes as R_dtypes
import deeplearning4j_tpu.ndarray.executioner as R_exec
import deeplearning4j_tpu.ndarray.factory as R_factory
import deeplearning4j_tpu.ndarray.indexing as R_indexing
import deeplearning4j_tpu.ndarray.ndarray as R_nd
import deeplearning4j_tpu.ndarray.parity as R_parity
import deeplearning4j_tpu.ndarray.random as R_random
import deeplearning4j_tpu.ops.transforms as R_transforms
import deeplearning4j_tpu.profiler.op_profiler as R_prof
import deeplearning4j_tpu_torch.interop as P_interop
import deeplearning4j_tpu_torch.ndarray as P_ndarray
import deeplearning4j_tpu_torch.ndarray.dtypes as P_dtypes
import deeplearning4j_tpu_torch.ndarray.executioner as P_exec
import deeplearning4j_tpu_torch.ndarray.factory as P_factory
import deeplearning4j_tpu_torch.ndarray.indexing as P_indexing
import deeplearning4j_tpu_torch.ndarray.ndarray as P_nd
import deeplearning4j_tpu_torch.ndarray.parity as P_parity
import deeplearning4j_tpu_torch.ndarray.random as P_random
import deeplearning4j_tpu_torch.ops.transforms as P_transforms
import deeplearning4j_tpu_torch.profiler.op_profiler as P_prof

# reference module name -> the port's module
MODULES = {
    "deeplearning4j_tpu.ndarray": (R_ndarray, P_ndarray),
    "deeplearning4j_tpu.ndarray.ndarray": (R_nd, P_nd),
    "deeplearning4j_tpu.ndarray.factory": (R_factory, P_factory),
    "deeplearning4j_tpu.ndarray.indexing": (R_indexing, P_indexing),
    "deeplearning4j_tpu.ndarray.parity": (R_parity, P_parity),
    "deeplearning4j_tpu.ndarray.dtypes": (R_dtypes, P_dtypes),
    "deeplearning4j_tpu.ndarray.random": (R_random, P_random),
    "deeplearning4j_tpu.ndarray.executioner": (R_exec, P_exec),
    "deeplearning4j_tpu.ops.transforms": (R_transforms, P_transforms),
    "deeplearning4j_tpu.profiler.op_profiler": (R_prof, P_prof),
    "deeplearning4j_tpu.interop": (R_interop, P_interop),
}

# reductions and products: held at 1e-5 (summation order differs)
RED_NAMES = {
    "sum", "mean", "prod", "std", "var", "norm1", "norm2", "normmax",
    "cumsum", "cumprod", "sumNumber", "meanNumber", "stdNumber",
    "varNumber", "prodNumber", "norm1Number", "norm2Number", "asum",
    "amean", "ameanNumber", "asumNumber", "entropy", "shannonEntropy",
    "logEntropy", "entropyNumber", "shannonEntropyNumber",
    "logEntropyNumber", "mmul", "mmuli", "dot", "tensorMmul", "gemm",
    "matmul", "batchMmul", "distance1", "distance2", "squaredDistance",
    "stdAlongDimension", "varAlongDimension", "norm2AlongDimension",
    "norm2NumberAlong", "norm1AlongDimension", "prodAlongDimension",
    "cumsumAlongDimension", "average", "accumulate", "svd", "cholesky",
    "solve", "det", "nrm2", "axpy", "syev", "allEuclideanDistances",
    "unitVec", "cosineSim", "euclideanDistance", "softmax", "median",
    "medianNumber", "percentile", "percentileNumber", "kron",
    "exec", "__matmul__", "norm2Number"}
EW = 1e-6
RED = 1e-5

# decompositions whose vectors are defined up to sign: each column of u
# (and row of vt), eigenvector, or column of q (and row of r) is turned to
# make its largest-magnitude entry positive before the comparison
SIGNED = {"svd", "gesvd", "syev", "eig", "qr", "geqrf"}

# cases that read such vectors back (``u.toNumpy()``): their 2-D float
# entries agree up to the sign of each column or of each row
SIGNED_CASES = {"TestLinalgFacade::test_svd_reconstructs"}

# cases that draw random numbers (float values not compared)
RANDOM = {
    "TestCreation::test_rand_reproducible",
    "TestCreation::test_stateful_rng",
    "TestFactoryTranche2::test_npy_and_binary_io",
    "TestFactoryTranche2::test_random_statics_reproducible",
}


# ------------------------------------------------------------ snapshots
def _host(x):
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return np.array((t.float() if t.dtype == torch.bfloat16 else t)
                        .cpu().numpy())          # a copy: later writes
    a = np.array(x)
    if a.dtype.name == "bfloat16":       # numpy has no bfloat16: the port
        a = a.astype(np.float32)         # gives float32 (ROADMAP queue 3)
    return a


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor)) or type(x).__module__ \
        .startswith(("jax", "jaxlib"))


def snap(x):
    if isinstance(x, (R_nd.NDArray, P_nd.NDArray)):
        return ("nd", str(x.dtype), tuple(x.shape), _host(x.buf()))
    if isinstance(x, (bool, np.bool_)):
        return ("py", bool(x))
    if isinstance(x, (int, np.integer)):
        return ("py", int(x))
    if isinstance(x, (float, np.floating)):
        return ("py", float(x))
    if isinstance(x, (str, bytes, type(None))):
        return ("py", x)
    if isinstance(x, (np.dtype, P_dtypes._BFloat16)):
        return ("dtype", str(x))
    if _is_array(x):
        a = _host(x)
        return ("arr", str(a.dtype), a.shape, a)
    if isinstance(x, (list, tuple)):
        return ("seq", tuple(snap(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((str(k), snap(v))
                                     for k, v in x.items())))
    return ("obj",)


def same(a, b, tol, values=True):
    """Whether two snapshots agree; returns a reason string if not."""
    if a[0] != b[0]:
        return f"kinds {a[0]} != {b[0]}"
    kind = a[0]
    if kind in ("nd", "arr"):
        if a[1] != b[1] or a[2] != b[2]:
            return f"dtype/shape {a[1:3]} != {b[1:3]}"
        x, y = a[3], b[3]
        if x.dtype.kind in "biu" or not values:
            if x.dtype.kind in "biu" and not np.array_equal(x, y):
                return f"values {x} != {y}"
            return None
        if not np.allclose(x, y, atol=tol, rtol=tol, equal_nan=True):
            return f"values {x} != {y} (tol {tol})"
        return None
    if kind == "py":
        x, y = a[1], b[1]
        if isinstance(x, float) and isinstance(y, float):
            if values and not (abs(x - y) <= tol + tol * abs(y)
                               or (np.isnan(x) and np.isnan(y))):
                return f"{x} != {y} (tol {tol})"
            return None
        return None if (x == y or (not values and type(x) is type(y))) \
            else f"{x!r} != {y!r}"
    if kind == "seq":
        if len(a[1]) != len(b[1]):
            return f"lengths {len(a[1])} != {len(b[1])}"
        for u, v in zip(a[1], b[1]):
            why = same(u, v, tol, values)
            if why:
                return why
        return None
    if kind == "dict":
        if [k for k, _ in a[1]] != [k for k, _ in b[1]]:
            return "keys differ"
        for (_, u), (_, v) in zip(a[1], b[1]):
            why = same(u, v, tol, values)
            if why:
                return why
        return None
    return None if a == b else f"{a} != {b}"


def canon_signs(name, entry):
    """A decomposition's snapshot with each vector's sign fixed (see
    ``SIGNED``)."""
    if entry[0] != "seq":
        return entry
    parts = [list(p) for p in entry[1]]
    if name in ("svd", "gesvd"):
        cols, rows = parts[0], parts[2]
    elif name in ("qr", "geqrf"):
        cols, rows = parts[0], parts[1]
    else:
        cols, rows = parts[1], None
    m = cols[3]
    pick = np.argmax(np.abs(m), axis=0)
    sign = np.sign(m[pick, np.arange(m.shape[1])])
    sign[sign == 0] = 1
    cols[3] = m * sign[None, :]
    if rows is not None:
        k = len(sign)
        rows[3] = np.concatenate([rows[3][:k] * sign[:, None],
                                  rows[3][k:]])
    return ("seq", tuple(tuple(p) for p in parts))


def _signed(entry, axis):
    """An array snapshot with each column (axis 0) or row (axis 1) turned
    so that its largest-magnitude entry is positive."""
    m = entry[3] if axis == 0 else entry[3].T
    pick = np.argmax(np.abs(m), axis=0)
    sign = np.sign(m[pick, np.arange(m.shape[1])])
    sign[sign == 0] = 1
    m = m * sign[None, :]
    return entry[:3] + (m if axis == 0 else m.T,)


# ------------------------------------------------------------ recording
class Recorder:
    def __init__(self):
        self.depth = 0
        self.entries = []

    def wrap(self, name, fn):
        rec = self

        def recorded(*args, **kwargs):
            if rec.depth:
                return fn(*args, **kwargs)
            rec.depth += 1
            try:
                out = fn(*args, **kwargs)
                entry = snap(out)
            except Exception as e:
                rec.entries.append((name, ("raise", type(e).__name__)))
                raise
            finally:
                rec.depth -= 1
            rec.entries.append((name, entry))
            return out
        recorded.__name__ = getattr(fn, "__name__", name)
        return recorded


_DUNDERS = ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
            "__rmul__", "__truediv__", "__rtruediv__", "__neg__", "__pow__",
            "__matmul__", "__getitem__", "__gt__", "__ge__", "__lt__",
            "__le__", "__eq__", "__ne__", "__and__", "__or__", "__xor__",
            "__invert__", "__float__", "__int__", "__bool__", "__len__",
            "__setitem__", "__array__")
_PROPS = ("shape", "dtype", "T", "ndim")


def _statics(cls):
    return [n for n, v in vars(cls).items()
            if isinstance(v, staticmethod) and not n.startswith("_")]


@contextlib.contextmanager
def recording(side, rec):
    """Patch every surface callable of one package (``side`` 0: the
    reference, 1: the port) to record into ``rec``."""
    mods = {k: v[side] for k, v in MODULES.items()}
    N = mods["deeplearning4j_tpu.ndarray.ndarray"].NDArray
    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, owner.__dict__[name]
                      if isinstance(owner, type) else getattr(owner, name)))
        setattr(owner, name, new)

    for name, v in list(vars(N).items()):
        if name in _PROPS and isinstance(v, property):
            patch(N, name, property(rec.wrap(name, v.fget)))
        elif (callable(v) and not isinstance(v, type)
              and (not name.startswith("_") or name in _DUNDERS)):
            patch(N, name, rec.wrap(name, v))
    for key in ("deeplearning4j_tpu.ndarray.factory",
                "deeplearning4j_tpu.ops.transforms"):
        mod = mods[key]
        for name, v in list(vars(mod).items()):
            if (not name.startswith("_") and isinstance(v, types.FunctionType)
                    and v.__module__ == mod.__name__):
                patch(mod, name, rec.wrap(name, v))
    for cls in (mods["deeplearning4j_tpu.ndarray.factory"].Nd4j,
                mods["deeplearning4j_tpu.ops.transforms"].Transforms,
                mods["deeplearning4j_tpu.ndarray.indexing"].BooleanIndexing):
        for name in _statics(cls):
            patch(cls, name, staticmethod(rec.wrap(
                name, vars(cls)[name].__func__)))
    fac = mods["deeplearning4j_tpu.ndarray.factory"]
    for cls in (fac._BlasWrapper, fac._Lapack):
        for name, v in list(vars(cls).items()):
            if not name.startswith("_") and callable(v):
                patch(cls, name, rec.wrap(name, v))
    E = type(mods["deeplearning4j_tpu.ndarray.executioner"].get_executioner())
    for name in ("exec", "execAndReturn", "profilingConfig", "commit",
                 "setProfilingConfig"):
        patch(E, name, rec.wrap(name, vars(E)[name]))
    par = mods["deeplearning4j_tpu.ndarray.parity"]
    for name in ("coverage", "nd4j_coverage", "distinct_method_count"):
        patch(par, name, rec.wrap(name, getattr(par, name)))
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


@contextlib.contextmanager
def port_modules():
    """The reference's module names resolve to the port's modules."""
    old = {k: sys.modules.get(k) for k in MODULES}
    try:
        for k, (_ref, port) in MODULES.items():
            sys.modules[k] = port
        yield
    finally:
        for k, v in old.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _port_globals(g):
    """A test module's globals with every reference object the port has
    a counterpart of swapped for it."""
    swap = {}
    for ref, port in MODULES.values():
        swap[id(ref)] = port
        for name, obj in vars(ref).items():
            if not name.startswith("_") and hasattr(port, name):
                swap.setdefault(id(obj), getattr(port, name))
    out = dict(g)
    for k, v in g.items():
        if id(v) in swap and not isinstance(v, (int, float, str, bool)):
            out[k] = swap[id(v)]
    return out


def _rebind(fn, g):
    return types.FunctionType(fn.__code__, g, fn.__name__, fn.__defaults__,
                              fn.__closure__)


def _resolve(module, case):
    if "::" in case:
        cls_name, fn_name = case.split("::")
        cls = getattr(module, cls_name)
        return cls, vars(cls)[fn_name]
    return None, getattr(module, case)


def _call(module, case, g, tmp_path):
    cls, fn = _resolve(module, case)
    if cls is not None:
        body = {k: (_rebind(v, g) if isinstance(v, types.FunctionType)
                    else v) for k, v in vars(cls).items()
                if not k.startswith("__")}
        self = type(cls.__name__, (object,), body)()
        fn = body[fn.__name__]
        args = [self]
        params = list(inspect.signature(fn).parameters)[1:]
    else:
        fn = _rebind(fn, g)
        args = []
        params = list(inspect.signature(fn).parameters)
    for p in params:
        if p == "tmp_path":
            args.append(tmp_path)
        else:                    # a module fixture, made in this package
            fix = getattr(module, p)._get_wrapped_function()
            args.append(_rebind(fix, g)())
    fn(*args)


def cases(module):
    """Every test of a module as "Class::test" / "test" ids, in order."""
    out = []
    for name, obj in vars(module).items():
        if name.startswith("Test") and isinstance(obj, type):
            out += [f"{name}::{k}" for k in vars(obj)
                    if k.startswith("test_")]
        elif name.startswith("test_") and callable(obj):
            out.append(name)
    return out


def run_twin(module, case, tmp_path):
    """Run ``case`` of the reference test ``module`` over both packages
    and hold their records to each other."""
    R_random.set_seed(12345)
    P_random.set_seed(12345)
    records = []
    for side in (0, 1):
        rec = Recorder()
        g = vars(module) if side == 0 else _port_globals(vars(module))
        ctx = port_modules() if side == 1 else contextlib.nullcontext()
        path = tmp_path / ("ref" if side == 0 else "port")
        path.mkdir()
        with ctx, recording(side, rec):
            _call(module, case, g, path)
        records.append(rec.entries)
    ref, port = records
    names_r = [n for n, _ in ref]
    names_p = [n for n, _ in port]
    assert names_r == names_p, (
        f"the two runs called different surfaces:\n{names_r}\n{names_p}")
    values = case not in RANDOM
    for i, ((name, a), (_, b)) in enumerate(zip(ref, port)):
        tol = RED if name in RED_NAMES else EW
        if name in SIGNED:
            a, b = canon_signs(name, a), canon_signs(name, b)
        elif case in SIGNED_CASES and a[0] in ("nd", "arr") \
                and a[3].ndim == 2 and same(a, b, tol) is not None:
            a, b = (_signed(a, 0), _signed(b, 0)) if same(
                _signed(a, 0), _signed(b, 0), tol) is None else (
                _signed(a, 1), _signed(b, 1))
        why = same(a, b, tol, values)
        assert why is None, f"entry {i} ({name}): {why}"
    return len(ref)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    P_factory.setDefaultDevice("cpu")
    yield
