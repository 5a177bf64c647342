"""The port's ``Transforms``, interop runners, ``net.params()`` view and
``DataSet`` getters against the JAX package's, and one named test for each
trap of the ND4J port (PERF.md's tolerance table: f32 elementwise
atol = rtol = 1e-6, reductions and products 1e-5, ints, bools, dtypes,
shapes and bytes exactly).

- ``Transforms``: every function of the reference's ``ops/transforms.py``
  on the same seeded numpy inputs in both packages.
- Traps: 64-bit narrowing, draws by distribution and seed
  reproducibility, logical views, reshape copies, in-place ops keeping
  the dtype, bias-corrected variance, stable sorts, synthesized strides,
  npy bytes (bf16 included), GELU's tanh form, copy-on-write wrapping.
- ``GraphRunner``/``OnnxRuntimeRunner`` gates: the same type and message.
- ``net.params()``: a narrow LeNet carrying the reference's weights;
  writes through the view change both nets alike.
"""
import io
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeplearning4j_tpu.interop as R_interop
import deeplearning4j_tpu.ndarray.factory as RN
import deeplearning4j_tpu.ops.transforms as RT
from deeplearning4j_tpu.data import dataset as R_ds
from deeplearning4j_tpu.ndarray import NDArrayIndex as RI
from deeplearning4j_tpu.ndarray import parity as R_parity
from deeplearning4j_tpu.ndarray.ndarray import NDArray as RNDArray
from deeplearning4j_tpu.ops import registry as R_reg

import deeplearning4j_tpu_torch.interop as P_interop
import deeplearning4j_tpu_torch.ndarray.factory as PN
import deeplearning4j_tpu_torch.ops.transforms as PT
from deeplearning4j_tpu_torch.data import dataset as P_ds
from deeplearning4j_tpu_torch.eval.classification import Evaluation
from deeplearning4j_tpu_torch.ndarray import NDArrayIndex as PI
from deeplearning4j_tpu_torch.ndarray import parity as P_parity
from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray as PNDArray
from deeplearning4j_tpu_torch.ops import registry as P_reg

from _torch_nd_twin import _port_on_cpu  # noqa: F401
from test_torch_networks import (J, P, _data, _np_tree, lenet_conf,
                                 residual_conf)

EW = dict(atol=1e-6, rtol=1e-6)
RED = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    if isinstance(x, (RNDArray, PNDArray)):
        x = x.toNumpy()
    return np.asarray(x, dtype=np.float64) if isinstance(x, float) \
        else np.asarray(x)


def _u(rng, lo, hi, shape=(3, 5)):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# (name, inputs from a seeded rng, kwargs, tolerance)
_ANY = (-2.0, 2.0)
TRANSFORMS = [
    *[(n, lambda r: [_u(r, *_ANY)], {}, EW) for n in (
        "exp", "expm1", "cbrt", "abs", "sign", "floor", "ceil", "round",
        "sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "asinh",
        "square", "erf", "erfc", "isNaN", "isInf", "sigmoid", "relu",
        "relu6", "elu", "selu", "gelu", "softplus", "softsign",
        "hardSigmoid", "hardTanh", "swish", "mish", "step", "notOp",
        "stabilize", "reverse")],
    *[(n, lambda r: [_u(r, 0.1, 3.0)], {}, EW) for n in (
        "log", "log1p", "sqrt", "reciprocal")],
    *[(n, lambda r: [_u(r, -0.9, 0.9)], {}, EW) for n in (
        "asin", "acos", "atanh")],
    ("acosh", lambda r: [_u(r, 1.1, 3.0)], {}, EW),
    ("leakyRelu", lambda r: [_u(r, *_ANY)], {"alpha": 0.2}, EW),
    ("pow", lambda r: [_u(r, 0.1, 3.0), 1.7], {}, EW),
    ("max", lambda r: [_u(r, *_ANY), _u(r, *_ANY)], {}, EW),
    ("min", lambda r: [_u(r, *_ANY), _u(r, *_ANY)], {}, EW),
    ("clip", lambda r: [_u(r, *_ANY), -0.5, 0.7], {}, EW),
    ("atan2", lambda r: [_u(r, *_ANY), _u(r, *_ANY)], {}, EW),
    ("andOp", lambda r: [_u(r, -1, 1) > 0, _u(r, -1, 1) > 0], {}, EW),
    ("orOp", lambda r: [_u(r, -1, 1) > 0, _u(r, -1, 1) > 0], {}, EW),
    ("xorOp", lambda r: [_u(r, -1, 1) > 0, _u(r, -1, 1) > 0], {}, EW),
    ("greaterThanOrEqual", lambda r: [_u(r, *_ANY), 0.3], {}, EW),
    ("lessThanOrEqual", lambda r: [_u(r, *_ANY), _u(r, *_ANY)], {}, EW),
    ("softmax", lambda r: [_u(r, *_ANY)], {}, RED),
    ("logSoftmax", lambda r: [_u(r, *_ANY)], {"axis": 0}, RED),
    ("logSumExp", lambda r: [_u(r, *_ANY)], {}, RED),
    ("logSumExp", lambda r: [_u(r, *_ANY)], {"axis": 1}, RED),
    *[(n, lambda r: [_u(r, *_ANY), _u(r, *_ANY)], {}, RED) for n in (
        "cosineSim", "cosineDistance", "euclideanDistance",
        "manhattanDistance", "allEuclideanDistances",
        "allManhattanDistances", "allCosineSimilarities")],
    ("dot", lambda r: [_u(r, *_ANY), _u(r, *_ANY, (5, 4))], {}, RED),
    ("hammingDistance", lambda r: [np.round(_u(r, 0, 2)),
                                   np.round(_u(r, 0, 2))], {}, EW),
    ("jaccardDistance", lambda r: [_u(r, 0.1, 2), _u(r, 0.1, 2)], {}, RED),
    ("unitVec", lambda r: [_u(r, *_ANY)], {}, RED),
    ("normalizeZeroMeanAndUnitVariance", lambda r: [_u(r, *_ANY)], {}, RED),
    ("cross", lambda r: [_u(r, *_ANY, (4, 3)), _u(r, *_ANY, (4, 3))], {},
     RED),
]


@pytest.mark.parametrize("case", range(len(TRANSFORMS)),
                         ids=[f"{c[0]}{'-' + str(c[2]) if c[2] else ''}"
                              for c in TRANSFORMS])
def test_transform_twin(case):
    name, inputs, kw, tol = TRANSFORMS[case]
    args = inputs(np.random.default_rng(case))
    want = getattr(RT.Transforms, name)(
        *[RN.create(a) if isinstance(a, np.ndarray) else a for a in args],
        **kw)
    got = getattr(PT.Transforms, name)(
        *[PN.create(a) if isinstance(a, np.ndarray) else a for a in args],
        **kw)
    assert type(got).__name__ == type(want).__name__
    w, g = _np(want), _np(got)
    assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_allclose(g, w, **tol)


def test_every_transform_is_twinned():
    names = {c[0] for c in TRANSFORMS}
    public = {n for n in vars(RT.Transforms) if not n.startswith("_")
              and n not in ("and_", "or_", "xor_", "not_")}
    assert public == names, sorted(public ^ names)
    assert set(vars(PT.Transforms)) >= set(vars(RT.Transforms)) - {
        "__module__", "__doc__", "__dict__", "__weakref__", "__qualname__",
        "__firstlineno__", "__static_attributes__"}


# ----------------------------------------------------------------- traps
def test_trap_x64_narrowing():
    """Module 1: the reference runs with 64-bit types off — an array
    asked for as "double" is float32, with a UserWarning; default ints
    are int32. The port gives the same types."""
    for nd in (RN, PN):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            a = nd.create([1.0, 2.0], dtype="double")
        assert str(a.dtype) == "float32"
        assert any(issubclass(x.category, UserWarning) for x in w)
        assert str(nd.create([1, 2]).dtype) == "int32"
        assert str(nd.arange(5).dtype) == "int32"
        assert str(nd.create(np.arange(3, dtype=np.int64)).dtype) == "int32"
        assert str(nd.zeros(2, dtype="long").dtype) == "int32"


def test_trap_draws_by_distribution_and_seed():
    """Module 2: threefry bits cannot be reproduced in torch, so draws
    are held in distribution (means and variances within 5 standard
    errors of the reference's over 20000 draws) and the port's seed
    reproduces its own draws; the state advances on every draw."""
    n = 20000
    for kind, mean, var in (("rand", 0.5, 1 / 12), ("randn", 0.0, 1.0)):
        for nd in (RN, PN):
            nd.setSeed(3)
            x = getattr(nd, kind)(n).toNumpy().astype(np.float64)
            assert abs(x.mean() - mean) < 5 * np.sqrt(var / n)
            assert abs(x.var() - var) < 5 * var * np.sqrt(2.0 / n)
    PN.setSeed(7)
    a, b = PN.randn(8), PN.randn(8)
    assert not a.equals(b)
    PN.setSeed(7)
    assert PN.randn(8).equals(a) and PN.randn(8).equals(b)
    assert PN.rand(4, seed=11).equals(PN.rand(4, seed=11))
    for name, args, mean in (("randomExponential", (2.0, n), 0.5),
                             ("randomGamma", (3.0, n), 3.0),
                             ("randomGamma", (0.5, n), 0.5),
                             ("randomPoisson", (4.0, n), 4.0),
                             ("randomBinomial", (10, 0.3, n), 3.0),
                             ("randomBernoulli", (0.3, n), 0.3)):
        got = getattr(PN, name)(*args).toNumpy()
        assert abs(got.mean() - mean) < 0.05 * max(mean, 1.0), (name, args)


def test_trap_views_are_logical():
    """Module 3: a view taken before an in-place op reads the new values,
    and writes through views of views land in the base — in both."""
    outs = []
    for nd, I in ((RN, RI), (PN, PI)):
        x = nd.create(np.arange(12.0).reshape(3, 4))
        row = x.get(I.point(1))
        block = x.get(I.interval(0, 2), I.all())
        x.addi(1.0)
        cell = block.get(I.point(0))
        cell.assign(-1.0)
        row.muli(2.0)
        outs.append((row.toNumpy(), block.toNumpy(), x.toNumpy()))
    for w, g in zip(*outs):
        np.testing.assert_array_equal(g, w)


def test_trap_reshape_transpose_permute_copy():
    """Module 3: reshape, ravel, transpose and permute return new arrays
    (torch would return views): writing into them leaves the source."""
    for nd in (RN, PN):
        x = nd.create(np.arange(4.0).reshape(2, 2))
        for out in (x.reshape(4), x.ravel(), x.transpose(), x.permute(1, 0),
                    x.swapAxes(0, 1), x.broadcast(2, 2), x.dup()):
            out.assign(9.0)
        np.testing.assert_array_equal(x.toNumpy(),
                                      np.arange(4.0).reshape(2, 2))


def test_trap_inplace_keeps_dtype():
    """Module 3: the reference casts an i-op's result back to the array's
    dtype (truncating): int32 [1 2 3] addi 0.5 reads [1 2 3] (torch's
    add_ raises here); a float out of an int type's range saturates and
    NaN gives 0, as XLA converts."""
    for nd in (RN, PN):
        a = nd.create([1, 2, 3], dtype="int32")
        a.addi(0.5)
        assert str(a.dtype) == "int32"
        np.testing.assert_array_equal(a.toNumpy(), [1, 2, 3])
        b = nd.create([1, 2, 3], dtype="int32")
        b.muli(1.9)
        np.testing.assert_array_equal(b.toNumpy(), [1, 3, 5])
    # float into int saturates as XLA converts (torch leaves it undefined)
    got = []
    for nd in (RN, PN):
        c = nd.create([0, 1, -1], dtype="int32")
        c.rdivi(100)
        f = nd.create([np.nan, np.inf, -np.inf, 3e10, -2.7])
        got.append((c.toNumpy(), f.castTo("int8").toNumpy(),
                    f.castTo("uint8").toNumpy(), f.castTo("int32").toNumpy()))
    for w, g in zip(*got):
        np.testing.assert_array_equal(g, w)


def test_trap_variance_bias_corrected_and_stable_sort():
    """Module 3: std/var divide by n - 1 by default; sorts are stable."""
    x = np.array([[3.0, 1.0, 3.0, 1.0, 2.0]], np.float32)
    for nd in (RN, PN):
        a = nd.create(x)
        np.testing.assert_allclose(a.std().item(), np.std(x, ddof=1),
                                   rtol=1e-6)
        np.testing.assert_allclose(a.var(bias_corrected=False).item(),
                                   np.var(x), rtol=1e-6)
        np.testing.assert_allclose(nd.std(a, 1).toNumpy(),
                                   np.std(x, 1, ddof=1), rtol=1e-6)
        idx, vals = a.sortWithIndices()
        np.testing.assert_array_equal(idx.toNumpy(), [[1, 3, 4, 0, 2]])
        np.testing.assert_array_equal(a.argSort().toNumpy(),
                                      [[1, 3, 4, 0, 2]])


@pytest.mark.parametrize("dtype", ["bool", "int8", "uint8", "int16",
                                   "int32", "float16"])
def test_trap_sums_and_scans_take_jnps_types(dtype):
    """Module 3: jnp sums and products of small ints in int32 (uint32 for
    unsigned), but scans keep the input's type (bool's in int32); torch
    sums every int in int64. The port gives the reference's types and
    values."""
    x = (np.arange(12) % 5).reshape(3, 4).astype(dtype)
    for name, args in (("sum", ()), ("sum", (1,)), ("prod", (0,)),
                       ("cumsum", (1,)), ("cumprod", (0,)), ("mean", ()),
                       ("argMax", (1,))):
        want = getattr(RN.create(x), name)(*args)
        got = getattr(PN.create(x), name)(*args)
        assert str(got.dtype) == str(want.dtype), (name, args)
        np.testing.assert_array_equal(got.toNumpy(), want.toNumpy())


def test_trap_synthesized_strides():
    """Module 6: strides are computed from the logical shape: the column
    view of a (2, 2) array reports (1,) though the torch view under it
    has stride (2,)."""
    for nd in (RN, PN):
        col = nd.create(np.arange(4.0).reshape(2, 2)).getColumn(0)
        assert col.stride() == (1,)
        assert col.shapeInfoDataBuffer().tolist() == [1, 2, 1, 2, 1, 99]
    col = PN.create(np.arange(4.0).reshape(2, 2)).getColumn(0)
    assert col.buf().stride() == (2,)


def _npy(a):
    bio = io.BytesIO()
    np.save(bio, a)
    return bio.getvalue()


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "int8",
                                   "uint8", "bool"])
def test_trap_npy_bytes_equal_and_cross_read(dtype):
    """Module 8: IO is npy bytes: toByteArray, toFlatArray, saveBinary and
    the compressor's payload are byte-equal across the packages and to
    ``np.save`` of the same array; each package reads the other's."""
    x = (np.random.default_rng(1).standard_normal((3, 4)) * 3).astype(dtype)
    r, p = RN.create(x), PN.create(x)
    want = _npy(x)
    assert RN.toByteArray(r) == PN.toByteArray(p) == want
    assert r.toFlatArray() == p.toFlatArray() == want
    np.testing.assert_array_equal(PN.fromByteArray(want).toNumpy(), x)
    np.testing.assert_array_equal(RN.fromByteArray(PN.toByteArray(p))
                                  .toNumpy(), x)
    np.testing.assert_array_equal(PN.fromByteArray(RN.toByteArray(r))
                                  .toNumpy(), x)
    import gzip
    blob = PN.getCompressor().compress(p)
    assert gzip.decompress(blob) == want
    np.testing.assert_array_equal(
        RN.getCompressor().decompress(blob).toNumpy(), x)


def test_trap_bf16_npy_unreadable_as_in_the_reference(tmp_path):
    """Module 8: the reference writes bfloat16 as descr ``<V2`` over the
    raw words and its own reader raises TypeError on it; the port writes
    the same bytes and raises the same type."""
    x = np.linspace(-3, 3, 6, dtype=np.float32).reshape(2, 3)
    r, p = RN.create(x, dtype="bfloat16"), PN.create(x, dtype="bfloat16")
    rb, pb = RN.toByteArray(r), PN.toByteArray(p)
    assert rb == pb and b"'descr': '<V2'" in pb
    for nd, data in ((RN, rb), (PN, pb), (PN, rb), (RN, pb)):
        with pytest.raises(TypeError, match=r"\|V2"):
            nd.fromByteArray(data)
    RN.saveBinary(r, str(tmp_path / "r.npy"))
    PN.saveBinary(p, str(tmp_path / "p.npy"))
    assert (tmp_path / "r.npy").read_bytes() == (tmp_path / "p.npy") \
        .read_bytes() == pb


def test_trap_gelu_is_the_tanh_form():
    """Module 12: jax.nn.gelu is the tanh approximation; F.gelu's default
    is erf. The port matches the reference, not torch's default."""
    x = np.linspace(-4, 4, 81, dtype=np.float32)
    got = PT.gelu(PN.create(x)).toNumpy()
    np.testing.assert_allclose(got, RT.gelu(RN.create(x)).toNumpy(), **EW)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4


def test_trap_wrapping_a_tensor_is_copy_on_write():
    """The reference's arrays are immutable: an NDArray over a caller's
    tensor copies it on its first in-place write, so the tensor stays."""
    t = torch.arange(4.0)
    a = PNDArray(t)
    a.addi(1.0)
    v = a[1:3]
    v.assign(7.0)
    np.testing.assert_array_equal(t.numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(a.toNumpy(), [1, 7, 7, 4])


def test_parity_coverage_reads_414_of_414():
    assert P_parity.coverage(strict=True)[:2] == \
        R_parity.coverage(strict=True)[:2] == (414, 414)
    assert P_parity.nd4j_coverage(strict=True)[:2] == \
        R_parity.nd4j_coverage(strict=True)[:2]
    assert P_parity.SIGNATURES == R_parity.SIGNATURES
    assert P_parity.ND4J_SIGNATURES == R_parity.ND4J_SIGNATURES


def test_factory_raises_without_cuda_on_the_card():
    """Factory calls place arrays on the card unless asked for the CPU;
    without CUDA they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PN.zeros(2, device="cuda")
    assert PN.zeros(2, device="cpu").device.type == "cpu"
    assert PN.backend() == "cpu"


# ------------------------------------------------------- interop gates
def _blocked(name):
    class _Ctx:
        def __enter__(self):
            self.old = sys.modules.get(name, "missing")
            sys.modules[name] = None         # import raises ImportError

        def __exit__(self, *exc):
            if self.old == "missing":
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = self.old
    return _Ctx()


@pytest.mark.parametrize("runner,module,args", [
    ("GraphRunner", "tensorflow", ()),
    ("OnnxRuntimeRunner", "onnxruntime", ("model.onnx",))])
def test_interop_gates_raise_the_same(runner, module, args):
    """Where the runtime is absent (the card's machine has neither), both
    packages raise ImportError with the same message."""
    seen = []
    with _blocked(module):
        for pkg in (R_interop, P_interop):
            with pytest.raises(ImportError) as e:
                getattr(pkg, runner)(*args)
            seen.append(str(e.value))
    assert seen[0] == seen[1] and module in seen[0]


# -------------------------------------------- the executioner, DataSet
def test_executioner_and_registry_take_ndarrays():
    """exec_op and the executioner accept the port's NDArray, as the
    reference's accept its own; the attention op through the
    executioner equals the registry's."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 1, 1, 8), bool)
    mask[1, ..., 5:] = False
    ex = PN.getExecutioner()
    got = ex.exec("dot_product_attention", *(PN.create(a)
                                             for a in (q, k, v, mask)))
    want = R_reg.exec_op("dot_product_attention", *(jnp.asarray(a)
                                                    for a in (q, k, v, mask)))
    assert isinstance(got, PNDArray)
    np.testing.assert_allclose(got.toNumpy(), np.asarray(want), **RED)
    direct = P_reg.exec_op("dot_product_attention", PN.create(q),
                           PN.create(k), PN.create(v), PN.create(mask))
    np.testing.assert_array_equal(direct.numpy(), got.toNumpy())


def test_dataset_getters_return_ndarray():
    x, y = _data("lenet", n=4)
    for ds_mod, cls in ((R_ds, RNDArray), (P_ds, PNDArray)):
        ds = ds_mod.DataSet(x, y)
        f, lab = ds.getFeatures(), ds.getLabels()
        assert isinstance(f, cls) and isinstance(lab, cls)
        np.testing.assert_array_equal(f.toNumpy(), x)
        np.testing.assert_array_equal(lab.toNumpy(), y)
    ds = P_ds.DataSet(PN.create(x), PN.create(y))
    assert isinstance(ds.features, torch.Tensor)
    ds.getFeatures().addi(1.0)         # a fresh wrapper: the field stays
    np.testing.assert_array_equal(ds.features.numpy(), x)


# ------------------------------------------------------ net.params() view
def _same_nets(ref, net, x, atol=1e-6):
    np.testing.assert_allclose(net.params().toNumpy(),
                               np.asarray(ref.params().toNumpy()),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(ref.output(x).toNumpy()),
                               atol=1e-5, rtol=0)


def test_params_view_writes_through_like_the_reference():
    """A narrow LeNet in both packages with the reference's weights:
    ``params().muli(0.9)``, ``params().get(interval).assign(0)`` and
    ``setParams(params())`` leave both nets with the same params and
    outputs."""
    ref = J["MLN"](lenet_conf(J)).init()
    net = P["MLN"](lenet_conf(P), device="cpu").init()
    net.set_param_tree(_np_tree(ref.param_tree()))
    x, _y = _data("lenet", n=4)
    _same_nets(ref, net, x)
    for n_ in (ref, net):
        n_.params().muli(0.9)
    _same_nets(ref, net, x)
    assert list(net.paramTable())[0] == "0_W"    # first in flat order
    w = net.paramTable()["0_W"].numel()
    for n_, I in ((ref, RI), (net, PI)):
        n_.params().get(I.interval(0, w)).assign(0.0)
    _same_nets(ref, net, x)
    assert float(net.paramTable()["0_W"].abs().sum()) == 0.0
    assert float(np.abs(np.asarray(ref.paramTable()["0_W"].toNumpy()))
                 .sum()) == 0.0
    assert all(float(t.abs().sum()) > 0 for k, t in
               net.paramTable().items() if k != "0_W" and k.endswith("W"))
    before = net.params().toNumpy()
    net.setParams(net.params())
    np.testing.assert_array_equal(net.params().toNumpy(), before)


def test_params_view_reads_live_params_after_fit():
    """The view is live: taken before a fit, it reads the fitted params;
    the net's output/fit/score take NDArrays."""
    net = P["MLN"](lenet_conf(P), device="cpu").init()
    x, y = _data("lenet", n=4)
    view = net.params()
    before = view.toNumpy()
    net.fit(PN.create(x), PN.create(y))
    assert not np.array_equal(view.toNumpy(), before)
    np.testing.assert_array_equal(view.toNumpy(),
                                  net.params().buf().numpy())
    out = net.output(PN.create(x))
    np.testing.assert_array_equal(out.numpy(), net.output(x).numpy())
    ev = Evaluation()
    ev.eval(PN.create(y), PNDArray(out))
    assert 0.0 <= ev.accuracy() <= 1.0


def test_params_view_on_a_computation_graph():
    """The port's ComputationGraph returns the view too (the reference's
    has no ``params()``): writes through it reach its param tree."""
    net = P["CG"](residual_conf(P), device="cpu").init()
    before = {k: t.clone() for k, t in net.paramTable().items()}
    net.params().muli(0.5)
    for k, t in net.paramTable().items():
        torch.testing.assert_close(t, before[k] * 0.5, rtol=0, atol=0)
