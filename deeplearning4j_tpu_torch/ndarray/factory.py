"""``nd`` — the array factory: counterpart of
``deeplearning4j_tpu/ndarray/factory.py`` (ref:
``org.nd4j.linalg.factory.Nd4j``).

Arrays are made on the card unless the caller passes ``device="cpu"`` (or
sets the process-wide default, :func:`setDefaultDevice`, the counterpart
of the reference's ``JAX_PLATFORMS``); without CUDA the card raises and
nothing falls back. Functions that take arrays work on their arrays'
device.

Products (``gemm``, ``mmul``, the BLAS wrapper) are ``torch.matmul`` with
TF32 off (choosing the card pins that, ``_device.resolve_device``), as the
reference computes them outside any Pallas kernel. IO is npy bytes, byte
for byte the reference's: ``np.save`` of the array, and for bfloat16 the
reference's ``<V2`` header over the raw 16-bit words, which the reference
cannot read back either (``TypeError``).
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray import random as _rng
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    NDArray, _fresh, _unwrap, as_tensor, cast, default_device,
    device_of, matmul as _matmul, np_to_tensor, r_argmax, r_argmin,
    r_cumprod, r_cumsum, r_max, r_mean, r_min, r_prod, r_sort, r_std,
    r_sum, r_var, set_default_device)
from deeplearning4j_tpu_torch.ndarray.ndarray import rev_dims as _rev

_default_dtype = _dt.FLOAT


def setDefaultDataType(dtype):
    """Ref: Nd4j.setDefaultDataTypes."""
    global _default_dtype
    _default_dtype = _dt.resolve(dtype)


def defaultFloatingPointType():
    return _default_dtype


def setDefaultDevice(device):
    """The device arrays are made on when the caller names none (None:
    the card)."""
    set_default_device(device)


def getDefaultDevice() -> torch.device:
    return default_device()


def backend() -> str:
    """The active compute platform: "cuda" or "cpu", the default device's
    (ref: Nd4jBackend discovery)."""
    return default_device().type


def _shape(args) -> tuple:
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(int(s) for s in args[0])
    return tuple(int(a) for a in args)


def _store(dtype, fallback=None):
    """The storage type of an array asked to be ``dtype`` (the default
    floating type when None and ``fallback`` is true)."""
    if dtype is None:
        return None if fallback is None else _dt.storage(_default_dtype)
    return _dt.storage(dtype)


def _t(x, device=None) -> torch.Tensor:
    return as_tensor(x, None if isinstance(x, (NDArray, torch.Tensor))
                     else device_of(device))


def _ts(arrays):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    ts = [_t(a) for a in arrays]
    dev = next((a.device for a in arrays if isinstance(
        a, (NDArray, torch.Tensor))), ts[0].device if ts else None)
    return [t.to(dev) for t in ts]


def _new(t) -> NDArray:
    return NDArray._new(t)


def _into(a, out: torch.Tensor) -> NDArray:
    """``out`` written into ``a`` when it is an NDArray, else a new one."""
    if isinstance(a, NDArray):
        return a._write(out)
    return _new(out)


# ------------------------------------------------------------------ creation
def create(data, dtype=None, device=None) -> NDArray:
    if isinstance(data, NDArray):
        t = data.buf().clone(memory_format=torch.contiguous_format)
    elif isinstance(data, torch.Tensor):
        t = data if device is None else data.to(device_of(device))
    else:
        t = np_to_tensor(data).to(device_of(device))
    if dtype is not None:
        t = t.to(_dt.storage(dtype))
    return NDArray(t) if t is data else _new(t)


def array(data, dtype=None, device=None) -> NDArray:
    return create(data, dtype, device)


def zeros(*shape, dtype=None, device=None) -> NDArray:
    return _new(torch.zeros(_shape(shape), dtype=_store(dtype, True),
                            device=device_of(device)))


def ones(*shape, dtype=None, device=None) -> NDArray:
    return _new(torch.ones(_shape(shape), dtype=_store(dtype, True),
                           device=device_of(device)))


def full(shape, value, dtype=None, device=None) -> NDArray:
    return _new(torch.full(tuple(shape), value, dtype=_store(dtype, True),
                           device=device_of(device)))


def valueArrayOf(shape, value, dtype=None, device=None) -> NDArray:
    return full(shape, value, dtype, device)


def zerosLike(a) -> NDArray:
    return _new(torch.zeros_like(_t(a)))


def onesLike(a) -> NDArray:
    return _new(torch.ones_like(_t(a)))


def eye(n, m=None, dtype=None, device=None) -> NDArray:
    return _new(torch.eye(n, n if m is None else m,
                          dtype=_store(dtype, True),
                          device=device_of(device)))


def arange(*args, dtype=None, device=None) -> NDArray:
    t = torch.arange(*args, device=device_of(device))
    if dtype is not None:
        want = _dt.storage(dtype)
    else:
        want = torch.float32 if t.is_floating_point() else torch.int32
    return _new(t.to(want))


def linspace(start, stop, num, dtype=None, device=None) -> NDArray:
    return _new(torch.linspace(start, stop, int(num),
                               dtype=_store(dtype, True),
                               device=device_of(device)))


def scalar(value, dtype=None, device=None) -> NDArray:
    t = np_to_tensor(value)
    want = _store(dtype) if dtype is not None else (
        _dt.storage(_default_dtype) if isinstance(value, float) else None)
    if want is not None:
        t = t.to(want)
    return _new(t.to(device_of(device)))


def empty(dtype=None, device=None) -> NDArray:
    return zeros((0,), dtype=dtype, device=device)


# ---------------------------------------------------------------------- rng
def _gen(seed, device):
    dev = device_of(device)
    return dev, (_rng.seeded(seed, dev) if seed is not None
                 else _rng.next_key(dev))


def rand(*shape, dtype=None, seed: Optional[int] = None,
         device=None) -> NDArray:
    """U[0,1). Ref: Nd4j.rand."""
    dev, gen = _gen(seed, device)
    return _new(torch.rand(_shape(shape), generator=gen, device=dev,
                           dtype=_store(dtype, True)))


def randn(*shape, dtype=None, seed: Optional[int] = None,
          device=None) -> NDArray:
    """N(0,1). Ref: Nd4j.randn."""
    dev, gen = _gen(seed, device)
    return _new(torch.randn(_shape(shape), generator=gen, device=dev,
                            dtype=_store(dtype, True)))


def randint(low, high, shape, seed: Optional[int] = None,
            device=None) -> NDArray:
    dev, gen = _gen(seed, device)
    return _new(torch.randint(int(low), int(high), tuple(shape),
                              generator=gen, device=dev).to(torch.int32))


def shuffle(a, seed: Optional[int] = None) -> NDArray:
    t = _t(a)
    _, gen = _gen(seed, t.device)
    perm = torch.randperm(t.shape[0], generator=gen, device=t.device)
    return _new(t[perm])


def getRandom() -> _rng.Random:
    return _rng.get_random()


def setSeed(seed: int):
    _rng.set_seed(seed)


# ------------------------------------------------------------------ combine
def concat(dim: int, *arrays) -> NDArray:
    return _new(torch.cat(_ts(arrays), dim=dim))


def stack(dim: int, *arrays) -> NDArray:
    return _new(torch.stack(_ts(arrays), dim=dim))


def vstack(*arrays) -> NDArray:
    return _new(torch.vstack(_ts(arrays)))


def hstack(*arrays) -> NDArray:
    return _new(torch.hstack(_ts(arrays)))


def _scalar_or(x, like):
    return x if isinstance(x, (bool, int, float)) else _t(x).to(like.device)


def where(cond, x=None, y=None) -> NDArray:
    c = _t(cond)
    if x is None:
        return _new(torch.nonzero(c).to(torch.int32))
    c = c.to(torch.bool)
    return _new(torch.where(c, _scalar_or(x, c), _scalar_or(y, c)))


def _pad_widths(pad_width, ndim):
    return np.broadcast_to(np.asarray(pad_width, np.int64).reshape(
        -1, 2) if np.ndim(pad_width) else np.full((1, 2), int(pad_width)),
        (ndim, 2))


_INDEX_PAD = {"edge", "reflect", "symmetric", "wrap"}


def pad(a, pad_width, mode="constant", constant_values=0) -> NDArray:
    t = _t(a)
    widths = _pad_widths(pad_width, t.dim())
    if mode == "constant":
        flat = [int(w) for lo_hi in widths[::-1] for w in lo_hi]
        return _new(F.pad(t, flat, value=constant_values))
    if mode not in _INDEX_PAD:
        raise NotImplementedError(f"pad mode {mode!r}")
    for d, (lo, hi) in enumerate(widths):
        src = np.pad(np.arange(t.shape[d]), (int(lo), int(hi)), mode=mode)
        t = torch.index_select(t, d, torch.as_tensor(src, device=t.device))
    return _new(t)


def gather(a, indices, axis=0) -> NDArray:
    t = _t(a)
    idx = _t(indices).to(t.device).long()
    out = torch.index_select(t, axis, idx.reshape(-1))
    return _new(out.reshape(t.shape[:axis] + idx.shape
                            + t.shape[axis + 1:]))


def sort(a, axis=-1, descending=False) -> NDArray:
    out = r_sort(_t(a), axis).values
    return _new(torch.flip(out, (axis,)) if descending else out)


def diag(a) -> NDArray:
    return _new(torch.diag(_t(a)).clone())


# --------------------------------------------------------------------------
# Nd4j static surface, tranche 2 (IO, structure, random-distribution,
# reduction tails)
def _npy_bytes(arr) -> bytes:
    """``np.save`` bytes of the array; bfloat16 as the reference writes it
    (``<V2`` over the raw 16-bit words)."""
    t = _t(arr).detach()
    bio = io.BytesIO()
    if t.dtype == torch.bfloat16:
        words = t.contiguous().view(torch.int16).cpu().numpy()
        np.lib.format.write_array_header_1_0(
            bio, {"descr": "<V2", "fortran_order": False,
                  "shape": tuple(words.shape)})
        bio.write(words.tobytes())
    else:
        np.save(bio, t.cpu().numpy())
    return bio.getvalue()


def _save(arr, path) -> None:
    path = str(path)
    if not path.endswith(".npy"):
        path += ".npy"               # np.save's rule
    with open(path, "wb") as f:
        f.write(_npy_bytes(arr))


def readNumpy(path, dtype=None, device=None) -> NDArray:
    """ref: Nd4j.readNumpy — .npy file → array. ``dtype`` accepts the
    DL4J-style names every other factory API does ("float" == float32)."""
    t = np_to_tensor(np.load(path))
    if dtype is not None:
        t = t.to(_dt.storage(dtype))
    return _new(t.to(device_of(device)))


def writeNumpy(arr, path) -> None:
    _save(arr, path)


createFromNpyFile = readNumpy


def saveBinary(arr, path) -> None:
    """ref: Nd4j.saveBinary — portable single-array binary (npy format)."""
    _save(arr, path)


def readBinary(path, device=None) -> NDArray:
    return _new(np_to_tensor(np.load(path)).to(device_of(device)))


def toFlattened(*arrays) -> NDArray:
    """ref: Nd4j.toFlattened — concat everything as one flat vector."""
    return _new(torch.cat([t.reshape(-1) for t in _ts(arrays)]))


def expandDims(a, axis) -> NDArray:
    t = _t(a)
    return _new(_fresh(t.unsqueeze(axis), t))


def squeeze(a, axis=None) -> NDArray:
    t = _t(a)
    return _new(_fresh(t.squeeze() if axis is None else t.squeeze(axis), t))


def tile(a, *reps) -> NDArray:
    reps = reps[0] if len(reps) == 1 and isinstance(reps[0],
                                                    (list, tuple)) else reps
    return _new(torch.tile(_t(a), tuple(int(r) for r in reps)))


def repeat(a, repeats, axis=None) -> NDArray:
    return NDArray._new(torch.repeat_interleave(_t(a), repeats, dim=axis))


def _dims(t, axis):
    if axis is None:
        return tuple(range(t.dim()))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (int(axis),)


def reverse(a, axis=None) -> NDArray:
    """ref: Nd4j.reverse."""
    t = _t(a)
    return _new(torch.flip(t, _dims(t, axis)))


flip = reverse


def roll(a, shift, axis=None) -> NDArray:
    return _new(torch.roll(_t(a), shift, axis))


def triu(a, k=0) -> NDArray:
    return _new(torch.triu(_t(a), k))


def tril(a, k=0) -> NDArray:
    return _new(torch.tril(_t(a), k))


def meshgrid(*xs, indexing="xy"):
    return tuple(_new(g.clone()) for g in
                 torch.meshgrid(*_ts(xs), indexing=indexing))


def split(a, parts, axis=0):
    t = _t(a)
    if isinstance(parts, int) and t.shape[axis] % parts:
        raise ValueError("array split does not result in an equal division")
    return [_new(p.clone(memory_format=torch.contiguous_format))
            for p in torch.tensor_split(t, parts, dim=axis)]


def kron(a, b) -> NDArray:
    ta, tb = _ts((a, b))
    return _new(torch.kron(ta, tb))


def _dot(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if a.dim() <= 2 and b.dim() <= 2:
        return torch.matmul(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2,
                                                           0)]))


def dot(a, b) -> NDArray:
    return _new(_dot(*_ts((a, b))))


def matmul(a, b) -> NDArray:
    ta, tb = _ts((a, b))
    dt = torch.promote_types(ta.dtype, tb.dtype)
    return _new(torch.matmul(ta.to(dt), tb.to(dt)))


def pile(*arrays) -> NDArray:
    """ref: Nd4j.pile — stack along a new leading axis."""
    return _new(torch.stack(_ts(arrays), dim=0))


def tear(a, axis=0):
    """ref: Nd4j.tear — unstack along an axis."""
    return [_new(p.clone(memory_format=torch.contiguous_format))
            for p in torch.unbind(_t(a), dim=axis)]


def argMax(a, axis=None) -> NDArray:
    return _new(r_argmax(_t(a), axis))


def argMin(a, axis=None) -> NDArray:
    return _new(r_argmin(_t(a), axis))


# random-distribution statics (ref: Nd4j.randomBernoulli etc.) — through
# the stateful RNG, so setSeed governs reproducibility
def _global_gen(device=None):
    dev = device_of(device)
    return dev, _rng.next_key(dev)


def randomBernoulli(p, *shape, device=None) -> NDArray:
    dev, gen = _global_gen(device)
    return _new(torch.bernoulli(torch.full(_shape(shape), float(p),
                                           device=dev), generator=gen))


def randomExponential(lam, *shape, device=None) -> NDArray:
    dev, gen = _global_gen(device)
    return _new(torch.empty(_shape(shape), device=dev).exponential_(
        1.0, generator=gen) / lam)


def _standard_gamma(alpha, shape, gen, dev):
    """Marsaglia and Tsang's method, every element redrawn until taken;
    alpha < 1 boosted by U^(1/alpha)."""
    a = float(alpha)
    boost = a < 1.0
    if boost:
        a += 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    out = torch.empty(shape, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    if boost:
        u = torch.rand(shape, generator=gen, device=dev)
        out = out * u ** (1.0 / float(alpha))
    return out


def randomGamma(alpha, *shape, device=None) -> NDArray:
    dev, gen = _global_gen(device)
    return _new(_standard_gamma(alpha, _shape(shape), gen, dev))


def randomPoisson(lam, *shape, device=None) -> NDArray:
    dev, gen = _global_gen(device)
    return _new(torch.poisson(torch.full(_shape(shape), float(lam),
                                         device=dev), generator=gen))


def randomBinomial(n, p, *shape, device=None) -> NDArray:
    dev, gen = _global_gen(device)
    return _new(torch.binomial(
        torch.full(_shape(shape), float(n), device=dev),
        torch.full(_shape(shape), float(p), device=dev), generator=gen))


def choice(source, probs, n) -> NDArray:
    src = _t(source)
    gen = _rng.next_key(src.device)
    p = _t(probs).to(src.device).float()
    idx = torch.multinomial(p, int(n), replacement=True, generator=gen)
    return _new(torch.index_select(src, 0, idx))


# reduction statics (ref: Nd4j.max/min/mean/std/sum/var/norm1/norm2)
def max(a, axis=None) -> NDArray:
    return _new(r_max(_t(a), axis))


def min(a, axis=None) -> NDArray:
    return _new(r_min(_t(a), axis))


def sum(a, axis=None) -> NDArray:
    return _new(r_sum(_t(a), axis))


def mean(a, axis=None) -> NDArray:
    return _new(r_mean(_t(a), axis))


def std(a, axis=None) -> NDArray:
    return _new(r_std(_t(a), axis, ddof=1))


def var(a, axis=None) -> NDArray:
    return _new(r_var(_t(a), axis, ddof=1))


def norm1(a, axis=None) -> NDArray:
    return _new(r_sum(_t(a).abs(), axis))


def norm2(a, axis=None) -> NDArray:
    return _new(torch.sqrt(r_sum(torch.square(_t(a)), axis)))


def normmax(a, axis=None) -> NDArray:
    return _new(r_max(_t(a).abs(), axis))


def prod(a, axis=None) -> NDArray:
    return _new(r_prod(_t(a), axis))


def getExecutioner():
    """ref: Nd4j.getExecutioner() — the op-execution facade."""
    from deeplearning4j_tpu_torch.ndarray.executioner import get_executioner
    return get_executioner()


# --------------------------------------------------------------------------
# Nd4j static surface, tranche 3 (creation-overload, linalg, accumulation,
# serialization and environment tails)
def createFromArray(*values, dtype=None, device=None) -> NDArray:
    """ref: Nd4j.createFromArray(...) — varargs scalars or nested lists."""
    if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
        values = values[0]
    return create(np.asarray(values), dtype, device)


def fromNumpy(arr, device=None) -> NDArray:
    """ref: Nd4j.createFromNpyPointer analog — numpy ingest."""
    return _new(_t(arr, device))


def createUninitialized(*shape, dtype=None, device=None) -> NDArray:
    """ref: Nd4j.createUninitialized — contents undefined: zeros."""
    return zeros(*shape, dtype=dtype, device=device)


createUninitializedDetached = createUninitialized


def trueScalar(value, device=None) -> NDArray:
    """ref: Nd4j.trueScalar (rank-0)."""
    return _new(_t(value, device).clone())


def trueVector(values, device=None) -> NDArray:
    t = _t(values, device)
    return _new(_fresh(t.reshape(-1), t))


emptyLike = zerosLike


def rot90(a, k: int = 1) -> NDArray:
    """ref: Nd4j.rot90."""
    return _new(torch.rot90(_t(a), k, (0, 1)))


def flipud(a) -> NDArray:
    return _new(torch.flipud(_t(a)))


def fliplr(a) -> NDArray:
    return _new(torch.fliplr(_t(a)))


def gemm(a, b, transpose_a=False, transpose_b=False, alpha=1.0, beta=0.0,
         c=None) -> NDArray:
    """ref: Nd4j.gemm — C = alpha·op(A)·op(B) + beta·C; bf16 operands give
    an f32 product. ``alpha`` of 1 multiplies by nothing (the same
    values)."""
    A, B = _ts((a, b))
    A = _rev(A) if transpose_a else A
    B = _rev(B) if transpose_b else B
    out = _matmul(A, B)
    if alpha != 1.0:
        out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * _t(c).to(out.device)
    if isinstance(c, NDArray):
        return c._write(cast(out, c.buf().dtype))
    return _new(out)


def tensorMmul(a, b, axes) -> NDArray:
    """ref: Nd4j.tensorMmul."""
    ta, tb = _ts((a, b))
    dt = torch.promote_types(ta.dtype, tb.dtype)
    return _new(torch.tensordot(ta.to(dt), tb.to(dt), dims=axes))


def outer(a, b) -> NDArray:
    ta, tb = _ts((a, b))
    dt = torch.promote_types(ta.dtype, tb.dtype)
    return _new(torch.outer(ta.reshape(-1).to(dt), tb.reshape(-1).to(dt)))


def accumulate(*arrays) -> NDArray:
    """ref: Nd4j.accumulate — elementwise sum of N same-shape arrays."""
    ts = _ts(arrays)
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return _new(out if len(ts) > 1 else out.clone())


def average(*arrays) -> NDArray:
    """ref: Nd4j.averageAndPropagate family — mean of N arrays."""
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = arrays[0]
    return _new(accumulate(list(arrays)).buf() / len(arrays))


averageAndPropagate = average


def appendBias(*vectors) -> NDArray:
    """ref: Nd4j.appendBias — concat column vectors and append a 1.0 bias."""
    flat = torch.cat([t.reshape(-1) for t in _ts(vectors)])
    return _new(torch.cat([flat, torch.ones((1,), dtype=flat.dtype,
                                            device=flat.device)])
                .reshape(-1, 1))


def bilinearProducts(curr, in_):
    """ref: Nd4j.bilinearProducts — d-vector of x^T·T[d]·y slices."""
    T, x = _ts((curr, in_))          # (d, n, n), n
    x = x.reshape(-1)
    return _new(torch.einsum("dij,i,j->d", T, x, x))


def isMax(a, axis=None) -> NDArray:
    """ref: Nd4j.getExecutioner IsMax op — one-hot of the argmax."""
    t = _t(a)
    if axis is None:
        flat = t.reshape(-1)
        hot = torch.arange(flat.numel(), device=t.device) == r_argmax(flat)
        return _new(hot.reshape(t.shape).to(t.dtype))
    idx = torch.argmax(t, dim=axis, keepdim=True)
    iota = torch.arange(t.shape[axis], device=t.device).reshape(
        [-1 if d == axis % t.dim() else 1 for d in range(t.dim())])
    return _new((iota == idx).to(t.dtype))


def scatterUpdate(op: str, array, indices, updates, axis=0) -> NDArray:
    """ref: Nd4j.scatterUpdate — in-place indexed update (add/sub/mul/assign)."""
    t = _t(array)
    idx = _t(indices, t.device).to(t.device).long().reshape(-1)
    upd = _t(updates, t.device).to(device=t.device, dtype=t.dtype)
    out = t.clone()
    if op == "add":
        out.index_add_(axis, idx, upd)
    elif op == "sub":
        out.index_add_(axis, idx, -upd)
    elif op == "mul":
        out.index_reduce_(axis, idx, upd, "prod")
    elif op == "assign":
        out.index_copy_(axis, idx, upd)
    else:
        raise KeyError(op)
    return _into(array, out)


def sortRows(a, column: int = 0, ascending=True) -> NDArray:
    """ref: Nd4j.sortRows — reorder rows by one column's values."""
    t = _t(a)
    order = r_sort(t[:, column], 0).indices
    if not ascending:
        order = torch.flip(order, (0,))
    return _new(t[order])


def sortColumns(a, row: int = 0, ascending=True) -> NDArray:
    t = _t(a)
    order = r_sort(t[row, :], 0).indices
    if not ascending:
        order = torch.flip(order, (0,))
    return _new(t[:, order])


def sortWithIndices(a, dim=-1, ascending=True):
    """ref: Nd4j.sortWithIndices — (indices, sorted) pair."""
    t = _t(a)
    idx = r_sort(t, dim).indices
    if not ascending:
        idx = torch.flip(idx, (dim,))
    return _new(idx.to(torch.int32)), _new(torch.gather(t, dim, idx))


def stripOnes(a) -> NDArray:
    """ref: Nd4j.stripOnes — squeeze all size-1 dims."""
    t = _t(a)
    return _new(_fresh(t.squeeze(), t))


def clearNans(a) -> NDArray:
    """ref: Nd4j.clearNans — in-place NaN→0."""
    t = _t(a)
    return _into(a, torch.where(torch.isnan(t), torch.zeros((), dtype=t.dtype,
                                                            device=t.device),
                                t))


def cumsum(a, axis=None) -> NDArray:
    return _new(r_cumsum(_t(a), axis))


def cumprod(a, axis=None) -> NDArray:
    return _new(r_cumprod(_t(a), axis))


def exec_(op, *args, **kwargs):
    """ref: Nd4j.exec(Op/CustomOp) — run a registry op eagerly by name."""
    from deeplearning4j_tpu_torch.ops import registry
    return registry.exec_op(op, *args, **kwargs)


def dataType():
    """ref: Nd4j.dataType() — the default floating point type."""
    return _default_dtype


setDefaultDataTypes = setDefaultDataType


def sizeOfDataType(dtype=None) -> int:
    """ref: Nd4j.sizeOfDataType — bytes per element."""
    return (_dt.resolve(dtype) if dtype is not None
            else _default_dtype).itemsize


def getBackend() -> str:
    return backend()


def getStrides(shape, order="c"):
    """ref: Nd4j.getStrides — row/col-major element strides for a shape."""
    shape = tuple(shape)
    if order == "f":
        out, acc = [], 1
        for s in shape:
            out.append(acc)
            acc *= s
        return tuple(out)
    out, acc = [], 1
    for s in reversed(shape):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


def checkShapeValues(shape) -> None:
    """ref: Nd4j.checkShapeValues — reject negatives/overflow."""
    for s in shape:
        if int(s) < 0:
            raise ValueError(f"negative dimension in shape {tuple(shape)}")


def toByteArray(arr) -> bytes:
    """ref: Nd4j.toByteArray — portable npy bytes."""
    return _npy_bytes(arr)


def fromByteArray(data: bytes, device=None) -> NDArray:
    return _new(np_to_tensor(np.load(io.BytesIO(data))).to(
        device_of(device)))


def toNpyByteArray(arr) -> bytes:
    return toByteArray(arr)


createNpyFromByteArray = fromByteArray


def writeTxt(arr, path, sep=",") -> None:
    """ref: Nd4j.writeTxt."""
    a = _unwrap(arr)
    a = NDArray._new(a).toNumpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    header = f"shape={a.shape}"
    rows = a.shape[0] if a.ndim > 1 else 1
    np.savetxt(path, a.reshape(rows, -1), delimiter=sep, header=header)


def readTxt(path, sep=",", device=None) -> NDArray:
    """ref: Nd4j.readTxt — reads writeTxt output (shape in header)."""
    with open(path) as f:
        first = f.readline()
    data = np.loadtxt(path, delimiter=sep)
    if first.startswith("# shape="):
        shape = tuple(int(x) for x in
                      first.strip()[len("# shape=("):-1].split(",") if x.strip())
        data = data.reshape(shape)
    return _new(np_to_tensor(data).to(device_of(device)))


def write(arr, path) -> None:
    """ref: Nd4j.write(INDArray, DataOutputStream) — binary single array."""
    saveBinary(arr, path)


def read(path, device=None) -> NDArray:
    return readBinary(path, device)


def _card():
    dev = default_device()
    return dev if dev.type == "cuda" else None


def getAffinityManager():
    """ref: Nd4j.getAffinityManager — device placement facade: the cards
    this process sees."""
    class _Affinity:
        def getNumberOfDevices(self):
            return torch.cuda.device_count() if _card() is not None else 1

        def getDeviceForCurrentThread(self):
            dev = _card()
            return dev.index if dev is not None else 0
    return _Affinity()


def getMemoryManager():
    """ref: Nd4j.getMemoryManager — the card's allocated bytes."""
    class _Mem:
        def getCurrentWorkspace(self):
            return None

        def allocatedMemory(self, device=0):
            if _card() is None:
                return 0
            return int(torch.cuda.memory_allocated(device))
    return _Mem()


def create_shaped(*args, dtype=None, order="c", device=None) -> NDArray:
    """ref: Nd4j.create(int...)/(double[])/(data, shape, order) — the
    creation mega-overload. Dispatch mirrors the reference's: int varargs /
    an int list = shape (Java ``create(int[])`` allocates); a float list,
    nested list, or numpy array = data; data + shape tuple = reshape."""
    if args and isinstance(args[0], (list, np.ndarray)):
        data = np.asarray(args[0])
        if len(args) >= 2 and isinstance(args[1], (tuple, list)):
            shape = tuple(args[1])
            t = create(data.ravel(), dtype, device).buf()
            out = _rev(t.reshape(shape[::-1])) if order == "f" \
                else t.reshape(shape)
            return _new(_fresh(out, t))
        if data.ndim > 1 or not np.issubdtype(data.dtype, np.integer) \
                or isinstance(args[0], np.ndarray):
            return create(data, dtype, device)
        # flat python int list = shape, matching Java create(int[])
        return zeros(*data.tolist(), dtype=dtype, device=device)
    return zeros(*args, dtype=dtype, device=device)


class Nd4j:
    """The reference-spelled static facade: ``Nd4j.zeros(...)`` etc.

    ref: org.nd4j.linalg.factory.Nd4j. Every module-level factory function
    is exposed as a static; populated at import time from this module's
    public functions.
    """
    pass


def _populate_nd4j_facade():
    import sys
    mod = sys.modules[__name__]
    skip = {"NDArray", "Nd4j"}
    for name in dir(mod):
        if name.startswith("_") or name in skip:
            continue
        obj = getattr(mod, name)
        if callable(obj) and getattr(obj, "__module__", "").endswith(
                ("factory", "random")):
            setattr(Nd4j, name, staticmethod(obj))
    # reference-spelled aliases
    Nd4j.create = staticmethod(create_shaped)
    Nd4j.createFromData = staticmethod(create)
    Nd4j.exec_ = staticmethod(exec_)
    setattr(Nd4j, "exec", staticmethod(exec_))
    Nd4j.getRandomFactory = staticmethod(getRandom)
    Nd4j.defaultFloatingPointType = staticmethod(defaultFloatingPointType)


# --------------------------------------------------------------------------
# BLAS/LAPACK facade (ref: Nd4j.getBlasWrapper() → BlasWrapper + .lapack())
class _Lapack:
    """ref: org.nd4j.linalg.api.blas.Lapack."""

    def gesvd(self, a):
        u, s, vt = torch.linalg.svd(_t(a), full_matrices=False)
        return _new(u), _new(s), _new(vt)

    def potrf(self, a, lower=True):
        c = torch.linalg.cholesky(_t(a))
        return _new(c if lower else c.T.contiguous())

    def getrf(self, a):
        lu_, piv = torch.linalg.lu_factor(_t(a))
        # LAPACK's 1-based pivots; the reference's are 0-based
        return _new(lu_), _new((piv - 1).to(torch.int32))

    def syev(self, a):
        w, v = torch.linalg.eigh(_t(a))
        return _new(w), _new(v)

    def geqrf(self, a):
        q, r = torch.linalg.qr(_t(a))
        return _new(q), _new(r)


class _BlasWrapper:
    """ref: org.nd4j.linalg.factory.BlasWrapper (level1/2/3 + lapack)."""

    def lapack(self):
        return _Lapack()

    def dot(self, x, y):
        tx, ty = _ts((x, y))
        return float(_dot(tx.reshape(-1), ty.reshape(-1)))

    def nrm2(self, x):
        return float(torch.linalg.vector_norm(_t(x).reshape(-1)))

    def asum(self, x):
        return float(r_sum(_t(x).abs()))

    def iamax(self, x):
        return int(r_argmax(_t(x).abs().reshape(-1)))

    def scal(self, alpha, x):
        return _into(x, alpha * _t(x))

    def axpy(self, alpha, x, y):
        tx, ty = _ts((x, y))
        return _into(y, alpha * tx + ty)

    def gemv(self, alpha, a, x, beta=0.0, y=None):
        ta, tx = _ts((a, x))
        out = alpha * _matmul(ta, tx.reshape(-1))
        if y is not None:
            out = out + beta * _t(y).to(out.device).reshape(-1)
        return _new(out)

    def gemm(self, a, b, transpose_a=False, transpose_b=False,
             alpha=1.0, beta=0.0, c=None):
        return gemm(a, b, transpose_a, transpose_b, alpha, beta, c)

    def ger(self, alpha, x, y, a=None):
        tx, ty = _ts((x, y))
        out = alpha * torch.outer(tx.reshape(-1), ty.reshape(-1))
        if a is not None:
            out = out + _t(a).to(out.device)
        return _new(out)


def getBlasWrapper() -> _BlasWrapper:
    return _BlasWrapper()


# linalg statics (ref: Lapack entry points surfaced on Nd4j in examples)
def svd(a):
    return getBlasWrapper().lapack().gesvd(a)


def cholesky(a) -> NDArray:
    return getBlasWrapper().lapack().potrf(a)


def qr(a):
    return getBlasWrapper().lapack().geqrf(a)


def lu(a):
    return getBlasWrapper().lapack().getrf(a)


def eig(a):
    return getBlasWrapper().lapack().syev(a)


def _float_pair(a, b):
    ta, tb = _ts((a, b))
    dt = torch.promote_types(torch.promote_types(ta.dtype, tb.dtype),
                             torch.float32)
    return ta.to(dt), tb.to(dt)


def solve(a, b) -> NDArray:
    return _new(torch.linalg.solve(*_float_pair(a, b)))


def lstsq(a, b) -> NDArray:
    ta, tb = _float_pair(a, b)
    vec = tb.dim() == 1
    sol = torch.linalg.lstsq(ta, tb[:, None] if vec else tb).solution
    return _new(sol[:, 0] if vec else sol)


def inv(a) -> NDArray:
    return _new(torch.linalg.inv(_t(a)))


def pinv(a) -> NDArray:
    return _new(torch.linalg.pinv(_t(a)))


def det(a) -> float:
    return float(torch.linalg.det(_t(a)))


def matrixRank(a) -> int:
    return int(torch.linalg.matrix_rank(_t(a)))


# remaining creation/structure statics
def randUniform(low, high, *shape, device=None) -> NDArray:
    """ref: Nd4j.rand(shape, min, max, rng)."""
    dev, gen = _global_gen(device)
    u = torch.rand(_shape(shape), generator=gen, device=dev,
                   dtype=_dt.storage(_default_dtype))
    return _new(low + (high - low) * u)


def specialConcat(dim, *arrays) -> NDArray:
    """ref: Nd4j.specialConcat — same contract as concat."""
    return concat(dim, *arrays)


def rollAxis(a, axis, start=0) -> NDArray:
    """ref: Nd4j.rollAxis."""
    t = _t(a)
    return _new(_fresh(torch.movedim(t, axis, start), t))


def shape(a):
    """ref: Nd4j.shape(INDArray)."""
    return tuple(_t(a).shape)


def order() -> str:
    """ref: Nd4j.order() — logical ordering."""
    return "c"


def factory():
    """ref: Nd4j.factory() — the NDArrayFactory; here the module itself."""
    import sys
    return sys.modules[__name__]


def createFromNpzFile(path, device=None):
    """ref: Nd4j.createFromNpzFile — dict of name → array."""
    data = np.load(path)
    return {k: _new(np_to_tensor(data[k]).to(device_of(device)))
            for k in data.files}


def writeAsNumpy(arr, path) -> None:
    """ref: Nd4j.writeAsNumpy."""
    writeNumpy(arr, path)


def getCompressor():
    """ref: Nd4j.getCompressor() → BasicNDArrayCompressor: the at-rest
    codec (gzip over npy bytes) the reference uses for transport."""
    import gzip

    class _Compressor:
        def compress(self, arr) -> bytes:
            return gzip.compress(toByteArray(arr))

        def decompress(self, data: bytes, device=None) -> NDArray:
            return fromByteArray(gzip.decompress(data), device)

        def setDefaultCompression(self, algo: str):
            return self
    return _Compressor()


def zeros_like(a) -> NDArray:
    return zerosLike(a)


def ones_like(a) -> NDArray:
    return onesLike(a)


def vander(x, n=None) -> NDArray:
    """ref: Nd4j.vander — Vandermonde matrix."""
    return _new(torch.vander(_t(x).reshape(-1), n))


def tri(n, m=None, k=0, device=None) -> NDArray:
    ones_ = torch.ones((n, n if m is None else m),
                       dtype=_dt.storage(_default_dtype),
                       device=device_of(device))
    return _new(torch.tril(ones_, k))


def logspace(start, stop, num, base=10.0, device=None) -> NDArray:
    return _new(torch.logspace(start, stop, int(num), base=base,
                               dtype=_dt.storage(_default_dtype),
                               device=device_of(device)))


def histogram(a, bins=10):
    """``jnp.histogram``: edges over [min, max], each value counted in the
    bin its right-sided search finds, the last edge closed."""
    t = _t(a).reshape(-1)
    f = t.float() if not t.is_floating_point() else t
    edges = torch.linspace(float(f.min()), float(f.max()), int(bins) + 1,
                           dtype=f.dtype, device=f.device)
    idx = torch.bucketize(f, edges, right=True)
    idx = torch.where(f == edges[-1], len(edges) - 1, idx)
    counts = torch.bincount(idx, minlength=len(edges))[1:len(edges)]
    return _new(counts.to(f.dtype)), _new(edges)


def unique(a) -> NDArray:
    return _new(torch.unique(_t(a), sorted=True))


def nonzero(a) -> NDArray:
    """Coordinates of nonzero elements, (n, rank) — Nd4j.where analog."""
    return _new(torch.nonzero(_t(a)).to(torch.int32))


def getEnvironment():
    """ref: Nd4j.getEnvironment() → Environment — runtime introspection.
    The debug flag is the NaN panic (an op giving NaN raises
    FloatingPointError, as the reference's ``jax_debug_nans``); verbose
    prints each op."""
    from deeplearning4j_tpu_torch.profiler.op_profiler import OpProfiler

    def _set(**kw):
        prof = OpProfiler.get_instance()
        for k, v in kw.items():
            setattr(prof.config, k, bool(v))
        prof.set_config(prof.config)

    class _Env:
        def isCPU(self):
            return default_device().type == "cpu"

        def isGPU(self):
            return default_device().type == "cuda"

        def isTPU(self):
            return False

        def isDebug(self):
            return OpProfiler.get_instance().config.check_for_nan

        def setDebug(self, v: bool):
            _set(check_for_nan=v)

        def isVerbose(self):
            return OpProfiler.get_instance().config.verbose

        def setVerbose(self, v: bool):
            _set(verbose=v)

        def maxThreads(self):
            import os as _os
            return _os.cpu_count()
    return _Env()


def version() -> str:
    """ref: nd4j-common VersionCheck / Nd4j version info."""
    try:
        import importlib.metadata as md
        return md.version("deeplearning4j-tpu")
    except Exception:
        return "0.0.0-dev"


# --------------------------------------------------------------------------
# Tranche-6 statics: the probed remaining Nd4j surface
def getDataType():
    """ref: Nd4j.dataType()/getDataType — the global default dtype."""
    return _default_dtype


def setDataType(dtype):
    """ref: Nd4j.setDataType(DataType) — alias of setDefaultDataType."""
    setDefaultDataType(dtype)


def typeConversion(arr, dtype):
    """ref: Nd4j.typeConversion(INDArray, DataTypeEx) — a dtype cast."""
    a = arr if isinstance(arr, NDArray) else NDArray(arr)
    return a.castTo(dtype)


def batchMmul(matrices_a, matrices_b, transpose_a: bool = False,
              transpose_b: bool = False):
    """ref: Nd4j.batchMmul(INDArray[], INDArray[]) — N independent GEMMs,
    stacked into one batched product as the reference stacks them."""
    As = torch.stack(_ts(list(matrices_a)))
    Bs = torch.stack(_ts(list(matrices_b))).to(As.device)
    if transpose_a:
        As = As.transpose(-1, -2)
    if transpose_b:
        Bs = Bs.transpose(-1, -2)
    dt = torch.promote_types(As.dtype, Bs.dtype)
    out = torch.matmul(As.to(dt), Bs.to(dt))
    return [_new(out[i].clone()) for i in range(out.shape[0])]


def createBuffer(data_or_length, dtype=None, device=None):
    """ref: Nd4j.createBuffer(...) — DataBuffer creation: the flat array
    that backs an NDArray. int/long → zero-filled flat buffer of that
    length; array-like → its flat copy."""
    dt = _dt.storage(dtype) if dtype is not None else _dt.storage(
        _default_dtype)
    if isinstance(data_or_length, (int, np.integer)):
        return _new(torch.zeros((int(data_or_length),), dtype=dt,
                                device=device_of(device)))
    t = _t(data_or_length, device)
    flat = t.reshape(-1).clone()
    return _new(flat.to(dt) if dtype is not None else flat)


def createArrayFromShapeBuffer(buffer, shape_info):
    """ref: Nd4j.createArrayFromShapeBuffer(DataBuffer, DataBuffer/long[])
    — reassemble an array from a flat buffer + the logical shape."""
    flat = _t(buffer).reshape(-1)
    shape_ = tuple(int(s) for s in (
        shape_info.toNumpy().astype(int) if isinstance(shape_info, NDArray)
        else shape_info))
    return _new(flat.reshape(shape_).clone())


def versionCheck():
    """ref: nd4j-common VersionCheck — one package: always consistent;
    returns the version string it validated."""
    return version()


class _DeallocatorService:
    """ref: Nd4j.getDeallocatorService() — tensors are freed by torch's
    allocator, so nothing is ever queued."""

    def pendingDeallocations(self):
        return 0

    def deallocate(self, _array=None):
        return True


_deallocator_service = _DeallocatorService()


def getDeallocatorService():
    return _deallocator_service


class _ShapeInfoProvider:
    """ref: Nd4j.getShapeInfoProvider() — the descriptor is (shape, order)."""

    def createShapeInformation(self, shape, order="c"):
        return (tuple(int(s) for s in shape), order)


_shape_info_provider = _ShapeInfoProvider()


def getShapeInfoProvider():
    return _shape_info_provider


_populate_nd4j_facade()
