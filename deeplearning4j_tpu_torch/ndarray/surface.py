"""INDArray surface, tranche 3: counterpart of
``deeplearning4j_tpu/ndarray/surface.py`` (ref:
``org.nd4j.linalg.api.ndarray.INDArray``). Java overloads collapse into
methods with optional arguments, so the parity unit is the distinct
method name. This module adds:

- result-arg binary ops (``add(other, result)`` — writes into ``result``)
- i-variant comparisons (``lti``/``gti``/``eqi``/``neqi``/…)
- boolean/bitwise ops (``and_``/``or_``/``xor_``/``not_``)
- the Condition family (``match``/``scan_``/``putWhere``/``putWhereWithMask``)
- order-aware ``dup``/``ravel``/``reshape`` (the 'c'/'f' char args)
- slice family (``slices``/``putSlice``/``vectorAlongDimension``/``dimShuffle``)
- entropy family with dimensions, remaining Number reductions
- assign-if, put-i row/column vectors, matrix getters with ``dup``

Loaded by ``deeplearning4j_tpu_torch.ndarray`` at import.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import (
    NDArray, _cond_mask, _fresh, _operand, as_tensor, cast, matmul, r_sum)
from deeplearning4j_tpu_torch.ndarray.ndarray import rev_dims as _rev


def extend_tranche3():
    N = NDArray

    # ------------------------------------------------ result-arg binops
    # ref: INDArray#add(INDArray, INDArray) etc. — the result array is
    # written in place and returned
    def _result_variant(fn):
        def f(self, other, result=None):
            t = self.buf()
            out = fn(t, _operand(other, t))
            if result is not None:
                return result._write(cast(out, result.buf().dtype))
            return NDArray._new(out)
        return f

    N.add = _result_variant(torch.add)
    N.sub = _result_variant(torch.sub)
    N.mul = _result_variant(torch.mul)
    N.div = _result_variant(torch.true_divide)
    N.rsub = _result_variant(lambda a, b: b - a)
    N.rdiv = _result_variant(lambda a, b: b / a)
    # keep python operators bound to the 2-arg forms
    N.__add__ = lambda self, o: N.add(self, o)
    N.__radd__ = N.__add__
    N.__sub__ = lambda self, o: N.sub(self, o)
    N.__rsub__ = lambda self, o: N.rsub(self, o)
    N.__mul__ = lambda self, o: N.mul(self, o)
    N.__rmul__ = N.__mul__
    N.__truediv__ = lambda self, o: N.div(self, o)
    N.__rtruediv__ = lambda self, o: N.rdiv(self, o)

    def _mmul_result(self, other, result=None, transpose=None):
        """ref: INDArray#mmul(INDArray, INDArray[, MMulTranspose]) —
        ``transpose`` accepts 'a', 'b', 'ab' for pre-transposed operands."""
        a = self.buf()
        b = as_tensor(other, a.device)
        if transpose in ("a", "ab"):
            a = _rev(a)
        if transpose in ("b", "ab"):
            b = _rev(b)
        out = matmul(a, b)
        if result is not None:
            return result._write(cast(out, result.buf().dtype))
        return NDArray._new(out)

    N.mmul = _mmul_result

    # ------------------------------------------------ i-variant comparisons
    # ref: INDArray#lti/gti/eqi/neqi (legacy in-place comparison results)
    def _cmp_i(fn):
        def f(self, o):
            t = self.buf()
            return self._write(fn(t, _operand(o, t)).to(t.dtype))
        return f

    N.lti = _cmp_i(torch.lt)
    N.gti = _cmp_i(torch.gt)
    N.eqi = _cmp_i(torch.eq)
    N.neqi = _cmp_i(torch.ne)
    N.ltei = _cmp_i(torch.le)
    N.gtei = _cmp_i(torch.ge)

    # ------------------------------------------------ boolean / bitwise
    # ref: Transforms.and/or/xor/not, surfaced as methods (python keywords
    # force the trailing underscore)
    def _boolify(x, like):
        return as_tensor(x, like.device).to(torch.bool)

    def _logic(fn):
        def f(self, o):
            t = self.buf()
            return NDArray._new(fn(t.to(torch.bool), _boolify(o, t)))
        return f

    N.and_ = _logic(torch.logical_and)
    N.or_ = _logic(torch.logical_or)
    N.xor_ = _logic(torch.logical_xor)
    N.not_ = lambda self: NDArray._new(~self.buf().to(torch.bool))
    N.__and__ = N.and_
    N.__or__ = N.or_
    N.__xor__ = N.xor_
    N.__invert__ = N.not_

    # ------------------------------------------------ Condition family
    def match(self, value, cond=None):
        """ref: INDArray#match(Number/INDArray, Condition) — boolean mask of
        elements matching. With no condition: equality match. A bare
        condition name string pairs with ``value`` ("greaterthan", 5)."""
        t = self.buf()
        if cond is None:
            return NDArray._new(torch.eq(t, _operand(value, t)))
        if isinstance(cond, str):
            cond = (cond, value)
        return NDArray._new(_cond_mask(t, cond))

    def scan_(self, cond):
        """ref: INDArray#scan(Condition) — COUNT of matching elements."""
        return int(r_sum(_cond_mask(self.buf(), cond)))

    def _put_mask(self, mask, put):
        t = self.buf()
        rep = as_tensor(put, t.device, t.dtype).broadcast_to(t.shape)
        return torch.where(mask, rep, t)

    def putWhere(self, mask_or_cond, put):
        """ref: INDArray#putWhere(INDArray mask, INDArray put) /
        (Number, INDArray, Condition) — copy, with masked elements replaced."""
        return NDArray._new(_put_mask(self, _cond_mask(self.buf(),
                                                       mask_or_cond), put))

    def putWhereWithMask(self, mask, put):
        """ref: INDArray#putWhereWithMask — explicit 0/1 mask array."""
        m = as_tensor(mask, self.device).to(torch.bool)
        return NDArray._new(_put_mask(self, m, put))

    def assignIf(self, other, cond):
        """ref: INDArray#assignIf(INDArray, Condition) — in-place assign of
        elements of ``other`` where THIS array's elements match ``cond``."""
        return self._write(_put_mask(self, _cond_mask(self.buf(), cond),
                                     other))

    N.match = match
    N.scan_ = scan_
    N.putWhere = putWhere
    N.putWhereWithMask = putWhereWithMask
    N.assignIf = assignIf

    # ------------------------------------------------ order-aware dup/ravel
    # ref: INDArray#dup(char), #ravel(char), #reshape(char, long...). 'f'
    # order affects only the logical element sequence, as in the reference
    _base_dup = N.dup

    def dup(self, order="c"):
        if order == "f":
            t = self.buf()
            return NDArray._new(_fresh(_rev(_rev(t).reshape(-1).reshape(
                tuple(self.shape)[::-1])), t))
        return _base_dup(self)

    def ravel(self, order="c"):
        t = self.buf()
        return NDArray._new(_fresh((_rev(t) if order == "f" else t)
                                   .reshape(-1), t))

    def reshape(self, *shape, order="c"):
        if shape and isinstance(shape[0], str):   # reshape('f', ...) form
            order, shape = shape[0], shape[1:]
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        t = self.buf()
        if order == "f":
            return NDArray._new(_fresh(_rev(_rev(t).reshape(-1).reshape(
                shape[::-1])), t))
        return NDArray._new(_fresh(t.reshape(shape), t))

    N.dup = dup
    N.ravel = ravel
    N.reshape = reshape
    N.flatten = lambda self, order="c": N.ravel(self, order)

    # ------------------------------------------------ slice family
    N.slices = lambda self: self.shape[0]  # ref: #slices() — count

    def putSlice(self, i, arr):
        """ref: INDArray#putSlice(int, INDArray)."""
        return self.put(i, arr)

    def vectorAlongDimension(self, i, dim):
        """ref: INDArray#vectorAlongDimension(int, int)."""
        return self.tensorAlongDimension(i, dim)

    def dimShuffle(self, rearrange, new_order=None, broadcastable=None):
        """ref: INDArray#dimShuffle — permute + expand: entries of
        ``rearrange`` are axis indices or 'x' for a new broadcast axis."""
        out_axes = [None if r == "x" else int(r) for r in rearrange]
        t = self.buf()
        out = t.permute([a for a in out_axes if a is not None])
        for j, a in enumerate(out_axes):
            if a is None:
                out = out.unsqueeze(j)
        return NDArray._new(_fresh(out, t))

    N.putSlice = putSlice
    N.vectorAlongDimension = vectorAlongDimension
    N.dimShuffle = dimShuffle

    # ------------------------------------------------ entropy family
    def _entropy(buf, axis):
        p = buf.float()
        return -r_sum(p * torch.log(torch.where(p > 0, p, 1.0)), axis)

    N.entropy = lambda self, *dims: NDArray._new(
        _entropy(self.buf(), dims or None))
    N.shannonEntropy = lambda self, *dims: NDArray._new(
        _entropy(self.buf(), dims or None) / np.log(2.0))
    N.logEntropy = lambda self, *dims: NDArray._new(
        torch.log(torch.clamp_min(_entropy(self.buf(), dims or None),
                                  1e-30)))
    N.shannonEntropyNumber = lambda self: float(
        _entropy(self.buf(), None) / np.log(2.0))
    N.logEntropyNumber = lambda self: float(
        torch.log(torch.clamp_min(_entropy(self.buf(), None), 1e-30)))

    # ------------------------------------------------ put-i vectors
    # ref: INDArray#putiRowVector / #putiColumnVector
    def _puti(row):
        def f(self, v):
            t = self.buf()
            v_ = as_tensor(v, t.device, t.dtype)
            v_ = v_.reshape(1, -1) if row else v_.reshape(-1, 1)
            return self._write(v_.broadcast_to(t.shape))
        return f

    N.putiRowVector = _puti(True)
    N.putiColumnVector = _puti(False)

    # ------------------------------------------------ dup-flag getters
    _getRow, _getColumn = N.getRow, N.getColumn

    N.getRow = lambda self, i, dup=False: (
        _getRow(self, i).dup() if dup else _getRow(self, i))
    N.getColumn = lambda self, i, dup=False: (
        _getColumn(self, i).dup() if dup else _getColumn(self, i))

    # ------------------------------------------------ transpose-i / permute-i
    # ref: INDArray#transposei / #permutei — in-place axis permutes (here a
    # rebind; a view CANNOT rebind its base's shape, matching the
    # reference's "reshape of a view copies" caveat)
    N.transposei = lambda self: self._write_reshaped(_rev(self.buf()))
    N.permutei = lambda self, *axes: self._write_reshaped(
        self.buf().permute(tuple(axes[0]) if len(axes) == 1
                           and isinstance(axes[0], (tuple, list))
                           else axes))

    def _write_reshaped(self, new_buf):
        if self._base is not None:
            raise ValueError(
                "in-place shape change of a view is unsupported "
                "(reference behavior: views must be dup()ed first)")
        self._t = new_buf.clone(memory_format=torch.contiguous_format)
        self._shared = False
        return self

    N._write_reshaped = _write_reshaped

    # ------------------------------------------------ misc long tail
    N.data = lambda self: self.toNumpy().ravel()   # ref: #data() buffer view
    N.element = lambda self: self.buf().reshape(()).item() \
        if self.length() == 1 else _raise(ValueError("not a scalar"))
    N.getNumber = lambda self, *idx: float(self.buf()[tuple(idx)])
    N.stride_of = lambda self, i: self.stride()[i]  # ref: #stride(int)
    N.elementWiseStride = lambda self: 1
    N.linearIndex = lambda self, i: int(i)
    N.isS = lambda self: False                     # no string dtype arrays
    N.isSparse = lambda self: False
    N.isCompressed = lambda self: False
    N.closeable = lambda self: False
    N.wasClosed = lambda self: False
    N.close = lambda self: None
    N.toStringFull = lambda self: repr(self)
    N.dataType = lambda self: self.dtype

    # nearest-neighbor of the JVM's shapeDescriptor diagnostics
    N.shapeDescriptor = lambda self: (
        f"[{','.join(map(str, self.shape))}]:{self.dtype},c,0")

    # ref: #rsubiRowVector etc. (i-variants of the reverse vector family)
    def _rvec_i(row, fn):
        def f(self, v):
            t = self.buf()
            v_ = as_tensor(v, t.device, t.dtype)
            v_ = v_.reshape(1, -1) if row else v_.reshape(-1, 1)
            return self._write(fn(t, v_))
        return f

    N.rsubiRowVector = _rvec_i(True, lambda a, b: b - a)
    N.rsubiColumnVector = _rvec_i(False, lambda a, b: b - a)
    N.rdiviRowVector = _rvec_i(True, lambda a, b: b / a)
    N.rdiviColumnVector = _rvec_i(False, lambda a, b: b / a)

    # ref: #toLongMatrix / #toBoolMatrix (matrix-convert completions)
    N.toLongMatrix = lambda self: self.toNumpy().astype(np.int64).reshape(
        self.shape[0], -1)
    N.toBoolMatrix = lambda self: self.toNumpy().astype(bool).reshape(
        self.shape[0], -1)

    # ref: Broadcast ops exposed on the array (#broadcast(INDArray result))
    def broadcast_to_result(self, result):
        out = self.buf().broadcast_to(result.shape)
        return result._write(cast(out, result.buf().dtype))

    N.broadcastTo = broadcast_to_result


def _raise(e):
    raise e


extend_tranche3()


def extend_tranche3b():
    """Remaining distinct-name completions (ref: INDArray interface)."""
    N = NDArray

    # ref: #convertToFloats / #convertToDoubles / #convertToHalfs
    N.convertToFloats = lambda self: NDArray._new(
        _fresh(self.buf().float(), self.buf()))
    # the reference's f64 array goes through jnp.asarray, which narrows it
    N.convertToDoubles = lambda self: NDArray._new(
        _fresh(self.buf().float(), self.buf()))
    N.convertToHalfs = lambda self: NDArray._new(
        _fresh(self.buf().half(), self.buf()))

    # legacy aliases that are distinct interface members upstream
    N.lengthLong = N.length
    N.scan = N.scan_
    N.isRowVectorOrScalar = lambda self: self.isRowVector() or self.isScalar()
    N.isColumnVectorOrScalar = lambda self: (self.isColumnVector()
                                             or self.isScalar())
    N.equalShapes = lambda self, o: self.shape == tuple(
        as_tensor(o, self.device).shape)

    # ref: the "along dimension into result" overloads' entry points
    N.sumAlongDimension = lambda self, *dims: self.sum(dims or None)
    N.meanAlongDimension = lambda self, *dims: self.mean(dims or None)

    # ref: #getWhere(Number, Condition) overload — comparator scalar
    _getWhere = N.getWhere

    def getWhere(self, comp, cond=None):
        if cond is None and isinstance(comp, tuple):
            comp, cond = None, comp
        if isinstance(cond, str):
            cond = (cond, comp)
        return _getWhere(self, comp, cond)

    N.getWhere = getWhere

    # ref: #mmuli with transpose flag parity
    N.mmuli = lambda self, other, result=None: (
        self._write(N.mmul(self, other).buf()) if result is None
        else result._write(cast(N.mmul(self, other).buf(),
                                result.buf().dtype)))

    # reduce-long accessors
    N.sumLong = lambda self: int(r_sum(self.buf()))
    N.prodLong = lambda self: int(torch.prod(self.buf()))

    # ref: #norm1 along-dimension Number accessor
    N.norm1NumberAlong = lambda self, *dims: NDArray._new(
        r_sum(self.buf().abs(), dims or None))

    # ref: #unsafeDuplication (fast copy without bounds checks — same as dup)
    N.unsafeDuplication = lambda self: self.dup()

    # ref: #repmat (legacy tile-to-shape)
    N.repmat = lambda self, *shape: NDArray._new(_fresh(torch.tile(
        self.buf(), tuple(_as_shape(shape))), self.buf()))

    # ref: #setShapeAndStride / #setOrder — physical-layout controls the
    # reference does not expose: explicit unsupported errors, as there
    def _layout_unsupported(self, *a, **k):
        raise NotImplementedError(
            "physical layout (shape-info strides/order) is not settable; "
            "use reshape/permute")

    N.setShapeAndStride = _layout_unsupported
    N.setOrder = _layout_unsupported


def _as_shape(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return shape


extend_tranche3b()
