"""INDArray surface, tranche 4: counterpart of
``deeplearning4j_tpu/ndarray/surface4.py`` (ref: ``INDArray`` /
``BaseNDArray``):

- shape-info/layout descriptors (``shapeInfo``/``shapeInfoDataBuffer``/
  stride accessors). The reference synthesizes C-order strides from the
  logical shape, so the column view ``getColumn(0)`` of a (2, 2) array
  reports ``(1,)``; the torch view under it has stride ``(2,)``. These
  report the reference's values, never the tensor's.
- the deprecated-era linear-view accessors (``linearView``/``majorStride``…)
- unsafe flat-offset accessors (``putScalarUnsafe``/``getDoubleUnsafe``)
- the sparse-protocol surface on dense arrays (``toDense``/``nnz``/
  ``getVectorCoordinates``; format-specific accessors raise, as
  ``BaseNDArray`` throws for dense inputs)
- explicit ``*AlongDimension`` reduction entry points and the remaining
  Number accessors
- list/compat helpers (``sliceVectors``, ``checkDimensions``,
  ``javaTensorAlongDimension``, ``tensorssAlongDimension``,
  ``leverageOrDetach``)
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.ndarray import (
    NDArray, as_tensor, cast, r_cumsum, r_max, r_min, r_prod, r_std, r_sum,
    r_var)


def extend_tranche4():
    N = NDArray

    # ------------------------------------------------- shape-info family
    def shapeInfo(self):
        """ref: INDArray#shapeInfo — human-readable shape descriptor."""
        return (f"Rank: {self.rank()}, Offset: 0, Order: c, "
                f"shape: {list(self.shape)}, stride: {list(self.stride())}")

    def shapeInfoDataBuffer(self):
        """ref: INDArray#shapeInfoDataBuffer — the packed shape-info vector
        [rank, shape..., stride..., dtypeOrdinal, elementWiseStride,
        orderChar], synthesized from the logical shape."""
        return np.asarray([self.rank(), *self.shape, *self.stride(),
                           _dt.type_ordinal(self.dtype),
                           self.elementWiseStride(), ord("c")], np.int64)

    N.shapeInfo = shapeInfo
    N.shapeInfoDataBuffer = shapeInfoDataBuffer
    N.shapeInfoJava = lambda self: [int(v) for v in
                                    self.shapeInfoDataBuffer()]
    N.jvmShapeInfo = lambda self: tuple(self.shapeInfoJava())
    N.getTrailingOnes = lambda self: next(
        (i for i, s in enumerate(reversed(self.shape)) if s != 1),
        len(self.shape))
    N.getLeadingOnes = lambda self: next(
        (i for i, s in enumerate(self.shape) if s != 1), len(self.shape))
    N.underlyingRank = lambda self: self.rank()
    N.originalOffset = lambda self: 0

    # deprecated-era stride accessors (row-major logical strides)
    N.majorStride = lambda self: self.stride()[0] if self.rank() else 1
    N.secondaryStride = lambda self: (self.stride()[1] if self.rank() > 1
                                      else 1)
    N.innerMostStride = lambda self: self.stride()[-1] if self.rank() else 1
    # ref: #linearView / #linearViewColumnOrder / #resetLinearView
    N.linearView = lambda self: self.ravel()
    N.linearViewColumnOrder = lambda self: self.ravel("f")
    N.resetLinearView = lambda self: self
    N.isView = N.is_view                       # reference spelling
    N.isWrapAround = lambda self: False

    # ref: #markAsCompressed(boolean) — compression is codec-level, not a
    # buffer state; accepted as a no-op
    N.markAsCompressed = lambda self, flag=True: self

    # -------------------------------------------------- unsafe accessors
    # ref: #putScalarUnsafe(long offset, double) / #getDoubleUnsafe(long)
    def putScalarUnsafe(self, offset, value):
        flat = self.buf().reshape(-1).clone()
        flat[int(offset)] = value
        return self._write(flat.reshape(self.shape))

    N.putScalarUnsafe = putScalarUnsafe
    N.getDoubleUnsafe = lambda self, offset: float(
        self.buf().reshape(-1)[int(offset)])

    # ------------------------------------------------ sparse protocol
    # ref: BaseNDArray#toDense (identity for dense), #nnz,
    # #getVectorCoordinates; format-specific accessors throw for dense
    N.toDense = lambda self: self
    N.nnz = lambda self: int(r_sum(self.buf() != 0))

    def getVectorCoordinates(self):
        # the reference's int64 coordinates go through jnp.asarray: int32
        flat = self.buf().reshape(-1)
        return NDArray._new(torch.nonzero(flat).reshape(-1)
                            .to(torch.int32))

    N.getVectorCoordinates = getVectorCoordinates

    def _dense_only(self, *a, **k):
        raise NotImplementedError(
            "not a sparse ndarray (ref: BaseNDArray throws "
            "UnsupportedOperationException for dense inputs)")

    N.sparseInfoDataBuffer = _dense_only

    # ----------------------------------- along-dimension reduction family
    def _along(fn):
        def f(self, *dims):
            return NDArray._new(fn(self.buf(), dims or None))
        return f

    N.maxAlongDimension = _along(r_max)
    N.minAlongDimension = _along(r_min)
    N.prodAlongDimension = _along(r_prod)
    N.stdAlongDimension = _along(lambda a, ax: r_std(a, ax, ddof=1))
    N.varAlongDimension = _along(lambda a, ax: r_var(a, ax, ddof=1))
    N.norm1AlongDimension = _along(lambda a, ax: r_sum(a.abs(), ax))
    N.norm2AlongDimension = _along(
        lambda a, ax: torch.sqrt(r_sum(torch.square(a), ax)))
    N.normmaxAlongDimension = _along(lambda a, ax: r_max(a.abs(), ax))
    N.cumsumAlongDimension = lambda self, dim: NDArray._new(
        r_cumsum(self.buf(), dim))
    N.norm2NumberAlong = lambda self, *dims: NDArray._new(
        torch.sqrt(r_sum(torch.square(self.buf()), dims or None)))
    N.normmaxNumberAlong = lambda self, *dims: NDArray._new(
        r_max(self.buf().abs(), dims or None))
    N.asumNumber = lambda self: float(r_sum(self.buf().abs()))

    # ------------------------------------------------------ compat helpers
    N.javaTensorAlongDimension = lambda self, i, *dims: \
        self.tensorAlongDimension(i, *dims)
    # the deprecated double-s spelling the reference kept for binary compat
    N.tensorssAlongDimension = lambda self, *dims: \
        self.tensorsAlongDimension(*dims)

    def sliceVectors(self, out=None):
        """ref: #sliceVectors(List<INDArray>) — appends this array's row
        vectors to ``out`` (returned; created when omitted). Rows are
        write-through views, as in the reference."""
        if out is None:
            out = []
        if self.rank() <= 1:
            out.append(self)
        else:
            for i in range(self.shape[0]):
                out.append(self[i])
        return out

    N.sliceVectors = sliceVectors

    def checkDimensions(self, other):
        """ref: #checkDimensions(INDArray) — assert shape compatibility."""
        o = as_tensor(other, self.device)
        if tuple(o.shape) != self.shape:
            raise ValueError(
                f"shape mismatch: {self.shape} vs {tuple(o.shape)}")
        return self

    N.checkDimensions = checkDimensions
    # ref: #leverageOrDetach(String) — no workspaces
    N.leverageOrDetach = lambda self, ws_id=None: self

    def getString(self, i):
        """ref: #getString(long) — utf8 arrays only; numeric arrays throw,
        matching the reference."""
        raise TypeError("getString is defined for utf8 arrays only "
                        f"(dtype={self.dtype})")

    N.getString = getString

    # sum/mean: widen with the #sum(INDArray result, int... dim) overload
    # (result written in place and returned)
    def _result_reduce(base):
        def f(self, *args, **kw):
            if args and isinstance(args[0], NDArray):
                result, *dims = args
                out = base(self, tuple(dims) or None, **kw)
                return result._write(cast(out.buf(), result.buf().dtype))
            return base(self, *args, **kw)
        return f

    N.sum = _result_reduce(N.sum)
    N.mean = _result_reduce(N.mean)

    # scalar accessors: the reference's single-``long`` overloads index
    # LINEARLY on multi-dim arrays; the multi-index overloads index by
    # coordinate
    def _linear_get(cast):
        def f(self, *idx):
            b = self.buf()
            if not idx:
                return cast(b)
            if len(idx) == 1 and not isinstance(idx[0], (tuple, list)) \
                    and b.dim() > 1:
                return cast(b.reshape(-1)[int(idx[0])])
            if len(idx) == 1 and isinstance(idx[0], (tuple, list)):
                idx = tuple(idx[0])
            return cast(b[tuple(int(i) for i in idx)])
        return f

    N.getDouble = _linear_get(float)
    N.getFloat = _linear_get(float)
    N.getInt = _linear_get(int)
    N.getLong = _linear_get(int)
    N.getNumber = _linear_get(float)

    # putScalar: the (long, double) linear form, the (long[], v)
    # coordinate form, and the flattened (i, j, ..., v) varargs overloads
    def putScalar(self, *args):
        *idx, value = args
        if len(idx) == 1 and isinstance(idx[0], (tuple, list, np.ndarray)):
            idx = tuple(int(i) for i in idx[0])
        else:
            idx = tuple(int(i) for i in idx)
        b = self.buf()
        if len(idx) == 1 and b.dim() > 1:     # linear overload
            return putScalarUnsafe(self, idx[0], value)
        self[idx] = value
        return self

    N.putScalar = putScalar

    # stride(): the no-arg form and the #stride(int dim) overload
    _stride_all = N.stride

    def stride(self, dim=None):
        s = _stride_all(self)
        return s if dim is None else s[dim]

    N.stride = stride

    # broadcast(): widen with the #broadcast(INDArray result) overload
    _broadcast_shape = N.broadcast

    def broadcast(self, *arg):
        if len(arg) == 1 and isinstance(arg[0], NDArray):
            result = arg[0]
            return result._write(cast(self.buf().broadcast_to(
                result.shape), result.buf().dtype))
        return _broadcast_shape(self, *arg)

    N.broadcast = broadcast


extend_tranche4()
