"""INDArray surface, tranche 5: counterpart of
``deeplearning4j_tpu/ndarray/surface5.py`` (ref: ``INDArray`` /
``BaseNDArray``):

- ``cond(Condition)`` / ``condi(Condition)`` — element-wise condition to a
  0/1 array in the array's dtype; the i-variant writes through.
- ``toFlatArray()`` — the reference's portable flat encoding: npy bytes
  (dtype + shape header + row-major data), byte-equal to the reference's.
- ``isInScope()`` — workspace-scope check; a live array is always in scope.
- ``setShape``/``setStride``/``setData`` — the deprecated in-place layout
  mutators: ``setShape`` reshapes (refused on views), ``setStride``
  validates the rank and is otherwise a no-op, ``setData`` replaces the
  contents.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import (
    NDArray, _cond_mask, as_tensor, cast)


def extend_tranche5():
    N = NDArray

    def cond(self, condition):
        """ref: INDArray#cond(Condition) — 1.0 where the condition holds."""
        t = self.buf()
        return NDArray._new(_cond_mask(t, condition).to(t.dtype))

    def condi(self, condition):
        """ref: INDArray#condi(Condition) — in-place form of #cond."""
        t = self.buf()
        return self._write(_cond_mask(t, condition).to(t.dtype))

    N.cond = cond
    N.condi = condi

    def epsi(self, other, eps=1e-5):
        """ref: INDArray#epsi — in-place epsilon-equality (result written
        through as 0/1 in this array's dtype)."""
        t = self.buf()
        mask = torch.abs(t - as_tensor(other, t.device)) < eps
        return self._write(mask.to(t.dtype))

    N.epsi = epsi

    def toFlatArray(self):
        """ref: BaseNDArray#toFlatArray(FlatBufferBuilder) → the serialized
        payload: npy bytes, read back by Nd4j.fromByteArray / numpy.load."""
        from deeplearning4j_tpu_torch.ndarray.factory import toByteArray
        return toByteArray(self)

    N.toFlatArray = toFlatArray

    def isInScope(self):
        """ref: INDArray#isInScope() — no scoped arenas: always in scope."""
        return True

    N.isInScope = isInScope

    def setShape(self, *shape):
        """ref: BaseNDArray#setShape(long...) (deprecated mutator) —
        in-place relayout. Refused on views: the view writes through to a
        fixed-shape slot of its parent (reshape the dup instead)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        if self._base is not None and shape != self.shape:
            raise ValueError(
                "setShape on a view is unsupported: the view writes through "
                "to a fixed-shape slot of its parent; use dup().reshape()")
        return self._write(self.buf().reshape(shape))

    def setStride(self, *stride):
        """ref: BaseNDArray#setStride(long...) (deprecated) — validates the
        rank; the layout is otherwise not settable (a no-op, as in the
        reference)."""
        if len(stride) == 1 and isinstance(stride[0], (tuple, list)):
            stride = tuple(stride[0])
        if len(stride) != len(self.shape):
            raise ValueError(
                f"stride rank {len(stride)} != array rank {len(self.shape)}")
        return self

    def setData(self, data):
        """ref: BaseNDArray#setData(DataBuffer) (deprecated) — replace the
        backing contents, preserving this array's shape."""
        t = self.buf()
        flat = as_tensor(data, t.device).reshape(-1)
        if flat.numel() != int(np.prod(self.shape)):
            raise ValueError(
                f"data length {flat.numel()} != array length "
                f"{int(np.prod(self.shape))}")
        return self._write(cast(flat, t.dtype).reshape(self.shape))

    N.setShape = setShape
    N.setStride = setStride
    N.setData = setData


extend_tranche5()
