"""NDArrayIndex and BooleanIndexing: counterpart of
``deeplearning4j_tpu/ndarray/indexing.py`` (ref:
``org.nd4j.linalg.indexing.NDArrayIndex`` + ``indexing.BooleanIndexing``).

``arr.get(NDArrayIndex.interval(0, 2), NDArrayIndex.all())``: index
objects translate to the Python indexing the NDArray implements (live
views for basic indices, copies for ``indices``).
"""
from __future__ import annotations

import numpy as np
import torch


class _Index:
    """One INDArrayIndex: wraps the equivalent python index object."""

    def __init__(self, py):
        self.py = py

    def __repr__(self):
        return f"NDArrayIndex({self.py!r})"


class NDArrayIndex:
    """Static factory (ref: indexing.NDArrayIndex)."""

    @staticmethod
    def all() -> _Index:
        return _Index(slice(None))

    @staticmethod
    def point(i: int) -> _Index:
        return _Index(int(i))

    @staticmethod
    def interval(*args) -> _Index:
        """ND4J's overloads, in its argument order: ``interval(begin,
        end)``, ``interval(begin, stride, end)``, ``interval(begin,
        stride, end, inclusive)``."""
        if len(args) == 2:
            begin, stride, end, inclusive = args[0], 1, args[1], False
        elif len(args) == 3:
            begin, stride, end = args
            inclusive = False
        elif len(args) == 4:
            begin, stride, end, inclusive = args
        else:
            raise TypeError("interval takes 2-4 arguments "
                            "(begin[, stride], end[, inclusive])")
        end = int(end) + (1 if inclusive else 0)
        return _Index(slice(int(begin), end, int(stride)))

    @staticmethod
    def indices(*idx) -> _Index:
        """Fancy index along one axis (ref: NDArrayIndex.indices)."""
        if len(idx) == 1 and hasattr(idx[0], "__len__"):
            idx = idx[0]
        return _Index(torch.as_tensor(np.asarray(idx, np.int64)))

    @staticmethod
    def newAxis() -> _Index:
        return _Index(None)

    new_axis = newAxis

    @staticmethod
    def empty() -> _Index:
        return _Index(slice(0, 0))


def resolve(idx_tuple):
    """Translate a mixed tuple of _Index / ints / slices to python
    indexing; passthrough when no _Index objects are present."""
    if not isinstance(idx_tuple, tuple):
        idx_tuple = (idx_tuple,)
    if not any(isinstance(i, _Index) for i in idx_tuple):
        return idx_tuple if len(idx_tuple) != 1 else idx_tuple[0]
    out = tuple(i.py if isinstance(i, _Index) else i for i in idx_tuple)
    return out if len(out) != 1 else out[0]


def _mask(arr, cond):
    from deeplearning4j_tpu_torch.ndarray.ndarray import _cond_mask
    return _cond_mask(arr.buf(), cond)


class BooleanIndexing:
    """ref: org.nd4j.linalg.indexing.BooleanIndexing statics."""

    @staticmethod
    def replaceWhere(arr, replacement, cond):
        return arr.replaceWhere(replacement, cond)

    @staticmethod
    def and_(arr, cond) -> bool:
        return bool(torch.all(_mask(arr, cond)))

    @staticmethod
    def or_(arr, cond) -> bool:
        return bool(torch.any(_mask(arr, cond)))

    @staticmethod
    def firstIndex(arr, cond):
        m = _mask(arr, cond).reshape(-1)
        hit = int(torch.argmax(m.to(torch.uint8)))
        return hit if bool(m[hit]) else -1

    @staticmethod
    def lastIndex(arr, cond):
        m = _mask(arr, cond).reshape(-1)
        if not bool(torch.any(m)):
            return -1
        rev = int(torch.argmax(torch.flip(m, (0,)).to(torch.uint8)))
        return m.shape[0] - 1 - rev
