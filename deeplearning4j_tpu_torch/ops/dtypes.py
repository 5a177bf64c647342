"""Dtypes as the JAX package sees them: names, numpy and torch types, and
its 64-bit rule.

The JAX package runs with 64-bit types off: an f64 or int64 array it is
handed becomes f32 or int32. The graph engine and its ops follow that
rule at their boundary (:func:`canonical`, :func:`as_tensor`), so a graph
computes in the types the reference's graph computes in.
"""
from __future__ import annotations

import numpy as np
import torch

_BY_NAME = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}

# 64-bit types off: what each type becomes
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def name_of(dtype) -> str:
    """The numpy-style name of a torch, numpy or named dtype."""
    return _NAME_OF[to_torch(dtype, narrow=False)]


def to_torch(dtype, narrow: bool = True) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or type, or name;
    64-bit types narrowed as the JAX package narrows them unless
    ``narrow`` is false."""
    if isinstance(dtype, torch.dtype):
        dt = dtype
    else:
        if isinstance(dtype, str):
            key = dtype
        elif getattr(dtype, "name", None) == "bfloat16" or \
                str(dtype) == "bfloat16":
            key = "bfloat16"
        else:
            key = np.dtype(dtype).name
        if key not in _BY_NAME:
            key = np.dtype(key).name
        dt = _BY_NAME[key]
    return _NARROW.get(dt, dt) if narrow else dt


def canonical(dtype: torch.dtype) -> torch.dtype:
    return _NARROW.get(dtype, dtype)


def to_numpy_dtype(dtype: torch.dtype):
    """The numpy dtype of a torch dtype (bfloat16 has none: raises)."""
    if dtype == torch.bfloat16:
        raise TypeError("numpy has no bfloat16")
    return np.dtype(_NAME_OF[dtype])


def as_tensor(value, device=None, dtype=None) -> torch.Tensor:
    """``jnp.asarray(value[, dtype])`` with 64-bit types off, on
    ``device``. A Python float becomes f32, an int int32, a bool bool; a
    numpy array is copied, a tensor passes through (moved or cast if
    asked)."""
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.asarray(value)
        if arr.dtype == object:
            raise TypeError(f"cannot make a tensor of {value!r}")
        # a copy: the graph's value must not alias the caller's array
        t = torch.from_numpy(np.array(arr))
    want = to_torch(dtype) if dtype is not None else canonical(t.dtype)
    if device is not None and t.device != torch.device(device):
        return t.to(device=device, dtype=want)
    return t if t.dtype == want else t.to(want)
