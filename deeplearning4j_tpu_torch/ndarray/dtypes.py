"""Data types of the port's NDArray: counterpart of
``deeplearning4j_tpu/ndarray/dtypes.py`` (ref: ND4J's
``org.nd4j.linalg.api.buffer.DataType``).

An NDArray reports its type as the JAX package's arrays do: a numpy dtype
(``np.dtype("float32")``), or, for bfloat16, which numpy lacks, the
:data:`BFLOAT16` object, whose ``str`` and ``name`` are ``"bfloat16"``.
The names, the ordinals of the packed shape-info descriptor and
:func:`resolve` are the reference's, bit for bit.

The reference runs with 64-bit types off: an array asked to be float64 or
int64 is made float32 or int32, with a UserWarning when the type was
asked for by name (:func:`storage`).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

_TORCH_BY_NAME = {
    "bool": torch.bool, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}
_NAME_OF_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}
# 64-bit types off: what each type becomes
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def canonical(dtype: torch.dtype) -> torch.dtype:
    """The type the reference holds a ``dtype`` array in."""
    return _NARROW.get(dtype, dtype)


class _BFloat16:
    """numpy has no bfloat16: this stands for it where a numpy dtype
    stands for every other type."""

    name = "bfloat16"
    itemsize = 2
    kind = "V"
    char = "E"

    def __str__(self):
        return "bfloat16"

    def __repr__(self):
        return "dtype(bfloat16)"

    def __eq__(self, other):
        if isinstance(other, _BFloat16) or other is torch.bfloat16:
            return True
        return isinstance(other, str) and other.lower() in ("bfloat16",
                                                            "bf16")

    def __hash__(self):
        return hash("bfloat16")


BFLOAT16 = _BFloat16()

# canonical names, lowercase — ``DataType.FLOAT`` in the reference == float32
DOUBLE = np.dtype(np.float64)
FLOAT = np.dtype(np.float32)
HALF = np.dtype(np.float16)
LONG = np.dtype(np.int64)
INT = np.dtype(np.int32)
SHORT = np.dtype(np.int16)
BYTE = np.dtype(np.int8)
UBYTE = np.dtype(np.uint8)
UINT16 = np.dtype(np.uint16)
UINT32 = np.dtype(np.uint32)
UINT64 = np.dtype(np.uint64)
BOOL = np.dtype(np.bool_)

_NAME_TO_DTYPE = {
    "double": DOUBLE, "float64": DOUBLE,
    "float": FLOAT, "float32": FLOAT,
    "half": HALF, "float16": HALF,
    "bfloat16": BFLOAT16, "bf16": BFLOAT16,
    "long": LONG, "int64": LONG,
    "int": INT, "int32": INT,
    "short": SHORT, "int16": SHORT,
    "byte": BYTE, "int8": BYTE,
    "ubyte": UBYTE, "uint8": UBYTE,
    "uint16": UINT16, "uint32": UINT32, "uint64": UINT64,
    "bool": BOOL,
}

FLOATING_DTYPES = (DOUBLE, FLOAT, HALF, BFLOAT16)

# stable ordinals for the packed shape-info descriptor (the reference's
# own table, by type name)
_ORDINALS = {
    "float64": 1, "float32": 2, "float16": 3, "bfloat16": 4,
    "int64": 5, "int32": 6, "int16": 7, "int8": 8,
    "uint8": 9, "uint16": 10, "uint32": 11, "uint64": 12,
    "bool": 13,
}


def type_ordinal(dtype) -> int:
    """Ordinal for ``dtype`` in shape-info descriptors; distinct dtypes get
    distinct ordinals so descriptor comparison implies dtype equality."""
    return _ORDINALS[str(resolve(dtype))]


def resolve(dtype):
    """Accept a string name, numpy or torch dtype, :data:`BFLOAT16`, or a
    Python type; return the NDArray-facing dtype (None for None)."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        key = dtype.lower()
        if key not in _NAME_TO_DTYPE:
            raise ValueError(f"Unknown dtype name: {dtype!r}")
        return _NAME_TO_DTYPE[key]
    if dtype is float:
        return FLOAT
    if dtype is int:
        return INT
    if dtype is bool:
        return BOOL
    if isinstance(dtype, _BFloat16) or dtype is torch.bfloat16 \
            or str(dtype) == "bfloat16":
        return BFLOAT16
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NAME_OF_TORCH[dtype])
    return np.dtype(dtype)


def is_floating(dtype) -> bool:
    dt = resolve(dtype)
    return dt is BFLOAT16 or np.issubdtype(dt, np.floating)


def to_torch(dtype) -> torch.dtype:
    """The torch dtype that stores ``dtype``, 64-bit types not narrowed."""
    return _TORCH_BY_NAME[str(resolve(dtype))]


def from_torch(dtype: torch.dtype):
    """The NDArray-facing dtype of a torch dtype."""
    return BFLOAT16 if dtype == torch.bfloat16 else np.dtype(
        _NAME_OF_TORCH[dtype])


def storage(dtype) -> torch.dtype:
    """The torch dtype an array asked to be ``dtype`` is made in: 64-bit
    types narrowed as the reference narrows them, with its UserWarning."""
    want = to_torch(dtype)
    got = canonical(want)
    if got != want:
        warnings.warn(
            f"Explicitly requested dtype {_NAME_OF_TORCH[want]} is not "
            f"available, and will be truncated to dtype "
            f"{_NAME_OF_TORCH[got]} (the reference runs with 64-bit types "
            f"off)", UserWarning, stacklevel=3)
    return got
