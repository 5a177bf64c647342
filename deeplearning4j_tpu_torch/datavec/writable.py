"""Writable value types (ref: org.datavec.api.writable.*, SURVEY E1).

The reference's Writables exist for Hadoop serialization; here they are thin
typed boxes so TransformProcess semantics (type checks, conversions) match.
Plain Python ints/floats/strs are accepted anywhere a Writable is and are
boxed on entry.
"""
from __future__ import annotations

import numpy as np


class Writable:
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def to_double(self) -> float:
        return float(self.value)

    def to_int(self) -> int:
        return int(self.value)

    def to_string(self) -> str:
        return str(self.value)

    toDouble, toInt, toString = to_double, to_int, to_string

    def __repr__(self):
        return f"{type(self).__name__}({self.value!r})"

    def __eq__(self, other):
        return (type(self) is type(other) and self.value == other.value) or \
            (not isinstance(other, Writable) and self.value == other)

    def __hash__(self):
        return hash(self.value)


class IntWritable(Writable):
    def __init__(self, value):
        super().__init__(int(value))


class LongWritable(IntWritable):
    pass


class FloatWritable(Writable):
    def __init__(self, value):
        super().__init__(float(value))


class DoubleWritable(FloatWritable):
    pass


class BooleanWritable(Writable):
    def __init__(self, value):
        super().__init__(bool(value))


class Text(Writable):
    def __init__(self, value):
        super().__init__(str(value))

    def to_double(self):
        return float(self.value)


class NDArrayWritable(Writable):
    def __init__(self, value):
        super().__init__(np.asarray(value))

    def to_double(self):
        raise TypeError("NDArrayWritable is not scalar")

    def __eq__(self, other):
        return isinstance(other, NDArrayWritable) and \
            np.array_equal(self.value, other.value)

    def __hash__(self):
        return id(self)


def box(v) -> Writable:
    """Box a raw Python value into the matching Writable."""
    if isinstance(v, Writable):
        return v
    if isinstance(v, bool):
        return BooleanWritable(v)
    if isinstance(v, (int, np.integer)):
        return IntWritable(v)
    if isinstance(v, (float, np.floating)):
        return DoubleWritable(v)
    if isinstance(v, np.ndarray):
        return NDArrayWritable(v)
    return Text(v)


def unbox(w):
    return w.value if isinstance(w, Writable) else w
