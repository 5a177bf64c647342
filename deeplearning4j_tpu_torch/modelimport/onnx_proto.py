"""Zero-dependency ONNX protobuf wire codec (reader and writer): the
port's copy of ``deeplearning4j_tpu/modelimport/onnx_proto.py``.

No ``onnx`` package and no onnxruntime: the module speaks the protobuf
wire format against the frozen field numbers of ``onnx.proto3``
(ModelProto and the messages under it), numpy in and out. Bytes written
by either package's codec parse in the other's.

Reader: ``parse_model(bytes) -> dict`` tree (repeated fields always
lists). Writer: ``make_model/make_graph/make_node/make_tensor/...``, with
which the tests and ``tools/onnx_resnet.py`` author ONNX models.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

# ------------------------------------------------------------------ wire IO
def _uvarint(b: bytes, i: int):
    v = s = 0
    while True:
        x = b[i]
        v |= (x & 0x7F) << s
        i += 1
        if not x & 0x80:
            return v, i
        s += 7


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _enc_uvarint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        x = v & 0x7F
        v >>= 7
        if v:
            out.append(x | 0x80)
        else:
            out.append(x)
            return bytes(out)


# ------------------------------------------------------- schemas (onnx.proto)
# field_no -> (name, kind, repeated, sub_schema)
_T, _F = True, False
TENSOR: Dict[int, tuple] = {
    1: ("dims", "int", _T, None), 2: ("data_type", "int", _F, None),
    4: ("float_data", "float", _T, None), 5: ("int32_data", "int", _T, None),
    6: ("string_data", "bytes", _T, None), 7: ("int64_data", "int", _T, None),
    8: ("name", "string", _F, None), 9: ("raw_data", "bytes", _F, None),
    10: ("double_data", "double", _T, None),
    11: ("uint64_data", "int", _T, None),
}
GRAPH: Dict[int, tuple] = {}   # filled below (recursive via ATTRIBUTE.g)
ATTRIBUTE: Dict[int, tuple] = {
    1: ("name", "string", _F, None), 2: ("f", "float", _F, None),
    3: ("i", "int", _F, None), 4: ("s", "bytes", _F, None),
    5: ("t", "message", _F, TENSOR), 6: ("g", "message", _F, GRAPH),
    7: ("floats", "float", _T, None), 8: ("ints", "int", _T, None),
    9: ("strings", "bytes", _T, None), 10: ("tensors", "message", _T, TENSOR),
    20: ("type", "int", _F, None),
}
NODE = {
    1: ("input", "string", _T, None), 2: ("output", "string", _T, None),
    3: ("name", "string", _F, None), 4: ("op_type", "string", _F, None),
    5: ("attribute", "message", _T, ATTRIBUTE),
    7: ("domain", "string", _F, None),
}
DIM = {1: ("dim_value", "int", _F, None), 2: ("dim_param", "string", _F, None)}
SHAPE = {1: ("dim", "message", _T, DIM)}
TENSOR_TYPE = {1: ("elem_type", "int", _F, None),
               2: ("shape", "message", _F, SHAPE)}
TYPE = {1: ("tensor_type", "message", _F, TENSOR_TYPE)}
VALUE_INFO = {1: ("name", "string", _F, None),
              2: ("type", "message", _F, TYPE)}
GRAPH.update({
    1: ("node", "message", _T, NODE), 2: ("name", "string", _F, None),
    5: ("initializer", "message", _T, TENSOR),
    11: ("input", "message", _T, VALUE_INFO),
    12: ("output", "message", _T, VALUE_INFO),
    13: ("value_info", "message", _T, VALUE_INFO),
})
OPSET = {1: ("domain", "string", _F, None), 2: ("version", "int", _F, None)}
MODEL = {
    1: ("ir_version", "int", _F, None), 2: ("producer_name", "string", _F, None),
    7: ("graph", "message", _F, GRAPH), 8: ("opset_import", "message", _T, OPSET),
}


def _decode(data: bytes, schema: Dict[int, tuple]) -> dict:
    out: dict = {name: [] for name, _, rep, _ in schema.values() if rep}
    i, n = 0, len(data)
    while i < n:
        tag, i = _uvarint(data, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            raw, i = _uvarint(data, i)
        elif wt == 1:
            raw, i = data[i:i + 8], i + 8
        elif wt == 5:
            raw, i = data[i:i + 4], i + 4
        elif wt == 2:
            ln, j = _uvarint(data, i)
            raw, i = data[j:j + ln], j + ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        spec = schema.get(fno)
        if spec is None:
            continue
        name, kind, rep, sub = spec
        if kind == "int":
            if wt == 0:
                vals = [_signed(raw)]
            else:                      # packed
                vals, j = [], 0
                while j < len(raw):
                    v, j = _uvarint(raw, j)
                    vals.append(_signed(v))
        elif kind == "float":
            vals = (list(struct.unpack(f"<{len(raw)//4}f", raw))
                    if wt == 2 else [struct.unpack("<f", raw)[0]])
        elif kind == "double":
            vals = (list(struct.unpack(f"<{len(raw)//8}d", raw))
                    if wt == 2 else [struct.unpack("<d", raw)[0]])
        elif kind == "string":
            vals = [raw.decode("utf-8", "replace")]
        elif kind == "bytes":
            vals = [raw]
        elif kind == "message":
            vals = [_decode(raw, sub)]
        else:  # pragma: no cover
            raise ValueError(kind)
        if rep:
            out[name].extend(vals)
        else:
            out[name] = vals[-1]
    return out


def parse_model(data) -> dict:
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    return _decode(bytes(data), MODEL)


# --------------------------------------------------------------- dtype maps
# onnx TensorProto.DataType enum
_ONNX_DT = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
            6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
            11: np.float64, 12: np.uint32, 13: np.uint64}
_NP_TO_ONNX = {np.dtype(v): k for k, v in _ONNX_DT.items()}


def onnx_dtype(enum: int) -> np.dtype:
    """The numpy dtype of an ONNX element type; bfloat16 (which numpy
    lacks) reads as float32, its values widened exactly."""
    if enum == 16:
        return np.dtype(np.float32)
    if enum not in _ONNX_DT:
        raise ValueError(f"unsupported ONNX dtype enum {enum}")
    return np.dtype(_ONNX_DT[enum])


def tensor_to_np(t: dict) -> np.ndarray:
    enum = t.get("data_type", 1)
    dt = onnx_dtype(enum)
    dims = [int(d) for d in t.get("dims", [])]
    raw = t.get("raw_data")
    if raw and enum == 16:
        bits = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(dims).copy()
    if raw:
        return np.frombuffer(raw, dtype=dt.newbyteorder("<")).reshape(dims) \
            .astype(dt, copy=True)
    for field in ("float_data", "int64_data", "int32_data", "double_data",
                  "uint64_data"):
        vals = t.get(field)
        if vals:
            return np.asarray(vals).astype(dt).reshape(dims)
    return np.zeros(dims, dt)


# ------------------------------------------------------------------- writer
def _field(fno: int, wt: int, payload: bytes) -> bytes:
    head = _enc_uvarint((fno << 3) | wt)
    if wt == 2:
        return head + _enc_uvarint(len(payload)) + payload
    return head + payload


def _s(fno: int, text: str) -> bytes:
    return _field(fno, 2, text.encode())


def _i(fno: int, v: int) -> bytes:
    return _field(fno, 0, _enc_uvarint(v))


def make_tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    enum = _NP_TO_ONNX[arr.dtype]
    out = b"".join(_i(1, d) for d in arr.shape)
    out += _i(2, enum) + _s(8, name)
    out += _field(9, 2, arr.astype(arr.dtype.newbyteorder("<")).tobytes())
    return out


def _attr(name: str, v) -> bytes:
    out = _s(1, name)
    if isinstance(v, bool):
        out += _i(3, int(v)) + _i(20, 2)
    elif isinstance(v, int):
        out += _i(3, v) + _i(20, 2)
    elif isinstance(v, float):
        out += _field(2, 5, struct.pack("<f", v)) + _i(20, 1)
    elif isinstance(v, str):
        out += _field(4, 2, v.encode()) + _i(20, 3)
    elif isinstance(v, np.ndarray):
        out += _field(5, 2, make_tensor("", v)) + _i(20, 4)
    elif isinstance(v, bytes):              # serialized GraphProto (If/Loop)
        out += _field(6, 2, v) + _i(20, 5)
    elif isinstance(v, (list, tuple)) and all(isinstance(x, int) for x in v):
        out += b"".join(_i(8, x) for x in v) + _i(20, 7)
    elif isinstance(v, (list, tuple)):
        out += b"".join(_field(7, 5, struct.pack("<f", float(x))) for x in v) \
            + _i(20, 6)
    else:  # pragma: no cover
        raise TypeError(f"attr {name}: {type(v)}")
    return out


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs) -> bytes:
    out = b"".join(_s(1, x) for x in inputs)
    out += b"".join(_s(2, x) for x in outputs)
    out += _s(3, name or f"{op_type}_{outputs[0]}") + _s(4, op_type)
    out += b"".join(_field(5, 2, _attr(k, v)) for k, v in attrs.items())
    return out


def make_value_info(name: str, dtype, shape: Sequence[Optional[int]]) -> bytes:
    dims = b""
    for d in shape:
        dims += _field(1, 2, _s(2, "N") if d is None else _i(1, int(d)))
    tt = _i(1, _NP_TO_ONNX[np.dtype(dtype)]) + _field(2, 2, dims)
    return _s(1, name) + _field(2, 2, _field(1, 2, tt))


def make_graph(nodes: Sequence[bytes], name: str,
               inputs: Sequence[bytes], outputs: Sequence[bytes],
               initializers: Sequence[bytes] = ()) -> bytes:
    out = b"".join(_field(1, 2, n) for n in nodes)
    out += _s(2, name)
    out += b"".join(_field(5, 2, t) for t in initializers)
    out += b"".join(_field(11, 2, vi) for vi in inputs)
    out += b"".join(_field(12, 2, vi) for vi in outputs)
    return out


def make_model(graph: bytes, opset: int = 17) -> bytes:
    return (_i(1, 8)                              # ir_version 8
            + _s(2, "deeplearning4j_tpu_torch")
            + _field(7, 2, graph)
            + _field(8, 2, _s(1, "") + _i(2, opset)))
