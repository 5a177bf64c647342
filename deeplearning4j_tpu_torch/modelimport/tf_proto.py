"""TensorFlow ``GraphDef`` protobuf messages, read and written without TF.

The JAX package parses a GraphDef with the tensorflow package's generated
proto classes; the card's machine has no TF and no protobuf. This module
is a protobuf wire reader and writer for the messages the importer reads
(``GraphDef``, ``NodeDef``, ``AttrValue`` and its ``ListValue``,
``TensorProto``, ``TensorShapeProto``, ``NameAttrList``,
``FunctionDefLibrary``, ``FunctionDef`` and its ``OpDef`` signature).
Its objects carry the fields, ``WhichOneof`` / ``HasField`` and map
access that ``tfimport._parse_attrs`` and ``_tensor_to_ndarray`` read, as
the generated classes do. Fields it does not model are kept as raw bytes
and written back unchanged, so parse-then-serialize keeps a graph whole.

``parse_graph_def(data)`` reads serialized bytes; ``GraphDef.
SerializeToString()`` writes them (the skeleton tool and the tests use
it).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# scalar kinds: (wire type, packable)
_VARINT = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_FIXED32 = {"float"}
_FIXED64 = {"double"}


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int):
    value &= (1 << 64) - 1
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def _signed(v: int, kind: str) -> int:
    if kind in ("int32", "int64", "enum") and v >= 1 << 63:
        return v - (1 << 64)
    return v


def _scalar_from_varint(v: int, kind: str):
    if kind == "bool":
        return bool(v)
    return _signed(v, kind)


class AttrMap(dict):
    """A proto map of AttrValue: a missing key reads as a default
    AttrValue (not inserted), as a generated message's map does."""

    def __missing__(self, key):
        return AttrValue()


class _Message:
    """Base of the messages: ``FIELDS`` maps a field number to (name,
    kind, repeated), kind a scalar kind, "string", "bytes", a message
    class, or ("map", value kind or class)."""

    FIELDS: Dict[int, tuple] = {}
    ONEOF: Tuple[str, ...] = ()     # names of the "value" oneof, if any

    def __init__(self, **kw):
        self._unknown: List[Tuple[int, int, bytes]] = []
        self._present = set()
        self._which = None
        for _no, (name, kind, rep) in self.FIELDS.items():
            if isinstance(kind, tuple):
                val = AttrMap() if kind[1] is AttrValue else {}
            elif rep:
                val = []
            elif isinstance(kind, type):
                val = kind()
            else:
                val = _DEFAULTS[kind]
            object.__setattr__(self, name, val)
        for k, v in kw.items():
            setattr(self, k, v)

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if not name.startswith("_"):
            self._present.add(name)
            if name in self.ONEOF:
                self._which = name

    # -- the generated classes' API the importers read ------------------
    def HasField(self, name: str) -> bool:
        if name in self.ONEOF:
            return self._which == name
        return name in self._present

    def WhichOneof(self, group: str) -> Optional[str]:
        return self._which

    def CopyFrom(self, other: "_Message"):
        clone = type(other).FromString(other.SerializeToString())
        self.__dict__.clear()
        self.__dict__.update(clone.__dict__)

    # -- wire format -----------------------------------------------------
    @classmethod
    def FromString(cls, data) -> "_Message":
        buf = memoryview(data) if not isinstance(data, memoryview) else data
        return cls._parse(buf, 0, len(buf))

    @classmethod
    def _parse(cls, buf, pos: int, end: int) -> "_Message":
        msg = cls()
        fields = cls.FIELDS
        while pos < end:
            key, pos = _read_varint(buf, pos)
            no, wt = key >> 3, key & 7
            start = pos
            if wt == 0:
                v, pos = _read_varint(buf, pos)
            elif wt == 1:
                pos += 8
            elif wt == 5:
                pos += 4
            elif wt == 2:
                n, pos = _read_varint(buf, pos)
                start = pos
                pos += n
            else:
                raise ValueError(f"unsupported wire type {wt} in "
                                 f"{cls.__name__}")
            spec = fields.get(no)
            if spec is None:
                msg._unknown.append((no, wt, bytes(buf[start:pos])))
                continue
            name, kind, rep = spec
            if isinstance(kind, tuple):                 # a map entry
                k, val = _parse_map_entry(buf, start, pos, kind[1])
                getattr(msg, name)[k] = val
                msg._present.add(name)
                continue
            if rep and wt == 2 and kind in _PACKED:
                getattr(msg, name).extend(_unpack(buf, start, pos, kind))
                msg._present.add(name)
                continue
            if wt == 0:
                val = _scalar_from_varint(v, kind)
            elif wt == 5:
                val = struct.unpack_from("<f", buf, start)[0] \
                    if kind == "float" else \
                    struct.unpack_from("<I", buf, start)[0]
            elif wt == 1:
                val = struct.unpack_from("<d", buf, start)[0] \
                    if kind == "double" else \
                    struct.unpack_from("<Q", buf, start)[0]
            elif kind == "string":
                val = bytes(buf[start:pos]).decode("utf-8")
            elif kind == "bytes":
                val = bytes(buf[start:pos])
            else:
                val = kind._parse(buf, start, pos)
            if rep:
                getattr(msg, name).append(val)
                msg._present.add(name)
            else:
                setattr(msg, name, val)
        return msg

    def SerializeToString(self) -> bytes:
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _write(self, out: bytearray):
        items = sorted(self.FIELDS.items())
        unknown = sorted(self._unknown, key=lambda u: u[0])
        ui = 0
        for no, (name, kind, rep) in items:
            while ui < len(unknown) and unknown[ui][0] < no:
                _write_raw(out, *unknown[ui])
                ui += 1
            val = getattr(self, name)
            if isinstance(kind, tuple):
                for k in sorted(val):
                    entry = bytearray()
                    _write_field(entry, 1, "string", k)
                    _write_field(entry, 2, kind[1], val[k], force=True)
                    _write_len(out, no, entry)
                continue
            if rep:
                if not val:
                    continue
                if kind in _PACKED:
                    _write_len(out, no, _pack(val, kind))
                else:
                    for v in val:
                        _write_field(out, no, kind, v, force=True)
                continue
            if self.ONEOF and name in self.ONEOF:
                if self._which == name:
                    _write_field(out, no, kind, val, force=True)
                continue
            if isinstance(kind, type) and name not in self._present:
                continue
            _write_field(out, no, kind, val)
        for u in unknown[ui:]:
            _write_raw(out, *u)


_DEFAULTS = {"int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "bool": False,
             "enum": 0, "float": 0.0, "double": 0.0, "string": "",
             "bytes": b""}
_PACKED = _VARINT | _FIXED32 | _FIXED64


def _unpack(buf, start, end, kind) -> list:
    raw = bytes(buf[start:end])
    if kind == "float":
        return np.frombuffer(raw, "<f4").astype(float).tolist()
    if kind == "double":
        return np.frombuffer(raw, "<f8").tolist()
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(_scalar_from_varint(v, kind))
    return out


def _pack(vals, kind) -> bytes:
    if kind == "float":
        return np.asarray(vals, "<f4").tobytes()
    if kind == "double":
        return np.asarray(vals, "<f8").tobytes()
    out = bytearray()
    for v in vals:
        _write_varint(out, int(v))
    return bytes(out)


def _parse_map_entry(buf, start, end, vkind):
    key, val = "", None
    pos = start
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        no, wt = tag >> 3, tag & 7
        if wt != 2:
            raise ValueError("unexpected map entry wire type")
        n, pos = _read_varint(buf, pos)
        if no == 1:
            key = bytes(buf[pos:pos + n]).decode("utf-8")
        elif no == 2:
            val = bytes(buf[pos:pos + n]).decode("utf-8") \
                if vkind == "string" else vkind._parse(buf, pos, pos + n)
        pos += n
    if val is None:
        val = "" if vkind == "string" else vkind()
    return key, val


def _write_len(out: bytearray, no: int, payload):
    _write_varint(out, (no << 3) | 2)
    _write_varint(out, len(payload))
    out += payload


def _write_raw(out: bytearray, no: int, wt: int, raw: bytes):
    _write_varint(out, (no << 3) | wt)
    if wt == 2:
        _write_varint(out, len(raw))
    out += raw


def _write_field(out: bytearray, no: int, kind, val, force=False):
    if isinstance(kind, type):
        _write_len(out, no, val.SerializeToString())
        return
    if not force and val == _DEFAULTS[kind]:
        return
    if kind in _VARINT:
        _write_varint(out, no << 3)
        _write_varint(out, int(val))
    elif kind == "float":
        _write_varint(out, (no << 3) | 5)
        out += struct.pack("<f", val)
    elif kind == "double":
        _write_varint(out, (no << 3) | 1)
        out += struct.pack("<d", val)
    elif kind == "string":
        _write_len(out, no, val.encode("utf-8"))
    else:
        _write_len(out, no, bytes(val))


# ------------------------------------------------------------ the messages
class Dim(_Message):
    FIELDS = {1: ("size", "int64", False), 2: ("name", "string", False)}


class TensorShapeProto(_Message):
    FIELDS = {2: ("dim", Dim, True), 3: ("unknown_rank", "bool", False)}


class TensorProto(_Message):
    FIELDS = {1: ("dtype", "enum", False),
              2: ("tensor_shape", TensorShapeProto, False),
              3: ("version_number", "int32", False),
              4: ("tensor_content", "bytes", False),
              5: ("float_val", "float", True),
              6: ("double_val", "double", True),
              7: ("int_val", "int32", True),
              8: ("string_val", "bytes", True),
              10: ("int64_val", "int64", True),
              11: ("bool_val", "bool", True),
              13: ("half_val", "int32", True),
              16: ("uint32_val", "uint32", True),
              17: ("uint64_val", "uint64", True)}


class NameAttrList(_Message):
    pass


class ListValue(_Message):
    pass


class AttrValue(_Message):
    ONEOF = ("list", "s", "i", "f", "b", "type", "shape", "tensor",
             "placeholder", "func")


ListValue.FIELDS = {2: ("s", "bytes", True), 3: ("i", "int64", True),
                    4: ("f", "float", True), 5: ("b", "bool", True),
                    6: ("type", "enum", True),
                    7: ("shape", TensorShapeProto, True),
                    8: ("tensor", TensorProto, True),
                    9: ("func", NameAttrList, True)}
AttrValue.FIELDS = {1: ("list", ListValue, False), 2: ("s", "bytes", False),
                    3: ("i", "int64", False), 4: ("f", "float", False),
                    5: ("b", "bool", False), 6: ("type", "enum", False),
                    7: ("shape", TensorShapeProto, False),
                    8: ("tensor", TensorProto, False),
                    9: ("placeholder", "string", False),
                    10: ("func", NameAttrList, False)}
NameAttrList.FIELDS = {1: ("name", "string", False),
                       2: ("attr", ("map", AttrValue), False)}


class NodeDef(_Message):
    FIELDS = {1: ("name", "string", False), 2: ("op", "string", False),
              3: ("input", "string", True), 4: ("device", "string", False),
              5: ("attr", ("map", AttrValue), False)}


class ArgDef(_Message):
    FIELDS = {1: ("name", "string", False),
              2: ("description", "string", False),
              3: ("type", "enum", False), 4: ("type_attr", "string", False),
              5: ("number_attr", "string", False),
              6: ("type_list_attr", "string", False),
              16: ("is_ref", "bool", False)}


class OpDef(_Message):
    FIELDS = {1: ("name", "string", False),
              2: ("input_arg", ArgDef, True),
              3: ("output_arg", ArgDef, True),
              20: ("control_output", "string", True)}


class FunctionDef(_Message):
    FIELDS = {1: ("signature", OpDef, False),
              3: ("node_def", NodeDef, True),
              4: ("ret", ("map", "string"), False),
              5: ("attr", ("map", AttrValue), False),
              6: ("control_ret", ("map", "string"), False)}


class FunctionDefLibrary(_Message):
    FIELDS = {1: ("function", FunctionDef, True)}


class GraphDef(_Message):
    FIELDS = {1: ("node", NodeDef, True),
              2: ("library", FunctionDefLibrary, False),
              3: ("version", "int32", False)}


def parse_graph_def(data) -> GraphDef:
    """A GraphDef from its serialized bytes."""
    return GraphDef.FromString(data)


def read_graph_def(path: str) -> GraphDef:
    """A GraphDef from a file of serialized bytes; ``.gz`` is gunzipped."""
    if str(path).endswith(".gz"):
        import gzip
        with gzip.open(path, "rb") as f:
            return parse_graph_def(f.read())
    with open(path, "rb") as f:
        return parse_graph_def(f.read())
