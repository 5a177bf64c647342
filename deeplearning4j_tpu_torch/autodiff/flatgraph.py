"""SameDiff's FlatBuffers ``FlatGraph`` files: counterpart of
``deeplearning4j_tpu/autodiff/flatgraph.py`` (ref: ``SameDiff#asFlatBuffers``
and ``libnd4j/include/graph/scheme/*.fbs``).

The reference writes and reads through the ``flatbuffers`` package; the
port carries its own small FlatBuffers writer and reader (numpy in and
out), with the same table slots, so a file written by either package
loads in the other:

- ``FlatGraph``: id, variables:[FlatVariable], nodes:[FlatNode],
  outputs:[IntPair], configuration, placeholders:[string],
  lossVariables:[string], trainingConfig:string,
  updaterState:[UpdaterState]
- ``FlatVariable``: id:IntPair, name, dtype, shape:[long], ndarray:FlatArray,
  device, variabletype
- ``FlatNode``: id, name, opType, opNum, properties:[FlatProperties],
  input, inputPaired:[IntPair], output, extraParams, extraInteger,
  extraBools, dimensions, device, scope_id, scope_name,
  outputNames:[string], opName, outputTypes:[byte], scalar
- ``FlatArray``: shape:[long] (the nd4j shapeInfo ``[rank, dims…,
  strides…, extras, ews, order]``), buffer:[byte], dtype, byteOrder
- ``UpdaterState``: paramName, updaterStateKeys:[string],
  updaterStateValues:[FlatArray]
- ``FlatProperties``: name, i, l, d, a:[FlatArray], b, s, shape
- ``IntPair``: first, second

Ops are CUSTOM nodes keyed by ``opName`` with their attributes in
``properties``, plus an ``__attr_meta__`` property recording the Python
attr kinds so attrs round-trip exactly. Control-flow subgraphs are scoped
node regions (``scope_name = …__sub__/<op>/<key>/``); lambda ops refuse.

The writer lays a buffer out front to back (each table's vtable just
before it, children after their parents, so every offset points forward);
any FlatBuffers reader reads it.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import dtypes as _dt

# ---------------------------------------------------------------- enums

# org.nd4j.graph.DType (bfloat16 = 17 is carried as raw 16-bit words)
_DTYPE_TO_NP = {1: np.dtype(np.bool_), 3: np.dtype(np.float16),
                5: np.dtype(np.float32), 6: np.dtype(np.float64),
                7: np.dtype(np.int8), 8: np.dtype(np.int16),
                9: np.dtype(np.int32), 10: np.dtype(np.int64),
                11: np.dtype(np.uint8), 12: np.dtype(np.uint16),
                13: np.dtype(np.uint32), 14: np.dtype(np.uint64)}
_NP_TO_DTYPE = {v: k for k, v in _DTYPE_TO_NP.items()}
_BF16 = 17

# org.nd4j.graph.VarType
_VARTYPE_TO_OURS = {0: "VARIABLE", 1: "CONSTANT", 2: "ARRAY",
                    3: "PLACEHOLDER"}
_OURS_TO_VARTYPE = {v: k for k, v in _VARTYPE_TO_OURS.items()}

_OP_TYPE_CUSTOM = 21          # org.nd4j.graph.OpType.CUSTOM
_BYTE_ORDER_LE = 0            # org.nd4j.graph.ByteOrder.LE

# field slot numbers (declaration order in the .fbs)
_FA = {"shape": 0, "buffer": 1, "dtype": 2, "byteOrder": 3}
_FV = {"id": 0, "name": 1, "dtype": 2, "shape": 3, "ndarray": 4,
       "device": 5, "variabletype": 6}
_FP = {"name": 0, "i": 1, "l": 2, "d": 3, "a": 4, "b": 5, "s": 6,
       "shape": 7}
_FN = {"id": 0, "name": 1, "opType": 2, "opNum": 3, "properties": 4,
       "input": 5, "inputPaired": 6, "output": 7, "extraParams": 8,
       "extraInteger": 9, "extraBools": 10, "dimensions": 11, "device": 12,
       "scope_id": 13, "scope_name": 14, "outputNames": 15, "opName": 16,
       "outputTypes": 17, "scalar": 18}
_FG = {"id": 0, "variables": 1, "nodes": 2, "outputs": 3,
       "configuration": 4, "placeholders": 5, "lossVariables": 6,
       "trainingConfig": 7, "updaterState": 8}
_US = {"paramName": 0, "updaterStateKeys": 1, "updaterStateValues": 2}

_ATTR_META = "__attr_meta__"

# (opType, opNum) pairs of legacy enum-op nodes → (registry op, adapter);
# empty until a mapping is verified against a real artifact
_LEGACY_OPS: Dict[tuple, tuple] = {}


def register_legacy_op(op_type: int, op_num: int, name: str,
                       attr_adapter=None):
    """Map a legacy (OpType enum, opNum) pair to a registry op name so
    non-CUSTOM FlatGraph nodes load. ``attr_adapter(payload) -> attrs``
    translates the node's legacy arguments (``{"extra_params",
    "extra_integer", "extra_bools", "dimensions"}``) into named attrs;
    a node carrying arguments without an adapter refuses to load."""
    _LEGACY_OPS[(int(op_type), int(op_num))] = (name, attr_adapter)


# ------------------------------------------------------ FlatBuffers writer
class _Table:
    """A table to write: ``fields`` is [(slot, kind, value)], kind one of
    "i8", "i32", "i64" (inline scalars) or "off" (a child object)."""

    def __init__(self, fields):
        self.fields = [f for f in fields if f[2] is not None]


class _Str:
    def __init__(self, s: str):
        self.data = s.encode("utf-8")


class _Vec:
    """A vector of child objects (tables or strings)."""

    def __init__(self, items):
        self.items = list(items)


_INLINE = {"i8": ("<b", 1), "i32": ("<i", 4), "i64": ("<q", 8)}


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int):
        self.buf.extend(b"\0" * (-len(self.buf) % n))

    def _u32_at(self, pos: int, value: int):
        struct.pack_into("<I", self.buf, pos, value)

    def place(self, obj) -> int:
        if isinstance(obj, _Table):
            return self._table(obj)
        if isinstance(obj, _Str):
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.data)) + obj.data + b"\0"
            return pos
        if isinstance(obj, _Vec):
            self._align(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(obj.items))
            slots = len(self.buf)
            self.buf += b"\0" * (4 * len(obj.items))
            for j, item in enumerate(obj.items):
                child = self.place(item)
                self._u32_at(slots + 4 * j, child - (slots + 4 * j))
            return pos
        arr = np.ascontiguousarray(obj)          # a vector of scalars
        size = max(arr.dtype.itemsize, 4)
        while len(self.buf) % 4 or (len(self.buf) + 4) % size:
            self.buf += b"\0"
        pos = len(self.buf)
        self.buf += struct.pack("<I", arr.size) + arr.tobytes()
        return pos

    def _table(self, t: _Table) -> int:
        # inline layout: the soffset at 0, then fields largest first
        layout, cur = {}, 4
        order = sorted(t.fields, key=lambda f: -(
            _INLINE[f[1]][1] if f[1] in _INLINE else 4))
        for slot, kind, _v in order:
            size = _INLINE[kind][1] if kind in _INLINE else 4
            cur = -(-cur // size) * size
            layout[slot] = cur
            cur += size
        nslots = max((f[0] for f in t.fields), default=-1) + 1
        self._align(2)
        vt_pos = len(self.buf)
        self.buf += struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, cur,
                                *[layout.get(s, 0) for s in range(nslots)])
        self._align(8)
        pos = len(self.buf)
        self.buf += b"\0" * cur
        struct.pack_into("<i", self.buf, pos, pos - vt_pos)
        children = []
        for slot, kind, value in t.fields:
            if kind in _INLINE:
                struct.pack_into(_INLINE[kind][0], self.buf,
                                 pos + layout[slot], int(value))
            else:
                children.append((pos + layout[slot], value))
        for at, value in children:
            self._u32_at(at, self.place(value) - at)
        return pos

    def finish(self, root: _Table) -> bytes:
        self.buf += b"\0" * 8
        self._u32_at(0, self.place(root))
        return bytes(self.buf)


# ------------------------------------------------------ FlatBuffers reader
class _Tab:
    """A table of a FlatBuffers buffer."""

    def __init__(self, buf, pos):
        self.b = buf
        self.pos = pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _o(self, slot):
        vo = 4 + 2 * slot
        return struct.unpack_from("<H", self.b, self.vt + vo)[0] \
            if vo < self.vt_len else 0

    def _get(self, fmt, slot, default):
        o = self._o(slot)
        return struct.unpack_from(fmt, self.b, self.pos + o)[0] if o \
            else default

    def i8(self, slot, default=0):
        return self._get("<b", slot, default)

    def i32(self, slot, default=0):
        return self._get("<i", slot, default)

    def i64(self, slot, default=0):
        return self._get("<q", slot, default)

    def _ind(self, at):
        return at + struct.unpack_from("<I", self.b, at)[0]

    def _str_at(self, p) -> str:
        n = struct.unpack_from("<I", self.b, p)[0]
        return bytes(self.b[p + 4:p + 4 + n]).decode("utf-8")

    def string(self, slot) -> Optional[str]:
        o = self._o(slot)
        return self._str_at(self._ind(self.pos + o)) if o else None

    def table(self, slot) -> Optional["_Tab"]:
        o = self._o(slot)
        return _Tab(self.b, self._ind(self.pos + o)) if o else None

    def has(self, slot) -> bool:
        """Field presence: a present-but-empty vector (a scalar's shape) is
        not an absent field."""
        return bool(self._o(slot))

    def _vec(self, slot):
        o = self._o(slot)
        if not o:
            return None, 0
        p = self._ind(self.pos + o)
        return p + 4, struct.unpack_from("<I", self.b, p)[0]

    def scalar_vec(self, slot, np_dtype) -> np.ndarray:
        start, n = self._vec(slot)
        if start is None:
            return np.zeros((0,), np_dtype)
        return np.frombuffer(bytes(self.b[start:start + n * np.dtype(
            np_dtype).itemsize]), dtype=np_dtype)

    def table_vec(self, slot) -> List["_Tab"]:
        start, n = self._vec(slot)
        return [] if start is None else [
            _Tab(self.b, self._ind(start + 4 * j)) for j in range(n)]

    def string_vec(self, slot) -> List[str]:
        start, n = self._vec(slot)
        return [] if start is None else [
            self._str_at(self._ind(start + 4 * j)) for j in range(n)]


# --------------------------------------------------------------- writing
def _int_pair(first: int, second: int) -> _Table:
    return _Table([(0, "i32", first), (1, "i32", second)])


def _shape_info(shape) -> np.ndarray:
    """nd4j shapeInfo of a C-order dense array: ``[rank, dims…,
    elementStrides…, extras, ews, order]``; extras 0, ews 1, order 'c'."""
    rank = len(shape)
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= int(d)
    strides.reverse()
    return np.asarray([rank, *shape, *strides, 0, 1, ord("c")],
                      dtype=np.int64)


def _array_payload(arr):
    """(raw bytes, DType code, shape) of a numpy array or tensor."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), _BF16,
                    tuple(t.shape))
        arr = t.numpy()
    arr = np.asarray(arr)
    if getattr(arr.dtype, "name", "") == "bfloat16":
        return arr.view(np.uint16).tobytes(), _BF16, arr.shape
    if arr.dtype not in _NP_TO_DTYPE:
        raise ValueError(f"dtype {arr.dtype} has no FlatBuffers DType code")
    return arr.tobytes(order="C"), _NP_TO_DTYPE[arr.dtype], arr.shape


def _flat_array(arr) -> _Table:
    raw, code, shape = _array_payload(arr)
    return _Table([(_FA["shape"], "off", _shape_info(shape)),
                   (_FA["buffer"], "off", np.frombuffer(raw, np.uint8)),
                   (_FA["dtype"], "i8", code),
                   (_FA["byteOrder"], "i8", _BYTE_ORDER_LE)])


def _strings(strings) -> _Vec:
    return _Vec([_Str(s) for s in strings])


def _flatten_nested(v):
    """Nested lists/tuples of scalars → (flat list, dims)."""
    if not isinstance(v, (list, tuple)):
        return [v], []
    if all(isinstance(e, (list, tuple)) for e in v) and v \
            and len({len(e) for e in v}) == 1:
        flat = [x for e in v for x in e]
        if not any(isinstance(x, (list, tuple)) for x in flat):
            return flat, [len(v), len(v[0])]
    return list(v), [len(v)]


def _jsonable(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.dtype):
        return {"__dtype__": v.name}
    if isinstance(v, torch.dtype):
        return {"__dtype__": _dt.name_of(v)}
    if isinstance(v, type) and issubclass(v, np.generic):
        return {"__dtype__": np.dtype(v).name}
    if isinstance(v, (np.ndarray, torch.Tensor)):
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        return {"__nd__": a.tolist(), "__nd_dtype__": a.dtype.name}
    if isinstance(v, (list, tuple)):
        return [_jsonable(e) for e in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def _unjsonable(v):
    if isinstance(v, dict) and "__dtype__" in v:
        return np.dtype(v["__dtype__"])
    if isinstance(v, dict) and "__nd__" in v:
        return np.asarray(v["__nd__"],
                          dtype=np.dtype(v.get("__nd_dtype__", "f4")))
    if isinstance(v, dict):
        return {k: _unjsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unjsonable(e) for e in v]
    return v


def _property(name: str, value):
    """One attr → (FlatProperties table, meta entry for reconstruction)."""
    slots: dict = {}
    meta: dict = {}
    v = value
    if isinstance(v, (bool, np.bool_)):
        meta["k"] = "bool"
        slots["b"] = np.asarray([bool(v)], np.uint8)
    elif isinstance(v, (int, np.integer)):
        meta["k"] = "int"
        slots["l"] = np.asarray([int(v)], np.int64)
    elif isinstance(v, (float, np.floating)):
        meta["k"] = "float"
        slots["d"] = np.asarray([float(v)], np.float64)
    elif isinstance(v, str):
        meta["k"] = "str"
        slots["s"] = _strings([v])
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        meta["k"] = "ndarray"
        slots["a"] = _Vec([_flat_array(v)])
    elif isinstance(v, (list, tuple)):
        flat, dims = _flatten_nested(v)
        meta["k"] = "seq"
        meta["tuple"] = isinstance(v, tuple)
        meta["dims"] = dims
        if flat and all(isinstance(e, (bool, np.bool_)) for e in flat):
            meta["et"] = "bool"
            slots["b"] = np.asarray([bool(e) for e in flat], np.uint8)
        elif all(isinstance(e, (int, np.integer)) for e in flat):
            meta["et"] = "int"
            slots["l"] = np.asarray([int(e) for e in flat], np.int64)
        elif all(isinstance(e, (int, float, np.integer, np.floating))
                 for e in flat):
            meta["et"] = "float"
            slots["d"] = np.asarray([float(e) for e in flat], np.float64)
        elif all(isinstance(e, str) for e in flat):
            meta["et"] = "str"
            slots["s"] = _strings(flat)
        else:
            meta, slots = {"k": "json", "v": json.dumps(_jsonable(v))}, {}
    else:
        # None, dtypes and other config values ride the meta json
        meta = {"k": "json", "v": json.dumps(_jsonable(v))}
    fields = [(_FP["name"], "off", _Str(name))]
    fields += [(_FP[k], "off", slots[k]) for k in ("l", "d", "a", "b", "s")
               if k in slots]
    if meta.get("dims") and len(meta["dims"]) > 1:
        fields.append((_FP["shape"], "off",
                       np.asarray(meta["dims"], np.int32)))
    return _Table(fields), meta


_SUB = "__sub__/"
_CF_KEY = "__cf_subgraphs__"


def _collect_graph(sd, prefix: str, vars_out: list, nodes_out: list):
    """Flatten a SameDiff and its control-flow subgraphs into prefixed
    variable/node records; subgraph entities live under
    ``<prefix>__sub__/<op>/<key>/``, the composite op recording its
    branch outputs in a ``__cf_subgraphs__`` attr."""
    for name, v in sd._vars.items():
        if _SUB in name:
            raise ValueError(
                f"variable name {name!r} contains the reserved scope "
                f"marker {_SUB!r} and cannot be FlatGraph-serialized")
        vars_out.append((prefix + name, v, sd._values.get(name)))
    for op in sd._ops:
        if op.fn is not None:
            raise ValueError(f"lambda op {op.name!r} is not serializable")
        if _SUB in op.name:
            raise ValueError(
                f"op name {op.name!r} contains the reserved scope marker "
                f"{_SUB!r} and cannot be FlatGraph-serialized")
        attrs = dict(op.attrs)
        if op.subgraphs:
            cf = {}
            for k, sub in op.subgraphs.items():
                _collect_graph(sub, f"{prefix}{_SUB}{op.name}/{k}/",
                               vars_out, nodes_out)
                cf[k] = {"outputs": list(sub._branch_outputs)}
            attrs[_CF_KEY] = json.dumps(cf)
        nodes_out.append((prefix + op.name, op.op_name,
                          [prefix + i for i in op.inputs],
                          [prefix + o for o in op.outputs], attrs, prefix))


def _dtype_code(dtype) -> int:
    if dtype is None:
        return 5
    if dtype == torch.bfloat16:
        return _BF16
    return _NP_TO_DTYPE.get(_dt.to_numpy_dtype(dtype), 5)


def to_flat_buffers(sd, include_updater_state: bool = False) -> bytes:
    """Serialize a SameDiff graph to the FlatGraph binary (ref:
    ``SameDiff#asFlatBuffers``); with ``include_updater_state`` the
    per-parameter optimizer state rides ``updaterState``."""
    from deeplearning4j_tpu_torch.autodiff.samediff import VariableType

    all_vars: list = []
    all_nodes: list = []
    _collect_graph(sd, "", all_vars, all_nodes)

    # ids: ops 1..N; leaf variables continue after
    op_ids = {name: i + 1 for i, (name, *_r) in enumerate(all_nodes)}
    pair_of: Dict[str, tuple] = {}
    for name, _opn, _ins, outs, _attrs, _scope in all_nodes:
        for j, out in enumerate(outs):
            pair_of[out] = (op_ids[name], j)
    next_id = len(all_nodes) + 1
    for name, _v, _val in all_vars:
        if name not in pair_of:
            pair_of[name] = (next_id, 0)
            next_id += 1

    var_tabs = []
    for name, v, val in all_vars:
        fields = [(_FV["id"], "off", _int_pair(*pair_of[name])),
                  (_FV["name"], "off", _Str(name)),
                  (_FV["dtype"], "i8", _dtype_code(v.dtype)),
                  (_FV["variabletype"], "i8",
                   _OURS_TO_VARTYPE[v.var_type.value])]
        if v.shape is not None and all(s is not None for s in v.shape):
            fields.append((_FV["shape"], "off",
                           np.asarray(v.shape, dtype=np.int64)))
        if v.var_type in (VariableType.VARIABLE, VariableType.CONSTANT) \
                and val is not None:
            fields.append((_FV["ndarray"], "off", _flat_array(val)))
        var_tabs.append(_Table(fields))

    var_by_name = {name: v for name, v, _val in all_vars}
    node_tabs = []
    for name, op_name, inputs, outputs, attrs, scope in all_nodes:
        props, metas = [], {}
        for an, av in attrs.items():
            tab, meta = _property(an, av)
            props.append(tab)
            metas[an] = meta
        props.append(_property(_ATTR_META, json.dumps(metas))[0])
        out_types = np.asarray(
            [_dtype_code(var_by_name[o].dtype if o in var_by_name else None)
             for o in outputs], np.int8)
        fields = [(_FN["id"], "i32", op_ids[name]),
                  (_FN["name"], "off", _Str(name)),
                  (_FN["opType"], "i8", _OP_TYPE_CUSTOM),
                  (_FN["properties"], "off", _Vec(props)),
                  (_FN["inputPaired"], "off",
                   _Vec([_int_pair(*pair_of[i]) for i in inputs])),
                  (_FN["outputNames"], "off", _strings(outputs)),
                  (_FN["opName"], "off", _Str(op_name)),
                  (_FN["outputTypes"], "off", out_types)]
        if scope:
            fields.append((_FN["scope_name"], "off", _Str(scope)))
        node_tabs.append(_Table(fields))

    fields = [(_FG["variables"], "off", _Vec(var_tabs)),
              (_FG["nodes"], "off", _Vec(node_tabs)),
              (_FG["placeholders"], "off", _strings(
                  [n for n, v in sd._vars.items()
                   if v.var_type == VariableType.PLACEHOLDER])),
              (_FG["lossVariables"], "off",
               _strings(list(sd._loss_variables)))]
    if sd.training_config is not None:
        fields.append((_FG["trainingConfig"], "off", _Str(json.dumps(
            _jsonable(sd.training_config.to_dict())))))
    if include_updater_state:
        state = sd._updater_state_by_param()
        if state:
            us = []
            for pname in sorted(state):
                entries = state[pname]
                keys = sorted(entries)
                us.append(_Table([
                    (_US["paramName"], "off", _Str(pname)),
                    (_US["updaterStateKeys"], "off", _strings(keys)),
                    (_US["updaterStateValues"], "off",
                     _Vec([_flat_array(entries[k]) for k in keys]))]))
            fields.append((_FG["updaterState"], "off", _Vec(us)))
    return _Writer().finish(_Table(fields))


# --------------------------------------------------------------- reading
def _decode_shape(vec: np.ndarray, n_elems: int) -> tuple:
    """FlatArray.shape → (dims, order): the nd4j shapeInfo, or bare dims
    (older self-written files), told apart by layout and element count."""
    vals = [int(x) for x in vec]
    n = len(vals)
    if n >= 4 and vals[0] >= 0 and n == 2 * vals[0] + 4:
        dims = tuple(vals[1:1 + vals[0]])
        si_elems = int(np.prod(dims)) if dims else 1
        bare_elems = int(np.prod(vals)) if vals else 1
        if si_elems == n_elems or bare_elems != n_elems:
            order = "F" if vals[-1] == ord("f") else "C"
            return dims, order
    return tuple(vals), "C"


def _read_flat_array(tab: _Tab):
    """A numpy array (a bfloat16 one as a torch tensor: numpy has none)."""
    shape = tab.scalar_vec(_FA["shape"], np.int64)
    code = int(tab.i8(_FA["dtype"]))
    raw = tab.scalar_vec(_FA["buffer"], np.uint8)
    if code == _BF16:
        words = np.frombuffer(raw.tobytes(), dtype=np.int16)
        dims, order = _decode_shape(shape, words.size)
        return torch.from_numpy(np.reshape(words, dims, order=order).copy()
                                ).view(torch.bfloat16)
    dt = _DTYPE_TO_NP.get(code)
    if dt is None:
        raise ValueError(f"FlatArray dtype code {code} unsupported")
    arr = np.frombuffer(raw.tobytes(), dtype=dt)
    dims, order = _decode_shape(shape, arr.size)
    return np.reshape(arr, dims, order=order)


def _property_value(tab: _Tab, meta: dict):
    kind = meta.get("k") if meta else None
    bools = tab.scalar_vec(_FP["b"], np.int8)
    longs = tab.scalar_vec(_FP["l"], np.int64)
    dbls = tab.scalar_vec(_FP["d"], np.float64)
    strs = tab.string_vec(_FP["s"])
    arrs = tab.table_vec(_FP["a"])
    if kind == "bool":
        return bool(bools[0])
    if kind == "int":
        return int(longs[0])
    if kind == "float":
        return float(dbls[0])
    if kind == "str":
        return strs[0]
    if kind == "ndarray":
        return _read_flat_array(arrs[0])
    if kind == "json":
        return _unjsonable(json.loads(meta["v"]))
    if kind == "seq":
        et = meta.get("et")
        if et == "bool":
            flat = [bool(x) for x in bools]
        elif et == "int":
            flat = [int(x) for x in longs]
        elif et == "float":
            flat = [float(x) for x in dbls]
        else:
            flat = list(strs)
        dims = meta.get("dims") or [len(flat)]
        if len(dims) == 2:
            flat = [flat[r * dims[1]:(r + 1) * dims[1]]
                    for r in range(dims[0])]
            if meta.get("tuple"):
                flat = tuple(tuple(r) for r in flat)
            return flat
        return tuple(flat) if meta.get("tuple") else flat
    # no meta (a foreign artifact): best effort by the populated vector
    ints32 = tab.scalar_vec(_FP["i"], np.int32)
    for seq, conv in ((bools, bool), (longs, int), (ints32, int),
                      (dbls, float)):
        if len(seq):
            vals = [conv(x) for x in seq]
            return vals[0] if len(vals) == 1 else vals
    if strs:
        return strs[0] if len(strs) == 1 else strs
    if arrs:
        vals = [_read_flat_array(a) for a in arrs]
        return vals[0] if len(vals) == 1 else vals
    return None


def _dtype_of_code(code: int):
    if code == _BF16:
        return torch.bfloat16
    return _DTYPE_TO_NP.get(int(code), np.dtype("f4"))


def from_flat_buffers(data: bytes, device=None):
    """Parse a FlatGraph binary into a SameDiff on ``device`` (None: the
    card) (ref: ``SameDiff#fromFlatBuffers``)."""
    from deeplearning4j_tpu_torch._device import resolve_device
    from deeplearning4j_tpu_torch.autodiff.samediff import (OpNode, SameDiff,
                                                            SDVariable,
                                                            TrainingConfig,
                                                            VariableType)

    device = resolve_device(device)
    buf = bytes(data)
    g = _Tab(buf, struct.unpack_from("<I", buf, 0)[0])

    pair_to_name: Dict[tuple, str] = {}
    var_recs = []                      # (full_name, vtype, shape, dt, value)
    for vt in g.table_vec(_FG["variables"]):
        name = vt.string(_FV["name"])
        dt = _dtype_of_code(vt.i8(_FV["dtype"]))
        shape = tuple(int(s) for s in vt.scalar_vec(_FV["shape"], np.int64)) \
            if vt.has(_FV["shape"]) else None   # () scalar != absent
        vtype = VariableType(_VARTYPE_TO_OURS.get(
            int(vt.i8(_FV["variabletype"])), "ARRAY"))
        nd = vt.table(_FV["ndarray"])
        val = _read_flat_array(nd) if nd is not None else None
        var_recs.append((name, vtype, shape, dt, val))
        idp = vt.table(_FV["id"])
        if idp is not None:
            pair_to_name[(idp.i32(0), idp.i32(1))] = name

    nodes = g.table_vec(_FG["nodes"])
    for nt in nodes:
        nid = nt.i32(_FN["id"])
        for j, out in enumerate(nt.string_vec(_FN["outputNames"])):
            pair_to_name.setdefault((nid, j), out)

    node_recs = []
    for nt in sorted(nodes, key=lambda t: t.i32(_FN["id"])):
        name = nt.string(_FN["name"]) or f"node_{nt.i32(_FN['id'])}"
        op_name = nt.string(_FN["opName"])
        legacy_attrs = None
        if not op_name:
            key = (int(nt.i8(_FN["opType"])), int(nt.i64(_FN["opNum"])))
            entry = _LEGACY_OPS.get(key)
            if not entry:
                raise ValueError(
                    f"FlatNode {name!r} has no opName and legacy enum pair "
                    f"(opType={key[0]}, opNum={key[1]}) is not registered — "
                    f"verify the mapping against the reference's "
                    f"legacy_ops.h and add it via "
                    f"flatgraph.register_legacy_op({key[0]}, {key[1]}, "
                    f"'<registry-op>')")
            op_name, adapter = entry
            payload = {
                "extra_params": [float(v) for v in nt.scalar_vec(
                    _FN["extraParams"], np.float64)],
                "extra_integer": [int(v) for v in nt.scalar_vec(
                    _FN["extraInteger"], np.int64)],
                "extra_bools": [bool(v) for v in nt.scalar_vec(
                    _FN["extraBools"], np.int8)],
                "dimensions": [int(v) for v in nt.scalar_vec(
                    _FN["dimensions"], np.int32)],
            }
            if any(payload.values()):
                if adapter is None:
                    raise ValueError(
                        f"legacy node {name!r} ({op_name}) carries "
                        f"arguments {payload} but its registration has no "
                        f"attr_adapter — running without them would be "
                        f"silently wrong; register with "
                        f"register_legacy_op(..., attr_adapter=fn)")
                legacy_attrs = dict(adapter(payload))
        raw = {p.string(_FP["name"]): p
               for p in nt.table_vec(_FN["properties"])}
        metas = {}
        if _ATTR_META in raw:
            metas = json.loads(_property_value(raw.pop(_ATTR_META),
                                               {"k": "str"}))
        attrs = {an: _property_value(p, metas.get(an))
                 for an, p in raw.items()}
        if legacy_attrs:
            attrs.update(legacy_attrs)
        inputs = []
        for pt in nt.table_vec(_FN["inputPaired"]):
            key = (pt.i32(0), pt.i32(1))
            if key not in pair_to_name:
                raise ValueError(f"node {name!r} references unknown "
                                 f"producer {key}")
            inputs.append(pair_to_name[key])
        scope = nt.string(_FN["scope_name"]) or ""
        if scope and not scope.endswith("/"):
            scope = ""                 # a foreign free-form scope label
        node_recs.append((name, op_name, inputs,
                          nt.string_vec(_FN["outputNames"]),
                          nt.scalar_vec(_FN["outputTypes"], np.int8),
                          attrs, scope))

    def _var_scope(name):
        i = name.rfind(_SUB)
        if i < 0:
            return ""
        parts = name[i + len(_SUB):].split("/", 2)
        if len(parts) < 3:
            return ""
        return name[:i] + _SUB + parts[0] + "/" + parts[1] + "/"

    vars_by_scope: Dict[str, list] = {}
    for rec in var_recs:
        vars_by_scope.setdefault(_var_scope(rec[0]), []).append(rec)
    nodes_by_scope: Dict[str, list] = {}
    for rec in node_recs:
        nodes_by_scope.setdefault(rec[-1], []).append(rec)
    # deepest scope first, so a composite op's subgraphs exist when its
    # own scope is built
    scopes = sorted(set(vars_by_scope) | set(nodes_by_scope) | {""},
                    key=len, reverse=True)
    built: Dict[str, "SameDiff"] = {}
    for scope in scopes:
        sd = SameDiff(device)
        for name, vtype, shape, dt, val in vars_by_scope.get(scope, []):
            local = name[len(scope):]
            v = SDVariable(sd, local, vtype, shape, dt)
            sd._vars[local] = v
            if val is not None:
                sd._values[local] = sd._tensor(val)
                if v.shape is None:
                    v.shape = tuple(val.shape)
        for name, op_name, inputs, outputs, out_codes, attrs, _ns \
                in nodes_by_scope.get(scope, []):
            local = name[len(scope):]
            subgraphs = None
            if _CF_KEY in attrs:
                cf = json.loads(attrs.pop(_CF_KEY))
                subgraphs = {}
                for k, meta in cf.items():
                    sub_path = f"{scope}{_SUB}{local}/{k}/"
                    sub = built.get(sub_path)
                    if sub is None:
                        raise ValueError(
                            f"composite op {name!r} references missing "
                            f"subgraph scope {sub_path!r}")
                    sub._branch_outputs = list(meta.get("outputs", []))
                    subgraphs[k] = sub
            l_outputs = [o[len(scope):] for o in outputs]
            node = OpNode(local, op_name, [i[len(scope):] for i in inputs],
                          l_outputs, attrs, subgraphs=subgraphs)
            sd._ops.append(node)
            for j, out in enumerate(l_outputs):
                if out not in sd._vars:
                    dt = _dtype_of_code(out_codes[j]) \
                        if j < len(out_codes) else np.dtype("f4")
                    sd._vars[out] = SDVariable(sd, out, VariableType.ARRAY,
                                               None, dt)
                sd._producer[out] = node
        sd._reseed_name_counters()
        built[scope] = sd

    sd = built[""]
    sd._loss_variables = g.string_vec(_FG["lossVariables"])
    tc = g.string(_FG["trainingConfig"])
    if tc:
        sd.training_config = TrainingConfig.from_dict(
            _unjsonable(json.loads(tc)))
    us_tabs = g.table_vec(_FG["updaterState"])
    if us_tabs:
        named: Dict[str, dict] = {}
        for ut in us_tabs:
            pname = ut.string(_US["paramName"]) or ""
            keys = ut.string_vec(_US["updaterStateKeys"])
            vals = [_read_flat_array(a)
                    for a in ut.table_vec(_US["updaterStateValues"])]
            named[pname] = dict(zip(keys, vals))
        sd._pending_opt_named = named
        upd = getattr(sd.training_config, "updater", None)
        if upd is not None:
            sd._pending_opt_updater = type(upd).__name__
    return sd


def save_flatbuffers(sd, path: str):
    with open(path, "wb") as f:
        f.write(to_flat_buffers(sd))


def load_flatbuffers(path: str, device=None):
    with open(path, "rb") as f:
        return from_flat_buffers(f.read(), device=device)
