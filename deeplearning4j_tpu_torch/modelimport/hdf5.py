"""A read-only HDF5 reader: the slice of ``h5py``'s API that the Keras
importer uses, over the file format itself (the port stands alone: no
``h5py``, as ``tf_proto.py`` and ``onnx_proto.py`` stand in for
protobuf).

Surface: ``File(path)`` (a context manager), ``"a/b" in group``, iteration
over a group's member names (sorted, as ``h5py`` lists them),
``group[key]``, ``.keys()`` / ``.items()`` / ``.values()``, datasets with
``.shape``, ``.dtype`` and ``np.asarray(ds)`` (or ``ds[()]``), and
``.attrs``, a read-only mapping of an object's attributes with ``h5py``'s
values: numpy scalars and arrays, ``np.bytes_`` and ``'S'`` arrays for
fixed-length strings, ``str`` and object arrays of ``str`` for
variable-length ones.

What it reads (the format of HDF5 1.14's specification):

- superblocks v0 and v1 (what ``h5py`` writes by default) and v2/v3
  (``libver="latest"``), at offset 0 or behind a user block;
- version-1 object headers, with continuation blocks, and version-2
  (``OHDR``/``OCHK``) ones;
- symbol-table groups (a v1 B-tree of type 0 over SNOD leaves and a local
  heap, any number of levels) and groups of compact link messages (hard
  and soft links);
- contiguous and compact dataset layouts; little-endian integers of 1-8
  bytes, IEEE floats of 2, 4 and 8 bytes, ``h5py``'s boolean enum,
  fixed-length strings, variable-length strings in global heap
  collections; scalar, simple (empty ones included) and null dataspaces;
- attributes of message versions 1-3.

Anything else raises :class:`UnsupportedHDF5Feature`, which names the
feature: dense link or attribute storage in a fractal heap, chunked or
virtual layouts, filter pipelines, external storage, big-endian or VAX
types, shared (committed) messages, compound, array, reference, opaque
and bitfield types, variable-length sequences, external links.
"""
from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "Empty", "HDF5Error",
           "UnsupportedHDF5Feature"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_LINK, _EXTERNAL = 0x06, 0x07
_LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION = 0x08, 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_TYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time",
                 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length",
                 10: "array"}


class HDF5Error(ValueError):
    """A file this reader cannot make sense of: not HDF5, or damaged."""


class UnsupportedHDF5Feature(HDF5Error):
    """A well-formed file that uses a part of the format this reader does
    not implement; ``feature`` names it."""

    def __init__(self, feature: str, where: str = ""):
        self.feature = feature
        super().__init__(f"unsupported HDF5 feature: {feature}"
                         + (f" ({where})" if where else ""))


class Empty:
    """The value of a null dataspace (``h5py.Empty``)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


# ------------------------------------------------------------- the buffer
class _Buffer:
    """The file's bytes and its sizes of offsets and lengths."""

    def __init__(self, data: bytes, base: int = 0):
        self.data = data
        self.base = base
        self.o = 8          # size of offsets
        self.l = 8          # size of lengths

    def uint(self, at: int, n: int) -> int:
        if at < 0 or at + n > len(self.data):
            raise HDF5Error(f"read past the end of the file at {at}")
        return int.from_bytes(self.data[at:at + n], "little")

    def undefined(self, addr: int, n: Optional[int] = None) -> bool:
        return addr == (1 << (8 * (n or self.o))) - 1

    def addr(self, at: int) -> int:
        """The address stored at ``at`` (relative to the base address),
        as a file offset; None where it is undefined."""
        a = self.uint(at, self.o)
        return None if self.undefined(a) else a + self.base

    def sig(self, at: int, want: bytes, what: str):
        if self.data[at:at + len(want)] != want:
            raise HDF5Error(f"{what} at {at}: no {want!r} signature")


# -------------------------------------------------------------- datatypes
class _Type:
    """A parsed datatype message: the numpy dtype that stores one element
    on disk, and how to turn the stored elements into ``h5py``'s values."""

    def __init__(self, kind: str, dtype: np.dtype, size: int, pad: int = 0):
        self.kind = kind          # "number", "fixed", "vlen_str", "bool"
        self.dtype = dtype        # on disk
        self.size = size
        self.pad = pad            # fixed strings: 0 nullterm, 1 nullpad, 2 space

    @property
    def value_dtype(self) -> np.dtype:
        if self.kind == "vlen_str":
            return np.dtype(object)
        if self.kind == "bool":
            return np.dtype(bool)
        return self.dtype


def _parse_type(buf: _Buffer, at: int, where: str) -> Tuple[_Type, int]:
    """(the datatype at ``at``, its encoded length)."""
    cv = buf.uint(at, 1)
    cls, version = cv & 0x0F, cv >> 4
    bits = [buf.uint(at + 1 + i, 1) for i in range(3)]
    size = buf.uint(at + 4, 4)
    props = at + 8
    if cls == 0:                                      # fixed-point
        if bits[0] & 1:
            raise UnsupportedHDF5Feature("big-endian types", where)
        if size not in (1, 2, 4, 8):
            raise UnsupportedHDF5Feature(f"{size}-byte integers", where)
        offset, precision = buf.uint(props, 2), buf.uint(props + 2, 2)
        if offset != 0 or precision != 8 * size:
            raise UnsupportedHDF5Feature("integers with padding bits", where)
        kind = "i" if bits[0] & 0x08 else "u"
        return _Type("number", np.dtype(f"<{kind}{size}"), size), 12
    if cls == 1:                                      # floating-point
        order = (bits[0] & 1) | ((bits[0] >> 5) & 2)
        if order == 1:
            raise UnsupportedHDF5Feature("big-endian types", where)
        if order != 0:
            raise UnsupportedHDF5Feature("VAX-endian floats", where)
        if size not in (2, 4, 8):
            raise UnsupportedHDF5Feature(f"{size}-byte floats", where)
        return _Type("number", np.dtype(f"<f{size}"), size), 20
    if cls == 3:                                      # fixed-length string
        return _Type("fixed", np.dtype(f"S{size}"), size,
                     pad=bits[0] & 0x0F), 8
    if cls == 9:                                      # variable-length
        if bits[0] & 0x0F != 1:
            raise UnsupportedHDF5Feature("variable-length sequences", where)
        _base, n = _parse_type(buf, props, where)
        return _Type("vlen_str", np.dtype(f"V{size}"), size), 8 + n
    if cls == 8:                                      # enum
        base, n = _parse_type(buf, props, where)
        count = bits[0] | (bits[1] << 8)
        names, p = [], props + n
        for _ in range(count):
            end = buf.data.index(b"\0", p)
            names.append(buf.data[p:end])
            p = end + 1 if version >= 3 else p + ((end - p) // 8 + 1) * 8
        values = [buf.uint(p + i * base.size, base.size)
                  for i in range(count)]
        p += count * base.size
        if (base.kind == "number" and base.size == 1
                and dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}):
            return _Type("bool", base.dtype, 1), p - at
        raise UnsupportedHDF5Feature("enum types", where)
    raise UnsupportedHDF5Feature(
        f"{_TYPE_CLASSES.get(cls, f'class {cls}')} types", where)


# ------------------------------------------------------------- dataspaces
def _parse_space(buf: _Buffer, at: int) -> Optional[Tuple[int, ...]]:
    """The dataspace's shape: () for a scalar, None for a null one."""
    version, rank, flags = (buf.uint(at, 1), buf.uint(at + 1, 1),
                            buf.uint(at + 2, 1))
    if version == 1:
        dims = at + 8
        kind = 1 if rank else 0
    elif version == 2:
        kind = buf.uint(at + 3, 1)
        dims = at + 4
    else:
        raise HDF5Error(f"dataspace message version {version}")
    if kind == 2:
        return None
    return tuple(buf.uint(dims + i * buf.l, buf.l) for i in range(rank))


# --------------------------------------------------------- global heaps
def _vlen_strings(buf: _Buffer, raw: np.ndarray, heaps: dict) -> List[str]:
    """Decode the variable-length string references in ``raw`` (each a
    length, a global heap collection's address and an object index)."""
    out = []
    step = 4 + buf.o + 4
    mem = memoryview(raw.tobytes())
    for i in range(len(mem) // step):
        rec = bytes(mem[i * step:(i + 1) * step])
        length = int.from_bytes(rec[:4], "little")
        coll = int.from_bytes(rec[4:4 + buf.o], "little")
        index = int.from_bytes(rec[4 + buf.o:], "little")
        if length == 0 or coll == 0 or buf.undefined(coll):
            out.append("")
            continue
        objects = heaps.get(coll)
        if objects is None:
            objects = heaps[coll] = _global_heap(buf, coll + buf.base)
        if index not in objects:
            raise HDF5Error(f"global heap {coll}: no object {index}")
        start, size = objects[index]
        out.append(buf.data[start:start + min(size, length)].decode(
            "utf-8", "surrogateescape"))
    return out


def _global_heap(buf: _Buffer, at: int) -> Dict[int, Tuple[int, int]]:
    """{object index: (data offset, size)} of the collection at ``at``."""
    buf.sig(at, b"GCOL", "global heap collection")
    size = buf.uint(at + 8, buf.l)
    end, p = at + size, at + 8 + buf.l
    head = 8 + buf.l
    objects = {}
    while p + head <= end:
        index = buf.uint(p, 2)
        osize = buf.uint(p + 8, buf.l)
        if index == 0:
            break                                     # free space
        objects[index] = (p + head, osize)
        p += head + ((osize + 7) // 8) * 8
    return objects


def _values(buf: _Buffer, t: _Type, shape, raw: np.ndarray, heaps: dict,
            attribute: bool):
    """The stored elements ``raw`` (1-d, of ``t.dtype``) as ``h5py``
    returns them: an array of ``shape``, or for a scalar attribute the
    element itself."""
    if t.kind == "vlen_str":
        strs = _vlen_strings(buf, raw, heaps)
        arr = np.empty(len(strs), dtype=object)
        if attribute:
            arr[:] = strs
        else:                                         # datasets: bytes
            arr[:] = [s.encode("utf-8", "surrogateescape") for s in strs]
    elif t.kind == "fixed":
        arr = raw
        if t.pad == 0:                                # null-terminated
            arr = np.array([v.split(b"\0", 1)[0] for v in raw.tolist()],
                           dtype=t.dtype)
        elif t.pad == 2:                              # space-padded
            arr = np.array([v.rstrip(b" ") for v in raw.tolist()],
                           dtype=t.dtype)
    elif t.kind == "bool":
        arr = raw.astype(bool)
    else:
        arr = raw
    arr = arr.reshape(shape)
    if attribute and shape == ():
        return arr[()]
    return arr


# ---------------------------------------------------------- object headers
class _Header:
    """The messages of one object header: [(type, data offset, size)]."""

    def __init__(self, buf: _Buffer, at: int):
        self.at = at
        self.messages: List[Tuple[int, int, int]] = []
        if buf.data[at:at + 4] == b"OHDR":
            self._v2(buf, at)
        elif buf.uint(at, 1) == 1:
            self._v1(buf, at)
        else:
            raise HDF5Error(f"object header at {at}: version "
                            f"{buf.uint(at, 1)}")

    def _v1(self, buf, at):
        blocks = [(at + 16, buf.uint(at + 8, 4))]
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize = buf.uint(p, 2), buf.uint(p + 2, 2)
                flags = buf.uint(p + 4, 1)
                self._add(buf, mtype, p + 8, msize, flags, blocks)
                p += 8 + msize

    def _v2(self, buf, at):
        flags = buf.uint(at + 5, 1)
        p = at + 6
        if flags & 0x20:
            p += 16                                   # times
        if flags & 0x10:
            p += 4                                    # attribute phase change
        width = 1 << (flags & 3)
        size = buf.uint(p, width)
        p += width
        self.creation_order = bool(flags & 0x04)
        blocks = [(p, size)]
        while blocks:
            start, size = blocks.pop(0)
            q, end = start, start + size
            head = 4 + (2 if self.creation_order else 0)
            while q + head <= end:
                mtype, msize = buf.uint(q, 1), buf.uint(q + 1, 2)
                mflags = buf.uint(q + 3, 1)
                self._add(buf, mtype, q + head, msize, mflags, blocks,
                          v2=True)
                q += head + msize

    def _add(self, buf, mtype, start, size, flags, blocks, v2=False):
        if mtype == _CONTINUATION:
            addr = buf.addr(start)
            length = buf.uint(start + buf.o, buf.l)
            if v2:
                buf.sig(addr, b"OCHK", "object header continuation")
                blocks.append((addr + 4, length - 8))
            else:
                blocks.append((addr, length))
            return
        if mtype == _NIL:
            return
        if flags & 0x02:
            raise UnsupportedHDF5Feature(
                f"shared (committed) messages of type {mtype:#x}",
                f"object header at {self.at}")
        self.messages.append((mtype, start, size))

    def all(self, mtype):
        return [(s, n) for t, s, n in self.messages if t == mtype]

    def one(self, mtype):
        got = self.all(mtype)
        return got[0] if got else None


# ---------------------------------------------------------------- objects
class _Object:
    """What groups and datasets share: the file, the header, the name and
    the attributes."""

    def __init__(self, file: "File", header: _Header, name: str):
        self._file = file
        self._header = header
        self.name = name
        self._attrs: Optional[AttributeManager] = None

    @property
    def file(self) -> "File":
        return self._file

    @property
    def attrs(self) -> "AttributeManager":
        if self._attrs is None:
            self._attrs = AttributeManager(self)
        return self._attrs


class AttributeManager(Mapping):
    """An object's attributes, read once, as a read-only mapping in name
    order."""

    def __init__(self, obj: _Object):
        buf, header = obj._file._buf, obj._header
        where = f"attributes of {obj.name!r}"
        info = header.one(_ATTRIBUTE_INFO)
        if info is not None:
            start, _ = info
            flags = buf.uint(start + 1, 1)
            p = start + 2 + (2 if flags & 1 else 0)
            if buf.addr(p) is not None:
                raise UnsupportedHDF5Feature(
                    "dense attribute storage in a fractal heap", where)
        self._values = {}
        for start, _size in header.all(_ATTRIBUTE):
            name, value = _parse_attribute(buf, start, obj._file._heaps,
                                           where)
            self._values[name] = value

    def __getitem__(self, name):
        return self._values[name]

    def __iter__(self):
        return iter(sorted(self._values, key=lambda s: s.encode()))

    def __len__(self):
        return len(self._values)


def _parse_attribute(buf: _Buffer, at: int, heaps: dict, where: str):
    version = buf.uint(at, 1)
    flags = buf.uint(at + 1, 1)
    name_size, type_size, space_size = (buf.uint(at + 2, 2),
                                        buf.uint(at + 4, 2),
                                        buf.uint(at + 6, 2))
    if version in (2, 3) and flags & 0x03:
        raise UnsupportedHDF5Feature("attributes of shared datatypes or "
                                     "dataspaces", where)

    def padded(n):
        return ((n + 7) // 8) * 8 if version == 1 else n

    p = at + 8 + (1 if version == 3 else 0)
    if version not in (1, 2, 3):
        raise HDF5Error(f"attribute message version {version} ({where})")
    name = buf.data[p:p + name_size].split(b"\0", 1)[0].decode("utf-8")
    p += padded(name_size)
    t, _ = _parse_type(buf, p, f"{where}: {name!r}")
    p += padded(type_size)
    shape = _parse_space(buf, p)
    p += padded(space_size)
    if shape is None:
        return name, Empty(t.value_dtype)
    count = int(np.prod(shape, dtype=np.int64))
    raw = np.frombuffer(buf.data, dtype=t.dtype, count=count, offset=p)
    return name, _values(buf, t, shape, raw, heaps, attribute=True)


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``np.asarray(ds)``, ``ds[()]``."""

    def __init__(self, file, header, name):
        super().__init__(file, header, name)
        buf = file._buf
        where = f"dataset {name!r}"
        if header.one(_FILTERS) is not None:
            raise UnsupportedHDF5Feature("filter pipelines", where)
        if header.one(_EXTERNAL) is not None:
            raise UnsupportedHDF5Feature("external storage", where)
        self._type, _ = _parse_type(buf, header.one(_DATATYPE)[0], where)
        self.shape = _parse_space(buf, header.one(_DATASPACE)[0])
        self._where = where
        self._data = self._layout(buf, header.one(_LAYOUT)[0], where)

    def _layout(self, buf, at, where):
        """(offset, stored bytes) of the data, or None where no storage
        was allocated (the fill value, which this reader takes as 0)."""
        version = buf.uint(at, 1)
        if version in (1, 2):
            rank, cls = buf.uint(at + 1, 1), buf.uint(at + 2, 1)
            p = at + 8
            if cls == 2:
                raise UnsupportedHDF5Feature("chunked layouts", where)
            addr = None
            if cls == 1:
                addr = buf.addr(p)
                p += buf.o
            p += 4 * rank
            if cls == 0:
                return p + 4, buf.uint(p, 4)
            return (None if addr is None else (addr, None))
        if version in (3, 4):
            cls = buf.uint(at + 1, 1)
            if cls == 0:
                return at + 4, buf.uint(at + 2, 2)
            if cls == 1:
                addr = buf.addr(at + 2)
                return None if addr is None else (
                    addr, buf.uint(at + 2 + buf.o, buf.l))
            raise UnsupportedHDF5Feature(
                {2: "chunked layouts", 3: "virtual layouts"}.get(
                    cls, f"layout class {cls}"), where)
        raise HDF5Error(f"layout message version {version} ({where})")

    @property
    def dtype(self) -> np.dtype:
        return self._type.value_dtype

    def _read(self):
        if self.shape is None:
            return Empty(self.dtype)
        count = int(np.prod(self.shape, dtype=np.int64))
        t = self._type
        if self._data is None or count == 0:
            raw = np.zeros(count, dtype=t.dtype)
        else:
            start, _stored = self._data
            raw = np.frombuffer(self._file._buf.data, dtype=t.dtype,
                                count=count, offset=start).copy()
        return _values(self._file._buf, t, self.shape, raw,
                       self._file._heaps, attribute=False)

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        if isinstance(arr, Empty):
            raise TypeError(f"{self._where} has a null dataspace")
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, key):
        arr = self._read()
        if isinstance(arr, Empty):
            return arr
        return arr[key]

    def __repr__(self):
        return (f'<HDF5 dataset "{self.name.rsplit("/", 1)[-1]}": shape '
                f'{self.shape}, type "{self.dtype.str}">')


class Group(_Object, Mapping):
    """A group: its member names, in order, and the members by name or
    path (``"a/b"``, ``"/a"``), as a read-only mapping."""

    def __init__(self, file, header, name):
        super().__init__(file, header, name)
        self._links: Optional[Dict[str, tuple]] = None

    # the links: {name: ("hard", header address) | ("soft", path)}
    def _read_links(self) -> Dict[str, tuple]:
        if self._links is not None:
            return self._links
        buf, header = self._file._buf, self._header
        where = f"group {self.name!r}"
        links: Dict[str, tuple] = {}
        table = header.one(_SYMBOL_TABLE)
        if table is not None:
            start, _ = table
            _symbol_table(buf, buf.addr(start), buf.addr(start + buf.o),
                          links)
        info = header.one(_LINK_INFO)
        if info is not None:
            start, _ = info
            flags = buf.uint(start + 1, 1)
            p = start + 2 + (8 if flags & 1 else 0)
            if buf.addr(p) is not None:
                raise UnsupportedHDF5Feature(
                    "dense link storage in a fractal heap", where)
        for start, _ in header.all(_LINK):
            name, target = _parse_link(buf, start, where)
            links[name] = target
        self._links = links
        return links

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._read_links(), key=lambda s: s.encode()))

    def __len__(self):
        return len(self._read_links())

    def __getitem__(self, path):
        return self._resolve(path)

    def _resolve(self, path: str, depth: int = 0):
        if not isinstance(path, str):
            raise TypeError(f"member names are strings, not {path!r}")
        if depth > 32:
            raise HDF5Error(f"soft links nest too deep at {path!r}")
        node = self._file if path.startswith("/") else self
        for part in [p for p in path.split("/") if p and p != "."]:
            if not isinstance(node, Group):
                raise KeyError(path)
            target = node._read_links().get(part)
            if target is None:
                raise KeyError(f"no member {part!r} in {node.name!r}")
            kind, value = target
            child = (node.name.rstrip("/") + "/" + part)
            if kind == "soft":
                node = node._resolve(value, depth + 1)
            else:
                node = self._file._open(value, child)
        return node

    def __repr__(self):
        return f'<HDF5 group "{self.name}" ({len(self)} members)>'

    __hash__ = object.__hash__
    __eq__ = object.__eq__


def _symbol_table(buf: _Buffer, btree: int, heap: int,
                  links: Dict[str, tuple]):
    """Add the entries of a v1 B-tree (type 0) group to ``links``."""
    buf.sig(heap, b"HEAP", "local heap")
    names = buf.addr(heap + 8 + 2 * buf.l)

    def name_at(offset):
        start = names + offset
        return buf.data[start:buf.data.index(b"\0", start)].decode("utf-8")

    def node(at, seen):
        if at in seen:
            raise HDF5Error(f"B-tree cycle at {at}")
        seen.add(at)
        buf.sig(at, b"TREE", "B-tree node")
        if buf.uint(at + 4, 1) != 0:
            raise HDF5Error(f"B-tree node at {at} is not a group node")
        level, used = buf.uint(at + 5, 1), buf.uint(at + 6, 2)
        p = at + 8 + 2 * buf.o
        for i in range(used):
            child = buf.addr(p + buf.l + i * (buf.l + buf.o))
            if level > 0:
                node(child, seen)
            else:
                leaf(child)

    def leaf(at):
        buf.sig(at, b"SNOD", "symbol table node")
        count = buf.uint(at + 6, 2)
        entry = 2 * buf.o + 24
        for i in range(count):
            p = at + 8 + i * entry
            name = name_at(buf.uint(p, buf.o))
            cache = buf.uint(p + 2 * buf.o, 4)
            if cache == 2:                            # a soft link
                links[name] = ("soft", name_at(buf.uint(p + 2 * buf.o + 8,
                                                        4)))
            else:
                links[name] = ("hard", buf.addr(p + buf.o))

    node(btree, set())


def _parse_link(buf: _Buffer, at: int, where: str):
    """(name, ("hard", address) | ("soft", path)) of a link message."""
    flags = buf.uint(at + 1, 1)
    p = at + 2
    kind = 0
    if flags & 0x08:
        kind = buf.uint(p, 1)
        p += 1
    if flags & 0x04:
        p += 8                                        # creation order
    if flags & 0x10:
        p += 1                                        # name charset
    width = 1 << (flags & 3)
    n = buf.uint(p, width)
    p += width
    name = buf.data[p:p + n].decode("utf-8")
    p += n
    if kind == 0:
        return name, ("hard", buf.addr(p))
    if kind == 1:
        size = buf.uint(p, 2)
        return name, ("soft", buf.data[p + 2:p + 2 + size].decode("utf-8"))
    raise UnsupportedHDF5Feature(
        "external links" if kind == 64 else f"link type {kind}",
        f"{where}: {name!r}")


# ------------------------------------------------------------------- file
class File(Group):
    """An HDF5 file opened for reading (``File(path)`` or
    ``File(path, "r")``); its bytes are read once, whole."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"this HDF5 reader opens files read-only, not "
                             f"with mode {mode!r}")
        self.filename = os.fspath(path)
        with open(self.filename, "rb") as fh:
            data = fh.read()
        at = 0
        while data[at:at + 8] != SIGNATURE:
            at = 512 if at == 0 else 2 * at
            if at + 8 > len(data):
                raise HDF5Error(f"{self.filename}: not an HDF5 file")
        self._buf = buf = _Buffer(data)
        self._heaps: dict = {}
        self._objects: dict = {}
        version = buf.uint(at + 8, 1)
        if version in (0, 1):
            buf.o, buf.l = buf.uint(at + 13, 1), buf.uint(at + 14, 1)
            p = at + 24 + (4 if version == 1 else 0)
            buf.base = buf.uint(p, buf.o)
            root_entry = p + 4 * buf.o
            root = buf.addr(root_entry + buf.o)
        elif version in (2, 3):
            buf.o, buf.l = buf.uint(at + 9, 1), buf.uint(at + 10, 1)
            buf.base = buf.uint(at + 12, buf.o)
            root = buf.addr(at + 12 + 3 * buf.o)
        else:
            raise UnsupportedHDF5Feature(f"superblock version {version}")
        self.superblock_version = version
        super().__init__(self, _Header(buf, root), "/")
        self._objects[root] = self

    def _open(self, addr: int, name: str):
        obj = self._objects.get(addr)
        if obj is None:
            header = _Header(self._buf, addr)
            cls = Dataset if header.one(_LAYOUT) is not None else Group
            obj = self._objects[addr] = cls(self, header, name)
        return obj

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
