"""Eager NDArray over a ``torch.Tensor``: counterpart of
``deeplearning4j_tpu/ndarray/ndarray.py`` (ref: ``INDArray`` /
``BaseNDArray``).

The reference keeps an immutable jax array and gives it DL4J's mutable
surface. This port keeps the same observable semantics over a torch
tensor:

- **In-place ops write into the storage.** ``addi``/``assign``/
  ``putScalar`` compute their result, cast it to the array's dtype (by
  truncation, as the reference's ``_binary_i`` casts), and ``copy_`` it
  into the tensor; where the result's shape or dtype differs (the few
  i-ops the reference does not cast back) the array takes the new tensor,
  as the reference rebinds its buffer.
- **Views are logical, as in the reference.** A view records (base,
  index); reading re-slices its base each time, so a view taken before
  ``x.addi(1)`` reads the new values. Writing through a view goes into the
  base's storage where torch can index it in place (every basic index
  except a negative step), else it is scattered into a copy of the base
  that is written up the chain, as the reference scatters. Advanced
  indexing returns copies, in both packages.
- **Reshape, transpose and permute copy.** Torch returns views where the
  reference returns new arrays; the port copies wherever the result would
  share the source's storage (:func:`_fresh`), so a write into
  ``x.reshape(4)`` leaves ``x`` as it was.
- **Arrays wrapping a caller's tensor are copy-on-write.** ``NDArray(t)``
  does not copy ``t``; the first in-place write copies it, so the
  caller's tensor never changes under it (the reference's arrays are
  immutable). ``buf()`` is the live tensor.
- **Types follow the reference with 64-bit types off**: a float64 or
  int64 input becomes float32 or int32; sums of small ints are int32,
  indices int32; ``toNumpy()`` of a bfloat16 array gives float32 (numpy
  has no bfloat16).

Arrays live on the device they were made on: the factory's default
(``factory.setDefaultDevice``) unless the caller names one; an operand
that is not a tensor goes to its array's device.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray import dtypes as _dt

Index = Any

# ----------------------------------------------------------------- device
_DEFAULT_DEVICE = None        # None: the card
_RESOLVED = None


def set_default_device(device) -> None:
    """The device arrays are made on when the caller names none: the
    counterpart of the reference's ``JAX_PLATFORMS``. ``None`` is the
    card, which raises without CUDA."""
    global _DEFAULT_DEVICE, _RESOLVED
    from deeplearning4j_tpu_torch._device import resolve_device
    _RESOLVED = resolve_device(device)
    _DEFAULT_DEVICE = device


def default_device() -> torch.device:
    global _RESOLVED
    if _RESOLVED is None:
        from deeplearning4j_tpu_torch._device import resolve_device
        _RESOLVED = resolve_device(_DEFAULT_DEVICE)
    return _RESOLVED


def device_of(device=None) -> torch.device:
    """``device`` resolved (the card raises without CUDA), else the
    default."""
    if device is None:
        return default_device()
    from deeplearning4j_tpu_torch._device import resolve_device
    return resolve_device(device)


# ------------------------------------------------------------ conversion
def np_to_tensor(a) -> torch.Tensor:
    """``jnp.asarray`` of host data with 64-bit types off, on the CPU: a
    private copy, float64 and int64 narrowed."""
    a = np.asarray(a)
    if getattr(a.dtype, "name", "") == "bfloat16":     # ml_dtypes' array
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    if a.dtype.kind in "OUSV":
        raise TypeError(f"Dtype {a.dtype.str} is not a valid array type; "
                        f"only arrays of numeric types are supported")
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    want = _dt.canonical(t.dtype)
    return t if t.dtype == want else t.to(want)


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as ``dtype`` by XLA's conversion: a float into an integer
    type truncates toward zero and saturates at the type's range, NaN
    going to 0 (torch's own conversion leaves those cases undefined)."""
    if t.dtype == dtype:
        return t
    if t.is_floating_point() and not (dtype.is_floating_point
                                      or dtype.is_complex
                                      or dtype == torch.bool):
        info = torch.iinfo(dtype)
        t = torch.nan_to_num(t.double(), nan=0.0).clamp(info.min, info.max)
    return t.to(dtype)


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` (NDArray, tensor, numpy, list, scalar) as a tensor on
    ``device`` (its own, or the default for host data), cast to ``dtype``
    (a torch dtype) if given."""
    if isinstance(x, NDArray):
        t = x.buf()
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = np_to_tensor(x)
        if device is None:
            device = default_device()
    if device is not None and t.device != torch.device(device):
        t = t.to(device)
    if dtype is not None:
        t = cast(t, dtype)
    return t


def _operand(x, like: torch.Tensor):
    """A binary op's other operand: Python scalars stay weak (both
    packages promote them alike), everything else becomes a tensor on
    ``like``'s device."""
    if isinstance(x, (bool, int, float, complex)):
        return x
    if isinstance(x, NDArray):
        t = x.buf()
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = np_to_tensor(x)
    if t.device != like.device:
        t = t.to(like.device)
    return t


def _unwrap(x):
    if isinstance(x, NDArray):
        return x.buf()
    return x


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.device == b.device and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


def _fresh(t: torch.Tensor, *sources: torch.Tensor) -> torch.Tensor:
    """``t``, copied if it shares storage with a source or is not
    contiguous: the reference's shape ops return new arrays."""
    if not t.is_contiguous() or any(
            isinstance(s, torch.Tensor) and _same_storage(t, s)
            for s in sources):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _index_item(i):
    if isinstance(i, NDArray):
        i = i.buf()
    if isinstance(i, np.ndarray):
        i = np_to_tensor(i)
    if isinstance(i, torch.Tensor):
        return i.long() if (not i.is_floating_point()
                            and i.dtype != torch.bool) else i
    if isinstance(i, np.integer):
        return int(i)
    return i


def _norm_index(idx):
    if isinstance(idx, tuple):
        return tuple(_index_item(i) for i in idx)
    return _index_item(idx)


def _is_basic_index(idx) -> bool:
    items = idx if isinstance(idx, tuple) else (idx,)
    for it in items:
        if isinstance(it, (int, np.integer, slice, type(Ellipsis),
                           type(None))):
            continue
        return False
    return True


def _negative_steps(idx) -> bool:
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in items)


def _dims_of(idx, ndim):
    """Each index item's input dim (None for items that take none)."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    takes = [i for i in items if i is not None and i is not Ellipsis]
    n_ell = ndim - len(takes)
    out, d = [], 0
    for i in items:
        if i is None:
            out.append(None)
        elif i is Ellipsis:
            out.append(None)
            d += n_ell
        else:
            out.append(d)
            d += 1
    return items, out


def getitem(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` with numpy's semantics: a negative-step slice (which
    torch cannot view) becomes a flip and a positive slice (a copy)."""
    if not _negative_steps(idx):
        return t[idx]
    items, dims = _dims_of(idx, t.dim())
    for k, (i, d) in enumerate(zip(items, dims)):
        if isinstance(i, slice) and i.step is not None and i.step < 0:
            n = t.shape[d]
            r = range(*i.indices(n))
            t = torch.flip(t, (d,))
            items[k] = (slice(0, 0) if len(r) == 0 else
                        slice(n - 1 - r[0], n - 1 - r[-1] + 1, -i.step))
    return t[tuple(items)]


def setitem(t: torch.Tensor, idx, value) -> None:
    """``t[idx] = value`` in place, numpy's semantics: the value cast to
    ``t``'s dtype and broadcast; negative steps through flat positions."""
    if isinstance(value, torch.Tensor):
        value = cast(value.to(t.device), t.dtype)
        if _same_storage(value, t):
            value = value.clone()
    if not _negative_steps(idx):
        t[idx] = value
        return
    pos = getitem(torch.arange(t.numel(), device=t.device).reshape(t.shape),
                  idx)
    val = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    flat = t.reshape(-1)
    flat[pos.reshape(-1)] = val.broadcast_to(pos.shape).reshape(-1)
    if not _same_storage(flat, t) or not t.is_contiguous():
        t.copy_(flat.reshape(t.shape))


# ------------------------------------------------------- reduction helpers
def _axes(t, axis):
    if axis is None:
        return tuple(range(t.dim()))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _sum_dtype(dtype):
    if dtype in (torch.bool, torch.int8, torch.int16, torch.int32,
                 torch.int64):
        return torch.int32
    if dtype in (torch.uint8, torch.uint16, torch.uint32, torch.uint64):
        return torch.uint32
    return dtype


def _wide(dt):
    """The type an integer scan or reduction accumulates in: its own,
    unsigned types past uint8 in int64 (torch sums them no other way);
    wrapping to ``dt`` after, as jnp's fixed-width sums wrap."""
    return torch.int64 if dt in (torch.uint16, torch.uint32,
                                 torch.uint64) else dt


def _float_of(t):
    return t if (t.is_floating_point() or t.is_complex()) else t.float()


def r_sum(t, axis=None, keepdims=False):
    dt = _sum_dtype(t.dtype)
    if t.dim() == 0:
        return t.to(dt)
    return torch.sum(t, dim=_axes(t, axis), keepdim=keepdims,
                     dtype=_wide(dt)).to(dt)


def r_mean(t, axis=None, keepdims=False):
    t = _float_of(t)
    if t.dim() == 0:
        return t.clone()
    return torch.mean(t, dim=_axes(t, axis), keepdim=keepdims)


def _one_dim_at_a_time(fn, t, axis, keepdims):
    dims = sorted((d % t.dim() for d in _axes(t, axis)), reverse=True)
    for d in dims:
        t = fn(t, d)
    if not keepdims:
        for d in dims:
            t = t.squeeze(d)
    return t


def r_prod(t, axis=None, keepdims=False):
    dt = _sum_dtype(t.dtype)
    if t.dim() == 0:
        return t.to(dt)
    return _one_dim_at_a_time(
        lambda x, d: torch.prod(x, dim=d, keepdim=True, dtype=_wide(dt)),
        t, axis, keepdims).to(dt)


def r_max(t, axis=None, keepdims=False):
    if t.dim() == 0:
        return t.clone()
    return torch.amax(t, dim=_axes(t, axis), keepdim=keepdims)


def r_min(t, axis=None, keepdims=False):
    if t.dim() == 0:
        return t.clone()
    return torch.amin(t, dim=_axes(t, axis), keepdim=keepdims)


def r_var(t, axis=None, keepdims=False, ddof=0):
    t = _float_of(t)
    if t.dim() == 0:
        t = t.reshape(1)
    return torch.var(t, dim=_axes(t, axis), correction=ddof,
                     keepdim=keepdims)


def r_std(t, axis=None, keepdims=False, ddof=0):
    t = _float_of(t)
    if t.dim() == 0:
        t = t.reshape(1)
    return torch.std(t, dim=_axes(t, axis), correction=ddof,
                     keepdim=keepdims)


def r_argmax(t, axis=None):
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if axis is None:
        return torch.argmax(t.reshape(-1)).to(torch.int32)
    return torch.argmax(t, dim=int(axis)).to(torch.int32)


def r_argmin(t, axis=None):
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if axis is None:
        return torch.argmin(t.reshape(-1)).to(torch.int32)
    return torch.argmin(t, dim=int(axis)).to(torch.int32)


def _scan_dtype(dtype):
    """jnp's cumsum/cumprod type: the input's, bool as int32."""
    return torch.int32 if dtype == torch.bool else dtype


def r_cumsum(t, axis=0):
    dt = _scan_dtype(t.dtype)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return torch.cumsum(t, dim=int(axis), dtype=_wide(dt)).to(dt)


def r_cumprod(t, axis=0):
    dt = _scan_dtype(t.dtype)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return torch.cumprod(t, dim=int(axis), dtype=_wide(dt)).to(dt)


def r_quantile(t, q, axis=None):
    """``jnp.percentile(t, 100 q, axis)`` (linear interpolation)."""
    t = _float_of(t)
    if axis is None or t.dim() == 0:
        flat = t.reshape(-1)
    else:
        dims = [d % t.dim() for d in _axes(t, axis)]
        keep = [d for d in range(t.dim()) if d not in dims]
        flat = t.permute(keep + dims).reshape(
            [t.shape[d] for d in keep] + [-1])
    qt = torch.as_tensor(q, dtype=flat.dtype, device=flat.device)
    return torch.quantile(flat, qt, dim=-1)


def r_sort(t, axis=-1):
    """Stable ascending sort (JAX's sorts are stable)."""
    return torch.sort(t, dim=axis, stable=True)


def rev_dims(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its dims reversed (jnp's ``.T`` at any rank), a view."""
    return t.permute(tuple(range(t.dim() - 1, -1, -1)))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.matmul`` with the reference's ``preferred_element_type``:
    bf16/f16 operands give an f32 product (exact bf16 products, f32
    sums); other types promote as numpy does."""
    if a.dtype in (torch.bfloat16, torch.float16):
        a = a.float()
        if b.dtype in (torch.bfloat16, torch.float16):
            b = b.float()
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


class NDArray:
    """Dense n-dimensional array over a torch tensor with the eager
    DL4J-style API of the reference's NDArray."""

    __slots__ = ("_t", "_base", "_index", "_shared")
    __array_priority__ = 100  # our ops win over numpy's in mixed expressions

    def __init__(self, buf, base: Optional["NDArray"] = None,
                 index: Index = None, device=None):
        self._base = base
        self._index = index
        self._shared = False
        if base is not None:
            self._t = None            # views read lazily from base
        elif isinstance(buf, torch.Tensor):
            self._t = buf if device is None else buf.to(device)
            self._shared = self._t is buf   # the caller's: copy on write
        elif isinstance(buf, NDArray):
            self._t = buf.buf()
            self._shared = True
        else:
            self._t = as_tensor(buf, device_of(device))

    @classmethod
    def _new(cls, t: torch.Tensor) -> "NDArray":
        """An array owning a tensor the port just computed."""
        out = cls.__new__(cls)
        out._t, out._base, out._index, out._shared = t, None, None, False
        return out

    # ------------------------------------------------------------------ core
    def buf(self) -> torch.Tensor:
        """The underlying tensor (a view's slice of its base's)."""
        if self._base is not None:
            return getitem(self._base.buf(), self._index)
        return self._t

    def is_view(self) -> bool:
        return self._base is not None

    def _in_storage(self) -> bool:
        """Whether ``buf()`` is a view of the root's own storage, so a
        write into it lands in the root."""
        if self._base is None:
            return True
        return (isinstance(self._base, NDArray)
                and not _negative_steps(self._index)
                and self._base._in_storage())

    def _own(self):
        """Copy-on-write: a root holding a caller's tensor copies it before
        its first in-place write."""
        node = self
        while node._base is not None:
            node = node._base
            if not isinstance(node, NDArray):
                return
        if node._shared:
            node._t = node._t.clone(memory_format=torch.contiguous_format)
            node._shared = False

    def _write(self, new_buf) -> "NDArray":
        """Write ``new_buf`` into this array; views write into their base
        (in place where they can, else scattered up the chain)."""
        if not isinstance(new_buf, torch.Tensor):
            new_buf = as_tensor(new_buf, self.device)
        if self._base is not None:
            if isinstance(self._base, NDArray) and self._base._in_storage():
                self._own()
                setitem(self._base.buf(), self._index, new_buf)
            else:
                nb = self._base.buf().clone()
                setitem(nb, self._index, new_buf)
                self._base._write(nb)
            return self
        t = self._t
        if (not self._shared and new_buf.shape == t.shape
                and new_buf.dtype == t.dtype and new_buf.device == t.device):
            if new_buf is not t:
                t.copy_(new_buf.clone() if _same_storage(new_buf, t)
                        else new_buf)
        else:
            self._t = new_buf.clone(memory_format=torch.contiguous_format)
            self._shared = False
        return self

    # ----------------------------------------------------------- properties
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.buf().shape)

    @property
    def dtype(self):
        return _dt.from_torch(self.buf().dtype)

    @property
    def device(self) -> torch.device:
        return self.buf().device

    def rank(self) -> int:
        return self.buf().dim()

    @property
    def ndim(self) -> int:
        return self.buf().dim()

    def length(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def isScalar(self) -> bool:
        return self.rank() == 0 or self.length() == 1

    def isVector(self) -> bool:
        return self.rank() == 1 or (self.rank() == 2 and 1 in self.shape)

    def isMatrix(self) -> bool:
        return self.rank() == 2

    def rows(self) -> int:
        return self.shape[0]

    def columns(self) -> int:
        return self.shape[1]

    # ------------------------------------------------------------- convert
    def toNumpy(self) -> np.ndarray:
        t = self.buf().detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.toNumpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self):
        return self.buf().item()

    def __int__(self):
        return int(self.buf())

    def __float__(self):
        return float(self.buf())

    def __bool__(self):
        return bool(self.buf())

    def __len__(self):
        return self.shape[0]

    def getDouble(self, *idx) -> float:
        return float(self.buf()[tuple(idx)] if idx else self.buf())

    def getInt(self, *idx) -> int:
        return int(self.buf()[tuple(idx)] if idx else self.buf())

    def castTo(self, dtype) -> "NDArray":
        t = self.buf()
        return NDArray._new(_fresh(cast(t, _dt.storage(dtype)), t))

    def dup(self) -> "NDArray":
        """Detached copy (views materialize)."""
        return NDArray._new(self.buf().clone(
            memory_format=torch.contiguous_format))

    def detach(self) -> "NDArray":
        return self.dup()

    # ------------------------------------------------------------- indexing
    def __getitem__(self, idx) -> "NDArray":
        idx = _norm_index(idx)
        if _is_basic_index(idx):
            return NDArray(None, base=self, index=idx)
        t = self.buf()
        return NDArray._new(_fresh(getitem(t, idx), t))   # advanced → copy

    def __setitem__(self, idx, value):
        idx = _norm_index(idx)
        value = _unwrap(value)
        if _is_basic_index(idx):
            NDArray(None, base=self, index=idx)._write(
                value if isinstance(value, torch.Tensor)
                else torch.as_tensor(np.asarray(value)).to(self.device))
            return
        nb = self.buf().clone()
        setitem(nb, idx, value if isinstance(value, torch.Tensor)
                else as_tensor(value, nb.device))
        self._write(nb)

    def get(self, *idx) -> "NDArray":
        """Reference: INDArray#get(INDArrayIndex...) — returns a live view.
        Accepts NDArrayIndex objects (point/interval/all/newAxis/indices)
        as well as plain python ints/slices."""
        from deeplearning4j_tpu_torch.ndarray.indexing import resolve
        return self.__getitem__(resolve(idx))

    def put(self, idx, value) -> "NDArray":
        from deeplearning4j_tpu_torch.ndarray.indexing import resolve
        self.__setitem__(resolve(idx), value)
        return self

    def getScalar(self, *idx) -> "NDArray":
        return NDArray._new(self.buf()[tuple(idx)].clone())

    def putScalar(self, idx, value) -> "NDArray":
        if isinstance(idx, (int, np.integer)):
            idx = (int(idx),)
        self[tuple(idx)] = value
        return self

    def getRow(self, i: int) -> "NDArray":
        return self[i]

    def getColumn(self, i: int) -> "NDArray":
        return self[:, i]

    def putRow(self, i: int, row) -> "NDArray":
        return self.put(i, row)

    def putColumn(self, i: int, col) -> "NDArray":
        return self.put((slice(None), i), col)

    def slice_(self, i: int, dim: int = 0) -> "NDArray":
        idx = (slice(None),) * dim + (i,)
        return self.__getitem__(idx)

    def tensorAlongDimension(self, i: int, *dims) -> "NDArray":
        """TAD: the i-th sub-tensor spanning `dims` (ref: shape::TAD)."""
        keep = [d for d in range(self.rank()) if d not in dims]
        t = self.buf()
        out = t.permute(keep + sorted(dims))
        lead = int(np.prod([self.shape[d] for d in keep])) if keep else 1
        out = out.reshape((lead,) + tuple(self.shape[d]
                                          for d in sorted(dims)))
        return NDArray._new(_fresh(out[i], t))

    # --------------------------------------------------------------- shape
    def _shaped(self, fn) -> "NDArray":
        t = self.buf()
        return NDArray._new(_fresh(fn(t), t))

    def reshape(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._shaped(lambda t: t.reshape(tuple(int(s)
                                                      for s in shape)))

    def ravel(self) -> "NDArray":
        return self._shaped(lambda t: t.reshape(-1))

    def flatten(self) -> "NDArray":
        return self.ravel()

    def transpose(self, *axes) -> "NDArray":
        if not axes:
            return self._shaped(rev_dims)
        return self.permute(*axes)

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def permute(self, *axes) -> "NDArray":
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._shaped(lambda t: t.permute(tuple(int(a)
                                                      for a in axes)))

    def swapAxes(self, a: int, b: int) -> "NDArray":
        return self._shaped(lambda t: t.transpose(a, b))

    def broadcast(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._shaped(lambda t: t.broadcast_to(tuple(shape)))

    def repeat(self, repeats, axis: Optional[int] = None) -> "NDArray":
        t = self.buf()
        if not isinstance(repeats, int):
            repeats = as_tensor(repeats, t.device).long()
        return NDArray._new(torch.repeat_interleave(t, repeats, dim=axis))

    def tile(self, reps) -> "NDArray":
        reps = (reps,) if isinstance(reps, int) else tuple(reps)
        return self._shaped(lambda t: torch.tile(t, reps))

    def squeeze(self, axis=None) -> "NDArray":
        if axis is None:
            return self._shaped(lambda t: t.squeeze())
        return self._shaped(lambda t: t.squeeze(
            tuple(axis) if isinstance(axis, (tuple, list)) else axis))

    def expandDims(self, axis: int) -> "NDArray":
        return self._shaped(lambda t: t.unsqueeze(axis))

    # ---------------------------------------------------------- arithmetic
    def _binary(self, other, fn) -> "NDArray":
        t = self.buf()
        return NDArray._new(fn(t, _operand(other, t)))

    def _binary_i(self, other, fn) -> "NDArray":
        t = self.buf()
        return self._write(cast(fn(t, _operand(other, t)), t.dtype))

    def add(self, other):  return self._binary(other, torch.add)
    def sub(self, other):  return self._binary(other, torch.sub)
    def mul(self, other):  return self._binary(other, torch.mul)
    def div(self, other):  return self._binary(other, torch.true_divide)
    def rsub(self, other): return self._binary(other, lambda a, b: b - a)
    def rdiv(self, other): return self._binary(other, lambda a, b: b / a)
    def fmod(self, other): return self._binary(other, torch.fmod)

    def addi(self, other):  return self._binary_i(other, torch.add)
    def subi(self, other):  return self._binary_i(other, torch.sub)
    def muli(self, other):  return self._binary_i(other, torch.mul)
    def divi(self, other):  return self._binary_i(other, torch.true_divide)
    def rsubi(self, other): return self._binary_i(other, lambda a, b: b - a)
    def rdivi(self, other): return self._binary_i(other, lambda a, b: b / a)

    def neg(self):  return NDArray._new(-self.buf())
    def negi(self): return self._write(-self.buf())

    def assign(self, other) -> "NDArray":
        t = self.buf()
        val = as_tensor(other, t.device, t.dtype) if not isinstance(
            other, (bool, int, float)) else cast(torch.tensor(
            other, device=t.device), t.dtype)
        return self._write(val.broadcast_to(t.shape))

    # python operators
    __add__ = add
    __sub__ = sub
    __mul__ = mul
    __truediv__ = div
    __radd__ = add
    __rsub__ = rsub
    __rmul__ = mul
    __rtruediv__ = rdiv
    __neg__ = neg

    def __pow__(self, p):
        t = self.buf()
        return NDArray._new(t ** _operand(p, t))

    def __matmul__(self, other): return self.mmul(other)

    # broadcast-with-dimension ops (ref: INDArray#addRowVector etc.)
    def _vec(self, v, fn, row):
        t = self.buf()
        b = as_tensor(v, t.device)
        return NDArray._new(fn(t, b.reshape(1, -1) if row
                               else b.reshape(-1, 1)))

    def addRowVector(self, v):  return self._vec(v, torch.add, True)
    def addColumnVector(self, v): return self._vec(v, torch.add, False)
    def mulRowVector(self, v):  return self._vec(v, torch.mul, True)
    def mulColumnVector(self, v): return self._vec(v, torch.mul, False)
    def subRowVector(self, v):  return self._vec(v, torch.sub, True)
    def subColumnVector(self, v): return self._vec(v, torch.sub, False)
    def divRowVector(self, v):  return self._vec(v, torch.true_divide, True)
    def divColumnVector(self, v): return self._vec(v, torch.true_divide,
                                                   False)

    # ------------------------------------------------------------- matmuls
    def mmul(self, other) -> "NDArray":
        """Matrix multiply; bf16 inputs give an f32 product."""
        t = self.buf()
        return NDArray._new(matmul(t, as_tensor(other, t.device)))

    def mmuli(self, other) -> "NDArray":
        return self._write(self.mmul(other).buf())

    def dot(self, other) -> float:
        t = self.buf()
        o = as_tensor(other, t.device)
        dt = torch.promote_types(t.dtype, o.dtype)
        return float(torch.dot(t.reshape(-1).to(dt), o.reshape(-1).to(dt)))

    def tensorMmul(self, other, axes) -> "NDArray":
        t = self.buf()
        o = as_tensor(other, t.device)
        dt = torch.promote_types(t.dtype, o.dtype)
        return NDArray._new(torch.tensordot(t.to(dt), o.to(dt), dims=axes))

    # ----------------------------------------------------------- reductions
    def _reduce(self, fn, dim, keepdims=False):
        axis = None if dim is None else (tuple(dim) if isinstance(
            dim, (tuple, list)) else dim)
        t = self.buf()
        out = fn(t, axis, keepdims) if axis is not None else fn(t, None,
                                                                False)
        return NDArray._new(out)

    def sum(self, dim=None, keepdims=False):  return self._reduce(r_sum, dim, keepdims)
    def mean(self, dim=None, keepdims=False): return self._reduce(r_mean, dim, keepdims)
    def prod(self, dim=None, keepdims=False): return self._reduce(r_prod, dim, keepdims)
    def max(self, dim=None, keepdims=False):  return self._reduce(r_max, dim, keepdims)
    def min(self, dim=None, keepdims=False):  return self._reduce(r_min, dim, keepdims)

    def std(self, dim=None, keepdims=False, bias_corrected=True):
        ddof = 1 if bias_corrected else 0
        return self._reduce(lambda t, a, k: r_std(t, a, k, ddof), dim,
                            keepdims)

    def var(self, dim=None, keepdims=False, bias_corrected=True):
        ddof = 1 if bias_corrected else 0
        return self._reduce(lambda t, a, k: r_var(t, a, k, ddof), dim,
                            keepdims)

    def norm1(self, dim=None, keepdims=False):
        return self._reduce(lambda t, a, k: r_sum(t.abs(), a, k), dim,
                            keepdims)

    def norm2(self, dim=None, keepdims=False):
        return self._reduce(lambda t, a, k: torch.sqrt(r_sum(t * t, a, k)),
                            dim, keepdims)

    def normmax(self, dim=None, keepdims=False):
        return self._reduce(lambda t, a, k: r_max(t.abs(), a, k), dim,
                            keepdims)

    def argMax(self, dim=None):
        return NDArray._new(r_argmax(self.buf(), dim))

    def argMin(self, dim=None):
        return NDArray._new(r_argmin(self.buf(), dim))

    def cumsum(self, dim=0):  return NDArray._new(r_cumsum(self.buf(), dim))
    def cumprod(self, dim=0): return NDArray._new(r_cumprod(self.buf(), dim))

    def sumNumber(self):  return float(r_sum(self.buf()))
    def meanNumber(self): return float(r_mean(self.buf()))
    def maxNumber(self):  return float(r_max(self.buf()))
    def minNumber(self):  return float(r_min(self.buf()))

    # ---------------------------------------------------------- comparisons
    def gt(self, other):  return self._binary(other, torch.gt)
    def gte(self, other): return self._binary(other, torch.ge)
    def lt(self, other):  return self._binary(other, torch.lt)
    def lte(self, other): return self._binary(other, torch.le)
    def eq(self, other):  return self._binary(other, torch.eq)
    def neq(self, other): return self._binary(other, torch.ne)

    __gt__ = gt
    __ge__ = gte
    __lt__ = lt
    __le__ = lte

    def equalsWithEps(self, other, eps=1e-5) -> bool:
        t = self.buf()
        o = as_tensor(other, t.device)
        if tuple(o.shape) != self.shape:
            return False
        return bool(torch.all(torch.abs(t.float() - o.float()) <= eps))

    def equals(self, other) -> bool:
        return self.equalsWithEps(other, 1e-5)

    def __eq__(self, other):
        if isinstance(other, (NDArray, np.ndarray, torch.Tensor, int,
                              float)):
            return self.eq(other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (NDArray, np.ndarray, torch.Tensor, int,
                              float)):
            return self.neq(other)
        return NotImplemented

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------- display
    def __repr__(self):
        return (f"NDArray{self.shape}<{self.dtype}>\n"
                f"{np.array2string(self.toNumpy(), precision=4, suppress_small=True)}")

    def shapeInfoToString(self) -> str:
        return f"rank={self.rank()}, shape={list(self.shape)}, dtype={self.dtype}"


# --------------------------------------------------------------------------
# INDArray surface widening (ref: org.nd4j.linalg.api.ndarray.INDArray —
# predicates, conversions, i-variant broadcast ops, absolute-value
# reductions, distances, and conditional replacement)
def _is_int(t):
    return not (t.is_floating_point() or t.is_complex()
                or t.dtype == torch.bool)


def _extend_ndarray():
    N = NDArray

    # ------------------------------------------------------- predicates
    N.isRowVector = lambda self: self.rank() == 2 and self.shape[0] == 1 or self.rank() == 1
    N.isColumnVector = lambda self: self.rank() == 2 and self.shape[1] == 1
    N.isSquare = lambda self: self.rank() == 2 and self.shape[0] == self.shape[1]
    N.isEmpty = lambda self: self.length() == 0
    N.isAttached = lambda self: False          # no workspaces
    N.isR = lambda self: self.buf().is_floating_point()
    N.isZ = lambda self: _is_int(self.buf())
    N.isB = lambda self: self.buf().dtype == torch.bool
    N.ordering = lambda self: "c"
    N.stride = lambda self: tuple(
        int(np.prod(self.shape[i + 1:], dtype=np.int64))
        for i in range(len(self.shape)))
    N.offset = lambda self: 0
    N.isNaN = lambda self: NDArray._new(torch.isnan(self.buf()))
    N.isInfinite = lambda self: NDArray._new(torch.isinf(self.buf()))

    # ------------------------------------------------------ conversions
    N.toDoubleVector = lambda self: self.toNumpy().astype(np.float64).reshape(-1)
    N.toFloatVector = lambda self: self.toNumpy().astype(np.float32).reshape(-1)
    N.toIntVector = lambda self: self.toNumpy().astype(np.int32).reshape(-1)
    N.toLongVector = lambda self: self.toNumpy().astype(np.int64).reshape(-1)
    N.toDoubleMatrix = lambda self: self.toNumpy().astype(np.float64).reshape(self.shape[0], -1)
    N.toFloatMatrix = lambda self: self.toNumpy().astype(np.float32).reshape(self.shape[0], -1)
    N.toIntMatrix = lambda self: self.toNumpy().astype(np.int32).reshape(self.shape[0], -1)

    # ----------------------------------------------- broadcast i-variants
    def _bcast_i(op, axis_row):
        def f(self, vec):
            t = self.buf()
            v = as_tensor(vec, t.device).reshape(-1)
            other = v[None, :] if axis_row else v[:, None]
            return self._write(op(t, other))
        return f

    N.addiRowVector = _bcast_i(torch.add, True)
    N.addiColumnVector = _bcast_i(torch.add, False)
    N.subiRowVector = _bcast_i(torch.sub, True)
    N.subiColumnVector = _bcast_i(torch.sub, False)
    N.muliRowVector = _bcast_i(torch.mul, True)
    N.muliColumnVector = _bcast_i(torch.mul, False)
    N.diviRowVector = _bcast_i(torch.true_divide, True)
    N.diviColumnVector = _bcast_i(torch.true_divide, False)

    # ---------------------------------------------- scalar/elementwise ops
    N.fmodi = lambda self, o: self._write(torch.fmod(self.buf(), _operand(o, self.buf())))
    N.remainder = lambda self, o: NDArray._new(torch.remainder(self.buf(), _operand(o, self.buf())))
    N.remainderi = lambda self, o: self._write(torch.remainder(self.buf(), _operand(o, self.buf())))

    # --------------------------------------------- absolute-value reduces
    def _red(fn):
        def f(self, *dims, keepdims=False):
            axis = dims if dims else None
            return NDArray._new(fn(self.buf().abs(), axis, keepdims))
        return f

    N.amax = _red(r_max)
    N.amin = _red(r_min)
    N.amean = _red(r_mean)
    N.asum = _red(r_sum)
    N.amaxNumber = lambda self: float(r_max(self.buf().abs()))
    N.aminNumber = lambda self: float(r_min(self.buf().abs()))
    N.ameanNumber = lambda self: float(r_mean(self.buf().abs()))
    N.stdNumber = lambda self, ddof=1: float(r_std(self.buf(), ddof=ddof))
    N.varNumber = lambda self, ddof=1: float(r_var(self.buf(), ddof=ddof))
    N.prodNumber = lambda self: float(r_prod(self.buf()))
    N.norm1Number = lambda self: float(r_sum(self.buf().abs()))
    N.norm2Number = lambda self: float(torch.sqrt(r_sum(torch.square(self.buf()))))
    N.normmaxNumber = lambda self: float(r_max(self.buf().abs()))
    N.entropyNumber = lambda self: float(-r_sum(
        self.buf() * torch.log(torch.where(self.buf() > 0, self.buf(),
                                           1.0))))

    # ----------------------------------------------------------- distances
    def _diff(self, o):
        t = self.buf()
        return t - _operand(o, t)

    N.distance1 = lambda self, o: float(r_sum(_diff(self, o).abs()))
    N.distance2 = lambda self, o: float(torch.sqrt(r_sum(torch.square(_diff(self, o)))))
    N.squaredDistance = lambda self, o: float(r_sum(torch.square(_diff(self, o))))

    # --------------------------------------------------------- conditional
    def replaceWhere(self, replacement, cond):
        """ref: INDArray#replaceWhere(INDArray, Condition) — elements where
        ``cond`` holds are taken from ``replacement`` (in place)."""
        t = self.buf()
        mask = _cond_mask(t, cond)
        rep = as_tensor(replacement, t.device, t.dtype).broadcast_to(t.shape)
        return self._write(torch.where(mask, rep, t))

    def getWhere(self, comp, cond):
        """ref: INDArray#getWhere — elements matching the condition (1-D)."""
        t = self.buf()
        return NDArray._new(t[_cond_mask(t, cond)])

    N.replaceWhere = replaceWhere
    N.getWhere = getWhere

    # -------------------------------------------------------------- rows
    def _rows(self, *idx):
        t = self.buf()
        return NDArray._new(t[torch.as_tensor(idx, device=t.device).long()])

    def _cols(self, *idx):
        t = self.buf()
        return NDArray._new(t[:, torch.as_tensor(idx,
                                                 device=t.device).long()])

    N.getRows = _rows
    N.getColumns = _cols
    N.subArray = lambda self, offsets, shape: NDArray._new(
        self.buf()[tuple(slice(o, o + s) for o, s in zip(offsets, shape))]
        .clone())

    # ------------------------------------------------------ workspace no-ops
    N.leverage = lambda self: self
    N.leverageTo = lambda self, *_a: self
    N.migrate = lambda self: self
    N.detach_ = N.detach


_CONDITIONS = {"lessthan": torch.lt, "greaterthan": torch.gt,
               "lessthanorequal": torch.le, "greaterthanorequal": torch.ge,
               "equals": torch.eq, "notequals": torch.ne}


def _cond_mask(buf: torch.Tensor, cond) -> torch.Tensor:
    """Condition → boolean mask (ref: org.nd4j.linalg.indexing.conditions):
    accepts a Conditions-style (name, value) tuple, a callable, or a
    boolean array."""
    if isinstance(cond, tuple) and len(cond) == 2 and isinstance(cond[0], str):
        name, v = cond
        return _CONDITIONS[name.lower().replace("_", "")](
            buf, _operand(v, buf))
    if callable(cond):
        return as_tensor(cond(buf), buf.device)
    return as_tensor(cond, buf.device).to(torch.bool)


_extend_ndarray()


def _extend_ndarray_tranche2():
    """INDArray surface, tranche 2 (the ordering/statistics/boolean long
    tail)."""
    N = NDArray

    # ------------------------------------------------ sorting / statistics
    def _sort(self, dim=-1, ascending=True):
        out = r_sort(self.buf(), dim).values
        return NDArray._new(out if ascending else torch.flip(out, (dim,)))

    N.sort = _sort
    N.sortAlongDimension = N.sort

    def _sort_with_indices(self, dim=-1, ascending=True):
        # argsort then flip; values come from the same permutation so both
        # halves always agree
        t = self.buf()
        idx = r_sort(t, dim).indices
        if not ascending:
            idx = torch.flip(idx, (dim,))
        vals = torch.gather(t, dim, idx)
        return NDArray._new(idx.to(torch.int32)), NDArray._new(vals)

    N.sortWithIndices = _sort_with_indices
    N.median = lambda self, *dims: NDArray._new(
        r_quantile(self.buf(), 0.5, dims or None))
    N.medianNumber = lambda self: float(r_quantile(self.buf(), 0.5))
    N.percentile = lambda self, q, *dims: NDArray._new(
        r_quantile(self.buf(), float(q) / 100.0, dims or None))
    N.percentileNumber = lambda self, q: float(
        r_quantile(self.buf(), float(q) / 100.0))
    N.argSort = lambda self, dim=-1: NDArray._new(
        r_sort(self.buf(), dim).indices.to(torch.int32))

    # ------------------------------------------------ boolean reductions
    N.all = lambda self: bool(torch.all(self.buf()))
    N.any = lambda self: bool(torch.any(self.buf()))
    N.none = lambda self: not bool(torch.any(self.buf()))
    N.countNonZero = lambda self: int(torch.count_nonzero(self.buf()))
    N.countZero = lambda self: int(self.length()
                                   - torch.count_nonzero(self.buf()))
    N.eps = lambda self, other, eps=1e-5: NDArray._new(
        torch.abs(self.buf() - as_tensor(other, self.device)) < eps)

    # ------------------------------------------------ scalar accessors
    N.getFloat = N.getDouble            # same accessor, float32 surface
    N.getLong = N.getInt
    N.maxIndex = lambda self: int(r_argmax(self.buf()))
    N.minIndex = lambda self: int(r_argmin(self.buf()))

    # ------------------------------------------------ structure helpers
    N.like = lambda self: NDArray._new(torch.zeros_like(self.buf()))
    N.ulike = N.like                      # no uninitialized memory here
    N.toBoolVector = lambda self: self.toNumpy().astype(bool).reshape(-1)
    N.vectorsAlongDimension = lambda self, dim: int(
        self.length() // self.shape[dim])
    N.tensorsAlongDimension = lambda self, *dims: int(
        self.length() // int(np.prod([self.shape[d] for d in dims],
                                     dtype=np.int64)))
    N.cumsumi = lambda self, dim=0: self.assign(r_cumsum(self.buf(), dim))
    N.cumprodi = lambda self, dim=0: self.assign(r_cumprod(self.buf(), dim))

    # ------------------------------------------- reverse vector-op family
    N.rsubRowVector = lambda self, v: self._vec(v, lambda a, b: b - a, True)
    N.rsubColumnVector = lambda self, v: self._vec(v, lambda a, b: b - a, False)
    N.rdivRowVector = lambda self, v: self._vec(v, lambda a, b: b / a, True)
    N.rdivColumnVector = lambda self, v: self._vec(v, lambda a, b: b / a, False)


_extend_ndarray_tranche2()
