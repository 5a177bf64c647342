"""The threshold gradient codec (K6): the dense sign-mask exchange of the
compressed data-parallel step and the sparse ±(idx+1) wire format.

Counterpart of ``deeplearning4j_tpu/kernels/threshold.py`` (the sparse
form: ``threshold_encode`` :36, ``threshold_decode`` :61,
``sparse_from_dense`` :79, ``dense_from_sparse`` :90) and of the codec
arithmetic in ``deeplearning4j_tpu/parallel/compression.py``
(``encode_dense`` :259 and ``exchange_bucket`` :266), which XLA fuses on the
TPU. Four hand-written CUDA kernels for Hopper, in ``csrc/threshold.cu``,
built with ``nvcc`` for ``sm_90a`` at first use:

- K6e (:func:`encode_dense`): ``acc = g + residual``, the int8 signs of
  ``|acc| >= t`` and the bucket's three all-reduce scalars
  ``(scale_local·has, has, fired/size)``, reduced in a fixed order (no
  float atomics: the scale repeats bit for bit); ``t`` stays on the device.
- K6d (:func:`decode_dense`): after the all-reduces, ``decoded = wire ·
  scale / n``, ``residual' = acc − signs·scale`` and ``Σ residual'²``;
  ``decoded`` may be ``g``'s own buffer.
- K6s-enc (:func:`threshold_encode`, :func:`sparse_from_dense`): an ordered
  stream compaction, capacity-bounded and first by flat index, n in slot 0.
- K6s-dec (:func:`threshold_decode`, :func:`dense_from_sparse`): a scatter
  decode; indices out of range are dropped, duplicates add.

Beside them their plain versions (``*_reference``, ``torch.nonzero`` and
``index_add_``); a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. ``launches_encode``, ``launches_decode``,
``launches_sparse_encode`` and ``launches_sparse_decode`` count the
kernels' launches.

What bounds them on the H100: memory alone. K6e moves 9 bytes an element,
K6d about 18 (ResNet-50's 23.9 M-element bucket: 0.064 ms and 0.13 ms at
3.35 TB/s); ``PERF.md`` holds their times beside it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_encode = 0
launches_decode = 0
launches_sparse_encode = 0
launches_sparse_decode = 0

_fns = {}

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ARGS = {
    "dl4j_k6_encode": [_P, _P, _P, _P, _LL, _P, _P, _P, _P],
    "dl4j_k6_decode": [_P, _P, _P, _P, _I, _P, _F, _P, _P, _LL, _P, _P, _P],
    "dl4j_k6s_encode": [_P, _I, _F, _LL, _LL, _P, _P, _P, _P, _P],
    "dl4j_k6s_decode": [_P, _LL, _I, _F, _P, _I, _LL, _P],
}


def _kernel(fn: str):
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        k = _fns[fn] = _build.bind("threshold", fn, _ARGS[fn],
                                   "dl4j_k6_error_string")
    return k


def _const(fn: str) -> int:
    from deeplearning4j_tpu_torch.kernels import _build
    f = getattr(_build.load("threshold"), fn)
    f.restype = ctypes.c_int
    return int(f())


# ------------------------------------------------------------ plain versions
def encode_dense_reference(g: torch.Tensor, residual: torch.Tensor,
                           threshold) -> Tuple[torch.Tensor, torch.Tensor]:
    """(signs (n,) int8, packed (3,) f32): the reference's
    ``encode_dense(g + residual, t)`` and, of the fired entries, the
    count, ``scale_local = Σ|acc|·fired / max(k, 1)`` and ``has = k > 0``,
    packed as ``(scale_local·has, has, mean(fired))``."""
    acc = g + residual
    signs = torch.where(acc.abs() >= threshold, torch.sign(acc),
                        torch.zeros((), dtype=acc.dtype, device=acc.device)
                        ).to(torch.int8)
    fired = signs.abs().float()
    k = fired.sum()
    scale_local = (acc.abs() * fired).sum() / torch.clamp_min(k, 1.0)
    has = (k > 0).float()
    return signs, torch.stack([scale_local * has, has,
                               k / float(fired.numel())])


def decode_dense_reference(g: torch.Tensor, residual: torch.Tensor,
                           signs: torch.Tensor, wire: torch.Tensor,
                           packed: torch.Tensor, n_replicas: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(decoded, residual', Σ residual'²) after the all-reduces: ``packed``
    holds the replicas' summed ``(scale_local·has, has)`` first, ``wire``
    the summed signs."""
    acc = g + residual
    scale = packed[0] / torch.clamp_min(packed[1], 1.0)
    sent = signs.float() * scale
    decoded = wire.float() * (scale / n_replicas)
    new_res = acc - sent
    return decoded, new_res, torch.sum(new_res * new_res)


def _sparse_reference(flat, hit, sign, threshold, capacity, with_residual):
    idx = torch.nonzero(hit).flatten()[:capacity]
    n = idx.numel()
    s = sign[idx]
    entries = torch.zeros(capacity, dtype=torch.int32, device=flat.device)
    entries[:n] = ((idx + 1) * s.long()).to(torch.int32)
    encoded = torch.cat([torch.tensor([n], dtype=torch.int32,
                                      device=flat.device), entries])
    if not with_residual:
        return encoded, None
    delta = torch.zeros_like(flat).index_add_(0, idx,
                                              s.to(flat.dtype) * threshold)
    return encoded, flat - delta


def threshold_encode_reference(updates: torch.Tensor, threshold,
                               capacity: int):
    """(encoded (capacity+1,) int32, residual_after) of the reference's
    ``threshold_encode``: hits ``|x| >= t`` (NaN never), the first
    ``capacity`` by flat index as ±(idx+1) (0 for a zero at t = 0), their
    count in slot 0, ±t taken from the residual at those positions."""
    flat = updates.reshape(-1).float()
    encoded, res = _sparse_reference(flat, flat.abs() >= threshold,
                                     torch.sign(flat), threshold, capacity,
                                     True)
    return encoded, res.reshape(updates.shape)


def sparse_from_dense_reference(signs: torch.Tensor,
                                capacity: int) -> torch.Tensor:
    """The reference's ``sparse_from_dense``: a dense sign mask to the
    wire format."""
    flat = signs.reshape(-1)
    return _sparse_reference(flat, flat != 0, flat, 0.0, capacity, False)[0]


def _decode_reference(encoded, size, use_n, vals_of, dtype):
    entries = encoded[1:].long()
    valid = entries != 0
    if use_n:
        slot = torch.arange(entries.numel(), device=entries.device)
        valid &= slot < encoded[0].long()
    idx = entries.abs() - 1
    valid &= idx < size
    out = torch.zeros(size, dtype=dtype, device=encoded.device)
    return out.index_add_(0, idx[valid], vals_of(torch.sign(entries[valid])))


def threshold_decode_reference(encoded: torch.Tensor, threshold,
                               shape) -> torch.Tensor:
    """The reference's ``threshold_decode``: ±t at |e|−1 for the slots
    below n with a non-zero entry, duplicates added, out-of-range
    indices dropped."""
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    return _decode_reference(encoded, size, True,
                             lambda s: s.float() * threshold,
                             torch.float32).reshape(shape)


def dense_from_sparse_reference(encoded: torch.Tensor,
                                size: int) -> torch.Tensor:
    """The reference's ``dense_from_sparse``: an int8 ±1 mask (every
    non-zero entry, slot 0 not read)."""
    return _decode_reference(encoded, size, False,
                             lambda s: s.to(torch.int8), torch.int8)


# ------------------------------------------------------------------ wrappers
def _check_f32(name: str, what: str, t: torch.Tensor, n: Optional[int]):
    if (not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous()
            or (n is not None and t.numel() != n)):
        raise ValueError(f"{name}: {what} must be a contiguous float32 CUDA "
                         f"tensor of {n} elements, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_same(name: str, ref: torch.Tensor, *ts):
    for t in ts:
        if t.device != ref.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{ref.device}")


def encode_dense(g: torch.Tensor, residual: torch.Tensor,
                 threshold: torch.Tensor, signs: Optional[torch.Tensor] = None,
                 packed: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6e: (signs (n,) int8, packed (3,) f32) for a 1-D f32 bucket ``g``,
    its ``residual`` and a 0-d f32 ``threshold`` tensor on the same device
    (read there, never on the host). ``signs`` and ``packed`` may be given
    to be written. A CPU tensor takes :func:`encode_dense_reference`."""
    global launches_encode
    if g.device.type == "cpu":
        s, p = encode_dense_reference(g, residual, threshold)
        if signs is not None:
            signs.copy_(s)
            s = signs
        if packed is not None:
            packed.copy_(p)
            p = packed
        return s, p
    n = g.numel()
    _check_f32("encode_dense", "g", g, None)
    _check_f32("encode_dense", "residual", residual, n)
    _check_f32("encode_dense", "threshold", threshold, 1)
    _check_same("encode_dense", g, residual, threshold)
    if signs is None:
        signs = torch.empty(n, dtype=torch.int8, device=g.device)
    if packed is None:
        packed = torch.empty(3, dtype=torch.float32, device=g.device)
    if (signs.dtype != torch.int8 or signs.numel() != n
            or not signs.is_contiguous() or packed.numel() != 3
            or packed.dtype != torch.float32 or not packed.is_contiguous()):
        raise ValueError("encode_dense: signs must be contiguous int8 of n "
                         "elements and packed contiguous float32 of 3")
    _check_same("encode_dense", g, signs, packed)
    blocks = _const("dl4j_k6_max_blocks")
    part_k = torch.empty(blocks, dtype=torch.int64, device=g.device)
    part_s = torch.empty(blocks, dtype=torch.float32, device=g.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("threshold encode", _kernel("dl4j_k6_encode"),
                (g.data_ptr(), residual.data_ptr(), threshold.data_ptr(),
                 signs.data_ptr(), n, part_k.data_ptr(), part_s.data_ptr(),
                 packed.data_ptr()), g.device)
    launches_encode += 1
    return signs, packed


def decode_dense(g: torch.Tensor, residual: torch.Tensor,
                 signs: torch.Tensor, wire: torch.Tensor,
                 packed: torch.Tensor, n_replicas: int,
                 decoded: Optional[torch.Tensor] = None,
                 new_residual: Optional[torch.Tensor] = None,
                 res_sq: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6d: (decoded, residual', Σ residual'² (0-d)) after the two
    all-reduces: ``wire`` the summed signs (int8, or int16 past 127
    replicas), ``packed`` the summed ``(scale_local·has, has, ...)``.
    ``decoded`` may be ``g`` itself and ``new_residual`` ``residual``
    (each element is read before it is written). A CPU tensor takes
    :func:`decode_dense_reference`."""
    global launches_decode
    if g.device.type == "cpu":
        d, r, q = decode_dense_reference(g, residual, signs, wire, packed,
                                         n_replicas)
        for out, val in ((decoded, d), (new_residual, r), (res_sq, q)):
            if out is not None:
                out.copy_(val)
        return (d if decoded is None else decoded,
                r if new_residual is None else new_residual,
                q if res_sq is None else res_sq)
    n = g.numel()
    _check_f32("decode_dense", "g", g, None)
    _check_f32("decode_dense", "residual", residual, n)
    _check_f32("decode_dense", "packed", packed, None)
    if (signs.dtype != torch.int8 or signs.numel() != n
            or not signs.is_contiguous()):
        raise ValueError("decode_dense: signs must be contiguous int8 of n "
                         "elements")
    if (wire.dtype not in (torch.int8, torch.int16) or wire.numel() != n
            or not wire.is_contiguous()):
        raise ValueError("decode_dense: wire must be contiguous int8 or "
                         "int16 of n elements")
    if packed.numel() < 2:
        raise ValueError("decode_dense: packed holds at least the two "
                         "summed scale terms")
    if decoded is None:
        decoded = torch.empty_like(g)
    if new_residual is None:
        new_residual = torch.empty_like(g)
    if res_sq is None:
        res_sq = torch.empty((), dtype=torch.float32, device=g.device)
    _check_f32("decode_dense", "decoded", decoded, n)
    _check_f32("decode_dense", "new_residual", new_residual, n)
    _check_f32("decode_dense", "res_sq", res_sq, 1)
    _check_same("decode_dense", g, residual, signs, wire, packed, decoded,
                new_residual, res_sq)
    blocks = _const("dl4j_k6_max_blocks")
    part_q = torch.empty(blocks, dtype=torch.float32, device=g.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("threshold decode", _kernel("dl4j_k6_decode"),
                (g.data_ptr(), residual.data_ptr(), signs.data_ptr(),
                 wire.data_ptr(), wire.element_size(), packed.data_ptr(),
                 float(n_replicas), decoded.data_ptr(),
                 new_residual.data_ptr(), n, part_q.data_ptr(),
                 res_sq.data_ptr()), g.device)
    launches_decode += 1
    return decoded, new_residual, res_sq


def _sparse_encode(name, x, in_int8, threshold, capacity, residual):
    global launches_sparse_encode
    n = x.numel()
    if n < 1 or n >= 2 ** 31 - 1:
        raise ValueError(f"{name}: {n} elements (want 1 .. 2^31 - 2)")
    if capacity < 0:
        raise ValueError(f"{name}: capacity {capacity} < 0")
    chunk = _const("dl4j_k6s_chunk")
    chunks = (n + chunk - 1) // chunk
    counts = torch.empty(chunks, dtype=torch.int32, device=x.device)
    offsets = torch.empty(chunks + 1, dtype=torch.int64, device=x.device)
    encoded = torch.empty(capacity + 1, dtype=torch.int32, device=x.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("threshold sparse encode", _kernel("dl4j_k6s_encode"),
                (x.data_ptr(), in_int8, float(threshold), n, capacity,
                 counts.data_ptr(), offsets.data_ptr(), encoded.data_ptr(),
                 None if residual is None else residual.data_ptr()),
                x.device)
    launches_sparse_encode += 1
    return encoded


def threshold_encode(updates: torch.Tensor, threshold,
                     capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6s-enc: (encoded (capacity+1,) int32, residual_after) of the
    reference's ``threshold_encode`` for an f32 tensor. A CPU tensor takes
    :func:`threshold_encode_reference`."""
    if updates.device.type == "cpu":
        return threshold_encode_reference(updates, threshold, capacity)
    if updates.dtype != torch.float32:
        raise TypeError(f"threshold_encode takes float32, got "
                        f"{updates.dtype}")
    x = updates.contiguous().reshape(-1)
    residual = torch.empty_like(x)
    encoded = _sparse_encode("threshold_encode", x, 0, threshold, capacity,
                             residual)
    return encoded, residual.reshape(updates.shape)


def sparse_from_dense(signs: torch.Tensor, capacity: int) -> torch.Tensor:
    """K6s-enc on an int8 sign mask: the reference's
    ``sparse_from_dense``. A CPU tensor takes
    :func:`sparse_from_dense_reference`."""
    if signs.device.type == "cpu":
        return sparse_from_dense_reference(signs, capacity)
    if signs.dtype != torch.int8:
        raise TypeError(f"sparse_from_dense takes int8, got {signs.dtype}")
    return _sparse_encode("sparse_from_dense",
                          signs.contiguous().reshape(-1), 1, 0.0, capacity,
                          None)


def _sparse_decode(name, encoded, use_n, threshold, size, out_int8):
    global launches_sparse_decode
    if (encoded.dtype != torch.int32 or encoded.dim() != 1
            or encoded.numel() < 1 or not encoded.is_contiguous()):
        raise ValueError(f"{name}: encoded must be a contiguous 1-D int32 "
                         f"CUDA tensor of capacity + 1 elements")
    if size < 1:
        raise ValueError(f"{name}: size {size} < 1")
    if out_int8:
        buf = torch.empty((size + 3) // 4 * 4, dtype=torch.int8,
                          device=encoded.device)
    else:
        buf = torch.empty(size, dtype=torch.float32, device=encoded.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("threshold sparse decode", _kernel("dl4j_k6s_decode"),
                (encoded.data_ptr(), encoded.numel() - 1, int(use_n),
                 float(threshold), buf.data_ptr(), int(out_int8), size),
                encoded.device)
    launches_sparse_decode += 1
    return buf[:size]


def threshold_decode(encoded: torch.Tensor, threshold,
                     shape) -> torch.Tensor:
    """K6s-dec: the reference's ``threshold_decode``, f32 of ``shape``. A
    CPU tensor takes :func:`threshold_decode_reference`."""
    if encoded.device.type == "cpu":
        return threshold_decode_reference(encoded, threshold, shape)
    shape = tuple(shape)
    size = 1
    for s in shape:
        size *= s
    return _sparse_decode("threshold_decode", encoded, True, threshold,
                          size, False).reshape(shape)


def dense_from_sparse(encoded: torch.Tensor, size: int) -> torch.Tensor:
    """K6s-dec with an int8 ±1 output: the reference's
    ``dense_from_sparse``. A CPU tensor takes
    :func:`dense_from_sparse_reference`."""
    if encoded.device.type == "cpu":
        return dense_from_sparse_reference(encoded, size)
    return _sparse_decode("dense_from_sparse", encoded, False, 0.0, size,
                          True)
