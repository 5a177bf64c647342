"""Paged decode attention (K4): the W-window attention over a KV page pool
(K4a) and the int8 quantize-and-scatter of KV rows (K4w).

Counterpart of the lax formulation on the JAX package's serving path:
``TransformerLM.decode_window_paged`` (its page gather and dequantizing
``store``), ``_window_attend`` and ``quantize_kv_rows`` in
``deeplearning4j_tpu/models/transformer.py``. Two hand-written CUDA kernels
for Hopper in ``csrc/paged_attention.cu``, built with ``nvcc`` for
``sm_90a`` at first use:

- K4a (:func:`paged_attention`): for each slot b, head h and the W ≤ 16
  window queries ``q[b, :, h]`` at positions ``pos[b, :]``, attention over
  the slot's keys at positions ≤ the query's, each read through the page
  table (key j at page ``tables[b, j // P]``, row ``j % P``); int8 pages
  are dequantized in registers with their f32 row scales. Scores and the
  softmax in f32, 1/√hd scaling, o in the compute dtype. One launch over
  (key split, head, slot): K/V rows stream through registers with 16-byte
  loads, reused across the window's queries, and the last split's block to
  finish (a ticket on a per-(slot, head) counter) merges the splits'
  partials in split order. A dense cache (B, S, H, hd) is the pool of B
  pages of S tokens with the table ``arange(B)[:, None]``
  (:func:`dense_tables`).
- K4w (:func:`kv_quant_write`): :func:`quantize_kv_rows_reference` of the
  k and v rows, written into an int8 pool and its scale grid at explicit
  (page, row) coordinates, bit-exact with the plain version.

Beside them their plain versions (``*_reference``): the gather of each
slot's pages followed by the reference's attention, and the quantization
followed by ``index_put_``. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. ``launches_attend`` /
``launches_quant_write`` count the launches of each kernel.

What bounds them on the H100: memory. K4a at the bench's large config
(H 16, hd 64) reads 4096 B a cached position a layer from bf16 pages, 2048
+ 8 B from int8 pages; ``PERF.md`` holds their times beside the bound.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
MAX_WINDOW = 16             # queries a (slot, head)
MAX_HEAD_DIM = 256
_SMS = 132                  # streaming multiprocessors of the H100
WARPS = 4                   # warps a K4a block, each a run of the split's keys
MIN_SPLIT_KEYS = 64         # keys a split holds at least
MAX_SPLITS = 256            # the kernel's limit on splits a (slot, head)
MERGE_FLOATS = 16384        # and on splits × W × hd (the last block's merge)
SPLIT_BLOCKS_PER_SM = 2     # resident K4a blocks an SM, unless measured
# 1/127 rounded to f32: the JAX engine's compiled steps compute the source's
# ``amax / 127.0`` as ``amax * f32(1/127)`` (XLA turns a division by a
# constant into a product by its reciprocal), and the port matches them.
# A Python float holding this f32 value gives the same product in f32 or in
# double arithmetic rounded to f32.
INV_127 = 0.007874015718698502

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_attend = 0
launches_quant_write = 0

_fns = {}


def _kernel(fn: str):
    """(launch function, error-string function) of one C entry point."""
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # the stream is the last argument of both launches
        args = {"dl4j_paged_attention":
                [p, ll, ll, ll] + [p] * 10 + [i] * 10 + [p],
                "dl4j_paged_attention_blocks_per_sm": [i] * 5,
                "dl4j_kv_quant_write":
                [p, p, ll, ll, ll, i, i, i, i, p, p, i, p, p, p, p, ll, ll,
                 i, i, p]}[fn]
        k = _fns[fn] = _build.bind("paged_attention", fn, args,
                                   "dl4j_paged_attention_error_string")
    return k


# ------------------------------------------------------------ plain versions
def quantize_kv_rows_reference(rows: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of KV rows (…, H, hd) → (int8
    rows, f32 scale (…,)): scale = max|row| · f32(1/127) (:data:`INV_127`),
    1 for an all-zero row (so its dequantization is exact), q8 = round(x /
    scale) (an IEEE division, half to even) clamped to ±127."""
    x = rows.float()
    amax = x.abs().amax(dim=(-2, -1))
    scale = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q8 = torch.clamp(torch.round(x / scale[..., None, None]), -127, 127)
    return q8.to(torch.int8), scale


def window_attend_reference(q: torch.Tensor, ck: torch.Tensor,
                            cv: torch.Tensor, mask: torch.Tensor
                            ) -> torch.Tensor:
    """q (B, W, H, hd) against caches (B, S, H, hd) under mask (B, W, S),
    as the reference's ``_window_attend``: scores in the compute dtype over
    √hd, masked to −1e30, max-subtract, exp and normalise in f32, P back in
    the compute dtype."""
    s = torch.einsum("bwhd,bshd->bwhs", q, ck) / float(
        math.sqrt(q.shape[-1]))
    s = torch.where(mask[:, :, None, :], s,
                    torch.tensor(_NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).float())
    p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bwhs,bshd->bwhd", p, cv)


def gather_pages(pool: torch.Tensor, scale: Optional[torch.Tensor],
                 tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each slot's pages as a (B, S, H, hd) view in ``dtype``: int8 rows
    times their f32 scales, then cast, as the reference's ``store``."""
    tables = tables.long()
    B, n_lp = tables.shape
    S = n_lp * pool.shape[1]
    view = pool[tables].reshape(B, S, *pool.shape[-2:])
    if scale is None:
        return view
    return (view.float() * scale[tables].reshape(B, S)[:, :, None, None]
            ).to(dtype)


def paged_attention_reference(q, k_pool, v_pool, tables, pos,
                              k_scale=None, v_scale=None) -> torch.Tensor:
    """The plain version of K4a: gather every slot's pages
    (:func:`gather_pages`) and attend under ``key position <= pos``."""
    S = tables.shape[1] * k_pool.shape[1]
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= pos.long()[:, :, None])
    return window_attend_reference(
        q, gather_pages(k_pool, k_scale, tables, q.dtype),
        gather_pages(v_pool, v_scale, tables, q.dtype), mask)


def kv_quant_write_reference(k_rows, v_rows, phys, off, k_pool, v_pool,
                             k_scale, v_scale,
                             quantize: Optional[Callable] = None):
    """The plain version of K4w: ``quantize`` (default
    :func:`quantize_kv_rows_reference`) of the k and v rows, then
    ``index_put_`` into the pools and scales. Rows (B, W, H, hd) into
    per-layer pools (n_pages, P, H, hd), or (L, B, W, H, hd) into (L,
    n_pages, P, H, hd); ``phys``/``off`` (B, Wp) give each row's page and
    row in the page, and with B = 1 may run past W, the extra rows being
    zero rows (a prefill's page padding)."""
    quantize = quantize or quantize_kv_rows_reference
    phys, off = phys.long(), off.long()
    layered = k_rows.dim() == 5
    for rows, pool, scale in ((k_rows, k_pool, k_scale),
                              (v_rows, v_pool, v_scale)):
        pad = off.shape[-1] - rows.shape[-3]
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
        q8, sc = quantize(rows)
        if layered:
            pool[:, phys, off] = q8
            scale[:, phys, off] = sc
        else:
            pool[phys, off] = q8
            scale[phys, off] = sc


# ------------------------------------------------------------------ wrappers
def dense_tables(slots: int, device) -> torch.Tensor:
    """The page table of a dense cache (B, S, H, hd) seen as a pool of B
    pages of S tokens: slot b owns page b."""
    return torch.arange(slots, dtype=torch.int32, device=device)[:, None]


def key_splits(slots: int, heads: int, keys: int,
               splits: Optional[int] = None, window_floats: int = 64,
               blocks_per_sm: int = SPLIT_BLOCKS_PER_SM) -> Tuple[int, int]:
    """(splits, keys a split) of K4a's grid over (split, head, slot) for
    ``keys`` cached positions: as many blocks as the card holds at once
    (``blocks_per_sm`` resident blocks on each of its SMs: one wave), no
    split under :data:`MIN_SPLIT_KEYS` keys (so each of a block's warps
    streams several rows per lane), no empty split, and the splits'
    partials of ``window_floats`` (W × hd) floats within
    :data:`MERGE_FLOATS`. ``splits`` overrides the count (the split sweep
    and the tests use it). Shapes only, never positions, so a captured CUDA
    graph stays valid."""
    if splits is None:
        want = blocks_per_sm * _SMS // (slots * heads)
        splits = min(want, keys // MIN_SPLIT_KEYS)
    splits = max(1, min(splits, MAX_SPLITS, keys,
                        MERGE_FLOATS // window_floats))
    per = -(-keys // splits)
    return -(-keys // per), per


def counter_slots(have: int, need: int) -> int:
    """Entries of K4a's ticket-counter buffer for a call that needs
    ``need`` (slots × heads) when the buffer holds ``have``: kept when it is
    large enough, else the next power of two (at least 256)."""
    if have >= need:
        return have
    return max(256, 1 << (need - 1).bit_length())


_counters = {}
_retired = []       # grown-out buffers a captured graph may still point at


def _ticket_counters(device: torch.device, need: int) -> torch.Tensor:
    """The zeroed int32 ticket counters of ``device`` (each launch leaves
    them at 0), grown by :func:`counter_slots` only outside CUDA-graph
    capture."""
    buf = _counters.get(device)
    have = 0 if buf is None else buf.numel()
    size = counter_slots(have, need)
    if size != have:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged_attention: {need} (slot, head) counters needed, "
                f"{have} allocated; call it once at this batch outside "
                f"CUDA-graph capture first")
        if buf is not None:
            _retired.append(buf)
        buf = _counters[device] = torch.zeros(size, dtype=torch.int32,
                                              device=device)
    return buf


_occupancy = {}


def _blocks_per_sm(q: torch.Tensor, quant: bool, k_pool: torch.Tensor,
                   v_pool: torch.Tensor) -> int:
    """K4a's resident blocks an SM for this call's kernel, from the CUDA
    occupancy calculator (once for each kernel configuration)."""
    B, W, H, hd = q.shape
    aligned = (k_pool.data_ptr() | v_pool.data_ptr()) % 16 == 0
    key = (q.device, q.dtype, quant, W, hd, aligned)
    n = _occupancy.get(key)
    if n is None:
        fn, err = _kernel("dl4j_paged_attention_blocks_per_sm")
        with torch.cuda.device(q.device):
            n = fn(W, hd, _DTYPES[q.dtype], int(quant), int(aligned))
        if n < 1:
            raise RuntimeError(f"paged_attention: occupancy query failed "
                               f"({err(-n).decode() if n < 0 else n})")
        _occupancy[key] = n
    return n


def attend_splits(q: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, tables: torch.Tensor,
                  splits: Optional[int] = None) -> Tuple[int, int]:
    """(splits, keys a split) that :func:`paged_attention` launches K4a
    with on the card: :func:`key_splits` at this call's shapes and the
    kernel's measured occupancy."""
    B, W, H, hd = q.shape
    return key_splits(B, H, tables.shape[1] * k_pool.shape[1], splits,
                      W * hd, _blocks_per_sm(q, k_pool.dtype == torch.int8,
                                             k_pool, v_pool))


def _int32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.int32).contiguous()


def _check_attend(q, k_pool, v_pool, tables, k_scale, v_scale):
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q, got "
                        f"{q.dtype}")
    if q.dim() != 4 or q.stride(-1) != 1:
        raise ValueError(f"paged_attention: q must be (B, W, H, hd) with a "
                         f"contiguous last dim, got {tuple(q.shape)} strides "
                         f"{q.stride()}")
    B, W, H, hd = q.shape
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"paged_attention: a window of {W} queries; the "
                         f"kernel takes 1 to {MAX_WINDOW}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: head dim {hd} must be a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    quant = k_pool.dtype == torch.int8
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if (pool.dim() != 4 or pool.shape[2:] != (H, hd)
                or pool.shape != k_pool.shape or not pool.is_contiguous()
                or pool.device != q.device
                or pool.dtype != (torch.int8 if quant else q.dtype)):
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"(n_pages, P, {H}, {hd}) pool of {q.dtype} or "
                             f"int8 on {q.device}, got {tuple(pool.shape)} "
                             f"{pool.dtype}")
        if pool.data_ptr() % (8 if quant else 16):
            raise ValueError(f"paged_attention: {name} is not aligned for "
                             f"8-element loads")
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc is None or sc.dtype != torch.float32
                    or sc.shape != k_pool.shape[:2] or not sc.is_contiguous()
                    or sc.device != q.device):
                raise ValueError(f"paged_attention: an int8 pool needs a "
                                 f"contiguous f32 {name} of shape "
                                 f"{tuple(k_pool.shape[:2])}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"paged_attention: tables must be (B={B}, n_lp), "
                         f"got {tuple(tables.shape)}")
    return quant


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    pos: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """o (B, W, H, hd) in q's dtype: each window query ``q[b, w]`` at
    position ``pos[b, w]`` (≥ 0) attends to the keys of slot b at positions
    ≤ its own, read from the pools (n_pages, P, H, hd) through ``tables``
    (B, n_lp) (table entries must lie in the pool); int8 pools with their
    (n_pages, P) f32 scales. A CUDA tensor launches K4a once (or raises); a
    CPU tensor takes :func:`paged_attention_reference`. ``splits``
    overrides :func:`key_splits`' count (for the split sweep and tests)."""
    global launches_attend
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, tables, pos,
                                         k_scale, v_scale)
    quant = _check_attend(q, k_pool, v_pool, tables, k_scale, v_scale)
    B, W, H, hd = q.shape
    P, n_lp = k_pool.shape[1], tables.shape[1]
    if pos.shape != (B, W):
        raise ValueError(f"paged_attention: pos must be (B, W) = {(B, W)}, "
                         f"got {tuple(pos.shape)}")
    tables, pos = _int32(tables, q.device), _int32(pos, q.device)
    splits, per = attend_splits(q, k_pool, v_pool, tables, splits)
    out = torch.empty((B, W, H, hd), dtype=q.dtype, device=q.device)
    o_part = ml_part = counters = None
    if splits > 1:
        o_part = torch.empty((B, H, splits, W, hd), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((B, H, splits, W, 2), dtype=torch.float32,
                              device=q.device)
        counters = _ticket_counters(q.device, B * H)
    from deeplearning4j_tpu_torch.kernels import _build
    sb, sw, sh, _ = q.stride()
    _build.call("paged_attention", _kernel("dl4j_paged_attention"),
                (q.data_ptr(), sb, sw, sh, k_pool.data_ptr(),
                 v_pool.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 None if o_part is None else o_part.data_ptr(),
                 None if ml_part is None else ml_part.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 B, W, H, hd, P, n_lp, splits, per, _DTYPES[q.dtype],
                 int(quant)), q.device)
    launches_attend += 1
    return out


def _check_rows(name, rows, pool, scale, phys):
    if rows.dtype not in _DTYPES:
        raise TypeError(f"kv_quant_write takes float32 or bfloat16 rows, "
                        f"got {rows.dtype}")
    lead = rows.dim() - 4           # 1 with a layer axis, else 0
    if lead not in (0, 1) or rows.stride(-1) != 1 \
            or rows.stride(-2) != rows.shape[-1]:
        raise ValueError(f"kv_quant_write: {name} rows must be (B, W, H, hd) "
                         f"or (L, B, W, H, hd) with each (H, hd) row "
                         f"contiguous, got {tuple(rows.shape)} strides "
                         f"{rows.stride()}")
    want = rows.shape[:lead] + (pool.shape[lead + 1],) + rows.shape[-2:]
    if (pool.dtype != torch.int8 or not pool.is_contiguous()
            or pool.dim() != lead + 4
            or pool.shape[:lead] + pool.shape[lead + 1:] != want
            or pool.device != rows.device):
        raise ValueError(f"kv_quant_write: the {name} pool must be a "
                         f"contiguous int8 {'(L, ' if lead else '('}n_pages, "
                         f"P, H, hd) tensor matching the rows, got "
                         f"{tuple(pool.shape)} {pool.dtype}")
    if (scale is None or scale.dtype != torch.float32
            or scale.shape != pool.shape[:lead + 2]
            or not scale.is_contiguous() or scale.device != rows.device):
        raise ValueError(f"kv_quant_write: the {name} scales must be "
                         f"contiguous f32 of shape "
                         f"{tuple(pool.shape[:lead + 2])}")
    B, W = rows.shape[lead], rows.shape[lead + 1]
    if phys.dim() != 2 or phys.shape[0] != B or phys.shape[1] < W \
            or (B > 1 and phys.shape[1] != W):
        raise ValueError(f"kv_quant_write: coordinates {tuple(phys.shape)} "
                         f"do not cover rows {tuple(rows.shape)} (only a "
                         f"single slot may pad with zero rows)")
    return lead


def kv_quant_write(k_rows: torch.Tensor, v_rows: torch.Tensor,
                   phys: torch.Tensor, off: torch.Tensor,
                   k_pool: torch.Tensor, v_pool: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor,
                   quantize: Optional[Callable] = None) -> None:
    """Quantize the k and v rows and write them, with their scales, into
    the int8 pools in place at (``phys``, ``off``), as
    :func:`kv_quant_write_reference` describes the shapes. A CUDA tensor
    launches K4w once for both (or raises); a CPU tensor takes the plain
    version with ``quantize`` (default
    :func:`quantize_kv_rows_reference`)."""
    global launches_quant_write
    if k_rows.numel() == 0:         # a zero-layer model: nothing to write
        return
    if k_rows.device.type == "cpu":
        kv_quant_write_reference(k_rows, v_rows, phys, off, k_pool, v_pool,
                                 k_scale, v_scale, quantize)
        return
    lead = _check_rows("k", k_rows, k_pool, k_scale, phys)
    if (_check_rows("v", v_rows, v_pool, v_scale, phys) != lead
            or v_rows.shape != k_rows.shape
            or v_rows.stride() != k_rows.stride()
            or v_rows.dtype != k_rows.dtype or off.shape != phys.shape):
        raise ValueError("kv_quant_write: k and v rows and their "
                         "coordinates must match")
    phys, off = _int32(phys, k_rows.device), _int32(off, k_rows.device)
    st = k_rows.stride()
    B, W, H, hd = k_rows.shape[lead:]
    layers = k_rows.shape[0] if lead else 1
    wp = phys.shape[1]
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("kv_quant_write", _kernel("dl4j_kv_quant_write"),
                (k_rows.data_ptr(), v_rows.data_ptr(), st[lead],
                 st[lead + 1], st[0] if lead else 0, wp, B * wp, B * W,
                 H * hd, phys.data_ptr(), off.data_ptr(),
                 k_pool.shape[lead + 1], k_pool.data_ptr(),
                 v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                 k_pool[0].numel() if lead else 0,
                 k_scale[0].numel() if lead else 0, layers,
                 _DTYPES[k_rows.dtype]), k_rows.device)
    launches_quant_write += 1
