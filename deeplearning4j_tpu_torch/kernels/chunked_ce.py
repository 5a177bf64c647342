"""Chunked LM cross-entropy (K3): the mean token cross-entropy of the tied
head's logits ``x @ emb.T`` without building the (N, V) logits.

Counterpart of ``deeplearning4j_tpu/kernels/chunked_ce.py``
(``chunked_softmax_xent``, its ``_forward_pieces`` scan and its custom-VJP
``_bwd``). Two hand-written CUDA kernels for Hopper, each in three designs,
built with ``nvcc`` for ``sm_90a`` at first use; :func:`kernel_for` says
which a call takes:

- ``csrc/chunked_ce_wgmma.cu`` — bf16 at d a multiple of 64 with operands
  TMA can address (the bf16 model's training step): ``wgmma`` m64n256k16
  over x and E panels that a producer warp streams through TMA into a
  ring, 128 × 256 block tiles, the logits in registers.
- ``csrc/chunked_ce_tf32.cu`` — f32 (the f32 model's training step): the
  same structure on TF32 ``wgmma`` m64nNk8, each operand split once into
  two TF32 parts (:func:`split_tf32`, a pass of its own) and every logit
  the sum of three tensor-core products; no product rounds its operands to
  TF32 alone.
- ``csrc/chunked_ce.cu`` — bf16 at the other d: ``mma.sync`` over a
  cp.async ring, 128 × 128 tiles; and the scalar-FMA f32 kernel, which
  ``kernel="mma_sync"`` still reaches (``chip_smoke.py`` times it against
  the TF32 kernel in turns).

Both compute the same two functions:

- K3f (:func:`chunked_ce_fwd`): per row, the online logsumexp of the
  logits over the whole vocabulary and the target's logit, with each logit
  tile kept in registers; partials per vocab split merged into ``lse``
  (saved for the backward) and the mean loss in a fixed order. The kernels
  walk the vocab in tiles of their own, so ``n_chunks`` does not change
  what they compute (only f32 sums run in another order).
- K3b (:func:`ce_dlogits`): one ce chunk's dlogits, ``(exp(s − lse) −
  onehot)·g/N`` in x's dtype, from the logits recomputed in registers. The
  backward (:func:`chunked_ce_bwd`) runs it once per chunk and follows each
  with the reference's two f32-accumulated products (``dx += dlog·E_c``,
  ``dE_c = dlogᵀ·x``) as plain matrix products.

Beside them their plain versions, :func:`chunked_ce_fwd_reference` (the
reference's scan: f32 chunk logits, online max and sum, the target picked
from the chunk that holds it) and :func:`ce_dlogits_reference`. A CPU tensor
takes the plain version; a CUDA tensor launches a kernel or raises.
:class:`ChunkedSoftmaxXent` is the ``autograd.Function`` the model trains
through, and :func:`chunked_softmax_xent` the JAX signature.
``launches_fwd_wgmma`` / ``launches_dlogits_wgmma`` /
``launches_fwd_tf32`` / ``launches_dlogits_tf32`` / ``launches_split_tf32``
/ ``launches_fwd`` / ``launches_dlogits`` count the launches of each
kernel.

What bounds them on the H100: 2·N·V·d FLOPs each (550 GFLOP at the bench's
large config, batch 8: 0.556 ms at the dense bf16 peak, 3.33 ms in f32 as
three TF32 products at the 495 TFLOP/s peak) against reading x and E once;
``PERF.md`` holds their times beside it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128                 # rows of every block tile; vocab columns of a
                            # chunked_ce.cu tile
_WGMMA_COLS = 256           # vocab columns of a chunked_ce_wgmma.cu tile
_PANEL = 64                 # bf16 columns of one 128-byte TMA panel
_SLAB_BYTES = 64            # depth of one chunked_ce.cu shared-memory stage
_TF32_PANEL = 32            # f32 columns of one 128-byte TMA panel
_SMS = 132                  # streaming multiprocessors of the H100
_MMA_BLOCKS = 4 * _SMS      # chunked_ce.cu K3f blocks to aim for (4 an SM)

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_fwd = 0
launches_dlogits = 0
launches_fwd_wgmma = 0
launches_dlogits_wgmma = 0
launches_fwd_tf32 = 0
launches_dlogits_tf32 = 0
launches_split_tf32 = 0

_fns = {}


def _kernel(fn: str):
    """(launch function, error-string function) of one C entry point."""
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if fn.endswith("_tf32"):
            args = {"dl4j_ce_split_tf32": [p] * 6 + [i] * 4 + [ll] * 2,
                    "dl4j_ce_fwd_tf32": [p] * 8 + [i] * 5,
                    "dl4j_ce_dlogits_tf32": [p] * 8 + [i] * 3 + [ll] * 2
                    + [i] * 2}[fn]
            k = _fns[fn] = _build.bind("chunked_ce_tf32", fn, args + [p],
                                       "dl4j_ce_tf32_error_string")
            return k
        wgmma = fn.endswith("_wgmma")
        fwd = fn.startswith("dl4j_ce_fwd")
        # the wgmma entry points take no dtype: they are bf16 only
        args = ([p] * 6 + [i] * 3 + [ll] * (2 if fwd else 3)
                + [i] * (2 if wgmma else 3) + [p])
        k = _fns[fn] = _build.bind(
            "chunked_ce_wgmma" if wgmma else "chunked_ce", fn, args,
            "dl4j_ce_wgmma_error_string" if wgmma else "dl4j_ce_error_string")
    return k


def _tf32_width(d: int) -> int:
    """Columns of a row of the TF32 parts: d rounded up to a panel."""
    return -(-d // _TF32_PANEL) * _TF32_PANEL


# ------------------------------------------------------------ plain versions
def _f32_logits(x2: torch.Tensor, emb_c: torch.Tensor) -> torch.Tensor:
    """(N, D) x (C, D)ᵀ → (N, C) f32 from the operands (bf16 products are
    exact in f32: the reference's ``preferred_element_type=f32``)."""
    return x2.float() @ emb_c.float().T


def chunked_ce_fwd_reference(x2: torch.Tensor, emb: torch.Tensor,
                             targets: torch.Tensor, n_chunks: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_forward_pieces`` over x (N, D), emb (V, D) and
    targets (N,): per chunk of V / n_chunks rows of emb, f32 logits, the
    running max and sum, and the target logit where the chunk holds it.
    Returns (lse, correct), both (N,) f32."""
    n, v = x2.shape[0], emb.shape[0]
    c = v // n_chunks
    m = torch.full((n,), -math.inf, dtype=torch.float32, device=x2.device)
    l = torch.zeros((n,), dtype=torch.float32, device=x2.device)
    correct = torch.zeros((n,), dtype=torch.float32, device=x2.device)
    for i in range(n_chunks):
        logits = _f32_logits(x2, emb[i * c:(i + 1) * c])
        m_new = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        local = targets - i * c
        in_chunk = (local >= 0) & (local < c)
        picked = logits.gather(-1, local.clamp(0, c - 1)[:, None])[:, 0]
        correct = correct + torch.where(in_chunk, picked, 0.0)
        m = m_new
    return m + torch.log(l), correct


def split_tf32_reference(a: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of an f32 matrix (rows, d), each (rows, dp) f32 with
    dp = d rounded up to a multiple of 32 and the columns past d zero:
    ``big`` is ``a`` rounded to TF32 (``cvt.rna.tf32.f32``: the low 13 bits
    of the pattern cleared, to nearest with ties away from zero) and
    ``small`` the same rounding of ``a − big`` (exact in f32). Both are
    TF32-exact; ``big + small`` is within 2^-22·|a| of ``a`` (``small``
    rounds the remainder's 13 or 14 bits to 11), and ``small·small``, the
    product term the kernels drop, is below 2^-22 of ``a·b``."""
    a = a.to(torch.float32)
    rows, d = a.shape
    dp = _tf32_width(d)

    def rna(t):
        u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        r = (u + 0x1000) & 0xFFFFE000
        return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(
            torch.int32).view(torch.float32)

    big = rna(a)
    small = rna(a - big)
    if dp == d:
        return big, small
    pad = torch.zeros((rows, dp - d), dtype=torch.float32, device=a.device)
    return torch.cat([big, pad], 1), torch.cat([small, pad], 1)


def split_logits_emulation(x2, emb_c, panel: int = _TF32_PANEL
                           ) -> torch.Tensor:
    """(N, C) f32 logits of x (N, d) against emb_c (C, d) in the tf32
    kernels' order, emulated in numpy: both operands split by
    :func:`split_tf32_reference`; per ``panel``-deep slice of d, the three
    products small·big, big·small, big·big (small·small dropped), each
    summed exactly and added to a zeroed partial sum with one rounding to
    f32, and the partial added to the f32 accumulator (the promoted sums).
    The tensor cores' truncation within a panel is not emulated
    (``tools/f32_rehearsal.py`` models it)."""
    xb, xs = (t.numpy().astype(np.float64)
              for t in split_tf32_reference(x2.detach().cpu()))
    eb, es = (t.numpy().astype(np.float64)
              for t in split_tf32_reference(emb_c.detach().cpu()))
    acc = np.zeros((xb.shape[0], eb.shape[0]), np.float32)
    for k in range(0, xb.shape[1], panel):
        sl = slice(k, k + panel)
        part = np.zeros_like(acc)
        for a, b in ((xs, eb), (xb, es), (xb, eb)):
            part = (part + a[:, sl] @ b[:, sl].T).astype(np.float32)
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return torch.from_numpy(acc).to(x2.device)


def ce_dlogits_reference(x2, emb_c, targets, lse, col0: int, g,
                         n_total: int) -> torch.Tensor:
    """One chunk's dlogits as the reference's ``_bwd`` forms them:
    ``(exp(s − lse) − onehot(targets − col0)) · g / n_total`` in f32 from
    the f32 logits ``s`` of x (N, D) against the chunk emb_c (C, D) whose
    row 0 is vocab id ``col0``, cast to x's dtype. (N, C)."""
    logits = _f32_logits(x2, emb_c)
    c = emb_c.shape[0]
    p = torch.exp(logits - lse[:, None])
    local = targets - col0
    in_chunk = (local >= 0) & (local < c)
    onehot = (torch.nn.functional.one_hot(local.clamp(0, c - 1), c)
              .to(torch.float32) * in_chunk[:, None])
    scale = (g / n_total).to(torch.float32)
    return ((p - onehot) * scale).to(x2.dtype)


# ------------------------------------------------------------------ wrappers
def kernel_for(device_type: str, dtype: torch.dtype, d: int,
               aligned: bool) -> str:
    """Which version a call takes: "plain" for a CPU tensor; on the card
    "wgmma" (``csrc/chunked_ce_wgmma.cu``) for bf16 at d a multiple of 64,
    "tf32" (``csrc/chunked_ce_tf32.cu``) for f32 at d a multiple of 16,
    "mma_sync" (``csrc/chunked_ce.cu``) for bf16 at the other d a multiple
    of 32. ``aligned``: x and emb have unit stride on d and 16-byte aligned
    bases and row strides (:func:`tma_aligned`), which every kernel needs.
    Raises for what no kernel takes."""
    if device_type == "cpu":
        return "plain"
    if dtype not in _DTYPES:
        raise TypeError(f"the K3 kernels take float32 or bfloat16, not "
                        f"{dtype}")
    if not aligned:
        raise ValueError("the K3 kernels need unit stride on d and 16-byte "
                         "aligned bases and row strides")
    if dtype == torch.bfloat16 and d % _PANEL == 0:
        return "wgmma"
    itemsize = 2 if dtype == torch.bfloat16 else 4
    if d * itemsize % _SLAB_BYTES:
        raise ValueError(f"d {d} must be a multiple of "
                         f"{_SLAB_BYTES // itemsize} for {dtype}")
    return "tf32" if dtype == torch.float32 else "mma_sync"


def tma_aligned(t: torch.Tensor) -> bool:
    """A 2-D operand both kernels can read: unit stride on d, a 16-byte
    aligned start and row stride."""
    item = t.element_size()
    return (t.stride(1) == 1 and t.stride(0) * item % 16 == 0
            and t.data_ptr() % 16 == 0)


def vocab_splits(n_rows: int, vocab: int, tile_cols: int = _WGMMA_COLS,
                 blocks: int = _SMS) -> Tuple[int, int]:
    """(splits, vocab tiles per split) of K3f's grid of ``ceil(n_rows /
    128) × splits`` blocks: as many splits of the vocab's ``tile_cols``-
    column tiles as fit ``blocks`` blocks in all (the wgmma kernel: one
    block an SM, one wave), at least one, each split a whole number of
    tiles, none empty."""
    tiles = -(-vocab // tile_cols)
    want = max(1, min(tiles, blocks // -(-n_rows // _TILE)))
    per = -(-tiles // want)
    return -(-tiles // per), per


def _check(name: str, x2, emb, targets, kernel=None) -> str:
    """Raise for operands no kernel takes; return the kernel that takes
    them (``kernel`` when given: it must take them)."""
    if not (x2.is_cuda and emb.device == x2.device
            and targets.device == x2.device):
        raise ValueError(f"{name}: x, emb and targets must lie on one CUDA "
                         f"device (got {x2.device}, {emb.device}, "
                         f"{targets.device})")
    if x2.dtype not in _DTYPES or emb.dtype != x2.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 x and emb of one "
                        f"dtype (got {x2.dtype}, {emb.dtype})")
    if x2.dim() != 2 or emb.dim() != 2 or emb.shape[1] != x2.shape[1]:
        raise ValueError(f"{name} wants x (N, D) and emb (V, D) (got "
                         f"{tuple(x2.shape)}, {tuple(emb.shape)})")
    if x2.shape[0] < 1 or emb.shape[0] < 1 or x2.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: empty or oversized operands "
                         f"{tuple(x2.shape)}, {tuple(emb.shape)}")
    if (targets.dtype != torch.int64 or targets.shape != x2.shape[:1]
            or not targets.is_contiguous()):
        raise ValueError(f"{name}: targets must be contiguous int64 of shape "
                         f"({x2.shape[0]},), got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    route = kernel_for("cuda", x2.dtype, x2.shape[1],
                       tma_aligned(x2) and tma_aligned(emb))
    if kernel is not None and kernel != route and not (
            kernel == "mma_sync" and route in ("wgmma", "tf32")):
        raise ValueError(f"{name}: the {kernel} kernel does not take "
                         f"{x2.dtype} at d {x2.shape[1]}")
    return kernel or route


def split_tf32(x2: torch.Tensor, emb: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(x big, x small, emb big, emb small) of f32 x (N, d) and emb
    (V, d) as :func:`split_tf32_reference` forms them, each (rows, dp)
    contiguous: the TF32 kernels' operands. A CUDA tensor launches
    ``ce_split_kernel`` once for both (or raises); a CPU tensor takes the
    plain version."""
    global launches_split_tf32
    if x2.device.type == "cpu":
        return split_tf32_reference(x2) + split_tf32_reference(emb)
    if x2.dtype != torch.float32 or emb.dtype != torch.float32 \
            or emb.device != x2.device or x2.shape[1] != emb.shape[1] \
            or x2.shape[1] % 4 or not (tma_aligned(x2) and tma_aligned(emb)):
        raise ValueError("split_tf32 takes f32 x (N, d) and emb (V, d) on "
                         "one device, d a multiple of 4, unit stride on d "
                         "and 16-byte aligned bases and row strides")
    (n, d), v = x2.shape, emb.shape[0]
    dp = _tf32_width(d)
    xp = torch.empty((2, n, dp), dtype=torch.float32, device=x2.device)
    ep = torch.empty((2, v, dp), dtype=torch.float32, device=x2.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("chunked_ce split (tf32)", _kernel("dl4j_ce_split_tf32"),
                (x2.data_ptr(), emb.data_ptr(), xp[0].data_ptr(),
                 xp[1].data_ptr(), ep[0].data_ptr(), ep[1].data_ptr(), n, v,
                 d, dp, x2.stride(0), emb.stride(0)), x2.device)
    launches_split_tf32 += 1
    return xp[0], xp[1], ep[0], ep[1]


def _check_parts(parts, n: int, c: int, d: int, device) -> None:
    dp = _tf32_width(d)
    want = ((n, dp), (n, dp), (c, dp), (c, dp))
    if len(parts) != 4 or any(
            p.device != device or p.dtype != torch.float32
            or tuple(p.shape) != w or p.stride() != (dp, 1)
            or p.data_ptr() % 16 for p, w in zip(parts, want)):
        raise ValueError(f"parts must be split_tf32's four f32 parts of "
                         f"shapes {want}, rows {dp} apart")


def chunked_ce_fwd(x2: torch.Tensor, emb: torch.Tensor,
                   targets: torch.Tensor, n_chunks: int,
                   kernel: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (N,) f32, loss () f32) of x (N, D) against emb (V, D) and
    int64 targets (N,): the loss is the mean of lse − the target's logit.
    A CUDA tensor launches K3f (or raises): the kernel :func:`kernel_for`
    names (for "tf32" after :func:`split_tf32`'s pass), or ``kernel`` ("mma_sync" also takes what
    "wgmma" and "tf32" take); a CPU tensor takes
    :func:`chunked_ce_fwd_reference` over ``n_chunks`` chunks."""
    global launches_fwd, launches_fwd_wgmma, launches_fwd_tf32
    if x2.device.type == "cpu":
        lse, correct = chunked_ce_fwd_reference(x2, emb, targets, n_chunks)
        return lse, (lse - correct).mean()
    route = _check("chunked_ce_fwd", x2, emb, targets, kernel)
    n, v = x2.shape[0], emb.shape[0]
    wgmma = route == "wgmma"
    if route == "mma_sync":
        splits, per = vocab_splits(n, v, _TILE, _MMA_BLOCKS)
    else:
        splits, per = vocab_splits(n, v)
    part = torch.empty((3, splits, n), dtype=torch.float32, device=x2.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x2.device)
    loss = torch.empty((), dtype=torch.float32, device=x2.device)
    from deeplearning4j_tpu_torch.kernels import _build
    if route == "tf32":
        xb, xs, eb, es = split_tf32(x2, emb)
        _build.call("chunked_ce fwd (tf32)", _kernel("dl4j_ce_fwd_tf32"),
                    (xb.data_ptr(), xs.data_ptr(), eb.data_ptr(),
                     es.data_ptr(), targets.data_ptr(), part.data_ptr(),
                     lse.data_ptr(), loss.data_ptr(), n, v, xb.shape[1],
                     splits, per), x2.device)
        launches_fwd_tf32 += 1
        return lse, loss
    args = (x2.data_ptr(), emb.data_ptr(), targets.data_ptr(),
            part.data_ptr(), lse.data_ptr(), loss.data_ptr(), n, v,
            x2.shape[1], x2.stride(0), emb.stride(0), splits, per)
    if wgmma:
        _build.call("chunked_ce fwd (wgmma)", _kernel("dl4j_ce_fwd_wgmma"),
                    args, x2.device)
        launches_fwd_wgmma += 1
    else:
        _build.call("chunked_ce fwd", _kernel("dl4j_ce_fwd"),
                    args + (_DTYPES[x2.dtype],), x2.device)
        launches_fwd += 1
    return lse, loss


def ce_dlogits(x2: torch.Tensor, emb_c: torch.Tensor, targets: torch.Tensor,
               lse: torch.Tensor, col0: int, g: torch.Tensor,
               n_total: int, kernel: Optional[str] = None,
               parts=None) -> torch.Tensor:
    """One ce chunk's dlogits (N, C) in x's dtype, ``(exp(x·emb_cᵀ − lse)
    − onehot(targets − col0))·g/n_total``, for the chunk emb_c (C, D) whose
    row 0 is vocab id ``col0`` and the loss's cotangent ``g`` (a 0-d
    tensor, read on the device). A CUDA tensor launches K3b (or raises),
    chosen as in :func:`chunked_ce_fwd`; the "tf32" kernel reads ``parts`` (x's and the chunk's
    :func:`split_tf32` parts, such as row views of the whole emb's) or
    splits x and emb_c first. A CPU tensor takes
    :func:`ce_dlogits_reference`. The wgmma and tf32 kernels write rows
    aligned to 8 elements: where C is not a multiple of 8 the result is a
    column view of a wider buffer."""
    global launches_dlogits, launches_dlogits_wgmma, launches_dlogits_tf32
    if x2.device.type == "cpu":
        return ce_dlogits_reference(x2, emb_c, targets, lse, col0, g,
                                    n_total)
    route = _check("ce_dlogits", x2, emb_c, targets, kernel)
    if lse.dtype != torch.float32 or lse.shape != x2.shape[:1] \
            or not lse.is_contiguous():
        raise ValueError(f"ce_dlogits: lse must be contiguous float32 of "
                         f"shape ({x2.shape[0]},)")
    g = g.to(device=x2.device, dtype=torch.float32).reshape(1).contiguous()
    n, c = x2.shape[0], emb_c.shape[0]
    wgmma = route == "wgmma"
    ldo = -(-c // 8) * 8 if route in ("wgmma", "tf32") else c
    dlog = torch.empty((n, ldo), dtype=x2.dtype, device=x2.device)[:, :c]
    from deeplearning4j_tpu_torch.kernels import _build
    if route == "tf32":
        if parts is None:
            parts = split_tf32(x2, emb_c)
        _check_parts(parts, n, c, x2.shape[1], x2.device)
        xb, xs, eb, es = parts
        _build.call("chunked_ce dlogits (tf32)",
                    _kernel("dl4j_ce_dlogits_tf32"),
                    (xb.data_ptr(), xs.data_ptr(), eb.data_ptr(),
                     es.data_ptr(), targets.data_ptr(), lse.data_ptr(),
                     g.data_ptr(), dlog.data_ptr(), n, c, xb.shape[1],
                     eb.stride(0), ldo, int(col0), int(n_total)),
                    x2.device)
        launches_dlogits_tf32 += 1
        return dlog
    args = (x2.data_ptr(), emb_c.data_ptr(), targets.data_ptr(),
            lse.data_ptr(), g.data_ptr(), dlog.data_ptr(), n, c,
            x2.shape[1], x2.stride(0), emb_c.stride(0), ldo, int(col0),
            int(n_total))
    if wgmma:
        _build.call("chunked_ce dlogits (wgmma)",
                    _kernel("dl4j_ce_dlogits_wgmma"), args, x2.device)
        launches_dlogits_wgmma += 1
    else:
        _build.call("chunked_ce dlogits", _kernel("dl4j_ce_dlogits"),
                    args + (_DTYPES[x2.dtype],), x2.device)
        launches_dlogits += 1
    return dlog


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 from f32-accumulated products of the operands as they
    are (bf16 on the card: ``mm`` with an f32 output; the CPU build has no
    such ``mm``, so there the exact f32 cast of both)."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def chunked_ce_bwd(x2, emb, targets, lse, g, n_chunks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx (N, D) in x's dtype, dE (V, D) in emb's) of the mean loss, as the
    reference's ``_bwd``: per chunk, its dlogits (:func:`ce_dlogits`), then
    ``dx += dlog·E_c`` and ``dE_c = dlogᵀ·x`` with f32 accumulation. On the
    "tf32" kernel x and emb are split once, before the chunks, and each
    chunk's K3b reads row views of emb's parts."""
    n, d = x2.shape
    v = emb.shape[0]
    c = v // n_chunks
    dx = torch.zeros((n, d), dtype=torch.float32, device=x2.device)
    de = torch.empty((v, d), dtype=torch.float32, device=x2.device)
    parts = None
    if x2.is_cuda and kernel_for("cuda", x2.dtype, d, tma_aligned(x2)
                                 and tma_aligned(emb)) == "tf32":
        parts = split_tf32(x2, emb)
    for i in range(n_chunks):
        emb_c = emb[i * c:(i + 1) * c]
        if parts is None:
            dlog = ce_dlogits(x2, emb_c, targets, lse, i * c, g, n)
        else:
            dlog = ce_dlogits(x2, emb_c, targets, lse, i * c, g, n,
                              parts=parts[:2] + tuple(
                                  p[i * c:(i + 1) * c] for p in parts[2:]))
        dx += _mm_f32(dlog, emb_c)
        de[i * c:(i + 1) * c] = _mm_f32(dlog.T, x2)
    return dx.to(x2.dtype), de.to(emb.dtype)


class ChunkedSoftmaxXent(torch.autograd.Function):
    """``apply(x, emb, targets, n_chunks)``: the mean cross-entropy of
    x (…, D) against emb (V, D) and targets (…) as a 0-d f32 tensor. The
    forward saves x, emb, targets and lse (no logits); the backward runs
    :func:`chunked_ce_bwd`. Both look up the module's functions at call
    time."""

    @staticmethod
    def forward(ctx, x, emb, targets, n_chunks):
        x2 = x.reshape(-1, x.shape[-1])
        t = targets.reshape(-1).long().contiguous()
        lse, loss = chunked_ce_fwd(x2, emb, t, n_chunks)
        ctx.save_for_backward(x2, emb, t, lse)
        ctx.n_chunks, ctx.x_shape = n_chunks, x.shape
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, emb, t, lse = ctx.saved_tensors
        dx, de = chunked_ce_bwd(x2, emb, t, lse, g, ctx.n_chunks)
        return dx.view(ctx.x_shape), de, None, None


def chunked_softmax_xent(x: torch.Tensor, emb: torch.Tensor,
                         targets: torch.Tensor, n_chunks: int
                         ) -> torch.Tensor:
    """Mean token cross-entropy of ``x @ emb.T`` logits against
    ``targets`` without materialising the logits. x: (B, T, D) compute
    dtype; emb: (V, D); targets: (B, T) int. V must divide by
    ``n_chunks``."""
    if emb.shape[0] % n_chunks:
        raise ValueError(f"vocab {emb.shape[0]} must divide into n_chunks "
                         f"{n_chunks}")
    return ChunkedSoftmaxXent.apply(x, emb, targets, n_chunks)
