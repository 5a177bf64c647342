"""Chunked LM cross-entropy (K3): the mean token cross-entropy of the tied
head's logits ``x @ emb.T`` without building the (N, V) logits.

Counterpart of ``deeplearning4j_tpu/kernels/chunked_ce.py``
(``chunked_softmax_xent``, its ``_forward_pieces`` scan and its custom-VJP
``_bwd``). Two hand-written CUDA kernels for Hopper, in
``csrc/chunked_ce.cu``, built with ``nvcc`` for ``sm_90a`` at first use:

- K3f (:func:`chunked_ce_fwd`): per row, the online logsumexp of the
  logits over the whole vocabulary and the target's logit, with each logit
  tile kept in registers; partials per vocab split merged into ``lse``
  (saved for the backward) and the mean loss. The kernel walks the vocab in
  128-column tiles of its own, so ``n_chunks`` does not change what it
  computes (only f32 sums run in another order).
- K3b (:func:`ce_dlogits`): one ce chunk's dlogits, ``(exp(s − lse) −
  onehot)·g/N`` in x's dtype, from the logits recomputed in registers. The
  backward (:func:`chunked_ce_bwd`) runs it once per chunk and follows each
  with the reference's two f32-accumulated products (``dx += dlog·E_c``,
  ``dE_c = dlogᵀ·x``) as plain matrix products.

Beside them their plain versions, :func:`chunked_ce_fwd_reference` (the
reference's scan: f32 chunk logits, online max and sum, the target picked
from the chunk that holds it) and :func:`ce_dlogits_reference`. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
:class:`ChunkedSoftmaxXent` is the ``autograd.Function`` the model trains
through, and :func:`chunked_softmax_xent` the JAX signature.
``launches_fwd`` / ``launches_dlogits`` count the kernels' launches.

What bounds them on the H100: 2·N·V·d FLOPs each (550 GFLOP at the bench's
large config, batch 8: 0.556 ms at the dense bf16 peak) against reading x
and E once; ``PERF.md`` holds their times beside it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 128                 # rows and vocab columns of a kernel block tile
_SLAB_BYTES = 64            # depth of one shared-memory stage
_BLOCKS_WANTED = 4 * 132    # K3f blocks to aim for: 4 a streaming
                            # multiprocessor on the H100

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_fwd = 0
launches_dlogits = 0

_fns = {}


def _kernel(fn: str):
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = ([p] * 6 + [i] * 3 + [ll] * 2 + [i] * 3 + [p]
                if fn == "dl4j_ce_fwd" else
                [p] * 6 + [i] * 3 + [ll] * 3 + [i] * 3 + [p])
        k = _fns[fn] = _build.bind("chunked_ce", fn, args,
                                   "dl4j_ce_error_string")
    return k


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
def vocab_splits(n_rows: int, vocab: int) -> Tuple[int, int]:
    """(splits, vocab tiles per split) of K3f's grid: enough splits of the
    vocab that ``ceil(n_rows / 128) × splits`` blocks come near 4 a
    streaming multiprocessor, each split a whole number of 128-column tiles,
    none empty."""
    tiles = -(-vocab // _TILE)
    want = max(1, -(-_BLOCKS_WANTED // -(-n_rows // _TILE)))
    per = -(-tiles // min(want, tiles))
    return -(-tiles // per), per


def _check(name: str, x2, emb, targets):
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
    item = x2.element_size()
    if x2.shape[1] * item % _SLAB_BYTES:
        raise ValueError(f"{name}: d {x2.shape[1]} must be a multiple of "
                         f"{_SLAB_BYTES // item} for {x2.dtype}")
    for what, t in (("x", x2), ("emb", emb)):
        if (t.stride(1) != 1 or t.stride(0) * item % 16
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {what} needs unit stride on d, a "
                             f"16-byte aligned start and row stride (got "
                             f"strides {tuple(t.stride())})")
    if (targets.dtype != torch.int64 or targets.shape != x2.shape[:1]
            or not targets.is_contiguous()):
        raise ValueError(f"{name}: targets must be contiguous int64 of shape "
                         f"({x2.shape[0]},), got {targets.dtype} "
                         f"{tuple(targets.shape)}")


def chunked_ce_fwd(x2: torch.Tensor, emb: torch.Tensor,
                   targets: torch.Tensor, n_chunks: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (N,) f32, loss () f32) of x (N, D) against emb (V, D) and
    int64 targets (N,): the loss is the mean of lse − the target's logit.
    A CUDA tensor launches K3f (or raises); a CPU tensor takes
    :func:`chunked_ce_fwd_reference` over ``n_chunks`` chunks."""
    global launches_fwd
    if x2.device.type == "cpu":
        lse, correct = chunked_ce_fwd_reference(x2, emb, targets, n_chunks)
        return lse, (lse - correct).mean()
    _check("chunked_ce_fwd", x2, emb, targets)
    n, v = x2.shape[0], emb.shape[0]
    splits, per = vocab_splits(n, v)
    part = torch.empty((3, splits, n), dtype=torch.float32, device=x2.device)
    lse = torch.empty((n,), dtype=torch.float32, device=x2.device)
    loss = torch.empty((), dtype=torch.float32, device=x2.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("chunked_ce fwd", _kernel("dl4j_ce_fwd"),
                (x2.data_ptr(), emb.data_ptr(), targets.data_ptr(),
                 part.data_ptr(), lse.data_ptr(), loss.data_ptr(), n, v,
                 x2.shape[1], x2.stride(0), emb.stride(0), splits, per,
                 _DTYPES[x2.dtype]), x2.device)
    launches_fwd += 1
    return lse, loss


def ce_dlogits(x2: torch.Tensor, emb_c: torch.Tensor, targets: torch.Tensor,
               lse: torch.Tensor, col0: int, g: torch.Tensor,
               n_total: int) -> torch.Tensor:
    """One ce chunk's dlogits (N, C) in x's dtype, ``(exp(x·emb_cᵀ − lse)
    − onehot(targets − col0))·g/n_total``, for the chunk emb_c (C, D) whose
    row 0 is vocab id ``col0`` and the loss's cotangent ``g`` (a 0-d
    tensor, read on the device). A CUDA tensor launches K3b (or raises); a
    CPU tensor takes :func:`ce_dlogits_reference`."""
    global launches_dlogits
    if x2.device.type == "cpu":
        return ce_dlogits_reference(x2, emb_c, targets, lse, col0, g,
                                    n_total)
    _check("ce_dlogits", x2, emb_c, targets)
    if lse.dtype != torch.float32 or lse.shape != x2.shape[:1] \
            or not lse.is_contiguous():
        raise ValueError(f"ce_dlogits: lse must be contiguous float32 of "
                         f"shape ({x2.shape[0]},)")
    g = g.to(device=x2.device, dtype=torch.float32).reshape(1).contiguous()
    n, c = x2.shape[0], emb_c.shape[0]
    dlog = torch.empty((n, c), dtype=x2.dtype, device=x2.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("chunked_ce dlogits", _kernel("dl4j_ce_dlogits"),
                (x2.data_ptr(), emb_c.data_ptr(), targets.data_ptr(),
                 lse.data_ptr(), g.data_ptr(), dlog.data_ptr(), n, c,
                 x2.shape[1], x2.stride(0), emb_c.stride(0), c, int(col0),
                 int(n_total), _DTYPES[x2.dtype]), x2.device)
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
    ``dx += dlog·E_c`` and ``dE_c = dlogᵀ·x`` with f32 accumulation."""
    n, d = x2.shape
    v = emb.shape[0]
    c = v // n_chunks
    dx = torch.zeros((n, d), dtype=torch.float32, device=x2.device)
    de = torch.empty((v, d), dtype=torch.float32, device=x2.device)
    for i in range(n_chunks):
        emb_c = emb[i * c:(i + 1) * c]
        dlog = ce_dlogits(x2, emb_c, targets, lse, i * c, g, n)
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
