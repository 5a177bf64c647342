"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper.

Replace the Pallas TPU kernel ``_attn_fwd_kernel`` (launched through
``pl.pallas_call`` in ``_fwd_pallas``) of
``deeplearning4j_tpu/kernels/flash_attention.py`` and its custom-VJP
backward ``_bwd_blockwise``. Four sources, each built with ``nvcc`` for
``sm_90a`` at first use (``_build.py``) and called through ctypes; each
wrapper chooses its kernel explicitly by dtype and head dim
(:func:`kernel_for`):

- ``csrc/flash_attention_fwd_wgmma.cu`` — bf16 at d = 64 and 128 (the
  model's prefill): ``wgmma`` for both products with scores, P and O in
  registers, K/V through a TMA ring, 128 query rows per block. It takes
  (B, H, T, d) views of any strides with unit stride on d and 16-byte
  multiples elsewhere, so the fused-QKV projection's views go in without a
  copy and o is written into a caller-given view.
- ``csrc/flash_attention_fwd.cu`` — f32, and bf16 at the other head dims:
  FA2 in registers on ``mma.sync`` (bf16 m16n8k16; f32 m16n8k8 with each
  operand split into two TF32 parts and three products, so no operand is
  rounded to TF32 alone), scores, P and O in registers, K/V through a
  ``cp.async`` ring, 64 query rows per block, on the same strided views.
- ``csrc/flash_attention_bwd_wgmma.cu`` — the backward (dq, dk, dv) for
  bf16 at d = 64 and 128 (the model's training step): FA2's split into a D
  pass, a dQ kernel and a dK/dV kernel, ``wgmma`` for every product with
  the scores, P and dS in registers, Q/dO or K/V through TMA rings. It
  reads and writes strided (B, H, T, d) views, so the fused projection's
  gradient is written in place.
- ``csrc/flash_attention_bwd.cu`` — the backward for f32 and bf16 at the
  other head dims, the same split: bf16 through ``mma.sync`` (the
  forward's products, ``csrc/flash_mma.cuh``), f32 through register-tiled
  FMA summing in the plain version's order (the f32 tolerance row is
  tighter than any other order can meet), on the same strided views.

Both redesigned kernels take every head dim ``d % 8 == 0`` in [8, 256]
(:func:`kernel_for`); the wgmma kernels keep bf16 at d 64 and 128.

What bounds them on the H100: per head 4·Tq·Tk·d FLOPs forward and
10·Tq·Tk·d backward (about half when causal) over 2·(Tq + Tk)·d·itemsize
bytes forward and 4·(Tq + Tk)·d·itemsize backward, so in bf16 the tensor
cores bound the forward above T ≈ 600 and the backward above T ≈ 470
(about twice that when causal), device memory below; the f32 forward's
products, three TF32 products each, run at a third of the 495 TFLOP/s TF32
rate. ``PERF.md`` holds the kernels' times beside the bound.

Beside the kernels:

- :func:`flash_attention_reference` — the plain PyTorch version (f32
  scores from the operands, the same mask and sentinel). CPU tensors go
  through it; on the card it is only the yardstick the kernels are held to.
- :func:`flash_attention_fwd` — (o, lse) on (BH, T, d) or (B, H, T, d); a
  CUDA tensor launches a kernel or raises, a CPU tensor takes the plain
  version.
- :func:`flash_attention` — the JAX signature over (B, T, d) or
  (B, H, T, d), returning o.
- :func:`flash_attention_bwd_reference` / :func:`flash_attention_bwd` —
  the backward's plain version and its wrapper, as the forward's.
- :class:`FlashAttention` — the ``autograd.Function`` the model trains
  through: the forward kernel, and the backward kernel as its gradient.
- ``launches_wgmma`` / ``launches_simple`` / ``launches_bwd_wgmma`` /
  ``launches_bwd`` — launches of each kernel.
- :func:`tf32_split` / :func:`split_matmul` and the two
  ``*_split_emulation`` functions — numpy emulations of the f32 forward's
  products, for the tests and for predicting its error.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

_NEG_INF = -1e30
_SIMPLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_DIMS = (64, 128)
#: the head dims every kernel pair takes: multiples of 8 in [8, 256]
HEAD_DIMS = tuple(range(8, 257, 8))

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_wgmma = 0
launches_simple = 0
launches_bwd = 0
launches_bwd_wgmma = 0

_fns = {}


def _kernel(name: str):
    """(launch function, error-string function) of ``csrc/<name>.cu``."""
    fn = _fns.get(name)
    if fn is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "flash_attention_fwd_wgmma":
            fn = _build.bind(name, "dl4j_flash_attention_fwd_wgmma",
                             [p] * 5 + [i] * 5 + [ll] * 12
                             + [ctypes.c_float, i, p],
                             "dl4j_flash_wgmma_error_string")
        elif name in ("flash_attention_bwd", "flash_attention_bwd_wgmma"):
            wgmma = name.endswith("wgmma")
            # the wgmma backward takes no dtype: it is bf16 only
            fn = _build.bind(name, f"dl4j_{name}",
                             [p] * 10 + [i] * 5
                             + [ctypes.POINTER(ll), ctypes.c_float, i]
                             + [i] * (not wgmma) + [p],
                             "dl4j_flash_bwd_wgmma_error_string" if wgmma
                             else "dl4j_flash_bwd_error_string")
        else:
            fn = _build.bind(name, "dl4j_flash_attention_fwd",
                             [p] * 5 + [i] * 5 + [ll] * 12
                             + [ctypes.c_float, i, i, p],
                             "dl4j_cuda_error_string")
        _fns[name] = fn
    return fn


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernels over (..., T, d): f32 scores
    from the operands times ``scale``, keys masked with the -1e30
    sentinel (``k_idx <= q_idx`` when causal), P cast to v's dtype before
    an f32-accumulated P·V, ``o / max(l, 1e-30)``. Returns (o in q's
    dtype, lse f32 of shape (..., T_q))."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel pair that takes attention of this dtype and head dim, for
    the forward and the backward alike: "wgmma" (bf16 at d 64 and 128) or
    "simple" (``flash_attention_fwd.cu`` / ``flash_attention_bwd.cu``: f32,
    and bf16 at every other d). Raises TypeError outside f32 and bf16, and
    ValueError for a head dim that is not a multiple of 8 in [8, 256]."""
    if dtype not in _SIMPLE_DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not "
                        f"{dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {d} must be a multiple "
                         f"of 8 in [8, 256]")
    return "wgmma" if dtype == torch.bfloat16 and d in _WGMMA_DIMS \
        else "simple"


def _check(q, k, v, out):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_fwd: q, k, v must lie on one "
                         f"CUDA device (got {q.device}, {k.device}, "
                         f"{v.device})")
    if q.dtype not in _SIMPLE_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 "
                        f"q, k, v of one dtype (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.dim() not in (3, 4) or k.dim() != q.dim() or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd wants q (BH, Tq, d) or "
                         f"(B, H, Tq, d) and k, v of the same rank and shape "
                         f"(got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    if k.shape[:-2] != q.shape[:-2] or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    kernel_for(q.dtype, q.shape[-1])
    if q.shape[-2] < 1 or k.shape[-2] < 1 or q.numel() == 0:
        raise ValueError(f"flash_attention_fwd: empty operands "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention_fwd: out {tuple(out.shape)} "
                         f"{out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")


def _outer_strides(t: torch.Tensor):
    """(b, h, t) strides and sizes of a (B, H, T, d) or (BH, T, d) view."""
    st, shape = t.stride(), t.shape
    if len(st) == 3:
        return (st[0], st[0], st[1]), (shape[0], 1, shape[1])
    return st[:3], shape[:3]


def _layout_error(t: torch.Tensor) -> Optional[str]:
    """Why the kernels cannot read ``t`` through its strides, or None."""
    if t.stride(-1) != 1:
        return (f"needs unit stride on the head dim (strides "
                f"{tuple(t.stride())})")
    if t.data_ptr() % 16:
        return "does not start on a 16-byte boundary"
    item = t.element_size()
    for stride, size in zip(*_outer_strides(t)):
        if size > 1 and (stride <= 0 or stride * item % 16):
            return (f"strides {tuple(t.stride())} (elements) must be "
                    f"positive multiples of 16 bytes outside the head dim")
    return None


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a contiguous copy of it where the kernels cannot read it
    through its strides (a copy, not ``contiguous()``: a contiguous view
    may still start off a 16-byte boundary)."""
    if _layout_error(t) is None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strided_operand(fn: str, name: str, t: torch.Tensor
                     ) -> Tuple[int, int, int, int]:
    err = _layout_error(t)
    if err is not None:
        raise ValueError(f"{fn}: {name} {err}")
    return (t.data_ptr(), *_outer_strides(t)[0])


def tma_operand(name: str, t: torch.Tensor) -> Tuple[int, int, int, int]:
    """(data_ptr, stride_b, stride_h, stride_t) in elements of a
    (B, H, T, d) view, or of a (BH, T, d) one taken as (BH, 1, T, d), that
    the forward kernels read or write as it is. Raises ValueError unless it
    has unit stride on d, a 16-byte aligned start, and every other stride
    of a dim longer than 1 a positive multiple of 16 bytes (TMA's rule)."""
    return _strided_operand("flash_attention_fwd", name, t)


def wgmma_args(q, k, v, o, lse, causal: bool, scale: float) -> tuple:
    """The argument tuple of ``dl4j_flash_attention_fwd_wgmma`` for q, k,
    v and o, all (B, H, T, d) or all (BH, T, d), each checked by
    :func:`tma_operand` (no launch); with the dtype code after it, that of
    ``dl4j_flash_attention_fwd``."""
    ops = [tma_operand(n, t) for n, t in (("q", q), ("k", k), ("v", v),
                                          ("out", o))]
    if q.dim() == 3:
        b, h = q.shape[0], 1
    else:
        b, h = q.shape[0], q.shape[1]
    return (ops[0][0], ops[1][0], ops[2][0], ops[3][0], lse.data_ptr(),
            b, h, q.shape[-2], k.shape[-2], q.shape[-1],
            *ops[0][1:], *ops[1][1:], *ops[2][1:], *ops[3][1:],
            float(scale), int(bool(causal)))


def _call(name, args, device):
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call(name, _kernel(name), args, device)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) for q (BH, Tq, d) or (B, H, Tq, d) and k, v of the same
    rank with Tk rows. ``out``, if given, is a view of q's shape that
    receives o (and is returned). lse has q's shape without d, f32.

    A CUDA tensor launches a kernel on the current stream (or raises), on
    views that meet :func:`tma_operand`'s rule as they are: the wgmma
    kernel for bf16 at d 64 or 128 (other views raise), the simple kernel
    for f32 and the other head dims (:func:`kernel_for`; other views go
    through contiguous copies, as in :func:`flash_attention_bwd`). A CPU
    tensor takes :func:`flash_attention_reference`."""
    global launches_wgmma, launches_simple
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, causal, scale)
        if out is None:
            return o, lse
        return out.copy_(o), lse
    _check(q, k, v, out)
    d = q.shape[-1]
    lead, t_q = q.shape[:-2], q.shape[-2]
    lse = torch.empty((*lead, t_q), dtype=torch.float32, device=q.device)
    if kernel_for(q.dtype, d) == "wgmma":
        o = out if out is not None else torch.empty(q.shape, dtype=q.dtype,
                                                    device=q.device)
        if (t_q + 127) // 128 > 65535:
            raise ValueError(f"flash_attention_fwd: Tq {t_q} too long")
        _call("flash_attention_fwd_wgmma",
              wgmma_args(q, k, v, o, lse, causal, scale), q.device)
        launches_wgmma += 1
        return o, lse
    bh = q.shape[0] * (1 if q.dim() == 3 else q.shape[1])
    if bh > 65535:
        raise ValueError(f"flash_attention_fwd: B·H = {bh} > 65535 for "
                         f"{q.dtype} at head dim {d}")
    q, k, v = (_readable(t) for t in (q, k, v))
    o = out if out is not None and _layout_error(out) is None else \
        torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _call("flash_attention_fwd",
          (*wgmma_args(q, k, v, o, lse, causal, scale),
           _SIMPLE_DTYPES[q.dtype]), q.device)
    launches_simple += 1
    if out is None or o is out:
        return o, lse
    return out.copy_(o), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention over (B, T, d) or (B, H, T, d) tensors; o. ``scale``
    defaults to 1/sqrt(d)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


# ------------------------------------------------------------- backward
def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = False,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the backward over (..., T, d), with the
    rounding points of the JAX ``_bwd_blockwise``: D = rowsum(f32 dO ∘ f32
    O); p = exp(s − lse) in f32 from f32 scores (masked keys at the −1e30
    sentinel give exactly 0); dV = p cast to v's dtype, times dO; dP =
    dO·Vᵀ; dS = p ∘ (dP − D) cast to q's dtype; dQ = scale·dS·K and dK =
    scale·dSᵀ·Q; every product accumulated in f32. Returns (dq, dk, dv) in
    the dtypes of q, k, v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = (torch.arange(t_q, device=s.device)[:, None]
                >= torch.arange(t_k, device=s.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, _NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_scratch_numel(b_h: int, t_q: int) -> int:
    """f32 scratch of the wgmma backward: D and a copy of lse, each
    (B·H, Tq rounded up to the 64-row query tile)."""
    return 2 * b_h * (-(-t_q // 64) * 64)


def bwd_args(q, k, v, o, lse, do, dq, dk, dv, delta) -> tuple:
    """Pointers, sizes and the 24 strides (b, h, t for q, k, v, o, dO, dq,
    dk, dv) of ``dl4j_flash_attention_bwd`` (no launch; scale, causal and
    dtype follow). Every operand must meet :func:`tma_operand`'s rule."""
    names = ("q", "k", "v", "o", "do", "dq", "dk", "dv")
    ops = [_strided_operand("flash_attention_bwd", n, t)
           for n, t in zip(names, (q, k, v, o, do, dq, dk, dv))]
    b, h = (q.shape[0], 1) if q.dim() == 3 else (q.shape[0], q.shape[1])
    strides = [s for op in ops for s in op[1:]]
    return ((*(op[0] for op in ops[:5]), lse.data_ptr(),
             *(op[0] for op in ops[5:]), delta.data_ptr(),
             b, h, q.shape[-2], k.shape[-2], q.shape[-1]), strides)


def bwd_wgmma_args(q, k, v, o, lse, do, dq, dk, dv, scratch) -> tuple:
    """The arguments of ``dl4j_flash_attention_bwd_wgmma`` (no launch;
    scale and causal follow), laid out as :func:`bwd_args`'s with
    ``scratch`` (:func:`bwd_scratch_numel` f32) in place of D. The kernel
    reads q, k, v and dO through tensor maps, so every operand must meet
    :func:`tma_operand`'s rule, and only bf16 at d 64 or 128 is taken."""
    if kernel_for(q.dtype, q.shape[-1]) != "wgmma":
        raise ValueError(f"flash_attention_bwd: the wgmma backward takes "
                         f"bf16 at head dim 64 or 128, not {q.dtype} at "
                         f"{q.shape[-1]}")
    b_h = q.shape[0] * (1 if q.dim() == 3 else q.shape[1])
    need = bwd_scratch_numel(b_h, q.shape[-2])
    if scratch.dtype != torch.float32 or scratch.numel() < need:
        raise ValueError(f"flash_attention_bwd: scratch needs {need} f32, "
                         f"got {scratch.numel()} {scratch.dtype}")
    return bwd_args(q, k, v, o, lse, do, dq, dk, dv, scratch)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False,
                        scale: Optional[float] = None,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]] = None):
    """(dq, dk, dv) of attention for the forward's (q, k, v, o, lse) and
    the output gradient ``do``, over (BH, T, d) or (B, H, T, d). ``out``,
    if given, is three views of q's, k's and v's shapes that receive the
    gradients (and are returned).

    A CUDA tensor launches a kernel (or raises): the wgmma backward for
    bf16 at d 64 or 128 (:func:`kernel_for`), ``csrc/
    flash_attention_bwd.cu`` for the rest. The operands are read through
    their strides where they meet :func:`tma_operand`'s rule and from
    contiguous copies where not; the views in ``out`` must meet it. A CPU
    tensor takes :func:`flash_attention_bwd_reference`."""
    global launches_bwd, launches_bwd_wgmma
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        grads = flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                              scale)
        if out is None:
            return grads
        return tuple(dst.copy_(g) for dst, g in zip(out, grads))
    _check(q, k, v, None)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} "
                             f"{t.dtype} must match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    if lse.shape != q.shape[:-1] or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} must be float32 of shape "
                         f"{tuple(q.shape[:-1])}")
    if out is None:
        out = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                    for t in (q, k, v))
    for name, dst, like in zip(("dq", "dk", "dv"), out, (q, k, v)):
        if dst.shape != like.shape or dst.dtype != like.dtype \
                or dst.device != like.device:
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(dst.shape)} {dst.dtype} must match "
                             f"{tuple(like.shape)} {like.dtype}")
    q, k, v, o, do = (_readable(t) for t in (q, k, v, o, do))
    b_h = q.shape[0] * (1 if q.dim() == 3 else q.shape[1])
    if b_h > 65535:
        raise ValueError(f"flash_attention_bwd: B·H = {b_h} > 65535")
    if kernel_for(q.dtype, q.shape[-1]) == "wgmma":
        if (max(q.shape[-2], k.shape[-2]) + 127) // 128 > 65535:
            raise ValueError(f"flash_attention_bwd: T {q.shape[-2]}, "
                             f"{k.shape[-2]} too long")
        scratch = torch.empty(bwd_scratch_numel(b_h, q.shape[-2]),
                              dtype=torch.float32, device=q.device)
        args, strides = bwd_wgmma_args(q, k, v, o, lse.contiguous(), do,
                                       *out, scratch)
        _call("flash_attention_bwd_wgmma",
              (*args, (ctypes.c_longlong * 24)(*strides), float(scale),
               int(bool(causal))), q.device)
        launches_bwd_wgmma += 1
        return out
    delta = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    args, strides = bwd_args(q, k, v, o, lse.contiguous(), do, *out, delta)
    _call("flash_attention_bwd",
          (*args, (ctypes.c_longlong * 24)(*strides), float(scale),
           int(bool(causal)), _SIMPLE_DTYPES[q.dtype]), q.device)
    launches_bwd += 1
    return out


def _heads(x, n_heads):
    """(q, k, v) as (B, H, T, hd) views of one (B, T, 3C) projection or of
    three (B, T, C) ones."""
    if len(x) == 1:
        x = torch.split(x[0], x[0].shape[-1] // 3, dim=-1)
    b, t, c = x[0].shape
    return tuple(a.view(b, t, n_heads, c // n_heads).transpose(1, 2)
                 for a in x)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention in the model's layout: ``apply(n_heads,
    causal, scale, qkv)`` for the fused (B, T, 3C) projection, or
    ``apply(n_heads, causal, scale, q, k, v)`` for three (B, T, C) ones;
    returns o as (B, T, C).

    Forward: :func:`flash_attention_fwd` on the (B, H, T, hd) views, o
    written through the (B, H, T, hd) view of a (B, T, H, hd) buffer.
    Backward: :func:`flash_attention_bwd`, the gradients written straight
    into one buffer shaped like each input (for the fused projection, one
    (B, T, 3C) gradient), so nothing is copied or concatenated around the
    kernels. Both look up the module's functions at call time."""

    @staticmethod
    def forward(ctx, n_heads, causal, scale, *x):
        q, k, v = _heads(x, n_heads)
        b, h, t, hd = q.shape
        o = torch.empty((b, t, h, hd), dtype=q.dtype, device=q.device)
        _o, lse = flash_attention_fwd(q, k, v, causal, scale,
                                      out=o.transpose(1, 2))
        ctx.save_for_backward(*x, o, lse)
        ctx.n_heads, ctx.causal, ctx.scale = n_heads, causal, scale
        return o.view(b, t, h * hd)

    @staticmethod
    def backward(ctx, do):
        *x, o, lse = ctx.saved_tensors
        dx = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
              for a in x]
        b, t, h, hd = o.shape
        flash_attention_bwd(*_heads(x, ctx.n_heads), o.transpose(1, 2), lse,
                            do.reshape(b, t, h, hd).transpose(1, 2),
                            ctx.causal, ctx.scale,
                            out=_heads(dx, ctx.n_heads))
        return (None, None, None, *dx)


# ---------------------------------------------- the TF32 split's products
def tf32_round(x) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on a numpy array: each f32 value rounded to
    TF32 (10 explicit mantissa bits, the low 13 bits of the f32 pattern
    zero), to nearest with ties away from zero. Returns f32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(x) -> Tuple[np.ndarray, np.ndarray]:
    """(big, small), both TF32, with big = rna(x) and small = rna(x − big):
    how the f32 forward splits each operand of a product (x − big is exact
    in f32)."""
    x = np.asarray(x, dtype=np.float32)
    big = tf32_round(x)
    return big, tf32_round(x - big)


def split_matmul(a, b) -> np.ndarray:
    """``a @ b`` over the last two dims as the f32 forward takes a product:
    each operand split by :func:`tf32_split`, big·big + big·small +
    small·big (small·small dropped), summed in f64 and rounded to f32 (the
    tensor cores sum in f32 and truncate; that is not emulated)."""
    (ab, as_), (bb, bs) = tf32_split(a), tf32_split(b)
    a64, b64 = ab.astype(np.float64), bb.astype(np.float64)
    return (a64 @ b64 + (a64 @ bs.astype(np.float64)
                         + as_.astype(np.float64) @ b64)).astype(np.float32)


def _causal_keep(t_q: int, t_k: int) -> np.ndarray:
    return np.arange(t_q)[:, None] >= np.arange(t_k)[None, :]


def flash_attention_split_emulation(q, k, v, causal: bool = False,
                                    scale: Optional[float] = None):
    """numpy (o, lse) of f32 attention over (..., T, d) with the f32
    forward's products (:func:`split_matmul`) and the rest as
    :func:`flash_attention_reference` computes it in f32."""
    q, k, v = (np.asarray(t, dtype=np.float32) for t in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = split_matmul(q, np.swapaxes(k, -1, -2)) * np.float32(scale)
    if causal:
        s = np.where(_causal_keep(s.shape[-2], s.shape[-1]), s,
                     np.float32(_NEG_INF))
    m = s.max(axis=-1, keepdims=True)
    p = np.exp(s - m)
    l = np.maximum(p.sum(axis=-1, keepdims=True), np.float32(1e-30))
    o = split_matmul(p, v) / l
    return o, (m + np.log(l))[..., 0]
