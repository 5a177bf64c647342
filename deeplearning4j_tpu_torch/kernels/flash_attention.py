"""Flash-attention forward: hand-written CUDA kernels for Hopper.

Replace the Pallas TPU kernel ``_attn_fwd_kernel`` (launched through
``pl.pallas_call`` in ``_fwd_pallas``) of
``deeplearning4j_tpu/kernels/flash_attention.py``. Two kernels, chosen
explicitly by dtype and head dim, each built with ``nvcc`` for ``sm_90a``
at first use (``_build.py``) and called through ctypes:

- ``csrc/flash_attention_fwd_wgmma.cu`` — bf16 at d = 64 and 128 (the
  model's prefill): ``wgmma`` for both products with scores, P and O in
  registers, K/V through a TMA ring, 128 query rows per block. It takes
  (B, H, T, d) views of any strides with unit stride on d and 16-byte
  multiples elsewhere, so the fused-QKV projection's views go in without a
  copy and o is written into a caller-given view.
- ``csrc/flash_attention_fwd.cu`` — f32 (scalar FMA: the port allows no
  TF32) and bf16 at the other head dims (16, 32, 48, 80, 96, 112): WMMA
  through shared memory on contiguous (BH, T, d), 64 query rows per block.
  Strided inputs are made contiguous for it first.

What bounds them on the H100: per head 4·Tq·Tk·d FLOPs (about half when
causal) over 2·(Tq + Tk)·d·itemsize bytes, so at d = 64 in bf16 the tensor
cores bound it above T ≈ 600 and device memory below. ``PERF.md`` holds
both kernels' times beside the bound.

Beside the kernels:

- :func:`flash_attention_reference` — the plain PyTorch version (f32
  scores from the operands, the same mask and sentinel). CPU tensors go
  through it; on the card it is only the yardstick the kernels are held to.
- :func:`flash_attention_fwd` — (o, lse) on (BH, T, d) or (B, H, T, d); a
  CUDA tensor launches a kernel or raises, a CPU tensor takes the plain
  version.
- :func:`flash_attention` — the JAX signature over (B, T, d) or
  (B, H, T, d), returning o.
- ``launches_wgmma`` / ``launches_simple`` — launches of each kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_SIMPLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WGMMA_DIMS = (64, 128)

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_wgmma = 0
launches_simple = 0

_fns = {}


def _kernel(name: str):
    """(launch function, error-string function) of ``csrc/<name>.cu``."""
    fn = _fns.get(name)
    if fn is None:
        from deeplearning4j_tpu_torch.kernels import _build
        lib = _build.load(name)
        if name == "flash_attention_fwd_wgmma":
            f = lib.dl4j_flash_attention_fwd_wgmma
            f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                          + [ctypes.c_longlong] * 12
                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            err = lib.dl4j_flash_wgmma_error_string
        else:
            f = lib.dl4j_flash_attention_fwd
            f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            err = lib.dl4j_cuda_error_string
        f.restype = ctypes.c_int
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn = _fns[name] = (f, err)
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


def takes_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether the wgmma kernel takes operands of this dtype and head dim
    (the simple kernel takes every other supported pair)."""
    return dtype == torch.bfloat16 and d in _WGMMA_DIMS


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
    d = q.shape[-1]
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash_attention_fwd: head dim {d} must be a "
                         f"multiple of 16 in [16, 128]")
    if q.shape[-2] < 1 or k.shape[-2] < 1 or q.numel() == 0:
        raise ValueError(f"flash_attention_fwd: empty operands "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention_fwd: out {tuple(out.shape)} "
                         f"{out.dtype} must match q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}")


def tma_operand(name: str, t: torch.Tensor) -> Tuple[int, int, int, int]:
    """(data_ptr, stride_b, stride_h, stride_t) in elements of a
    (B, H, T, d) view, or of a (BH, T, d) one taken as (BH, 1, T, d), that
    the wgmma kernel reads or writes as it is. Raises ValueError unless it
    has unit stride on d, a 16-byte aligned start, and every other stride
    of a dim longer than 1 a positive multiple of 16 bytes (TMA's rule)."""
    st, shape = t.stride(), t.shape
    if st[-1] != 1:
        raise ValueError(f"flash_attention_fwd: {name} needs unit stride on "
                         f"the head dim (strides {tuple(st)})")
    ptr = t.data_ptr()
    if ptr % 16:
        raise ValueError(f"flash_attention_fwd: {name} does not start on a "
                         f"16-byte boundary")
    if len(st) == 3:
        outer, sizes = (st[0], st[0], st[1]), (shape[0], 1, shape[1])
    else:
        outer, sizes = st[:3], shape[:3]
    item = t.element_size()
    for size, stride in zip(sizes, outer):
        if size > 1 and (stride <= 0 or stride * item % 16):
            raise ValueError(
                f"flash_attention_fwd: {name} strides {tuple(st)} "
                f"(elements) must be positive multiples of 16 bytes outside "
                f"the head dim")
    return (ptr, *outer)


def wgmma_args(q, k, v, o, lse, causal: bool, scale: float) -> tuple:
    """The argument tuple of ``dl4j_flash_attention_fwd_wgmma`` for q, k,
    v and o, all (B, H, T, d) or all (BH, T, d), each checked by
    :func:`tma_operand` (no launch)."""
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
    fn, err_str = _kernel(name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (f"CUresult {-err}" if err < 0 else f"CUDA error {err}")
        raise RuntimeError(f"{name} launch failed: {what} "
                           f"({err_str(err).decode()})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        out: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) for q (BH, Tq, d) or (B, H, Tq, d) and k, v of the same
    rank with Tk rows. ``out``, if given, is a view of q's shape that
    receives o (and is returned). lse has q's shape without d, f32.

    A CUDA tensor launches a kernel on the current stream (or raises): the
    wgmma kernel for bf16 at d 64 or 128, on the views as they are; the
    simple kernel for f32 and the other head dims, on contiguous copies. A
    CPU tensor takes :func:`flash_attention_reference`."""
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
    if takes_wgmma(q.dtype, d):
        o = out if out is not None else torch.empty(
            q.shape, dtype=q.dtype, device=q.device)
        if (t_q + 127) // 128 > 65535:
            raise ValueError(f"flash_attention_fwd: Tq {t_q} too long")
        _call("flash_attention_fwd_wgmma",
              wgmma_args(q, k, v, o, lse, causal, scale), q.device)
        launches_wgmma += 1
        return o, lse
    q3, k3, v3 = (t.reshape(-1, t.shape[-2], d).contiguous()
                  for t in (q, k, v))
    bh = q3.shape[0]
    if bh > 65535:
        raise ValueError(f"flash_attention_fwd: B·H = {bh} > 65535 for "
                         f"{q.dtype} at head dim {d}")
    for name, t in (("q", q3), ("k", k3), ("v", v3)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte "
                             f"aligned")
    o3 = torch.empty_like(q3)
    _call("flash_attention_fwd",
          (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), o3.data_ptr(),
           lse.data_ptr(), bh, t_q, k3.shape[1], d, float(scale),
           int(bool(causal)), _SIMPLE_DTYPES[q.dtype]), q.device)
    launches_simple += 1
    o = o3.view(q.shape)
    if out is None:
        return o, lse
    return out.copy_(o), lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention over (B, T, d) or (B, H, T, d) tensors; o. ``scale``
    defaults to 1/sqrt(d)."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]
