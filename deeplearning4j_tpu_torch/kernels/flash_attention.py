"""Flash-attention forward: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``_attn_fwd_kernel`` (launched through
``pl.pallas_call`` in ``_fwd_pallas``) of
``deeplearning4j_tpu/kernels/flash_attention.py``. The kernel source is
``csrc/flash_attention_fwd.cu``; it is built with ``nvcc`` for ``sm_90a``
at first use (``_build.py``) and called through ctypes.

What bounds it on the H100: per head it does 4·T²·d FLOPs (half when
causal) over 4·T·d·itemsize bytes, so at d = 64 in bf16 the tensor cores
bound it above T ≈ 600 and device memory below. This first version keeps
Q, the running max/sum and the output accumulator on chip for a block's
whole key loop (the (T, T) scores never reach device memory), but stages
scores and P through shared memory between WMMA tiles, so shared-memory
traffic, not either bound, sets its time. ``PERF.md`` holds its times
beside the bound.

Beside the kernel:

- :func:`flash_attention_reference` — the plain PyTorch version (f32
  scores from the operands, the same mask and sentinel). CPU tensors go
  through it; on the card it is only the yardstick the kernel is held to.
- :func:`flash_attention_fwd` — (o, lse) on (BH, T, d); a CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version.
- :func:`flash_attention` — the JAX signature over (B, T, d) or
  (B, H, T, d), returning o.
- ``launches`` — how many times the kernel was launched.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

_NEG_INF = -1e30
_SUPPORTED = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches in this process (a plain integer; reset it to 0 to count
#: one run's launches)
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from deeplearning4j_tpu_torch.kernels import _build
        lib = _build.load("flash_attention_fwd")
        f = lib.dl4j_flash_attention_fwd
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        lib.dl4j_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_cuda_error_string.restype = ctypes.c_char_p
        _fn = (f, lib.dl4j_cuda_error_string)
    return _fn


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel over (..., T, d): f32 scores
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


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_fwd: q, k, v must lie on one "
                         f"CUDA device (got {q.device}, {k.device}, "
                         f"{v.device})")
    if q.dtype not in _SUPPORTED or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32 or bfloat16 "
                        f"q, k, v of one dtype (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd wants q (BH, Tq, d) and k, v "
                         f"(BH, Tk, d) (got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)})")
    bh, t_q, d = q.shape
    if k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"flash_attention_fwd: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash_attention_fwd: head dim {d} must be a "
                         f"multiple of 16 in [16, 128]")
    if not 1 <= bh <= 65535 or t_q < 1 or k.shape[1] < 1:
        raise ValueError(f"flash_attention_fwd: unsupported sizes "
                         f"BH={bh}, Tq={t_q}, Tk={k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd: {name} is not 16-byte "
                             f"aligned")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) for q (BH, Tq, d), k and v (BH, Tk, d). A CUDA tensor
    launches the kernel on the current stream (or raises); a CPU tensor
    takes :func:`flash_attention_reference`."""
    global launches
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    _check(q, k, v)
    bh, t_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), bh, t_q, k.shape[1], d, float(scale),
                 int(bool(causal)), _SUPPORTED[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, T, d) or (B, H, T, d) tensors of any strides;
    leading dims are flattened into the kernel grid (a copy where the
    layout needs one). ``scale`` defaults to 1/sqrt(d)."""
    d = q.shape[-1]
    o, _ = flash_attention_fwd(*(t.reshape(-1, t.shape[-2], d).contiguous()
                                 for t in (q, k, v)), causal, scale)
    return o.reshape(q.shape)
