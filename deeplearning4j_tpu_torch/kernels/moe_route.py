"""MoE token movement (K7): dispatch and combine of the Switch / GShard FFN.

Counterpart of the two one-hot einsums of ``moe_ffn`` in
``deeplearning4j_tpu/parallel/moe.py`` (dispatch ``"gec,gd->ecd"``, combine
``"gec,ecd->gd"``). Routing (``parallel/moe.py``) reduces the (G, E, C)
one-hot tensors to two int32 index maps: ``slot`` (G, K), the expert slot
``e·C + pos`` of each (token, choice) or −1 where it was dropped, and
``src`` (E·C,), the inverse, ``g·K + k`` of the choice filling each slot or
−1 for an empty one. Two hand-written CUDA kernels for Hopper, in
``csrc/moe_route.cu``, built with ``nvcc`` for ``sm_90a`` at first use, move
rows through them:

- K7d (:func:`moe_dispatch`, :func:`moe_dispatch_grad`): ``out[s] =
  x[src[s] // K]``, empty slots 0; with gates it is combine's backward,
  ``d_out[s] = gate·dy[g]`` and ``d_gate = ⟨dy[g], out_e[s]⟩``.
- K7c (:func:`moe_combine`): ``y[g] = Σ_k gate_k·rows[slot[g, k]]`` with
  f32 accumulation, 0 when every choice dropped; with unit gates it is
  dispatch's backward.

Beside them their plain versions (``*_reference``); a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.
``launches_dispatch`` / ``launches_combine`` count the kernels' launches.

What bounds them on the H100: memory alone, the kept rows read once and
each output row written once (dispatch at the bench's large width: 16.8 MB
read, 21.0 MB written, ≈11 µs at 3.35 TB/s); ``PERF.md`` holds their
times beside it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of each kernel in this process (plain integers; set them to 0 to
#: count one run's launches)
launches_dispatch = 0
launches_combine = 0

_fns = {}


def _kernel(fn: str):
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = ([p] * 3 + [ll, i, i] + [p] * 3 + [i, p]
                if fn == "dl4j_moe_dispatch" else
                [p] * 4 + [ll, i, i, i, p])
        k = _fns[fn] = _build.bind("moe_route", fn, args,
                                   "dl4j_moe_error_string")
    return k


# ------------------------------------------------------------ plain versions
def dispatch_reference(x: torch.Tensor, src: torch.Tensor,
                       k: int) -> torch.Tensor:
    """out (S, d): row s is x[src[s] // k], or 0 where src[s] < 0."""
    out = torch.zeros((src.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    kept = src >= 0
    out[kept] = x[src[kept].long() // k]
    return out


def dispatch_grad_reference(dy, src, k: int, gates, out_e
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine's backward: (d_out (S, d) with row s = gate·dy[g] for the
    choice g·k + j = src[s] (0 for an empty slot), d_gates (G, k) with
    ⟨dy[g], out_e[s]⟩ at each kept choice and 0 elsewhere), each product in
    f32 and rounded to dy's dtype."""
    d_out = torch.zeros(out_e.shape, dtype=dy.dtype, device=dy.device)
    d_gates = torch.zeros(gates.numel(), dtype=dy.dtype, device=dy.device)
    kept = src >= 0
    gk = src[kept].long()
    rows = dy[gk // k].float()
    d_out[kept] = (gates.reshape(-1)[gk].float()[:, None] * rows
                   ).to(dy.dtype)
    d_gates[gk] = (rows * out_e[kept].float()).sum(-1).to(dy.dtype)
    return d_out, d_gates.view(gates.shape)


def combine_reference(rows: torch.Tensor, slot: torch.Tensor,
                      gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (G, d): Σ over the kept choices k (slot[g, k] >= 0) of
    gates[g, k]·rows[slot[g, k]] (weight 1 without gates), accumulated in
    f32 in the order of k, rounded to rows' dtype."""
    acc = torch.zeros((slot.shape[0], rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for j in range(slot.shape[1]):
        s = slot[:, j].long()
        kept = s >= 0
        r = rows[s[kept]].float()
        if gates is not None:
            r = gates[kept, j].float()[:, None] * r
        acc[kept] += r
    return acc.to(rows.dtype)


# ------------------------------------------------------------------ wrappers
def _check_rows(name: str, what: str, t: torch.Tensor, dtype, d: int):
    if not t.is_cuda or t.dtype != dtype or t.dim() != 2 \
            or t.shape[1] != d or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous (rows, {d}) "
                         f"{dtype} CUDA tensor, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} does not start on a 16-byte "
                         f"boundary")


def _check(name, x, index, gates, k):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 rows, got "
                        f"{x.dtype}")
    d = x.shape[-1]
    _check_rows(name, "rows", x, x.dtype, d)
    if d * x.element_size() % 16:
        raise ValueError(f"{name}: a row of {d} {x.dtype} is not a multiple "
                         f"of 16 bytes")
    if k not in (1, 2):
        raise ValueError(f"{name}: top_k {k} must be 1 or 2")
    if (index.dtype != torch.int32 or index.device != x.device
            or not index.is_contiguous() or index.numel() < 1):
        raise ValueError(f"{name}: index maps must be non-empty contiguous "
                         f"int32 on {x.device}, got {index.dtype} "
                         f"{tuple(index.shape)} on {index.device}")
    if gates is not None and (gates.dtype != x.dtype
                              or gates.device != x.device
                              or not gates.is_contiguous()
                              or gates.dim() != 2 or gates.shape[1] != k):
        raise ValueError(f"{name}: gates must be contiguous (G, {k}) "
                         f"{x.dtype} on {x.device}, got {gates.dtype} "
                         f"{tuple(gates.shape)}")


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, k: int) -> torch.Tensor:
    """The expert buffers (S, d): ``out[s] = x[src[s] // k]``, 0 where
    ``src[s] < 0``. A CUDA tensor launches K7d (or raises); a CPU tensor
    takes :func:`dispatch_reference`."""
    global launches_dispatch
    if x.device.type == "cpu":
        return dispatch_reference(x, src, k)
    _check("moe_dispatch", x, src, None, k)
    out = torch.empty((src.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("moe_route dispatch", _kernel("dl4j_moe_dispatch"),
                (x.data_ptr(), src.data_ptr(), out.data_ptr(), src.shape[0],
                 x.shape[1], k, None, None, None, _DTYPES[x.dtype]),
                x.device)
    launches_dispatch += 1
    return out


def moe_dispatch_grad(dy: torch.Tensor, src: torch.Tensor, k: int,
                      gates: torch.Tensor, out_e: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine's backward, (d_out_e (S, d), d_gates (G, k)), for the
    output gradient dy (G, d): K7d with gates on a CUDA tensor (or raises),
    :func:`dispatch_grad_reference` on a CPU one."""
    global launches_dispatch
    if dy.device.type == "cpu":
        return dispatch_grad_reference(dy, src, k, gates, out_e)
    _check("moe_dispatch_grad", dy, src, gates, k)
    _check_rows("moe_dispatch_grad", "out_e", out_e, dy.dtype, dy.shape[1])
    if out_e.shape[0] != src.shape[0] or gates.shape[0] != dy.shape[0]:
        raise ValueError(f"moe_dispatch_grad: out_e {tuple(out_e.shape)} "
                         f"and gates {tuple(gates.shape)} do not match src "
                         f"{tuple(src.shape)} and dy {tuple(dy.shape)}")
    d_out = torch.empty(out_e.shape, dtype=dy.dtype, device=dy.device)
    d_gates = torch.zeros(gates.shape, dtype=dy.dtype, device=dy.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("moe_route dispatch", _kernel("dl4j_moe_dispatch"),
                (dy.data_ptr(), src.data_ptr(), d_out.data_ptr(),
                 src.shape[0], dy.shape[1], k, gates.data_ptr(),
                 out_e.data_ptr(), d_gates.data_ptr(), _DTYPES[dy.dtype]),
                dy.device)
    launches_dispatch += 1
    return d_out, d_gates


def moe_combine(rows: torch.Tensor, slot: torch.Tensor,
                gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y (G, d) = Σ_k gates[g, k]·rows[slot[g, k]] over kept choices (unit
    weights when ``gates`` is None), f32 accumulation. A CUDA tensor
    launches K7c (or raises); a CPU tensor takes
    :func:`combine_reference`."""
    global launches_combine
    if rows.device.type == "cpu":
        return combine_reference(rows, slot, gates)
    k = slot.shape[1] if slot.dim() == 2 else 0
    _check("moe_combine", rows, slot, gates, k)
    if gates is not None and gates.shape[0] != slot.shape[0]:
        raise ValueError(f"moe_combine: gates {tuple(gates.shape)} do not "
                         f"match slot {tuple(slot.shape)}")
    y = torch.empty((slot.shape[0], rows.shape[1]), dtype=rows.dtype,
                    device=rows.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("moe_route combine", _kernel("dl4j_moe_combine"),
                (rows.data_ptr(), slot.data_ptr(),
                 None if gates is None else gates.data_ptr(), y.data_ptr(),
                 slot.shape[0], rows.shape[1], k, _DTYPES[rows.dtype]),
                rows.device)
    launches_combine += 1
    return y
