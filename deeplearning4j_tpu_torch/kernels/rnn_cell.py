"""The fused LSTM / GravesLSTM cell (K11) and the recurrent layers' time
loops.

Counterpart of ``_RnnBase.run`` in ``deeplearning4j_tpu/nn/conf/layers.py``
(a ``lax.scan`` whose body XLA fuses) for ``LSTM.step`` and
``GravesLSTM.step``, the mask's ``where`` included. Eager PyTorch would
launch every op of that body at every step (about 12 kernels forward and
25 backward a step and a layer), so the cell is one hand-written CUDA
kernel pair for Hopper, in ``csrc/rnn_cell.cu``, built with ``nvcc`` for
``sm_90a`` at first use:

- K11f (:func:`lstm_cell_fwd`): z = X·W[t] + h_prev·RW (+ b in the
  kernel) → the gates, c, h, the step's output h·m and the carries
  ``where(m != 0, new, old)``; it keeps the activated gates for the
  backward.
- K11b (:func:`lstm_cell_bwd`): the output's gradient and the carried dh,
  dc → dz, dc_prev and, under a mask, the part of dh_prev not through RW
  (0 with no mask, and then not written); the peephole terms are added
  into per-row buffers summed once after the loop.

Beside them their plain versions (``*_reference``), the reference's step
in torch ops; a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises. ``launches_cell_fwd`` / ``launches_cell_bwd`` count
the kernels' launches.

:class:`LSTMLayer` is the ``torch.autograd.Function`` of a whole LSTM
layer over T steps, in place of ``lax.scan``: the input product over all
T as one GEMM, then per step one ``addmm`` and K11f; its backward per step
K11b and one product, then dW, dRW, db, the peepholes and dX as whole
products. Autograd records one node a layer. The cell activations K11
takes are :data:`ACTIVATIONS`; an LSTM with another one, and GRU and
SimpleRnn, run their torch ``step`` in ``_RnnBase.run``'s plain loop under
autograd (no kernel).

Precision: f32 in both data types. The reference's carries are f32, and
under the bf16 policy its ``h_prev(f32) @ RW(bf16)`` promotes to f32, so
z, c and h are f32 and only a bf16 layer input's X·W is a bf16 product,
rounded to bf16 before it is added. ``torch.matmul`` refuses mixed types:
``ops.standard.promote_mm`` casts where JAX promotes. An f64 input or f64
params run the plain cell in f64 on the CPU (a reading against f64); K11
takes f32 only.

What bounds K11 on the H100: bytes, ~0.40 MB a step at N 32, H 256
(0.12 µs at 3.35 TB/s) — far under one launch, so it is launch-bound;
``PERF.md`` holds its times beside its bound, the plain version, aten's
fused cell and cuDNN's LSTM.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.standard import promote_mm

#: the cell activations K11 takes, by code (``csrc/rnn_cell.cu``'s Act)
ACTIVATIONS = {"tanh": 0, "identity": 1, "linear": 1, "relu": 2,
               "sigmoid": 3, "hardtanh": 4, "softsign": 5}

#: launches of each kernel in this process (plain integers; set them to 0
#: to count one run's launches)
launches_cell_fwd = 0
launches_cell_bwd = 0

_fns = {}


def act_code(name) -> Optional[int]:
    """K11's code for the activation ``name``, or None where K11 does not
    take it."""
    if name is None or callable(name):
        return None
    return ACTIVATIONS.get(str(name).lower().replace("_", ""))


def _kernel(fn: str):
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i = ctypes.c_void_p, ctypes.c_int
        # the pointers, rows, hd, act, then the stream
        args = ([p] * 10 + [i] * 3 + [p] if fn == "dl4j_lstm_cell_fwd"
                else [p] * 12 + [i] * 3 + [p])
        k = _fns[fn] = _build.bind("rnn_cell", fn, args,
                                   "dl4j_rnn_cell_error_string")
    return k


# ------------------------------------------------------------ plain versions
def _act(code: int, x):
    if code == 0:
        return torch.tanh(x)
    if code == 1:
        return x
    if code == 2:
        return torch.clamp_min(x, 0.0)
    if code == 3:
        return torch.sigmoid(x)
    if code == 4:
        return torch.clamp(x, -1.0, 1.0)
    return x / (1.0 + torch.abs(x))


def _act_d(code: int, x, a):
    """d act(x)/dx from x and a = act(x)."""
    if code == 0:
        return 1.0 - a * a
    if code == 1:
        return torch.ones_like(x)
    if code == 2:
        return (x > 0).to(x.dtype)
    if code == 3:
        return a * (1.0 - a)
    if code == 4:
        return ((x > -1.0) & (x < 1.0)).to(x.dtype)
    d = 1.0 + torch.abs(x)
    return 1.0 / (d * d)


def cell_fwd_reference(z, b, c_prev, h_prev, peep, m, act: int):
    """(y, h, c, gates) of one step: the reference's LSTM / GravesLSTM
    step after its products (z = x·W + h_prev·RW), its bias, peepholes
    ``peep`` = (pI, pF, pO) stacked (3, H) or None, and the mask ``m`` (N,)
    or None (a masked row keeps its carries and outputs 0). All f32."""
    if b is not None:
        z = z + b
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    if peep is not None:
        zi = zi + peep[0] * c_prev
        zf = zf + peep[1] * c_prev
    i, f, g = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
    c = f * c_prev + i * g
    if peep is not None:
        zo = zo + peep[2] * c
    o = torch.sigmoid(zo)
    h = o * _act(act, c)
    gates = torch.cat([i, f, g, o], dim=-1)
    if m is None:
        return h, h, c, gates
    mm = m[:, None]
    keep = mm != 0
    return (h * mm, torch.where(keep, h, h_prev), torch.where(keep, c, c_prev),
            gates)


def cell_bwd_reference(dy, dh, dc, gates, c, c_prev, peep, m, act: int):
    """(dz, dc_prev, dh_pass, dpeep) of one step: the gradient of the
    step's output ``dy`` (or None) and of its carries ``dh``, ``dc``; ``c``
    is the step's carried c, ``c_prev`` the one before. ``dh_pass`` is the
    part of dh_prev not through RW (the carry a masked row passes on), None
    with no mask (it is 0 there); ``dpeep`` (3, N, H) the per-row peephole
    terms, or None."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    if m is None:
        keep = None
        dhn, dcn = dh, dc
        if dy is not None:
            dhn = dy + dhn
    else:
        mm = m[:, None]
        keep = mm != 0
        zero = torch.zeros_like(dh)
        dhn = torch.where(keep, dh, zero)
        dcn = torch.where(keep, dc, zero)
        if dy is not None:
            dhn = dy * mm + dhn
    a = _act(act, c)
    dzo = dhn * a * o * (1.0 - o)
    dct = dcn + dhn * o * _act_d(act, c, a)
    if peep is not None:
        dct = dct + dzo * peep[2]
    dzi = dct * g * i * (1.0 - i)
    dzf = dct * c_prev * f * (1.0 - f)
    dzg = dct * i * (1.0 - g * g)
    dz = torch.cat([dzi, dzf, dzg, dzo], dim=-1)
    dcp = dct * f
    if peep is not None:
        dcp = dcp + dzi * peep[0] + dzf * peep[1]
    dh_pass = None
    if keep is not None:
        dcp = torch.where(keep, dcp, dcp + dc)
        dh_pass = torch.where(keep, torch.zeros_like(dh), dh)
    dpeep = (None if peep is None else
             torch.stack([dzi * c_prev, dzf * c_prev, dzo * c]))
    return dz, dcp, dh_pass, dpeep


# ------------------------------------------------------------------ wrappers
def _check(name: str, rows: int, hd: int, act: int, **tensors):
    if act not in range(6):
        raise ValueError(f"{name}: activation code {act} is not K11's")
    want = {"z": (rows, 4 * hd), "gates": (rows, 4 * hd), "dz": (rows, 4 * hd),
            "b": (4 * hd,), "peep": (3, hd), "m": (rows,),
            "dpeep": (3, rows, hd)}
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        shape = want.get(key, (rows, hd))
        if (not t.is_cuda or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous {shape} "
                             f"float32 CUDA tensor, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        dev = t.device


def _ptr(t):
    return None if t is None else t.data_ptr()


def lstm_cell_fwd(z, b, c_prev, h_prev, peep, m, act: int, out=None):
    """One step forward, (y, h, c, gates): K11f on CUDA tensors (or
    raises), :func:`cell_fwd_reference` on CPU ones. ``out`` = (y or None,
    h, c, gates) preallocated buffers to write (y None: the output is h,
    which an unmasked step's is)."""
    global launches_cell_fwd
    if z.device.type == "cpu":
        res = cell_fwd_reference(z, b, c_prev, h_prev, peep, m, act)
        if out is None:
            return res
        for buf, val in zip(out, res):
            if buf is not None:
                buf.copy_(val)
        y, h, c, gates = out
        return (h if y is None else y), h, c, gates
    rows, hd = c_prev.shape
    if out is None:
        out = (None if m is None else torch.empty_like(c_prev),
               torch.empty_like(c_prev), torch.empty_like(c_prev),
               torch.empty_like(z))
    y, h, c, gates = out
    _check("lstm_cell_fwd", rows, hd, act, z=z, b=b, c_prev=c_prev,
           h_prev=h_prev, peep=peep, m=m, y=y, h=h, c=c, gates=gates)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("rnn_cell fwd", _kernel("dl4j_lstm_cell_fwd"),
                (z.data_ptr(), _ptr(b), c_prev.data_ptr(), h_prev.data_ptr(),
                 _ptr(peep), _ptr(m), _ptr(y), h.data_ptr(), c.data_ptr(),
                 gates.data_ptr(), rows, hd, act), z.device)
    launches_cell_fwd += 1
    return (h if y is None else y), h, c, gates


def lstm_cell_bwd(dy, dh, dc, gates, c, c_prev, peep, m, act: int,
                  dz=None, dpeep=None):
    """One step backward, (dz, dc_prev, dh_pass): K11b on CUDA tensors (or
    raises), :func:`cell_bwd_reference` on CPU ones; ``dh_pass`` is None
    with no mask (K11b does not write it there). ``dz`` is an optional
    (N, 4H) buffer to write; ``dpeep`` (3, N, H) has the step's peephole
    terms added into it (needed when ``peep`` is given)."""
    global launches_cell_bwd
    if dh.device.type == "cpu":
        got, dcp, dh_pass, dp = cell_bwd_reference(dy, dh, dc, gates, c,
                                                   c_prev, peep, m, act)
        if dpeep is not None and dp is not None:
            dpeep += dp
        if dz is not None:
            dz.copy_(got)
            got = dz
        return got, dcp, dh_pass
    rows, hd = dh.shape
    if dz is None:
        dz = torch.empty_like(gates)
    if peep is not None and dpeep is None:
        raise ValueError("lstm_cell_bwd: peepholes need a dpeep buffer")
    dcp = torch.empty_like(dh)
    dh_pass = None if m is None else torch.empty_like(dh)
    _check("lstm_cell_bwd", rows, hd, act, dy=dy, dh=dh, dc=dc, gates=gates,
           c=c, c_prev=c_prev, peep=peep, m=m, dz=dz,
           dpeep=dpeep if peep is not None else None)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("rnn_cell bwd", _kernel("dl4j_lstm_cell_bwd"),
                (_ptr(dy), dh.data_ptr(), dc.data_ptr(), gates.data_ptr(),
                 c.data_ptr(), c_prev.data_ptr(), _ptr(peep), _ptr(m),
                 dz.data_ptr(), dcp.data_ptr(), _ptr(dh_pass),
                 _ptr(dpeep) if peep is not None else None, rows, hd, act),
                dh.device)
    launches_cell_bwd += 1
    return dz, dcp, dh_pass


# ---------------------------------------------------------- layer Functions
class LSTMLayer(torch.autograd.Function):
    """A whole LSTM / GravesLSTM layer over T steps: (y (N, T, H), h_T,
    c_T) from x (N, T, C), W (C, 4H), RW (H, 4H), b (4H), the peepholes
    (H each, or None), the carries h0, c0 (N, H) and a mask (N, T) or
    None; ``act`` is K11's activation code. Params may be bf16 (the
    hidden-layer policy): products promote as ``promote_mm``, the cell
    runs in f32. With no mask the output is h itself (K11f writes no second
    copy); under a mask it is h·m."""

    @staticmethod
    def forward(ctx, act, x, W, RW, b, pI, pF, pO, h0, c0, mask):
        n, t_len, n_in = x.shape
        hd = RW.shape[0]
        # the cell's type: f32, or f64 for an f64 input or f64 params
        cdt = torch.promote_types(torch.promote_types(x.dtype, W.dtype),
                                  torch.float32)
        x_tm = x.transpose(0, 1).reshape(t_len * n, n_in)
        xw = promote_mm(x_tm, W).to(cdt)                # (T·N, 4H)
        rw = RW.to(cdt)
        bf = b.to(cdt).contiguous()
        peep = (None if pI is None else
                torch.stack([pI, pF, pO]).to(cdt).contiguous())
        m_tm = (None if mask is None
                else mask.transpose(0, 1).to(cdt).contiguous())
        dev = x.device
        hs = torch.empty((t_len, n, hd), dtype=cdt, device=dev)
        cs = torch.empty_like(hs)
        ys = None if m_tm is None else torch.empty_like(hs)
        gates = torch.empty((t_len, n, 4 * hd), dtype=cdt, device=dev)
        h, c = h0.to(cdt).contiguous(), c0.to(cdt).contiguous()
        h0f, c0f = h, c
        for t in range(t_len):
            z = torch.addmm(xw[t * n:(t + 1) * n], h, rw)
            lstm_cell_fwd(z, bf, c, h, peep,
                          None if m_tm is None else m_tm[t], act,
                          out=(None if ys is None else ys[t], hs[t], cs[t],
                               gates[t]))
            h, c = hs[t], cs[t]
        ctx.act = act
        ctx.dtypes = (x.dtype, W.dtype, RW.dtype, b.dtype,
                      None if pI is None else pI.dtype)
        ctx.shape = (n, t_len, n_in)
        ctx.save_for_backward(x_tm, W, rw, peep, h0f, c0f, m_tm, hs, cs,
                              gates)
        y = hs if ys is None else ys
        return y.transpose(0, 1), hs[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, d_y, d_ht, d_ct):
        x_tm, W, rw, peep, h0, c0, m_tm, hs, cs, gates = ctx.saved_tensors
        n, t_len, n_in = ctx.shape
        hd = rw.shape[0]
        act = ctx.act
        cdt = gates.dtype
        dy = (None if d_y is None
              else d_y.transpose(0, 1).to(cdt).contiguous())
        dh = (torch.zeros_like(h0) if d_ht is None
              else d_ht.to(cdt).contiguous())
        dc = (torch.zeros_like(c0) if d_ct is None
              else d_ct.to(cdt).contiguous())
        dz_all = torch.empty_like(gates)
        dpeep = (None if peep is None else
                 torch.zeros((3, n, hd), dtype=cdt, device=h0.device))
        rw_t = rw.t()
        for t in range(t_len - 1, -1, -1):
            c_prev = cs[t - 1] if t > 0 else c0
            dz, dc, dh_pass = lstm_cell_bwd(
                None if dy is None else dy[t], dh, dc, gates[t], cs[t],
                c_prev, peep, None if m_tm is None else m_tm[t], act,
                dz=dz_all[t], dpeep=dpeep)
            dh = (dz @ rw_t if dh_pass is None
                  else torch.addmm(dh_pass, dz, rw_t))
        x_dt, w_dt, rw_dt, b_dt, p_dt = ctx.dtypes
        dz2 = dz_all.reshape(t_len * n, 4 * hd)
        h_prev = torch.cat([h0[None], hs[:-1]]).reshape(t_len * n, hd)
        d_rw = (h_prev.t() @ dz2).to(rw_dt)
        d_b = dz2.sum(0).to(b_dt)
        # the input product's cotangent in that product's type (bf16 for
        # a bf16 input and bf16 W)
        dz_p = dz2.to(torch.promote_types(x_dt, w_dt))
        need = ctx.needs_input_grad
        d_w = promote_mm(x_tm.t(), dz_p).to(w_dt) if need[2] else None
        d_x = None
        if need[1]:
            d_x = promote_mm(dz_p, W.t()).reshape(t_len, n, n_in).transpose(
                0, 1).to(x_dt)
        d_pi = d_pf = d_po = None
        if dpeep is not None:
            d_pi, d_pf, d_po = (p.to(p_dt) for p in dpeep.sum(1))
        return (None, d_x, d_w, d_rw, d_b, d_pi, d_pf, d_po,
                dh if need[8] else None, dc if need[9] else None, None)
