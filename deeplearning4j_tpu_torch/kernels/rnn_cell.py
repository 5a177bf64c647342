"""The LSTM / GravesLSTM time loop on the card: a whole layer a launch
(K11L) and the fused cell a step (K11).

Counterpart of ``_RnnBase.run`` in ``deeplearning4j_tpu/nn/conf/layers.py``
(a ``lax.scan`` over ``LSTM.step`` / ``GravesLSTM.step``, the mask's
``where`` included, which XLA compiles into one device loop). Hand-written
CUDA kernels for Hopper in ``csrc/rnn_cell.cu``, built with ``nvcc`` for
``sm_90a`` at first use:

- K11Lf (:func:`lstm_layer_fwd`): the layer over the T steps of a call in
  one launch, the recurrent product h_prev·RW inside the kernel: a grid of
  thread-block clusters, each owning a block of batch rows, each CTA a
  slice of hidden units with RW's columns for them resident in its shared
  memory and h exchanged through the cluster's distributed shared memory
  at every step. Its outputs: the carries after each step, the activated
  gates (kept for the backward) and, under a mask, the output h·m.
- K11Lb (:func:`lstm_layer_bwd`): its backward in one launch, RW's rows
  of each CTA's units resident, dz exchanged the same way: dz of every
  step, the initial carries' gradients and the peephole terms.
- K11f / K11b (:func:`lstm_cell_fwd`, :func:`lstm_cell_bwd`): one step's
  cell and its backward, the recurrent product an ``addmm`` a step
  outside; the route of layers too wide for K11L's shared memory.

Beside them their plain versions (``*_reference``), the reference's loop
and step in torch ops; a CPU tensor takes the plain version, a CUDA tensor
launches the kernel or raises. ``launches_layer_fwd`` /
``launches_layer_bwd`` / ``launches_cell_fwd`` / ``launches_cell_bwd``
count the kernels' launches.

:class:`LSTMLayer` is the ``torch.autograd.Function`` of a whole LSTM
layer over T steps, in place of ``lax.scan``: the input product over all
T as one GEMM, then the time loop on its route (:func:`cell_route`):
"k11_layer" (K11Lf, and K11Lb in the backward) where the layer's width
fits a cluster's shared memory (:data:`MAX_LAYER_HIDDEN`), else "k11" (per
step an ``addmm`` and K11f; K11b and a product backward); then dW, dRW,
db, the peepholes and dX as whole products. Autograd records one node a
layer. The cell activations K11 takes are :data:`ACTIVATIONS`; an LSTM
with another one, and GRU and SimpleRnn, run their torch ``step`` in
``_RnnBase.run``'s plain loop under autograd (the "step" route, no
kernel). The route follows from the configuration, never from a failed
launch.

Precision: f32 in both data types. The reference's carries are f32, and
under the bf16 policy its ``h_prev(f32) @ RW(bf16)`` promotes to f32, so
z, c and h are f32 and only a bf16 layer input's X·W is a bf16 product,
rounded to bf16 before it is added. ``torch.matmul`` refuses mixed types:
``ops.standard.promote_mm`` casts where JAX promotes. K11L's product runs
in f32 on the FMA units (no TF32), every sum in a fixed order. An f64
input or f64 params run the plain loop in f64 on the CPU (a reading
against f64); the kernels take f32 only.

What bounds them on the H100: K11 moves ~0.40 MB a step at N 32, H 256
(0.12 µs at 3.35 TB/s), far under one launch; K11L's product is 0.84
GFLOP a launch at R1's second layer (12.5 µs at 67 TFLOP/s), but its T
dependent steps, each a pass over the CTA's RW slice in shared memory and
a cluster barrier, hold it above that. ``PERF.md`` holds their times
beside their bounds, the plain versions and cuDNN's LSTM.
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
launches_layer_fwd = 0
launches_layer_bwd = 0

#: K11L's threads a block (``csrc/rnn_cell.cu``'s LAYER_THREADS)
LAYER_THREADS = 256
#: the dynamic shared memory one block may take on the H100 (227 KB)
SMEM_PER_BLOCK = 232448
#: K11L's cluster sizes, in the order tried: 8 CTAs (portable), then 16
#: (non-portable; the kernel's attribute allows it)
LAYER_CLUSTERS = (8, 16)
#: the most batch rows a cluster owns
LAYER_ROWS = 4

_fns = {}
_clusters = {}


def act_code(name) -> Optional[int]:
    """K11's code for the activation ``name``, or None where K11 does not
    take it."""
    if name is None or callable(name):
        return None
    return ACTIVATIONS.get(str(name).lower().replace("_", ""))


def layer_geometry(which: str, hd: int, cluster: int, rows: int) -> dict:
    """One CTA's share of a K11L launch (``which`` "fwd" or "bwd"), as
    ``csrc/rnn_cell.cu``'s ``geometry`` computes it: the hidden ``units`` a
    CTA owns (U = ceil(H / cluster); the last CTAs may own fewer or none),
    the product's output columns ``oc`` (the forward's 4U gate columns,
    the backward's U units) and its reduction length ``k`` (H forward, 4H
    backward) padded to ``kp`` (a multiple of 4); ``ncb`` column blocks of
    32, a warp each, ``ks`` shares of k (the warps over the blocks; 0 when
    the blocks outnumber the warps) of ``chunk`` each (a multiple of 4),
    and the block's shared memory ``smem`` in bytes: the resident RW slice
    (kp, oc), the exchanged h or dz of ``rows`` rows twice
    (double-buffered) and the shares' sums (ks, rows, oc)."""
    units = -(-hd // cluster)
    oc = units if which == "bwd" else 4 * units
    k = 4 * hd if which == "bwd" else hd
    kp = -(-k // 4) * 4
    ncb = -(-oc // 32)
    warps = LAYER_THREADS // 32
    ks = warps // ncb if ncb <= warps else 0
    chunk = -(-(-(-kp // ks)) // 4) * 4 if ks else 0
    return {"units": units, "oc": oc, "k": k, "kp": kp, "ncb": ncb,
            "ks": ks, "chunk": chunk,
            "smem": 4 * (kp * oc + 2 * rows * kp + ks * rows * oc)}


def layer_cluster(hd: int) -> Optional[int]:
    """The cluster size K11L runs a layer of ``hd`` hidden units with: the
    first of :data:`LAYER_CLUSTERS` at which the forward and the backward
    fit one block's shared memory (:data:`SMEM_PER_BLOCK`) and threads
    with :data:`LAYER_ROWS` rows a cluster; None when none does."""
    for cluster in LAYER_CLUSTERS:
        geo = [layer_geometry(w, hd, cluster, LAYER_ROWS)
               for w in ("fwd", "bwd")]
        if all(g["ks"] > 0 and LAYER_ROWS * g["units"] <= LAYER_THREADS
               and g["smem"] <= SMEM_PER_BLOCK for g in geo):
            return cluster
    return None


#: the widest layer K11L takes (wider ones take K11 a step)
MAX_LAYER_HIDDEN = max(h for h in range(1, 1025) if layer_cluster(h))


def layer_rows(n: int) -> int:
    """Batch rows a K11L cluster owns: 1 up to 8 rows, 2 up to 16, else
    :data:`LAYER_ROWS` (the char-RNN's N 32: 8 clusters)."""
    return 1 if n <= 8 else 2 if n <= 16 else LAYER_ROWS


def cell_route(activation, hd: int) -> str:
    """The time loop of an LSTM layer with cell ``activation`` and ``hd``
    hidden units: "k11_layer" (K11L, one launch a layer and call) where
    K11 takes the activation and the width fits K11L, "k11" (K11 a step)
    for a wider layer, "step" (the torch step under autograd) for an
    activation K11 does not take."""
    if act_code(activation) is None:
        return "step"
    return "k11" if layer_cluster(hd) is None else "k11_layer"


def _kernel(fn: str):
    k = _fns.get(fn)
    if k is None:
        from deeplearning4j_tpu_torch.kernels import _build
        p, i = ctypes.c_void_p, ctypes.c_int
        # the pointers, then the ints, then the stream
        args = {"dl4j_lstm_cell_fwd": [p] * 10 + [i] * 3 + [p],
                "dl4j_lstm_cell_bwd": [p] * 12 + [i] * 3 + [p],
                "dl4j_lstm_layer_fwd": [p] * 11 + [i] * 6 + [p],
                "dl4j_lstm_layer_bwd": [p] * 13 + [i] * 6 + [p],
                "dl4j_lstm_layer_clusters": [i] * 4
                + [ctypes.POINTER(i)]}[fn]
        k = _fns[fn] = _build.bind("rnn_cell", fn, args,
                                   "dl4j_rnn_cell_error_string")
    return k


def layer_clusters(which: str, hd: int, cluster: int, rows: int,
                   device) -> int:
    """How many K11L clusters of this shape the card on ``device`` holds at
    once (``cudaOccupancyMaxActiveClusters``, after the kernel's dynamic
    shared memory limit and non-portable cluster sizes are set); raises
    RuntimeError when none fits. Asked once a shape and device."""
    key = (which, hd, cluster, rows, device.index)
    n = _clusters.get(key)
    if n is None:
        fn, err_str = _kernel("dl4j_lstm_layer_clusters")
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(int(which == "bwd"), hd, cluster, rows,
                     ctypes.byref(out))
        if err != 0 or out.value < 1:
            why = (f"CUDA error {err} ({err_str(err).decode()})" if err
                   else "0 clusters")
            raise RuntimeError(
                f"lstm_layer_{which}: no cluster of {cluster} CTAs with "
                f"{layer_geometry(which, hd, cluster, rows)['smem']} bytes "
                f"of shared memory each fits the card (H {hd}, {rows} "
                f"rows a cluster): {why}")
        n = _clusters[key] = out.value
    return n


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


def layer_fwd_reference(xw, rw, b, peep, m, h0, c0, act: int):
    """(ys, hs, cs, gates) of a layer over T steps: the reference's time
    loop, an ``addmm`` for each step's z = X·W[t] + h_prev·RW and the plain
    cell. ``xw`` (T, N, 4H) is X·W, ``m`` (T, N) or None; ``hs``, ``cs``
    (T, N, H) the carries after each step, ``gates`` (T, N, 4H), ``ys``
    the output h·m, None with no mask (the output is then ``hs``)."""
    t_len, n, _ = xw.shape
    hd = rw.shape[0]
    hs = xw.new_empty((t_len, n, hd))
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xw)
    ys = None if m is None else torch.empty_like(hs)
    h, c = h0, c0
    for t in range(t_len):
        y, h, c, g = cell_fwd_reference(torch.addmm(xw[t], h, rw), b, c, h,
                                        peep, None if m is None else m[t],
                                        act)
        hs[t], cs[t], gates[t] = h, c, g
        if ys is not None:
            ys[t] = y
    return ys, hs, cs, gates


def layer_bwd_reference(dy, dh, dc, gates, cs, c0, rw, peep, m, act: int):
    """(dz, dh0, dc0, dpeep) of a layer's backward over the T steps of
    :func:`layer_fwd_reference`, last to first: ``dy`` (T, N, H) the
    output's gradient or None, ``dh``, ``dc`` (N, H) the final carries';
    ``dz`` (T, N, 4H), the initial carries' ``dh0``, ``dc0``, and
    ``dpeep`` (3, N, H) each row's peephole terms summed over the steps
    (None without peepholes). dh_prev = dh_pass + dz·RWᵀ a step."""
    t_len, n, _ = gates.shape
    dz_all = torch.empty_like(gates)
    dpeep = None if peep is None else gates.new_zeros((3, n, rw.shape[0]))
    rw_t = rw.t()
    for t in range(t_len - 1, -1, -1):
        dz, dc, dh_pass, dp = cell_bwd_reference(
            None if dy is None else dy[t], dh, dc, gates[t], cs[t],
            cs[t - 1] if t > 0 else c0, peep, None if m is None else m[t],
            act)
        if dp is not None:
            dpeep += dp
        dz_all[t] = dz
        dh = dz @ rw_t if dh_pass is None else torch.addmm(dh_pass, dz, rw_t)
    return dz_all, dh, dc, dpeep


# ------------------------------------------------------------------ wrappers
def _check_tensors(name: str, act: int, shapes: dict, **tensors):
    """Raise unless ``act`` is K11's and every given tensor is a
    contiguous f32 CUDA tensor of its shape in ``shapes``, all on one
    device."""
    if act not in range(6):
        raise ValueError(f"{name}: activation code {act} is not K11's")
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        shape = shapes[key]
        if (not t.is_cuda or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous {shape} "
                             f"float32 CUDA tensor, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        dev = t.device


def _check(name: str, rows: int, hd: int, act: int, **tensors):
    shapes = {key: (rows, hd) for key in tensors}
    shapes.update(z=(rows, 4 * hd), gates=(rows, 4 * hd),
                  dz=(rows, 4 * hd), b=(4 * hd,), peep=(3, hd), m=(rows,),
                  dpeep=(3, rows, hd))
    _check_tensors(name, act, shapes, **tensors)


def _check_layer(name: str, t_len: int, n: int, hd: int, act: int,
                 **tensors):
    seq, gate = (t_len, n, hd), (t_len, n, 4 * hd)
    shapes = {key: (n, hd) for key in tensors}
    shapes.update(xw=gate, gates=gate, dz=gate, rw=(hd, 4 * hd),
                  b=(4 * hd,), peep=(3, hd), m=(t_len, n), ys=seq, hs=seq,
                  cs=seq, dy=seq, dpeep=(3, n, hd))
    _check_tensors(name, act, shapes, **tensors)


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


def _layer_shape(name: str, n: int, hd: int):
    """(cluster, rows a cluster) of a K11L launch; raises past
    :data:`MAX_LAYER_HIDDEN`."""
    cluster = layer_cluster(hd)
    if cluster is None:
        raise ValueError(f"{name}: H {hd} is past K11L's widest layer "
                         f"({MAX_LAYER_HIDDEN}); the per-step route takes it")
    return cluster, layer_rows(n)


def lstm_layer_fwd(xw, rw, b, peep, m, h0, c0, act: int):
    """A layer forward over T steps in one launch, (ys, hs, cs, gates) as
    :func:`layer_fwd_reference` gives them: K11Lf on CUDA tensors (or
    raises), the plain version on CPU ones. ``xw`` (T, N, 4H) is X·W, ``rw``
    (H, 4H), ``b`` (4H), ``peep`` (3, H) or None, ``m`` (T, N) or None,
    ``h0``, ``c0`` (N, H)."""
    global launches_layer_fwd
    if xw.device.type == "cpu":
        return layer_fwd_reference(xw, rw, b, peep, m, h0, c0, act)
    t_len, n, _ = xw.shape
    hd = rw.shape[0]
    cluster, rows = _layer_shape("lstm_layer_fwd", n, hd)
    hs = torch.empty((t_len, n, hd), dtype=xw.dtype, device=xw.device)
    cs, gates = torch.empty_like(hs), torch.empty_like(xw)
    ys = None if m is None else torch.empty_like(hs)
    _check_layer("lstm_layer_fwd", t_len, n, hd, act, xw=xw, rw=rw, b=b,
                 peep=peep, m=m, h0=h0, c0=c0)
    layer_clusters("fwd", hd, cluster, rows, xw.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("rnn_cell layer fwd", _kernel("dl4j_lstm_layer_fwd"),
                (xw.data_ptr(), rw.data_ptr(), _ptr(b), _ptr(peep), _ptr(m),
                 h0.data_ptr(), c0.data_ptr(), _ptr(ys), hs.data_ptr(),
                 cs.data_ptr(), gates.data_ptr(), t_len, n, hd, act, cluster,
                 rows), xw.device)
    launches_layer_fwd += 1
    return ys, hs, cs, gates


def lstm_layer_bwd(dy, dh, dc, gates, cs, c0, rw, peep, m, act: int):
    """A layer backward over the T steps in one launch, (dz, dh0, dc0,
    dpeep) as :func:`layer_bwd_reference` gives them: K11Lb on CUDA
    tensors (or raises), the plain version on CPU ones."""
    global launches_layer_bwd
    if gates.device.type == "cpu":
        return layer_bwd_reference(dy, dh, dc, gates, cs, c0, rw, peep, m,
                                   act)
    t_len, n, _ = gates.shape
    hd = rw.shape[0]
    cluster, rows = _layer_shape("lstm_layer_bwd", n, hd)
    dz = torch.empty_like(gates)
    dh0, dc0 = torch.empty_like(dh), torch.empty_like(dc)
    dpeep = (None if peep is None else
             torch.empty((3, n, hd), dtype=dh.dtype, device=dh.device))
    _check_layer("lstm_layer_bwd", t_len, n, hd, act, dy=dy, dh=dh, dc=dc,
                 gates=gates, cs=cs, c0=c0, rw=rw, peep=peep, m=m)
    layer_clusters("bwd", hd, cluster, rows, gates.device)
    from deeplearning4j_tpu_torch.kernels import _build
    _build.call("rnn_cell layer bwd", _kernel("dl4j_lstm_layer_bwd"),
                (_ptr(dy), dh.data_ptr(), dc.data_ptr(), gates.data_ptr(),
                 cs.data_ptr(), c0.data_ptr(), rw.data_ptr(), _ptr(peep),
                 _ptr(m), dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
                 _ptr(dpeep), t_len, n, hd, act, cluster, rows),
                gates.device)
    launches_layer_bwd += 1
    return dz, dh0, dc0, dpeep


# ---------------------------------------------------------- layer Functions
class LSTMLayer(torch.autograd.Function):
    """A whole LSTM / GravesLSTM layer over T steps: (y (N, T, H), h_T,
    c_T) from x (N, T, C), W (C, 4H), RW (H, 4H), b (4H), the peepholes
    (H each, or None), the carries h0, c0 (N, H) and a mask (N, T) or
    None; ``act`` is K11's activation code, ``route`` the time loop's
    (:func:`cell_route`: "k11_layer" one K11L launch each way, "k11" K11
    and an ``addmm`` a step). Params may be bf16 (the hidden-layer
    policy): products promote as ``promote_mm``, the cell runs in f32.
    With no mask the output is h itself (no second copy is written);
    under a mask it is h·m."""

    @staticmethod
    def forward(ctx, act, route, x, W, RW, b, pI, pF, pO, h0, c0, mask):
        n, t_len, n_in = x.shape
        hd = RW.shape[0]
        # the cell's type: f32, or f64 for an f64 input or f64 params
        cdt = torch.promote_types(torch.promote_types(x.dtype, W.dtype),
                                  torch.float32)
        x_tm = x.transpose(0, 1).reshape(t_len * n, n_in)
        xw = promote_mm(x_tm, W).to(cdt).reshape(t_len, n, 4 * hd)
        rw = RW.to(cdt).contiguous()
        bf = b.to(cdt).contiguous()
        peep = (None if pI is None else
                torch.stack([pI, pF, pO]).to(cdt).contiguous())
        m_tm = (None if mask is None
                else mask.transpose(0, 1).to(cdt).contiguous())
        h0f, c0f = h0.to(cdt).contiguous(), c0.to(cdt).contiguous()
        if route == "k11_layer":
            ys, hs, cs, gates = lstm_layer_fwd(xw, rw, bf, peep, m_tm, h0f,
                                               c0f, act)
        else:
            hs = torch.empty((t_len, n, hd), dtype=cdt, device=x.device)
            cs = torch.empty_like(hs)
            ys = None if m_tm is None else torch.empty_like(hs)
            gates = torch.empty_like(xw)
            h, c = h0f, c0f
            for t in range(t_len):
                z = torch.addmm(xw[t], h, rw)
                lstm_cell_fwd(z, bf, c, h, peep,
                              None if m_tm is None else m_tm[t], act,
                              out=(None if ys is None else ys[t], hs[t],
                                   cs[t], gates[t]))
                h, c = hs[t], cs[t]
        ctx.act, ctx.route = act, route
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
        if ctx.route == "k11_layer":
            dz_all, dh, dc, dpeep = lstm_layer_bwd(dy, dh, dc, gates, cs, c0,
                                                   rw, peep, m_tm, act)
        else:
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
        d_w = promote_mm(x_tm.t(), dz_p).to(w_dt) if need[3] else None
        d_x = None
        if need[2]:
            d_x = promote_mm(dz_p, W.t()).reshape(t_len, n, n_in).transpose(
                0, 1).to(x_dt)
        d_pi = d_pf = d_po = None
        if dpeep is not None:
            d_pi, d_pf, d_po = (p.to(p_dt) for p in dpeep.sum(1))
        return (None, None, d_x, d_w, d_rw, d_b, d_pi, d_pf, d_po,
                dh if need[9] else None, dc if need[10] else None, None)
