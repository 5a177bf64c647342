"""The standard ops the ported layers call: counterparts of the JAX
package's ``ops/standard.py`` entries ``conv1d``, ``conv2d``, ``conv3d``,
``depthwise_conv2d``, ``maxpool2d``, ``avgpool2d``, ``pnormpool2d``,
``maxpool3d``, ``avgpool3d``, ``upsampling2d``, ``resize_bilinear``,
``batchnorm``, ``lrn``, ``dropout_inverted`` and
``dot_product_attention``, as plain functions (the op registry is not
ported); ``conv_transpose``, the transposed convolution that the
deconvolution layers take from ``lax.conv_transpose``; and
``promote_mm``, the dtype rule of ``jnp.matmul`` that the layers'
products follow.

``dot_product_attention`` runs on the hand flash kernels K1/K2
(``kernels/flash_attention.py``) wherever :func:`attention_route` says
they take it, with the layers' key mask; elsewhere on its plain version.

Activations are NHWC and conv weights HWIO, as in the reference. A
contiguous NHWC tensor ``x`` gives ``x.permute(0, 3, 1, 2)``, an NCHW view
in channels-last memory, so cuDNN runs its NHWC kernels without a copy,
and its result permutes back the same way. ``padding`` is ``"SAME"``,
``"VALID"``, an int or pair (symmetric), or a pair of (lo, hi) pairs.
"SAME" follows lax: the odd row of padding goes at the end, which
``F.conv2d(padding="same")`` cannot do at stride 2, so asymmetric padding
is applied to the NHWC input first.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.kernels import flash_attention as _fa


def promote_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted type of the two, as ``jnp.matmul`` takes
    mixed types (f32 @ bf16 → f32; the bf16 → f32 cast is exact), where
    ``torch.matmul`` refuses them."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """lax's "SAME" (lo, hi) padding of one spatial dim."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def resolve_pads(padding, spatial, kernel, strides, dilation=(1, 1)):
    """[(lo, hi), (lo, hi)] of the two spatial dims."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0), (0, 0)]
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [same_pads(s, k, st, d) for s, k, st, d in
                zip(spatial, kernel, strides, dilation)]
    if isinstance(padding, int):
        padding = (padding, padding)
    if all(isinstance(p, (tuple, list)) for p in padding):
        return [(int(lo), int(hi)) for lo, hi in padding]
    return [(int(p), int(p)) for p in padding]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad_nhwc(x, pads, value=0.0):
    (t, b), (l, r) = pads
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def conv2d(x, w, b=None, strides=(1, 1), padding="SAME", dilation=(1, 1)):
    """NHWC ``x`` * HWIO ``w`` (+ ``b``): ``lax.conv_general_dilated`` with
    ("NHWC", "HWIO", "NHWC"), as cuDNN's ``F.conv2d``."""
    strides, dilation = _pair(strides), _pair(dilation)
    pads = resolve_pads(padding, x.shape[1:3], w.shape[:2], strides,
                        dilation)
    if any(lo != hi for lo, hi in pads):
        x = _pad_nhwc(x, pads)
        pads = [(0, 0), (0, 0)]
    out = _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), None, strides,
                         (pads[0][0], pads[1][0]), dilation))
    # the bias is added after the product, as the reference adds it: its
    # gradient is then the same bf16 sum on both sides
    return out + b if b is not None else out


def _window_sum(x, kernel, strides):
    """Unpadded sum over each window (NHWC in, NHWC out)."""
    return _nhwc(F.avg_pool2d(_nchw(x), kernel, strides, divisor_override=1))


def _symmetric_fits(pads, kernel):
    return all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel))


def _pool_args(kernel, strides):
    kernel = _pair(kernel)
    return kernel, kernel if strides is None else _pair(strides)


def maxpool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    """Max over windows; padded cells are −inf."""
    kernel, strides = _pool_args(kernel, strides)
    pads = resolve_pads(padding, x.shape[1:3], kernel, strides)
    if _symmetric_fits(pads, kernel):
        return _nhwc(F.max_pool2d(_nchw(x), kernel, strides,
                                  (pads[0][0], pads[1][0])))
    x = _pad_nhwc(x, pads, value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), kernel, strides))


def avgpool2d(x, kernel=(2, 2), strides=None, padding="VALID"):
    """Mean over each window's real cells: padding is not counted. A padded
    pooling is each window's sum over the zero-padded input over its count
    of real cells: ``F.avg_pool2d(count_include_pad=False)`` with padding
    computes the right forward on the card, but its backward over a
    channels-last input is not the forward's gradient there (NASNet's
    3x3/1 pools read 104 % off the CPU's)."""
    kernel, strides = _pool_args(kernel, strides)
    pads = resolve_pads(padding, x.shape[1:3], kernel, strides)
    if all(lo == hi == 0 for lo, hi in pads):
        return _nhwc(F.avg_pool2d(_nchw(x), kernel, strides))
    sums = _window_sum(_pad_nhwc(x, pads), kernel, strides)
    ones = _pad_nhwc(torch.ones_like(x[..., :1]), pads)
    return sums / _window_sum(ones, kernel, strides)


def pnormpool2d(x, kernel=(2, 2), strides=None, padding="VALID", pnorm=2):
    """(sum over the window of |x|^p)^(1/p); padding adds 0."""
    kernel, strides = _pool_args(kernel, strides)
    pads = resolve_pads(padding, x.shape[1:3], kernel, strides)
    s = _window_sum(_pad_nhwc(torch.abs(x) ** pnorm, pads), kernel, strides)
    return s ** (1.0 / pnorm)


def batchnorm(x, mean, variance, gamma=None, beta=None, epsilon=1e-5):
    """Normalize the last axis by ``mean`` and ``variance``: the
    per-channel algebra folds into one scale and one shift in >= f32, then
    one elementwise pass over the activation, cast back to its dtype."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    scale = torch.rsqrt(variance.to(acc) + epsilon)
    if gamma is not None:
        scale = scale * gamma.to(acc)
    shift = mean.to(acc) * scale
    if beta is not None:
        shift = shift - beta.to(acc)
    return (x.to(acc) * scale - shift).to(x.dtype)


def lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    """Local response normalization over the channel (last) axis."""
    d = int(depth_radius)
    c = x.shape[-1]
    sq = F.pad(torch.square(x), (d, d))
    window = sum(sq[..., i:i + c] for i in range(2 * d + 1))
    return x / torch.pow(bias + alpha * window, beta)


def dropout_inverted(x, gen, p=0.5):
    """DL4J dropout: ``p`` is the RETAIN probability; kept entries are
    ``x / p``. ``gen`` is a ``torch.Generator`` on ``x``'s device."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) < p
    return torch.where(keep, x / p, torch.zeros_like(x))


# ------------------------------------------------- 1-D, 3-D and grouped
def _pads_nd(padding, spatial, kernel, strides, dilation):
    """[(lo, hi)] of each spatial dim for an N-d op (lax's rules)."""
    nd = len(spatial)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * nd
        if padding.upper() != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        return [same_pads(s, k, st, d) for s, k, st, d in
                zip(spatial, kernel, strides, dilation)]
    if isinstance(padding, int):
        padding = (padding,) * nd
    if all(isinstance(p, (tuple, list)) for p in padding):
        return [(int(lo), int(hi)) for lo, hi in padding]
    return [(int(p), int(p)) for p in padding]


def _channels_first(x):
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _channels_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


def _pad_spatial(x, pads, value=0.0):
    """Pad the spatial dims of a channels-last ``x`` by (lo, hi) pairs."""
    flat = [0, 0]
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def conv1d(x, w, b=None, stride=1, padding="SAME", dilation=1):
    """(N, T, C) ``x`` * (k, C, O) ``w``: the 2-D convolution over a
    (N, T, 1, C) view with a (k, 1, C, O) kernel."""
    if not isinstance(padding, str):
        pads = _pads_nd(padding, (x.shape[1],), (w.shape[0],), (stride,),
                        (dilation,))
        padding = [pads[0], (0, 0)]
    out = conv2d(x[:, :, None, :], w[:, None], None, (int(stride), 1),
                 padding, (int(dilation), 1))[:, :, 0, :]
    return out + b if b is not None else out


def conv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME",
           dilation=(1, 1, 1)):
    """NDHWC ``x`` * DHWIO ``w``: cuDNN's ``F.conv3d`` on the NCDHW view;
    lax's asymmetric "SAME" padding applied to the input first."""
    strides, dilation = tuple(strides), tuple(dilation)
    pads = _pads_nd(padding, x.shape[1:4], w.shape[:3], strides, dilation)
    if any(lo != hi for lo, hi in pads):
        x = _pad_spatial(x, pads)
        pads = [(0, 0)] * 3
    out = _channels_last(F.conv3d(_channels_first(x),
                                  w.permute(4, 3, 0, 1, 2), None, strides,
                                  tuple(lo for lo, _ in pads), dilation))
    return out + b if b is not None else out


def depthwise_conv2d(x, w, b=None, strides=(1, 1), padding="SAME",
                     dilation=(1, 1)):
    """Depthwise convolution: ``w`` (kh, kw, C, m) convolves input channel
    c with its m filters into output channels c·m … c·m + m − 1, the
    reference's ``feature_group_count`` reshape of ``w`` to (kh, kw, 1,
    C·m). cuDNN's grouped ``F.conv2d`` (groups C) orders its output
    channels the same way: channel o in group o // m."""
    strides, dilation = _pair(strides), _pair(dilation)
    kh, kw, c, m = w.shape
    pads = resolve_pads(padding, x.shape[1:3], (kh, kw), strides, dilation)
    if any(lo != hi for lo, hi in pads):
        x = _pad_nhwc(x, pads)
        pads = [(0, 0), (0, 0)]
    weight = w.reshape(kh, kw, c * m).permute(2, 0, 1)[:, None]
    out = _nhwc(F.conv2d(_nchw(x), weight, None, strides,
                         (pads[0][0], pads[1][0]), dilation, groups=c))
    return out + b if b is not None else out


def conv_transpose(x, w, strides, pads, dilation):
    """``lax.conv_transpose(x, w.swap(I, O), strides, pads, rhs_dilation,
    transpose_kernel=True)`` over channels-last ``x`` (1-3 spatial dims)
    and a (*k, I, O) kernel ``w``: the convolution of the stride-dilated
    input with the flipped kernel under explicit (lo, hi) ``pads``. cuDNN's
    ``F.conv_transposeNd`` pads symmetrically, so it runs unpadded (the
    dilated input padded by k_eff − 1 each side) and its output is cropped,
    or padded with zeros where a pad exceeds k_eff − 1."""
    nd = x.dim() - 2
    fn = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[nd - 1]
    weight = w.permute(nd, nd + 1, *range(nd))        # (I, O, *k)
    full = _channels_last(fn(_channels_first(x), weight, None,
                             tuple(strides), 0, 0, 1, tuple(dilation)))
    crops = []
    for k, d, (lo, hi) in zip(w.shape[:nd], dilation, pads):
        keff = (k - 1) * d + 1
        crops.append((keff - 1 - lo, keff - 1 - hi))
    if any(c < 0 for pair in crops for c in pair):
        full = _pad_spatial(full, [(max(-a, 0), max(-b, 0))
                                   for a, b in crops])
        crops = [(max(a, 0), max(b, 0)) for a, b in crops]
    idx = [slice(None)] + [slice(a, full.shape[i + 1] - b)
                           for i, (a, b) in enumerate(crops)] + [slice(None)]
    return full[tuple(idx)]


def conv_transpose_same_valid(kernel, strides, padding):
    """The (lo, hi) pads ``lax.conv_transpose`` derives for "SAME" or
    "VALID" (its ``_conv_transpose_padding``), per spatial dim."""
    pads = []
    for k, s in zip(kernel, strides):
        if padding.upper() == "SAME":
            total = k + s - 2
            lo = k - 1 if s > k - 1 else -(-total // 2)
        elif padding.upper() == "VALID":
            total = k + s - 2 + max(k - s, 0)
            lo = k - 1
        else:
            raise ValueError(f"unknown padding {padding!r}")
        pads.append((lo, total - lo))
    return pads


def _pool3d_args(kernel, strides):
    kernel = (kernel,) * 3 if isinstance(kernel, int) else tuple(kernel)
    if strides is None:
        return kernel, kernel
    return kernel, ((strides,) * 3 if isinstance(strides, int)
                    else tuple(strides))


def maxpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    """Max over NDHWC windows; padded cells are −inf."""
    kernel, strides = _pool3d_args(kernel, strides)
    pads = _pads_nd(padding, x.shape[1:4], kernel, strides, (1, 1, 1))
    x = _pad_spatial(x, pads, value=float("-inf"))
    return _channels_last(F.max_pool3d(_channels_first(x), kernel, strides))


def avgpool3d(x, kernel=(2, 2, 2), strides=None, padding="VALID"):
    """Mean over each NDHWC window's real cells: padding not counted."""
    kernel, strides = _pool3d_args(kernel, strides)
    pads = _pads_nd(padding, x.shape[1:4], kernel, strides, (1, 1, 1))

    def window_sum(a):
        return _channels_last(F.avg_pool3d(
            _channels_first(_pad_spatial(a, pads)), kernel, strides,
            divisor_override=1))

    return window_sum(x) / window_sum(torch.ones_like(x[..., :1]))


def upsampling2d(x, size=2):
    """Nearest upsampling of NHWC ``x``: each row and column repeated."""
    sh, sw = _pair(size)
    return torch.repeat_interleave(torch.repeat_interleave(x, sh, dim=1),
                                   sw, dim=2)


def resize_bilinear(x, size):
    """``jax.image.resize(method="bilinear", antialias=False)`` of NHWC
    ``x`` to ``size`` (H, W): half-pixel centres, no filtering when it
    shrinks, which is ``F.interpolate``'s bilinear mode with
    ``align_corners=False`` and no antialias."""
    return _nhwc(F.interpolate(_nchw(x), size=(int(size[0]), int(size[1])),
                               mode="bilinear", align_corners=False,
                               antialias=False))


# ---------------------------------------------------------------- attention
_MASK_SENTINEL = -1e30


def key_mask_of(mask: Optional[torch.Tensor], q: torch.Tensor,
                k: torch.Tensor) -> Optional[torch.Tensor]:
    """The (N, Tk) bool key mask that ``mask`` amounts to when it is one:
    shaped (N or 1, 1, 1, Tk), broadcast over heads and queries (the
    attention layers' ``mask[:, None, None, :]``); else None."""
    if mask is None or mask.dim() != 4:
        return None
    n, t_k = q.shape[0], k.shape[-2]
    if mask.shape[1:] != (1, 1, t_k) or mask.shape[0] not in (1, n):
        return None
    return (mask[:, 0, 0, :] != 0).expand(n, t_k)


def attention_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> str:
    """Where :func:`dot_product_attention` runs, by one stated rule:
    "kernel" (``fa.FlashAttention``: K1/K2 on the card, their plain
    versions on the CPU) for 4-D (N, H, T, d) q and k, v of one shape
    (no broadcasting), all float32 or all bfloat16, a head dim d % 8 == 0
    in [8, 256] (``fa.HEAD_DIMS``), and no mask or a key mask
    (:func:`key_mask_of`); "plain" (the op's plain version) for every
    other call: f64 (the gradcheck harness), mixed dtypes, other head
    dims, masks over queries. It reads shapes and dtypes only."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]
            or q.dtype not in (torch.float32, torch.bfloat16)
            or not q.dtype == k.dtype == v.dtype
            or q.shape[-1] not in _fa.HEAD_DIMS
            or q.shape[-2] < 1 or k.shape[-2] < 1):
        return "plain"
    if mask is not None and key_mask_of(mask, q, k) is None:
        return "plain"
    return "kernel"


def dot_product_attention_plain(q, k, v, mask=None, scaled=True):
    """The reference op's arithmetic: scores accumulated in at least f32
    (f64 inputs stay f64), divided by sqrt(d) when ``scaled``, masked keys
    set to the finite sentinel -1e30 (a row that keeps no key averages
    v), softmax, the weights cast to q's dtype, then their product with
    v."""
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    if scaled:
        scores = scores / torch.sqrt(torch.tensor(float(q.shape[-1]),
                                                  dtype=acc))
    if mask is not None:
        scores = torch.where(mask != 0, scores,
                             torch.tensor(_MASK_SENTINEL, dtype=acc))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return promote_mm(w, v)


def dot_product_attention(q, k, v, mask=None, scaled=True):
    """(..., heads, seq, d) attention, the reference op
    ``dot_product_attention``: softmax(q·kᵀ / sqrt(d)) · v over f32 (f64)
    scores, keys masked by ``mask`` with the -1e30 sentinel.

    By :func:`attention_route`: on "kernel", ``fa.FlashAttention`` with
    the key mask. A batch element whose keys are all masked must average
    v evenly and send no gradient to q or k, as the reference's softmax of
    a constant row does; the kernels do not define such a row. So, with no
    host sync, the element is handed to them with every key kept and q
    zeroed
    (the product inside autograd): its scores are then 0, P exactly 1/Tk,
    and dq = dk = 0. On "plain", :func:`dot_product_attention_plain`; on
    the card that adds one to the ``attention_plain`` count
    (``kernels/__init__.py``)."""
    if attention_route(q, k, v, mask) == "plain":
        if q.is_cuda:
            _fa.plain_route_calls += 1
        return dot_product_attention_plain(q, k, v, mask, scaled)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scaled else 1.0
    kmask = key_mask_of(mask, q, k)
    extra = ()
    if kmask is not None:
        kept = kmask.any(dim=-1)
        extra = (kmask | ~kept[:, None],)
        q = q * kept[:, None, None, None].to(q.dtype)
    if q.is_cuda:
        # views the kernels cannot read (a query bank broadcast over the
        # batch has stride 0) go in as contiguous copies
        q, k, v = (_fa._readable(t) for t in (q, k, v))
    return _fa.FlashAttention.apply(q.shape[1], False, scale, q, k, v,
                                    *extra)
