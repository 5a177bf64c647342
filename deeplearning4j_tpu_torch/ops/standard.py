"""The standard ops: counterparts of the JAX package's ``ops/standard.py``.

Two halves. The plain functions the ported layers call (``conv1d``,
``conv2d``, ``conv3d``, ``depthwise_conv2d``, ``maxpool2d``,
``avgpool2d``, ``pnormpool2d``, ``maxpool3d``, ``avgpool3d``,
``upsampling2d``, ``resize_bilinear``, ``batchnorm``, ``lrn``,
``dropout_inverted``, ``dot_product_attention``; ``conv_transpose``, the
transposed convolution the deconvolution layers take from
``lax.conv_transpose``; ``promote_mm``, the dtype rule of ``jnp.matmul``
that the layers' products follow). And, at the end of the module, the
op registry's entries (``ops/registry.py``): every op the reference
registers in its ``ops/standard.py``, under the same names, aliases and
signatures; the three of its other op modules that the TF import of a
BERT graph and the graph passes reach (``reduce_all``, ``reduce_any``,
``stop_gradient``); and the four that its later op modules rebind
standard names to (``realdiv``, ``truncatediv``, ``reverse``,
``batched_gemm``), so a name means one op in both packages.

``dot_product_attention`` runs on the hand flash kernels K1/K2
(``kernels/flash_attention.py``) wherever :func:`attention_route` says
they take it, with the layers' key mask; elsewhere on its plain version.
The registry's ``dot_product_attention`` is this function, so a SameDiff
graph's attention takes the kernels by the same rule.

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

import numpy as np
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


# ======================================================= the op registry
# Every op of the reference's ``ops/standard.py``, registered under its
# name and aliases with the reference's signature: tensors positional,
# attributes as keywords. The graph engine and the TF importer run ops by
# these names. Integer results come back int32 (``registry.OpDef``).
from deeplearning4j_tpu_torch.ops import dtypes as _dt  # noqa: E402
from deeplearning4j_tpu_torch.ops.moments import (  # noqa: E402
    one_pass_moments as _one_pass_moments)
from deeplearning4j_tpu_torch.ops.registry import register  # noqa: E402
from deeplearning4j_tpu_torch.ops import registry as _registry  # noqa: E402


def _axes(axis, ndim):
    """A reduction's dims: None is every dim, an int one dim."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _floatish(x):
    return x if (x.is_floating_point() or x.is_complex()) else x.float()


# --------------------------------------------------------------- arithmetic
register("add", lambda a, b: a + b, aliases=["Add"])
register("sub", lambda a, b: a - b, aliases=["Sub", "subtract"])
register("mul", lambda a, b: a * b, aliases=["Mul", "multiply"])
register("div", lambda a, b: torch.true_divide(a, b),
         aliases=["Div", "RealDiv", "truediv"])
register("floordiv", lambda a, b: torch.floor_divide(a, b),
         aliases=["FloorDiv"])
register("mod", lambda a, b: torch.remainder(a, b), aliases=["FloorMod", "Mod"])
register("pow", lambda a, b: torch.pow(a, b), aliases=["Pow"])
register("squaredsubtract", lambda a, b: torch.square(a - b),
         aliases=["SquaredDifference"])
register("maximum", torch.maximum, aliases=["Maximum"])
register("minimum", torch.minimum, aliases=["Minimum"])
register("neg", torch.neg, aliases=["Neg"])
register("reciprocal", torch.reciprocal, aliases=["Reciprocal"])


@register("truncate_div", aliases=["TruncateDiv"])
def _truncate_div(a, b):
    """``lax.div``: C division, truncating toward zero on integers."""
    if a.is_floating_point() or b.is_floating_point():
        return a / b
    return torch.div(a, b, rounding_mode="trunc")


# --------------------------------------------------------------- elementwise
for _n, _f, _al in [
    ("abs", torch.abs, ["Abs"]), ("exp", torch.exp, ["Exp"]),
    ("log", torch.log, ["Log"]), ("log1p", torch.log1p, ["Log1p"]),
    ("sqrt", torch.sqrt, ["Sqrt"]), ("rsqrt", torch.rsqrt, ["Rsqrt"]),
    ("square", torch.square, ["Square"]), ("sin", torch.sin, ["Sin"]),
    ("cos", torch.cos, ["Cos"]), ("tan", torch.tan, ["Tan"]),
    ("asin", torch.asin, ["Asin"]), ("acos", torch.acos, ["Acos"]),
    ("atan", torch.atan, ["Atan"]), ("sinh", torch.sinh, ["Sinh"]),
    ("cosh", torch.cosh, ["Cosh"]), ("tanh", torch.tanh, ["Tanh"]),
    ("asinh", torch.asinh, []), ("acosh", torch.acosh, []),
    ("atanh", torch.atanh, []),
    ("erf", torch.special.erf, ["Erf"]), ("erfc", torch.special.erfc, ["Erfc"]),
    ("floor", torch.floor, ["Floor"]), ("ceil", torch.ceil, ["Ceil"]),
    ("round", torch.round, ["Round"]), ("sign", torch.sign, ["Sign"]),
    ("isnan", torch.isnan, ["IsNan"]), ("isinf", torch.isinf, ["IsInf"]),
    ("isfinite", torch.isfinite, ["IsFinite"]),
]:
    register(_n, _f, aliases=_al)


@register("clipbyvalue", aliases=["ClipByValue", "clip_by_value"])
def _clipbyvalue(x, lo=None, hi=None, clip_value_min=None,
                 clip_value_max=None):
    return torch.clamp(x, lo if lo is not None else clip_value_min,
                       hi if hi is not None else clip_value_max)


@register("clipbynorm", aliases=["ClipByNorm"])
def _clipbynorm(x, clipnorm=1.0):
    n = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(n > clipnorm, x * (clipnorm / n), x)


# -------------------------------------------------------------- activations
register("sigmoid", torch.sigmoid, aliases=["Sigmoid"])
register("relu", torch.relu, aliases=["Relu"])
register("relu6", F.relu6, aliases=["Relu6"])
register("elu", F.elu, aliases=["Elu"])
register("selu", F.selu, aliases=["Selu"])
# jax.nn.gelu's default is the tanh approximation
register("gelu", lambda x: F.gelu(x, approximate="tanh"), aliases=["Gelu"])
register("softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)),
         aliases=["Softplus"])
register("softsign", lambda x: x / (1 + torch.abs(x)), aliases=["Softsign"])
register("swish", F.silu, aliases=["silu"])
register("mish", F.mish)
# reference/Keras/ONNX semantics clip(0.2x+0.5, 0, 1), not relu6(x+3)/6
register("hard_sigmoid", lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
         aliases=["HardSigmoid"])
register("hard_tanh", lambda x: torch.clamp(x, -1.0, 1.0),
         aliases=["HardTanh"])
register("leakyrelu", lambda x, alpha=0.01: F.leaky_relu(x, alpha),
         aliases=["LeakyRelu", "leaky_relu"])
register("prelu", lambda x, alpha: torch.where(x >= 0, x, alpha * x),
         aliases=["PRelu"])
register("cube", lambda x: x ** 3)
register("rationaltanh", lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0))
register("rectifiedtanh", lambda x: torch.clamp_min(torch.tanh(x), 0.0))
register("thresholdedrelu", lambda x, theta=1.0:
         torch.where(x > theta, x, torch.zeros_like(x)))
register("softmax", lambda x, axis=-1: torch.softmax(x, dim=axis),
         aliases=["Softmax"])
register("log_softmax", lambda x, axis=-1: torch.log_softmax(x, dim=axis),
         aliases=["LogSoftmax"])


# --------------------------------------------------------------- reductions
def _red(fn, floats=False):
    def op(x, axis=None, keepdims=False, keep_dims=None):
        kd = bool(keepdims if keep_dims is None else keep_dims)
        dims = _axes(axis, x.dim())
        if floats:
            x = _floatish(x)
        # no dim to reduce (a 0-d input, or axis=()): None, x unchanged
        return fn(x, dims or None, kd)
    return op


def _sum(x, dims, kd):
    if dims is None:
        return x.to(torch.int32) if x.dtype == torch.bool else x
    return torch.sum(x, dim=dims, keepdim=kd)


def _mean(x, dims, kd):
    return x if dims is None else torch.mean(x, dim=dims, keepdim=kd)


def _amax(x, dims, kd):
    return x if dims is None else torch.amax(x, dim=dims, keepdim=kd)


def _amin(x, dims, kd):
    return x if dims is None else torch.amin(x, dim=dims, keepdim=kd)


def _prod(x, dims, kd):
    if dims is None:
        return x
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=kd)
    return x


def _all(x, dims, kd):
    if dims is None:
        return x.bool()
    return torch.all(x.bool(), dim=dims, keepdim=kd)


def _any(x, dims, kd):
    if dims is None:
        return x.bool()
    return torch.any(x.bool(), dim=dims, keepdim=kd)


register("reduce_sum", _red(_sum), aliases=["Sum", "sum"])
register("reduce_mean", _red(_mean, floats=True), aliases=["Mean", "mean"])
register("reduce_max", _red(_amax), aliases=["Max"])
register("reduce_min", _red(_amin), aliases=["Min"])
register("reduce_prod", _red(_prod), aliases=["Prod"])
register("reduce_norm1", _red(
    lambda x, d, kd: _sum(torch.abs(x), d, kd)))
register("reduce_norm2", _red(
    lambda x, d, kd: torch.sqrt(_sum(x * x, d, kd)), floats=True))
register("reduce_normmax", _red(
    lambda x, d, kd: _amax(torch.abs(x), d, kd)))
# ops/extended.py's boolean reductions, which the TF rules for All/Any emit
register("reduce_all", _red(_all), aliases=["All"])
register("reduce_any", _red(_any), aliases=["Any"])


@register("reduce_variance")
def _reduce_variance(x, axis=None, keepdims=False, bias_corrected=False):
    return torch.var(_floatish(x), dim=_axes(axis, x.dim()),
                     correction=1 if bias_corrected else 0, keepdim=keepdims)


@register("reduce_stdev")
def _reduce_stdev(x, axis=None, keepdims=False, bias_corrected=False):
    return torch.std(_floatish(x), dim=_axes(axis, x.dim()),
                     correction=1 if bias_corrected else 0, keepdim=keepdims)


@register("reduce_logsumexp")
def _reduce_logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(_floatish(x), dim=_axes(axis, x.dim()),
                           keepdim=keepdims)


register("argmax", lambda x, axis=None: torch.argmax(x, dim=axis),
         aliases=["ArgMax"])
register("argmin", lambda x, axis=None: torch.argmin(x, dim=axis),
         aliases=["ArgMin"])


def _cum(fn, x, axis, exclusive, reverse, init):
    if reverse:
        x = torch.flip(x, (axis,))
    out = fn(x, dim=axis)
    if exclusive:
        head = torch.full_like(out.narrow(axis, 0, 1), init)
        out = torch.cat([head, out.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    return out


register("cumsum", lambda x, axis=0, exclusive=False, reverse=False:
         _cum(torch.cumsum, x, axis, exclusive, reverse, 0.0),
         aliases=["Cumsum"])
register("cumprod", lambda x, axis=0, exclusive=False, reverse=False:
         _cum(torch.cumprod, x, axis, exclusive, reverse, 1.0),
         aliases=["Cumprod"])


# -------------------------------------------------------------------- shape
register("reshape", lambda x, shape: torch.reshape(
    x, tuple(int(s) for s in shape)), aliases=["Reshape"])


@register("transpose", aliases=["Transpose", "permute"])
def _transpose(x, perm=None, axes=None):
    perm = perm if perm is not None else axes
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*[int(p) for p in perm])


@register("squeeze", aliases=["Squeeze"])
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    dims = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"cannot squeeze axis {d} of size "
                             f"{x.shape[d]}")
    return torch.squeeze(x, dim=dims) if dims else x


register("expand_dims", lambda x, axis=0: torch.unsqueeze(x, int(axis)),
         aliases=["ExpandDims"])
register("concat", lambda *xs, axis=0: torch.cat(xs, dim=axis),
         aliases=["Concat", "ConcatV2"])
register("stack", lambda *xs, axis=0: torch.stack(xs, dim=axis),
         aliases=["Stack", "Pack"])
register("unstack", lambda x, axis=0, num=None: tuple(torch.unbind(x, axis)),
         num_outputs=-1, aliases=["Unstack", "Unpack"])
register("tile", lambda x, reps: torch.tile(x, tuple(int(r) for r in reps)),
         aliases=["Tile"])


@register("flip", aliases=["ReverseV2", "reverse"])
def _flip(x, axis):
    dims = range(x.dim()) if axis is None else (
        axis if isinstance(axis, (list, tuple)) else (axis,))
    return torch.flip(x, [int(d) for d in dims])


@register("slice", aliases=["Slice"])
def _slice(x, begin, size):
    """``lax.dynamic_slice``: a start is clamped so the slice fits."""
    for i, (b, s) in enumerate(zip(begin, size)):
        n = x.shape[i]
        s = n - int(b) if int(s) == -1 else int(s)
        b = min(max(int(b), 0), n - s)
        x = x.narrow(i, b, s)
    return x


def _slice_axis(x, axis, sl):
    n = x.shape[axis]
    start, stop, step = sl.indices(n)
    count = len(range(start, stop, step))
    if step > 0:
        return x.narrow(axis, start, 0) if count == 0 else \
            x.narrow(axis, start, (count - 1) * step + 1)[
                (slice(None),) * axis + (slice(None, None, step),)]
    if count == 0:
        return x.narrow(axis, 0, 0)
    flipped = torch.flip(x, (axis,))
    return flipped.narrow(axis, n - 1 - start, (count - 1) * -step + 1)[
        (slice(None),) * axis + (slice(None, None, -step),)]


@register("strided_slice", aliases=["StridedSlice"])
def _strided_slice(x, begin, end, strides=None):
    """Python slicing per axis (None = full extent in the stride's
    direction); torch has no negative step, so a reversed axis is sliced
    out of its flip."""
    strides = strides if strides is not None else [1] * len(begin)
    as_int = lambda v: None if v is None else int(v)   # noqa: E731
    for axis, (b, e, s) in enumerate(zip(begin, end, strides)):
        x = _slice_axis(x, axis, slice(as_int(b), as_int(e), as_int(s)))
    return x


def _take(x, indices, axis=0):
    """``jnp.take``: negative indices count from the end."""
    axis = int(axis) % x.dim()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


register("gather", _take, aliases=["Gather", "GatherV2"])


@register("split", num_outputs=-1, aliases=["Split"])
def _split(x, num_split=2, axis=0):
    n = int(num_split)
    if x.shape[axis] % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {x.shape[axis]} by {n}")
    return tuple(torch.split(x, x.shape[axis] // n, dim=axis))


@register("split_v", num_outputs=-1, aliases=["SplitV"])
def _split_v(x, size_splits, axis=0):
    cuts = np.cumsum([int(s) for s in size_splits[:-1]]).tolist()
    return tuple(torch.tensor_split(x, cuts, dim=axis))


register("einsum", lambda *xs, equation: torch.einsum(equation, *xs),
         aliases=["Einsum"])
register("gather_nd", lambda x, indices:
         x[tuple(indices.long().unbind(-1))], aliases=["GatherNd"])


@register("scatter_update", aliases=["ScatterUpdate"])
def _scatter_update(ref, indices, updates):
    return torch.index_put(ref, (indices.long(),), updates.to(ref.dtype))


@register("scatter_add", aliases=["ScatterAdd"])
def _scatter_add(ref, indices, updates):
    return torch.index_put(ref, (indices.long(),), updates.to(ref.dtype),
                           accumulate=True)


def _mirror_index(n, lo, hi, symmetric, device):
    """Source index of each padded position along one axis (numpy's
    "reflect" leaves the edge out, "symmetric" repeats it)."""
    idx = np.arange(-lo, n + hi)
    period = 2 * n if symmetric else 2 * (n - 1)
    if period == 0:
        return torch.zeros(len(idx), dtype=torch.long, device=device)
    m = np.mod(idx, period)
    if symmetric:
        src = np.where(m < n, m, period - 1 - m)
    else:
        src = np.where(m < n, m, period - m)
    return torch.as_tensor(src, dtype=torch.long, device=device)


@register("pad", aliases=["Pad", "PadV2"])
def _pad(x, paddings, mode="CONSTANT", constant_values=0, value=None):
    pads = [tuple(int(v) for v in p) for p in paddings]
    mode = str(mode).upper()
    if mode == "CONSTANT":
        cv = constant_values if value is None else value
        flat = []
        for lo, hi in reversed(pads):
            flat += [lo, hi]
        return F.pad(x, flat, value=float(cv) if x.is_floating_point()
                     else int(cv))
    if mode not in ("REFLECT", "SYMMETRIC"):
        raise ValueError(f"unknown pad mode {mode!r}")
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            idx = _mirror_index(x.shape[axis], lo, hi, mode == "SYMMETRIC",
                                x.device)
            x = torch.index_select(x, axis, idx)
    return x


def _scalar(v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


register("shape_of", lambda x: torch.tensor(tuple(x.shape), dtype=torch.int32,
                                            device=x.device),
         aliases=["Shape"])
register("size", lambda x: _scalar(x.numel(), torch.int32, x.device),
         aliases=["Size"])
register("rank", lambda x: _scalar(x.dim(), torch.int32, x.device),
         aliases=["Rank"])
register("cast", lambda x, dtype: x.to(_dt.to_torch(dtype)), aliases=["Cast"])
register("identity", lambda x: x, aliases=["Identity"])
# lax.stop_gradient (ops/longtail.py): the graph pass reads through it
register("stop_gradient", lambda x: x.detach(),
         aliases=["StopGradient", "stopgradient"])


@register("fill", aliases=["Fill"])
def _fill(shape, value):
    dims = tuple(int(s) for s in shape)
    if isinstance(value, torch.Tensor):
        return value.reshape(()).expand(dims).contiguous()
    return torch.full(dims, value, device=shape.device
                      if isinstance(shape, torch.Tensor) else None)


register("zeros_like", torch.zeros_like, aliases=["ZerosLike"])
register("ones_like", torch.ones_like, aliases=["OnesLike"])


@register("linspace", aliases=["LinSpace"])
def _linspace(start, stop, num):
    dev = start.device if isinstance(start, torch.Tensor) else None
    return torch.linspace(float(start), float(stop), int(num), device=dev)


@register("range", aliases=["Range"])
def _range(start, limit, delta):
    vals = [v.item() if isinstance(v, torch.Tensor) else v
            for v in (start, limit, delta)]
    dev = start.device if isinstance(start, torch.Tensor) else None
    if all(isinstance(v, (int, bool)) for v in vals):
        return torch.arange(*vals, dtype=torch.int32, device=dev)
    return torch.arange(*vals, dtype=torch.float32, device=dev)


@register("one_hot", aliases=["OneHot", "onehot"])
def _one_hot(indices, depth, on_value=1.0, off_value=0.0, axis=-1,
             dtype=None):
    depth = int(depth)
    nd = indices.dim() + 1
    a = int(axis) % nd
    shape = [1] * nd
    shape[a] = depth
    cls = torch.arange(depth, device=indices.device).reshape(shape)
    hot = (indices.unsqueeze(a) == cls).to(torch.float32)
    out = hot * (on_value - off_value) + off_value
    return out.to(_dt.to_torch(dtype)) if dtype is not None else out


@register("where", aliases=["Where", "Select", "SelectV2"])
def _where(cond, x=None, y=None):
    if x is not None:
        return torch.where(cond.bool(), x, y)
    return torch.nonzero(cond)


register("broadcast_to", lambda x, shape: torch.broadcast_to(
    x, tuple(int(s) for s in shape)), aliases=["BroadcastTo"])


@register("space_to_depth", aliases=["SpaceToDepth"])
def _space_to_depth(x, block_size=2):
    b = int(block_size)
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, c * b * b)


@register("depth_to_space", aliases=["DepthToSpace"])
def _depth_to_space(x, block_size=2):
    b = int(block_size)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, b, b, c // (b * b))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * b, w * b, c // (b * b))


# -------------------------------------------------------------- comparisons
register("equals", torch.eq, aliases=["Equal", "eq"])
register("not_equals", torch.ne, aliases=["NotEqual", "neq"])
register("greater", torch.gt, aliases=["Greater", "gt"])
register("greater_equal", torch.ge, aliases=["GreaterEqual", "gte"])
register("less", torch.lt, aliases=["Less", "lt"])
register("less_equal", torch.le, aliases=["LessEqual", "lte"])
register("boolean_and", torch.logical_and, aliases=["LogicalAnd"])
register("boolean_or", torch.logical_or, aliases=["LogicalOr"])
register("boolean_not", torch.logical_not, aliases=["LogicalNot"])
register("boolean_xor", torch.logical_xor, aliases=["LogicalXor"])


# ------------------------------------------------------------------- linalg
@register("matmul", aliases=["MatMul", "mmul", "BatchMatMul", "BatchMatMulV2"])
def _matmul(a, b, transpose_a=False, transpose_b=False, transA=None,
            transB=None):
    ta = transpose_a if transA is None else bool(transA)
    tb = transpose_b if transB is None else bool(transB)
    if ta:
        a = a.transpose(-1, -2)
    if tb:
        b = b.transpose(-1, -2)
    if a.dtype in (torch.bfloat16, torch.float16):
        # preferred_element_type f32: the half inputs widen exactly
        return promote_mm(a.float(), b.float())
    return promote_mm(a, b)


@register("tensordot", aliases=["tensormmul"])
def _tensordot(a, b, axes):
    if isinstance(axes, (list, tuple)):
        axes = [list(np.atleast_1d(ax).tolist()) for ax in axes]
    return torch.tensordot(a, b, dims=axes)


register("diag", torch.diag, aliases=["Diag"])
register("diag_part", lambda x: torch.diagonal(x, 0, 0, 1),
         aliases=["DiagPart"])
register("matrix_inverse", torch.linalg.inv, aliases=["MatrixInverse"])
register("matrix_determinant", torch.linalg.det,
         aliases=["MatrixDeterminant"])
register("cholesky", torch.linalg.cholesky, aliases=["Cholesky"])
register("qr", lambda x, mode="reduced": tuple(torch.linalg.qr(x, mode=mode)),
         num_outputs=2, aliases=["Qr"])
register("svd", lambda x, full_matrices=False: tuple(
    torch.linalg.svd(x, full_matrices=full_matrices)),
    num_outputs=3, aliases=["Svd"])
register("trace", lambda x: torch.diagonal(x, 0, 0, 1).sum(-1),
         aliases=["Trace"])
register("lstsq", lambda a, b: torch.linalg.lstsq(a, b).solution)


@register("triangular_solve")
def _triangular_solve(a, b, lower=True):
    vec = b.dim() == a.dim() - 1
    out = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b,
                                        upper=not lower)
    return out.squeeze(-1) if vec else out


register("solve", torch.linalg.solve, aliases=["MatrixSolve"])


@register("matrix_band_part", aliases=["MatrixBandPart"])
def _band_part(x, lower, upper):
    lower, upper = int(lower), int(upper)
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = ((i - j) <= (lower if lower >= 0 else m)) & \
        ((j - i) <= (upper if upper >= 0 else n))
    return torch.where(keep, x, torch.zeros_like(x))


# ------------------------------------------------------------- convolutions
def _explicit_pads(padding, spatial, kernel, strides, dilation):
    """The reference's ``_pad_attr`` and lax's "SAME"/"VALID" rules, as
    (lo, hi) per spatial dim."""
    return _pads_nd(padding, spatial, kernel, strides, dilation)


register("conv1d", conv1d, aliases=["Conv1D"])


@register("conv2d", aliases=["Conv2D"])
def _conv2d_op(x, w, b=None, strides=(1, 1), padding="SAME",
               dilation=(1, 1), groups=1):
    if int(groups) == 1:
        return conv2d(x, w, b, strides, padding, dilation)
    strides, dilation = _pair(strides), _pair(dilation)
    pads = resolve_pads(padding, x.shape[1:3], w.shape[:2], strides,
                        dilation)
    x = _pad_nhwc(x, pads)
    out = _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), None, strides, 0,
                         dilation, groups=int(groups)))
    return out + b if b is not None else out


@register("conv2d_nchw")
def _conv2d_nchw(x, w, b=None, strides=(1, 1), padding=((0, 0), (0, 0)),
                 dilation=(1, 1), groups=1):
    strides, dilation = _pair(strides), _pair(dilation)
    pads = _explicit_pads(padding, x.shape[2:4], w.shape[2:4], strides,
                          dilation)
    x = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    out = F.conv2d(x, w, None, strides, 0, dilation, groups=int(groups))
    return out + b.reshape(1, -1, 1, 1) if b is not None else out


def _pool_nchw_pad(x, padding, value):
    (t, bo), (l, r) = [tuple(int(v) for v in p) for p in padding]
    return F.pad(x, (l, r, t, bo), value=value)


@register("maxpool2d_nchw")
def _maxpool2d_nchw(x, kernel=(2, 2), strides=(2, 2),
                    padding=((0, 0), (0, 0))):
    x = _pool_nchw_pad(x, padding, float("-inf"))
    return F.max_pool2d(x, tuple(kernel), tuple(strides))


@register("avgpool2d_nchw")
def _avgpool2d_nchw(x, kernel=(2, 2), strides=(2, 2),
                    padding=((0, 0), (0, 0)), count_include_pad=False):
    s = F.avg_pool2d(_pool_nchw_pad(x, padding, 0.0), tuple(kernel),
                     tuple(strides), divisor_override=1)
    if count_include_pad:
        return s / float(np.prod(kernel))
    ones = _pool_nchw_pad(torch.ones_like(x[:, :1]), padding, 0.0)
    return s / F.avg_pool2d(ones, tuple(kernel), tuple(strides),
                            divisor_override=1)


register("global_avgpool_nchw", lambda x: torch.mean(
    x, dim=tuple(range(2, x.dim())), keepdim=True))


@register("batchnorm_nchw")
def _batchnorm_nchw(x, scale, offset, mean, var, epsilon=1e-5):
    shp = (1, -1) + (1,) * (x.dim() - 2)
    acc = torch.promote_types(x.dtype, torch.float32)
    s = torch.rsqrt(var.to(acc) + epsilon) * scale.to(acc)
    sh = mean.to(acc) * s - offset.to(acc)
    return (x.to(acc) * s.reshape(shp) - sh.reshape(shp)).to(x.dtype)


register("conv3d", conv3d, aliases=["Conv3D"])
register("depthwise_conv2d", depthwise_conv2d,
         aliases=["DepthwiseConv2dNative", "sconv2d_depthwise"])


@register("deconv2d", aliases=["Conv2DTranspose", "Conv2DBackpropInput"])
def _deconv2d(x, w, b=None, strides=(1, 1), padding="SAME",
              transpose_kernel=False):
    """``lax.conv_transpose`` over NHWC/HWIO. ``transpose_kernel=True`` is
    a conv GRADIENT (TF Conv2DBackpropInput, filter (H, W, out, in));
    False the correlation form of the Keras/ONNX layers."""
    strides = _pair(strides)
    kernel = tuple(w.shape[:2])
    if isinstance(padding, str):
        pads = conv_transpose_same_valid(kernel, strides, padding)
    else:
        pads = [(p, p) for p in _pair(padding)]
    kern = w.transpose(2, 3) if transpose_kernel else torch.flip(w, (0, 1))
    out = conv_transpose(x, kern, strides, pads, (1, 1))
    return out + b if b is not None else out


register("maxpool2d", maxpool2d, aliases=["MaxPool", "max_pool_2d",
                                          "MaxPoolV2"])
register("avgpool2d", avgpool2d, aliases=["AvgPool", "avg_pool_2d"])
register("pnormpool2d", pnormpool2d)
register("maxpool3d", maxpool3d, aliases=["MaxPool3D"])
register("avgpool3d", avgpool3d, aliases=["AvgPool3D"])
register("global_avgpool2d", lambda x: torch.mean(x, dim=(1, 2)))
register("upsampling2d", upsampling2d, aliases=["ResizeNearestNeighbor"])
register("resize_bilinear", resize_bilinear, aliases=["ResizeBilinear"])


@register("im2col")
def _im2col(x, kernel, strides=(1, 1), padding="VALID"):
    """NHWC → (N, OH, OW, C·KH·KW), channel-major features (the
    ``conv_general_dilated_patches`` layout)."""
    kh, kw = (int(k) for k in kernel)
    strides = _pair(strides)
    if isinstance(padding, str):
        pads = resolve_pads(padding, x.shape[1:3], (kh, kw), strides)
    else:
        pads = [(int(p), int(p)) for p in padding]
    x = _pad_nhwc(x, pads)
    n, h, w, c = x.shape
    cols = F.unfold(_nchw(x), (kh, kw), stride=strides)
    oh = (h - kh) // strides[0] + 1
    ow = (w - kw) // strides[1] + 1
    return cols.reshape(n, c * kh * kw, oh, ow).permute(0, 2, 3, 1)


# ------------------------------------------------------------ normalization
@register("batchnorm", aliases=["FusedBatchNorm", "FusedBatchNormV2",
                                "FusedBatchNormV3"])
def _batchnorm_op(x, mean, variance, gamma=None, beta=None, epsilon=1e-5,
                  axis=-1):
    shp = [1] * x.dim()
    shp[axis] = x.shape[axis]
    acc = torch.promote_types(x.dtype, torch.float32)
    scale = torch.rsqrt(variance.to(acc) + epsilon)
    if gamma is not None:
        scale = scale * gamma.to(acc)
    shift = mean.to(acc) * scale
    if beta is not None:
        shift = shift - beta.to(acc)
    return (x.to(acc) * scale.reshape(shp) - shift.reshape(shp)).to(x.dtype)


@register("layer_norm", aliases=["LayerNorm"])
def _layer_norm(x, gamma=None, beta=None, axis=-1, epsilon=1e-5):
    mean, var = _one_pass_moments(x, _axes(axis, x.dim()), keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if gamma is not None:
        out = out * gamma
    if beta is not None:
        out = out + beta
    return out.to(x.dtype)


register("lrn", lrn, aliases=["LRN"])


@register("standardize")
def _standardize(x, axis=-1, epsilon=1e-5):
    mean = torch.mean(x, dim=axis, keepdim=True)
    std = torch.std(x, dim=axis, correction=0, keepdim=True)
    return (x - mean) / (std + epsilon)


@register("l2_normalize", aliases=["L2Normalize"])
def _l2_normalize(x, axis=-1, epsilon=1e-12):
    return x * torch.rsqrt(torch.clamp_min(
        torch.sum(torch.square(x), dim=axis, keepdim=True), epsilon))


# ------------------------------------------------------------------- losses
@register("softmax_cross_entropy", aliases=["SoftmaxCrossEntropyWithLogits"])
def _softmax_cross_entropy(logits, labels, axis=-1):
    return -torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis)


@register("sparse_softmax_cross_entropy",
          aliases=["SparseSoftmaxCrossEntropyWithLogits"])
def _sparse_softmax_cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long().unsqueeze(-1))[..., 0]


@register("sigmoid_cross_entropy")
def _sigmoid_cross_entropy(logits, labels):
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


# ---------------------------------------------------------------- recurrent
@register("lstm_cell", aliases=["LSTMBlockCell"])
def _lstm_cell(x, h_prev, c_prev, w, b, forget_bias=1.0):
    """One LSTM step; w (input + hidden, 4·hidden), gates i, f, g, o."""
    z = promote_mm(torch.cat([x, h_prev], dim=-1), w) + b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + forget_bias) * c_prev + torch.sigmoid(i) * \
        torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


@register("gru_cell", aliases=["GRUCell"])
def _gru_cell(x, h_prev, w_rz, w_h, b_rz, b_h):
    xh = torch.cat([x, h_prev], dim=-1)
    rz = torch.sigmoid(promote_mm(xh, w_rz) + b_rz)
    r, z = torch.chunk(rz, 2, dim=-1)
    h_tilde = torch.tanh(promote_mm(torch.cat([x, r * h_prev], dim=-1), w_h)
                         + b_h)
    return (1.0 - z) * h_tilde + z * h_prev


@register("sru_cell")
def _sru_cell(x, c_prev, w, b):
    z = promote_mm(x, w)
    xt, f, r = torch.chunk(z, 3, dim=-1)
    bf, br = torch.chunk(b, 2, dim=-1)
    f = torch.sigmoid(f + bf)
    r = torch.sigmoid(r + br)
    c = f * c_prev + (1 - f) * xt
    h = r * torch.tanh(c) + (1 - r) * x[..., :c.shape[-1]]
    return h, c


# ---------------------------------------------------------------- attention
# the routed op: K1/K2 wherever ``attention_route`` says "kernel"
register("dot_product_attention", dot_product_attention,
         aliases=["MultiHeadDotProductAttention"])


# ------------------------------------------------------------------- random
# ``key`` is a ``torch.Generator`` on the output's device (the graph
# engine derives one per node from the execution seed).
@register("dropout")
def _dropout(x, key, rate=0.5):
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=key, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


@register("random_normal", aliases=["RandomStandardNormal"])
def _random_normal(key, shape, mean=0.0, stddev=1.0, dtype="float32"):
    return mean + stddev * torch.randn(
        tuple(int(s) for s in shape), generator=key, device=key.device,
        dtype=_dt.to_torch(dtype))


@register("random_uniform", aliases=["RandomUniform"])
def _random_uniform(key, shape, minval=0.0, maxval=1.0, dtype="float32"):
    u = torch.rand(tuple(int(s) for s in shape), generator=key,
                   device=key.device, dtype=_dt.to_torch(dtype))
    return u * (maxval - minval) + minval


@register("random_bernoulli")
def _random_bernoulli(key, shape, p=0.5):
    u = torch.rand(tuple(int(s) for s in shape), generator=key,
                   device=key.device)
    return (u < p).to(torch.float32)


register("dropout_inverted", dropout_inverted)


# -------------------------------------------------------------- image / misc
@register("non_max_suppression", aliases=["NonMaxSuppressionV3"])
def _non_max_suppression(boxes, scores, max_output_size=10,
                         iou_threshold=0.5, score_threshold=float("-inf")):
    """Greedy NMS over a fixed ``max_output_size`` (padded with -1), in
    the reference's order of steps."""
    n = boxes.shape[0]
    ys1, xs1, ys2, xs2 = boxes.unbind(-1)
    y1, y2 = torch.minimum(ys1, ys2), torch.maximum(ys1, ys2)
    x1, x2 = torch.minimum(xs1, xs2), torch.maximum(xs1, xs2)
    areas = (y2 - y1) * (x2 - x1)
    valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    minus_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                             device=scores.device)
    out = []
    for _ in range(int(max_output_size)):
        masked = torch.where(valid, scores, minus_inf)
        best = torch.argmax(masked)
        ok = valid[best] & (masked[best] >= score_threshold)
        out.append(torch.where(ok, best, torch.full_like(best, -1)))
        yy1 = torch.maximum(y1[best], y1)
        xx1 = torch.maximum(x1[best], x1)
        yy2 = torch.minimum(y2[best], y2)
        xx2 = torch.minimum(x2[best], x2)
        inter = torch.clamp_min(yy2 - yy1, 0.0) * torch.clamp_min(
            xx2 - xx1, 0.0)
        ious = inter / (areas[best] + areas - inter + 1e-9)
        valid = valid & (ious <= iou_threshold) & ok
    return torch.stack(out) if out else torch.zeros(
        0, dtype=torch.int32, device=boxes.device)


@register("confusion_matrix", aliases=["ConfusionMatrix"])
def _confusion_matrix(labels, predictions, num_classes):
    n = int(num_classes)
    idx = labels.long() * n + predictions.long()
    counts = torch.bincount(idx.reshape(-1), minlength=n * n)[:n * n]
    return counts.reshape(n, n)


@register("top_k", aliases=["TopKV2", "TopK"], num_outputs=2)
def _top_k(x, k=1, sorted=True):
    return tuple(torch.topk(x, int(k), dim=-1, largest=True, sorted=True))


@register("in_top_k", aliases=["InTopKV2"])
def _in_top_k(predictions, targets, k=1):
    idx = torch.topk(predictions, int(k), dim=-1).indices
    return torch.any(idx == targets.long()[:, None], dim=-1)


@register("segment_sum", aliases=["SegmentSum"])
def _segment_sum(data, segment_ids, num_segments=None):
    n = int(num_segments) if num_segments is not None else \
        int(segment_ids.max()) + 1
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, segment_ids.long(), data)


@register("sequence_mask", aliases=["SequenceMask"])
def _sequence_mask(lengths, maxlen=None):
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    return torch.arange(m, device=lengths.device)[None, :] < lengths[:, None]


@register("reverse_sequence", aliases=["ReverseSequence"])
def _reverse_sequence(x, seq_lengths, seq_axis=1, batch_axis=0):
    x = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    lens = seq_lengths.long()[:, None]
    gather_idx = torch.where(idx < lens, lens - 1 - idx, idx)
    gather_idx = gather_idx.reshape(gather_idx.shape + (1,) * (x.dim() - 2))
    out = torch.take_along_dim(x, gather_idx.expand(
        gather_idx.shape[:2] + x.shape[2:]), dim=1)
    return torch.movedim(out, (0, 1), (batch_axis, seq_axis))


# ----------------------------------------------- threshold codec (Strom 2015)
@register("encode_threshold")
def _encode_threshold(grad, threshold=1e-3):
    """Sparse 1-bit gradient encoding: (flat sign int8, residual)."""
    flat = grad.reshape(-1)
    over = torch.abs(flat) >= threshold
    sign = torch.sign(flat)
    signs = torch.where(over, sign, torch.zeros_like(sign)).to(torch.int8)
    residual = torch.where(over, flat - sign * threshold, flat)
    return signs, residual


@register("decode_threshold")
def _decode_threshold(signs, threshold=1e-3, shape=None):
    out = signs.to(torch.float32) * threshold
    return out.reshape(tuple(shape)) if shape is not None else out


# ------------------------------------------- names the reference rebinds
# The reference's later op modules (ops/extended.py, tranche4, tranche5)
# rebind some of the names above. Where the op they rebind to is plain
# arithmetic it is registered here as there, so a name means one op in
# both packages; the three names whose later ops are not ported yet are
# unbound rather than left meaning another op.
register("realdiv", lambda x, y: torch.true_divide(x, y), aliases=["RealDiv"])
register("truncatediv", lambda x, y: torch.trunc(torch.true_divide(x, y))
         .to(x.dtype), aliases=["TruncateDiv"])


@register("reverse", aliases=["Reverse", "ReverseV2"])
def _reverse(x, axis):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, axis)


register("batched_gemm", promote_mm,
         aliases=["BatchedGemm", "batch_matmul", "BatchMatMul",
                  "BatchMatMulV2"])
_registry.unbind("LSTMBlockCell", "ResizeNearestNeighbor",
                 "SoftmaxCrossEntropyWithLogits")
