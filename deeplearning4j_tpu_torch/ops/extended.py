"""The registry's long tail: counterparts of the JAX package's
``ops/extended.py`` (libnd4j's declarable-op groups that ``standard.py``
does not cover: absolute-value reductions, segment and scatter families,
bitwise, image colour, resize and patch ops, special functions, random
distributions, loss ops, the sequence RNN runners, spectral ops, CTC).

Same conventions as ``standard.py``: tensors positional, attributes as
keywords, NHWC, integer results int32 (``registry.OpDef``). The random
ops take a ``torch.Generator`` where the reference takes a JAX key: draws
are deterministic per seed, not equal to the reference's. Ops the
reference runs eagerly on the host (``unique``, ``listdiff``,
``dynamic_partition``, ``dynamic_stitch``) give data-dependent shapes
here too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops.moments import one_pass_moments
from deeplearning4j_tpu_torch.ops.registry import exec_op, register
from deeplearning4j_tpu_torch.ops.standard import (
    _axes, _nchw, _nhwc, _pad_nhwc, promote_mm, same_pads)


def _floaty(x):
    return x if (x.is_floating_point() or x.is_complex()) else x.float()


def _tensor_like(v, ref):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, device=ref.device)


# ----------------------------------------------------- elementwise long tail
def _sigmoid_derivative(x):
    s = torch.sigmoid(x)
    return s * (1 - s)


for _n, _f, _al in [
    ("expm1", torch.expm1, ["Expm1"]),
    ("log2", lambda x: torch.log2(_floaty(x)), ["Log2"]),
    ("log10", lambda x: torch.log10(_floaty(x)), ["Log10"]),
    ("rint", torch.round, ["Rint"]),
    ("trunc", torch.trunc, ["Trunc"]),
    ("atan2", torch.atan2, ["Atan2", "tr_atan2"]),
    ("hypot", torch.hypot, []),
    ("lgamma", torch.special.gammaln, ["Lgamma"]),
    ("digamma", torch.special.digamma, ["Digamma"]),
    ("erfinv", torch.special.erfinv, ["Erfinv"]),
    ("sigmoid_derivative", _sigmoid_derivative, []),
    ("tanh_derivative", lambda x: 1 - torch.tanh(x) ** 2, []),
]:
    register(_n, _f, aliases=_al)

register("rsub", lambda a, b: b - a, aliases=["reversesubtract", "RSub"])
register("rdiv", lambda a, b: torch.true_divide(b, a),
         aliases=["reversedivide", "RDiv"])


@register("divide_no_nan", aliases=["DivNoNan"])
def _divide_no_nan(a, b):
    q = torch.true_divide(a, b)
    return torch.where(b == 0, torch.zeros_like(q), q)


register("igamma", torch.special.gammainc, aliases=["Igamma"])
register("igammac", torch.special.gammaincc, aliases=["Igammac"])


def _betacf(a, b, x, iters=300):
    """The continued fraction of the regularised incomplete beta (modified
    Lentz, as in Numerical Recipes' ``betacf``), in f64, all elements at
    once for a fixed number of terms."""
    tiny = 1e-300
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 - qab * x / qap
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1.0 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
        c = 1.0 + aa / c
        c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
        d = 1.0 / d
        h = h * d * c
    return h


@register("betainc", aliases=["Betainc"])
def _betainc(a, b, x):
    """Regularised incomplete beta I_x(a, b): the continued fraction on
    whichever side of the mean converges, in f64 on the tensors' device,
    cast back to the inputs' type."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    out_dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                 x.dtype)
    a64, b64, x64 = (t.to(torch.float64) for t in (a, b, x))
    xc = x64.clamp(0.0, 1.0)
    lbeta = (torch.lgamma(a64 + b64) - torch.lgamma(a64) - torch.lgamma(b64))
    inner = xc.clamp(1e-300, 1 - 1e-16)
    front = torch.exp(lbeta + a64 * torch.log(inner)
                      + b64 * torch.log1p(-inner))
    direct = (xc < (a64 + 1.0) / (a64 + b64 + 2.0))
    lo = front * _betacf(a64, b64, xc) / a64
    hi = 1.0 - front * _betacf(b64, a64, 1.0 - xc) / b64
    out = torch.where(direct, lo, hi)
    out = torch.where(xc <= 0, torch.zeros_like(out), out)
    out = torch.where(xc >= 1, torch.ones_like(out), out)
    bad = (a64 <= 0) | (b64 <= 0) | (x64 < 0) | (x64 > 1)
    out = torch.where(bad, torch.full_like(out, float("nan")), out)
    return out.to(out_dt)


@register("polygamma", aliases=["Polygamma"])
def _polygamma(n, x):
    """``polygamma(n, x)`` with an integer ``n`` tensor broadcast against
    ``x``: one ``torch.special.polygamma`` per distinct order."""
    n = _tensor_like(n, x).to(torch.int64)
    n, x = torch.broadcast_tensors(n, x)
    x = _floaty(x)
    out = torch.full_like(x, float("nan"))
    for order in torch.unique(n).tolist():
        if order < 0:
            continue
        out = torch.where(n == order,
                          torch.special.polygamma(int(order), x), out)
    return out


@register("isclose", aliases=["ApproxEquals"])
def _isclose(a, b, rtol=1e-5, atol=1e-8):
    return torch.isclose(a, b, rtol=rtol, atol=atol)


register("is_non_decreasing",
         lambda x: torch.all(x.reshape(-1)[1:] >= x.reshape(-1)[:-1]),
         aliases=["IsNonDecreasing"])
register("is_strictly_increasing",
         lambda x: torch.all(x.reshape(-1)[1:] > x.reshape(-1)[:-1]),
         aliases=["IsStrictlyIncreasing"])


# ------------------------------------------------- absolute-value reductions
def _reduce(fn, x, axis, keepdims):
    if x.dim() == 0:
        return fn(x, None, False)
    return fn(x, _axes(axis, x.dim()), keepdims)


def _amax(x, d, kd):
    return x if d is None else torch.amax(x, dim=d, keepdim=kd)


def _amin(x, d, kd):
    return x if d is None else torch.amin(x, dim=d, keepdim=kd)


def _sum(x, d, kd):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return x if d is None else torch.sum(x, dim=d, keepdim=kd)


def _mean(x, d, kd):
    x = _floaty(x)
    return x if d is None else torch.mean(x, dim=d, keepdim=kd)


register("reduce_amax", lambda x, axis=None, keepdims=False:
         _reduce(_amax, torch.abs(x), axis, keepdims), aliases=["amax"])
register("reduce_amin", lambda x, axis=None, keepdims=False:
         _reduce(_amin, torch.abs(x), axis, keepdims), aliases=["amin"])
register("reduce_amean", lambda x, axis=None, keepdims=False:
         _reduce(_mean, torch.abs(x), axis, keepdims), aliases=["amean"])
register("reduce_asum", lambda x, axis=None, keepdims=False:
         _reduce(_sum, torch.abs(x), axis, keepdims), aliases=["asum"])
register("count_nonzero", lambda x, axis=None, keepdims=False:
         _reduce(_sum, x != 0, axis, keepdims), aliases=["CountNonZero"])
register("count_zero", lambda x, axis=None, keepdims=False:
         _reduce(_sum, x == 0, axis, keepdims), aliases=["CountZero"])
register("zero_fraction", lambda x: torch.mean((x == 0).to(torch.float32)),
         aliases=["ZeroFraction"])
register("argamax", lambda x, axis=None: torch.argmax(torch.abs(x), dim=axis),
         aliases=["absargmax"])
register("argamin", lambda x, axis=None: torch.argmin(torch.abs(x), dim=axis),
         aliases=["absargmin"])


def _sum_axis(x, axis):
    return torch.sum(x) if axis is None else torch.sum(
        x, dim=_axes(axis, x.dim()))


@register("entropy", aliases=["Entropy"])
def _entropy(p, axis=None):
    """−Σ p·log p (ref: reduce ops entropy)."""
    q = torch.where(p > 0, p, torch.ones_like(p))
    return -_sum_axis(p * torch.log(q), axis)


@register("log_entropy", aliases=["LogEntropy"])
def _log_entropy(p, axis=None):
    return torch.log(_entropy(p, axis=axis))


@register("shannon_entropy", aliases=["ShannonEntropy", "shannonentropy"])
def _shannon_entropy(p, axis=None):
    q = torch.where(p > 0, p, torch.ones_like(p))
    return -_sum_axis(p * torch.log2(q), axis)


@register("moments", num_outputs=2, aliases=["Moments"])
def _moments(x, axes=None, keepdims=False):
    """Mean and variance in f32 (f64) accumulation; cast back to a float
    input's type, kept float for an integer input."""
    dims = _axes(axes, x.dim())
    mean, var = one_pass_moments(x, dims, keepdim=keepdims)
    if x.is_floating_point():
        return mean.to(x.dtype), var.to(x.dtype)
    return mean, var


@register("normalize_moments", num_outputs=2, aliases=["NormalizeMoments"])
def _normalize_moments(counts, mean_ss, var_ss, shift=0.0):
    mean = mean_ss / counts + shift
    var = var_ss / counts - torch.square(mean_ss / counts)
    return mean, var


@register("reduce_dot", aliases=["dot"])
def _reduce_dot(a, b, axis=None, keepdims=False):
    return _reduce(_sum, a * b, axis, keepdims)


def _norm(x, axis):
    return torch.sqrt(torch.sum(x * x, dim=axis))


@register("cosine_similarity", aliases=["CosineSimilarity"])
def _cosine_similarity(a, b, axis=-1):
    num = torch.sum(a * b, dim=axis)
    den = _norm(a, axis) * _norm(b, axis)
    return num / torch.clamp_min(den, 1e-12)


register("cosine_distance", lambda a, b, axis=-1:
         1.0 - _cosine_similarity(a, b, axis=axis),
         aliases=["CosineDistance"])
register("euclidean_distance", lambda a, b, axis=-1:
         torch.sqrt(torch.sum(torch.square(a - b), dim=axis)),
         aliases=["EuclideanDistance"])
register("manhattan_distance", lambda a, b, axis=-1:
         torch.sum(torch.abs(a - b), dim=axis), aliases=["ManhattanDistance"])
register("hamming_distance", lambda a, b, axis=None:
         _reduce(_sum, a != b, axis, False), aliases=["HammingDistance"])
register("jaccard_distance", lambda a, b, axis=-1:
         1.0 - (torch.sum(torch.minimum(a, b), dim=axis)
                / torch.clamp_min(torch.sum(torch.maximum(a, b), dim=axis),
                                  1e-12)),
         aliases=["JaccardDistance"])


# ------------------------------------------------------------- shape / index
@register("eye", aliases=["Eye"])
def _eye(n, m=None, dtype="float32"):
    return torch.eye(int(n), int(m) if m is not None else int(n),
                     dtype=_dt.to_torch(dtype))


@register("repeat", aliases=["Repeat"])
def _repeat(x, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(device=x.device, dtype=torch.int64)
    elif not isinstance(repeats, int):
        repeats = torch.as_tensor(repeats, dtype=torch.int64, device=x.device)
    return torch.repeat_interleave(x, repeats, dim=int(axis))


@register("roll", aliases=["Roll"])
def _roll(x, shift, axis=None):
    if isinstance(shift, torch.Tensor):
        shift = shift.tolist()
    if axis is None:
        return torch.roll(x, shift)
    if isinstance(axis, (list, tuple)) and not isinstance(shift,
                                                          (list, tuple)):
        shift = [shift] * len(axis)
    return torch.roll(x, shift, dims=axis)


register("rot90", lambda x, k=1, axes=(0, 1): torch.rot90(
    x, int(k), dims=[int(a) for a in axes]))
register("invert_permutation", lambda p: torch.argsort(p, stable=True),
         aliases=["InvertPermutation"])
register("meshgrid", lambda *xs, indexing="xy":
         list(torch.meshgrid(*xs, indexing=indexing)), aliases=["Meshgrid"])
register("size_at", lambda x, dim: x.shape[dim], aliases=["SizeAt"])


@register("searchsorted", aliases=["SearchSorted"])
def _searchsorted(sorted_seq, values, side="left"):
    return torch.searchsorted(sorted_seq, values, side=side)


@register("bincount", aliases=["Bincount"])
def _bincount(x, weights=None, minlength=0, length=None):
    """``jnp.bincount``: counts (or summed weights) of each value of the
    flattened ``x``; ``length`` fixes the size (values beyond it drop)."""
    flat = x.reshape(-1).long()
    n = int(length) if length is not None else max(
        int(flat.max()) + 1 if flat.numel() else 0, int(minlength))
    if weights is None:
        w = torch.ones_like(flat, dtype=torch.int32)
    else:
        w = weights.reshape(-1)
    keep = (flat >= 0) & (flat < n)
    out = torch.zeros(n, dtype=w.dtype, device=x.device)
    return out.index_add(0, flat.clamp(0, max(n - 1, 0)),
                         torch.where(keep, w, torch.zeros_like(w)))


@register("histogram_fixed_width", aliases=["HistogramFixedWidth"])
def _histogram_fixed_width(x, value_range, nbins=100):
    lo, hi = value_range[0], value_range[1]
    idx = torch.clamp(((x - lo) / (hi - lo) * nbins).to(torch.int32), 0,
                      nbins - 1)
    out = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    return out.index_add(0, idx.reshape(-1).long(),
                         torch.ones(idx.numel(), dtype=torch.int32,
                                    device=x.device))


@register("unique", num_outputs=2, aliases=["Unique"])
def _unique(x, size=None):
    """Sorted values and each element's index into them; ``size`` pads
    the values with the maximum to a fixed length."""
    vals, inv = torch.unique(x.reshape(-1), sorted=True, return_inverse=True)
    if size is None:
        return vals, inv.reshape(x.shape)
    n = int(size)
    if vals.numel() < n:
        vals = torch.cat([vals, vals.max().expand(n - vals.numel())])
    vals = vals[:n]
    inv = torch.searchsorted(vals, x.reshape(-1)).reshape(x.shape)
    return vals, inv


@register("unique_with_counts", num_outputs=3, aliases=["UniqueWithCounts"])
def _unique_with_counts(x):
    vals, inv, counts = torch.unique(x.reshape(-1), sorted=True,
                                     return_inverse=True, return_counts=True)
    return vals, inv.reshape(x.shape), counts


@register("listdiff", num_outputs=2, aliases=["ListDiff", "setdiff1d"])
def _listdiff(x, y):
    mask = ~torch.isin(x, y)
    return x[mask], torch.nonzero(mask).reshape(-1)


@register("dynamic_partition", aliases=["DynamicPartition"])
def _dynamic_partition(x, partitions, num_partitions):
    return [x[partitions == i] for i in range(num_partitions)]


@register("dynamic_stitch", aliases=["DynamicStitch"])
def _dynamic_stitch(indices, values):
    n = int(max(int(i.max()) for i in indices)) + 1
    first = values[0]
    out = torch.zeros((n,) + tuple(first.shape[1:]), dtype=first.dtype,
                      device=first.device)
    for idx, val in zip(indices, values):
        out[idx.long().reshape(-1)] = val.reshape(
            (-1,) + tuple(first.shape[1:]))
    return out


# --------------------------------------------------------- segment / scatter
def _identity(reduce, dtype):
    if reduce == "prod":
        return 1
    if dtype.is_floating_point:
        return float("-inf") if reduce == "amax" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if reduce == "amax" else info.max


def _expand_ids(ids, data):
    """Segment ids of the leading axis broadcast over ``data``'s other
    dims (``scatter_reduce`` wants an index of ``data``'s shape)."""
    ids = ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return ids.expand(data.shape)


def _segment_reduce(data, ids, n, reduce, init=None):
    init = _identity(reduce, data.dtype) if init is None else init
    out = torch.full((n,) + tuple(data.shape[1:]), init, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce(0, _expand_ids(ids, data), data, reduce,
                              include_self=True)


def _segment_sum(data, ids, n):
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add(0, ids.long().reshape(-1), data)


def _make_segment(red):
    def f(data, segment_ids, num_segments=None):
        n = (int(num_segments) if num_segments is not None
             else int(segment_ids.max()) + 1)
        if red == "mean":
            s = _segment_sum(data, segment_ids, n)
            c = _segment_sum(torch.ones_like(data), segment_ids, n)
            return s / torch.clamp_min(c, 1)
        return _segment_reduce(data, segment_ids, n,
                               {"max": "amax", "min": "amin",
                                "prod": "prod"}[red])
    return f


for _nm, _red in [("segment_max", "max"), ("segment_min", "min"),
                  ("segment_prod", "prod"), ("segment_mean", "mean")]:
    register(_nm, _make_segment(_red),
             aliases=["Segment" + _red.capitalize(), "unsorted_" + _nm,
                      "Unsorted" + _nm.title().replace("_", "")])


@register("unsorted_segment_sqrt_n", aliases=["UnsortedSegmentSqrtN"])
def _unsorted_segment_sqrt_n(data, segment_ids, num_segments):
    n = int(num_segments)
    c = _segment_sum(torch.ones_like(data), segment_ids, n)
    return _segment_sum(data, segment_ids, n) / torch.sqrt(
        torch.clamp_min(c, 1))


def _rows(ref, idx, upd):
    """(flat row ids, updates as rows) of ``ref.at[idx]`` with ``idx`` an
    integer tensor over the leading axis (negative ids count from the
    end)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + ref.shape[0], idx)
    rows = tuple(ref.shape[1:])
    upd = torch.broadcast_to(upd.to(ref.dtype), tuple(idx.shape) + rows)
    return idx.reshape(-1), upd.reshape((-1,) + rows)


def _scatter_reduce_rows(ref, idx, upd, reduce):
    flat, rows = _rows(ref, idx, upd)
    return ref.scatter_reduce(0, _expand_ids(flat, rows), rows, reduce,
                              include_self=True)


register("scatter_sub", lambda ref, idx, upd: ref.index_put(
    (_rows(ref, idx, upd)[0],), -_rows(ref, idx, upd)[1], accumulate=True),
    aliases=["ScatterSub"])
register("scatter_mul", lambda ref, idx, upd:
         _scatter_reduce_rows(ref, idx, upd, "prod"), aliases=["ScatterMul"])
register("scatter_div", lambda ref, idx, upd: ref / _scatter_reduce_rows(
    torch.ones_like(ref), idx, upd, "prod"), aliases=["ScatterDiv"])
register("scatter_max", lambda ref, idx, upd:
         _scatter_reduce_rows(ref, idx, upd, "amax"), aliases=["ScatterMax"])
register("scatter_min", lambda ref, idx, upd:
         _scatter_reduce_rows(ref, idx, upd, "amin"), aliases=["ScatterMin"])


def _nd_index(indices):
    return tuple(indices.long().movedim(-1, 0))


@register("scatter_nd", aliases=["ScatterNd"])
def _scatter_nd(indices, updates, shape):
    out = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                      device=updates.device)
    return out.index_put(_nd_index(indices), updates, accumulate=True)


register("scatter_nd_add", lambda ref, indices, upd: ref.index_put(
    _nd_index(indices), upd.to(ref.dtype), accumulate=True),
    aliases=["ScatterNdAdd", "TensorScatterAdd"])
register("scatter_nd_update", lambda ref, indices, upd: ref.index_put(
    _nd_index(indices), upd.to(ref.dtype)),
    aliases=["ScatterNdUpdate", "TensorScatterUpdate"])
register("scatter_nd_sub", lambda ref, indices, upd: ref.index_put(
    _nd_index(indices), -upd.to(ref.dtype), accumulate=True),
    aliases=["ScatterNdSub", "TensorScatterSub"])


# ------------------------------------------------------------------- bitwise
# torch's shifts and unsigned types beyond uint8 are partial (more so on
# the card), so shifts and rotations run in int64 with the width's mask
# and wrap back: the same bits as the reference's fixed-width integers
def _width(dtype):
    return torch.iinfo(dtype).bits


def _wrap(v, dtype):
    """int64 ``v`` reduced to ``dtype``'s width, two's complement."""
    bits = _width(dtype)
    v = v & ((1 << bits) - 1)
    if torch.iinfo(dtype).min < 0:
        v = v - ((v >> (bits - 1)) & 1) * (1 << bits)
    return v.to(dtype)


def _shift_amount(n, x):
    return _tensor_like(n, x).to(torch.int64)


def _left_shift(x, n):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    s = _shift_amount(n, x)
    bits = _width(x.dtype)
    out = x.to(torch.int64) << s.clamp(0, 63)
    return _wrap(torch.where(s >= bits, torch.zeros_like(out), out), x.dtype)


def _right_shift(x, n):
    s = _shift_amount(n, x)
    bits = _width(x.dtype)
    v = x.to(torch.int64)
    if torch.iinfo(x.dtype).min < 0:     # arithmetic: sign fill
        return _wrap(v >> s.clamp(0, bits - 1), x.dtype)
    out = v >> s.clamp(0, 63)
    return _wrap(torch.where(s >= bits, torch.zeros_like(out), out), x.dtype)


register("bitwise_and", torch.bitwise_and,
         aliases=["BitwiseAnd", "bitwise_and_"])
register("bitwise_or", torch.bitwise_or, aliases=["BitwiseOr"])
register("bitwise_xor", torch.bitwise_xor, aliases=["BitwiseXor"])
register("toggle_bits", torch.bitwise_not,
         aliases=["ToggleBits", "bitwise_not"])
register("shift_bits", _left_shift, aliases=["ShiftBits", "LeftShift"])
register("rshift_bits", _right_shift, aliases=["RShiftBits", "RightShift"])


@register("cyclic_shift_bits", aliases=["CyclicShiftBits"])
def _cyclic_shift_bits(x, shift):
    """Rotate left within the type's width, in the integer type the
    reference's promotion gives: a 32-bit integer rotates as uint32, but a
    signed shift tensor promotes that back to int32 (so the right part
    fills with the sign); narrower types shift in their own type."""
    nbits = _width(x.dtype)
    s = _shift_amount(shift, x) % nbits
    v = x.to(torch.int64)
    if nbits == 32:
        if isinstance(shift, torch.Tensor) and shift.dtype.is_signed:
            v = _wrap(v, torch.int32).to(torch.int64)
        else:
            v = v & 0xFFFFFFFF
        right = v >> (nbits - s)
    else:
        signed = torch.iinfo(x.dtype).min < 0
        right = v >> (nbits - s).clamp(max=nbits - 1 if signed else 63)
        if not signed:
            right = torch.where(nbits - s >= nbits, torch.zeros_like(right),
                                right)
    left = v << s
    return _wrap(left | right, x.dtype)


def _popcount(x):
    """Set bits of each element in its own width (two's complement)."""
    bits = _width(x.dtype)
    v = x.to(torch.int64) & ((1 << bits) - 1)
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v * 0x0101010101010101) >> 56
    return (v & 0xFF).to(x.dtype)


@register("bits_hamming_distance", aliases=["BitsHammingDistance"])
def _bits_hamming_distance(a, b):
    """Σ set bits of a ^ b, summed as the reference sums them (unsigned
    types into uint32, signed into int32)."""
    x = torch.bitwise_xor(a, b)
    total = torch.sum(_popcount(x).to(torch.int64))
    return total.to(torch.int32 if torch.iinfo(x.dtype).min < 0
                    else torch.uint32)


@register("bitcast", aliases=["Bitcast"])
def _bitcast(x, dtype):
    """``lax.bitcast_convert_type``: same width reinterprets; a narrower
    type adds a trailing dim of the ratio, a wider one consumes it."""
    to = _dt.to_torch(dtype, narrow=False)
    src, dst = x.element_size(), torch.empty((), dtype=to).element_size()
    x = x.contiguous()
    if src == dst:
        return x.view(to)
    if dst < src:
        return x.reshape(tuple(x.shape) + (1,)).view(to).reshape(
            tuple(x.shape) + (src // dst,))
    return x.view(to).reshape(tuple(x.shape[:-1]))


# --------------------------------------------------------------------- image
def _resize(x, size, method):
    """``jax.image.resize`` without antialiasing: half-pixel centres, as
    ``F.interpolate`` with ``nearest-exact`` or bilinear
    ``align_corners=False``."""
    mode = {"nearest": "nearest-exact", "linear": "bilinear"}[method]
    kw = {} if mode == "nearest-exact" else {"align_corners": False}
    return _nhwc(F.interpolate(_nchw(x), size=(int(size[0]), int(size[1])),
                               mode=mode, **kw))


register("resize_nearest_neighbor",
         lambda x, size: _resize(x, size, "nearest"),
         aliases=["ResizeNearestNeighbor"])


def _tf_cubic_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Sampling matrix (out, in) of TF's bicubic resize without
    antialiasing: Keys cubic convolution (A = −0.5), half-pixel centres,
    taps outside the image dropped and the rest renormalised, the
    fractional offset quantised to TF's 1024-entry table. ``F.interpolate``
    takes A = −0.75 and clamps at the border, so the matrix is built
    here."""
    A = -0.5
    scale = in_size / out_size
    coords = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    base = np.floor(coords)
    t = np.round((coords - base) * 1024.0) / 1024.0

    def k(s):
        s = np.abs(s)
        return np.where(
            s <= 1.0, ((A + 2.0) * s - (A + 3.0)) * s * s + 1.0,
            np.where(s < 2.0, A * (((s - 5.0) * s + 8.0) * s - 4.0), 0.0))

    W = np.zeros((out_size, in_size), np.float64)
    rows = np.arange(out_size)
    for off in (-1, 0, 1, 2):
        idx = base.astype(np.int64) + off
        inside = (idx >= 0) & (idx < in_size)
        np.add.at(W, (rows[inside], idx[inside]), (k(t - off))[inside])
    W /= W.sum(axis=1, keepdims=True)
    return W.astype(np.float32)


@register("resize_bicubic", aliases=["ResizeBicubic"])
def _resize_bicubic(x, size):
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    wy = torch.as_tensor(_tf_cubic_matrix(oh, h), device=x.device)
    wx = torch.as_tensor(_tf_cubic_matrix(ow, w), device=x.device)
    y = torch.einsum("oy,nyxc->noxc", wy, x.to(torch.float32))
    return torch.einsum("px,noxc->nopc", wx, y).to(x.dtype)


# XLA has no true area resize: the reference takes bilinear
register("resize_area", lambda x, size: _resize(x, size, "linear"),
         aliases=["ResizeArea"])


@register("crop_and_resize", aliases=["CropAndResize"])
def _crop_and_resize(image, boxes, box_indices, crop_size):
    """Normalised-coordinate box crops resized bilinearly to
    ``crop_size``, all boxes at once."""
    ch, cw = int(crop_size[0]), int(crop_size[1])
    n, h, w, c = image.shape
    boxes = boxes.to(torch.float32)
    bi = box_indices.long()
    y1, x1, y2, x2 = boxes.unbind(-1)
    lin_h = torch.linspace(0.0, 1.0, ch, device=image.device)
    lin_w = torch.linspace(0.0, 1.0, cw, device=image.device)
    ys = y1[:, None] * (h - 1) + lin_h[None] * ((y2 - y1) * (h - 1))[:, None]
    xs = x1[:, None] * (w - 1) + lin_w[None] * ((x2 - x1) * (w - 1))[:, None]
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    img = image[bi]                                   # (B, H, W, C)
    ar = torch.arange(len(bi), device=image.device)[:, None, None]

    def at(yy, xx):
        return img[ar, yy[:, :, None], xx[:, None, :]]

    return (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
            + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)


@register("extract_image_patches", aliases=["ExtractImagePatches"])
def _extract_image_patches(x, ksizes, strides, rates=(1, 1), padding="VALID"):
    """Patches of NHWC ``x`` packed (kh, kw, C) per output position: the
    unfold of the padded NCHW view, regrouped from its channel-major
    packing."""
    kh, kw = (int(k) for k in ksizes)
    sh, sw = (int(s) for s in strides)
    rh, rw = (int(r) for r in rates)
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            pads = [same_pads(x.shape[1], kh, sh, rh),
                    same_pads(x.shape[2], kw, sw, rw)]
        else:
            pads = [(0, 0), (0, 0)]
    else:
        pads = [tuple(int(v) for v in p) for p in padding]
    xp = _pad_nhwc(x, pads)
    n, h, w, c = xp.shape
    oh = (h - ((kh - 1) * rh + 1)) // sh + 1
    ow = (w - ((kw - 1) * rw + 1)) // sw + 1
    cols = F.unfold(_nchw(xp), (kh, kw), dilation=(rh, rw), stride=(sh, sw))
    cols = cols.reshape(n, c, kh * kw, oh, ow).permute(0, 3, 4, 2, 1)
    return cols.reshape(n, oh, ow, kh * kw * c)


register("rgb_to_grayscale",
         lambda x: torch.sum(x * torch.tensor([0.2989, 0.587, 0.114],
                                              dtype=x.dtype, device=x.device),
                             dim=-1, keepdim=True),
         aliases=["RgbToGrayscale", "rgb_to_grs"])


@register("rgb_to_hsv", aliases=["RgbToHsv"])
def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    one, zero = torch.ones_like(d), torch.zeros_like(d)
    safe_d = torch.where(d == 0, one, d)
    h = torch.where(
        d == 0, zero,
        torch.where(mx == r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0))) / 6.0
    s = torch.where(mx == 0, zero, d / torch.where(mx == 0, one, mx))
    return torch.stack([h, s, mx], dim=-1)


def _select(i, choices):
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return torch.where((i >= 0) & (i <= 5), out, torch.zeros_like(out))


@register("hsv_to_rgb", aliases=["HsvToRgb"])
def _hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


_YUV = np.array([[0.299, 0.587, 0.114],
                 [-0.14714119, -0.28886916, 0.43601035],
                 [0.61497538, -0.51496512, -0.10001026]], np.float32)


def _color(x, m):
    return torch.einsum("...c,rc->...r", x, torch.as_tensor(
        m, dtype=x.dtype, device=x.device))


register("rgb_to_yuv", lambda x: _color(x, _YUV), aliases=["RgbToYuv"])
register("yuv_to_rgb", lambda x: _color(x, np.linalg.inv(_YUV)),
         aliases=["YuvToRgb"])


@register("adjust_contrast", aliases=["AdjustContrast", "AdjustContrastV2"])
def _adjust_contrast(x, factor):
    m = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - m) * factor + m


@register("adjust_saturation", aliases=["AdjustSaturation"])
def _adjust_saturation(x, factor):
    hsv = _rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


@register("adjust_hue", aliases=["AdjustHue"])
def _adjust_hue(x, delta):
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


# ------------------------------------------------------------------- random
# ``key`` is a ``torch.Generator`` on the output's device
def _draw_shape(shape, like=None):
    if shape:
        return tuple(int(s) for s in shape)
    return tuple(like.shape) if like is not None else ()


def sample_gamma(gen, alpha, shape, device):
    """Gamma(alpha, 1) draws from ``gen`` (torch's own sampler takes no
    generator): Marsaglia and Tsang's rejection for alpha >= 1, and for
    alpha < 1 a Gamma(alpha + 1) draw times U^(1/alpha)."""
    a = torch.broadcast_to(alpha.to(device=device, dtype=torch.float32),
                           shape).clone()
    boost = a < 1
    a1 = torch.where(boost, a + 1, a)
    d = a1 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        z = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u.clamp_min(1e-38))
                        < 0.5 * z * z + d - d * v
                        + d * torch.log(v.clamp_min(1e-38)))
        take = ok & todo
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, device=device)
    scale = torch.where(boost, u.clamp_min(1e-38) ** (1.0 / a),
                        torch.ones_like(u))
    return out * scale


@register("random_gamma", aliases=["RandomGamma"])
def _random_gamma(key, alpha, shape=None, dtype="float32"):
    alpha = _tensor_like(alpha, torch.empty(0, device=key.device))
    shp = _draw_shape(shape, alpha)
    return sample_gamma(key, alpha, shp, key.device).to(_dt.to_torch(dtype))


@register("random_poisson", aliases=["RandomPoisson", "RandomPoissonV2"])
def _random_poisson(key, lam, shape=None, dtype="float32"):
    lam = _tensor_like(lam, torch.empty(0, device=key.device))
    shp = _draw_shape(shape, lam)
    rate = torch.broadcast_to(lam.to(device=key.device, dtype=torch.float32),
                              shp).contiguous()
    return torch.poisson(rate, generator=key).to(_dt.to_torch(dtype))


@register("random_exponential", aliases=["RandomExponential"])
def _random_exponential(key, rate, shape, dtype="float32"):
    e = torch.empty(_draw_shape(shape), device=key.device).exponential_(
        generator=key)
    return (e / rate).to(_dt.to_torch(dtype))


@register("random_shuffle", aliases=["RandomShuffle"])
def _random_shuffle(key, x):
    perm = torch.randperm(x.shape[0], generator=key, device=key.device)
    return x[perm.to(x.device)]


@register("random_categorical", aliases=["Multinomial", "multinomial"])
def _random_categorical(key, logits, num_samples):
    """(B, num_samples) class draws from each row's logits (Gumbel-max, as
    ``jax.random.categorical``)."""
    b, k = logits.shape
    u = torch.rand((b, int(num_samples), k), generator=key,
                   device=key.device).to(logits.device)
    e = -torch.log(u.clamp_min(1e-38))
    g = -torch.log(e.clamp_min(1e-38))
    return torch.argmax(logits[:, None, :].float() + g, dim=-1)


# ------------------------------------------------------------------- linalg
register("matrix_diag", lambda d: torch.diag_embed(d) if d.dim() > 1
         else torch.diag(d), aliases=["MatrixDiag"])


@register("matrix_set_diag", aliases=["MatrixSetDiag"])
def _matrix_set_diag(x, d):
    n = d.shape[-1]
    ar = torch.arange(n, device=x.device)
    out = x.clone()
    out[..., ar, ar] = d.to(x.dtype)
    return out


register("cross", lambda a, b: torch.linalg.cross(a, b, dim=-1),
         aliases=["Cross"])
register("logdet", lambda x: torch.linalg.slogdet(x)[1], aliases=["Logdet"])
# jax.scipy.linalg.lu's convention x = P @ L @ U is torch.linalg.lu's
register("lu", lambda x: tuple(torch.linalg.lu(x)), aliases=["Lu"])
register("self_adjoint_eig", lambda x: tuple(torch.linalg.eigh(x)),
         aliases=["SelfAdjointEigV2", "eigh"])
register("matrix_transpose", lambda x: torch.swapaxes(x, -1, -2),
         aliases=["MatrixTranspose", "adjoint"])


# ------------------------------------------------------------------ loss ops
def _apply_weights_and_reduce(per, weights, reduction):
    if weights is not None:
        per = per * weights
    if reduction in ("mean", "MEAN_BY_WEIGHT", "weighted_mean"):
        den = (torch.sum(torch.broadcast_to(weights, per.shape))
               if weights is not None else per.numel())
        if isinstance(den, torch.Tensor):
            den = torch.clamp_min(den, 1e-12)
        else:
            den = max(den, 1e-12)
        return torch.sum(per) / den
    if reduction in ("sum", "SUM"):
        return torch.sum(per)
    return per     # "none"


@register("huber_loss", aliases=["HuberLoss"])
def _huber_loss(labels, predictions, weights=None, delta=1.0,
                reduction="mean"):
    err = torch.abs(predictions - labels)
    per = torch.where(err <= delta, 0.5 * err * err,
                      delta * err - 0.5 * delta * delta)
    return _apply_weights_and_reduce(per, weights, reduction)


@register("log_loss", aliases=["LogLoss"])
def _log_loss(labels, predictions, weights=None, epsilon=1e-7,
              reduction="mean"):
    p = torch.clamp(predictions, epsilon, 1 - epsilon)
    per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    return _apply_weights_and_reduce(per, weights, reduction)


@register("absolute_difference_loss", aliases=["AbsoluteDifference"])
def _absolute_difference_loss(labels, predictions, weights=None,
                              reduction="mean"):
    return _apply_weights_and_reduce(torch.abs(predictions - labels),
                                     weights, reduction)


@register("mean_sqerr_loss", aliases=["MeanSqerrLoss"])
def _mean_sqerr_loss(labels, predictions, weights=None, reduction="mean"):
    return _apply_weights_and_reduce(torch.square(predictions - labels),
                                     weights, reduction)


@register("hinge_loss", aliases=["HingeLoss"])
def _hinge_loss(labels, logits, weights=None, reduction="mean"):
    signed = 2.0 * labels - 1.0
    return _apply_weights_and_reduce(
        torch.clamp_min(1.0 - signed * logits, 0.0), weights, reduction)


@register("cosine_distance_loss", aliases=["CosineDistanceLoss"])
def _cosine_distance_loss(labels, predictions, weights=None, axis=-1,
                          reduction="mean"):
    per = 1.0 - torch.sum(labels * predictions, dim=axis, keepdim=True)
    return _apply_weights_and_reduce(per, weights, reduction)


@register("weighted_cross_entropy_with_logits",
          aliases=["WeightedCrossEntropyWithLogits"])
def _weighted_ce(labels, logits, pos_weight):
    log_w = 1 + (pos_weight - 1) * labels
    return (1 - labels) * logits + log_w * (
        torch.log1p(torch.exp(-torch.abs(logits)))
        + torch.clamp_min(-logits, 0.0))


# ------------------------------------------------------------ nn extensions
register("bias_add", lambda x, b: x + b, aliases=["BiasAdd"])
register("xw_plus_b", lambda x, w, b: promote_mm(x, w) + b,
         aliases=["XwPlusB"])
register("relu_layer", lambda x, w, b: torch.relu(promote_mm(x, w) + b),
         aliases=["ReluLayer"])
register("embedding_lookup", lambda params, ids: params[ids.long()],
         aliases=["EmbeddingLookup"])


@register("lstm_layer", num_outputs=2, aliases=["LSTMLayer", "lstmLayer"])
def _lstm_layer(x, h0, c0, w, b, forget_bias=0.0):
    """Full-sequence LSTM over (N, T, C): the fused cell stepped over time
    (the reference's ``lax.scan``). Returns (outputs (N, T, H), (hN,
    cN))."""
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        h, c = exec_op("lstm_cell", x[:, t], h, c, w, b,
                       forget_bias=forget_bias)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


@register("gru_layer", num_outputs=2, aliases=["GRULayer", "gruLayer"])
def _gru_layer(x, h0, w_rz, w_h, b_rz, b_h):
    """Full-sequence GRU over (N, T, C). Returns (outputs (N, T, H),
    hN)."""
    h = h0
    ys = []
    for t in range(x.shape[1]):
        h = exec_op("gru_cell", x[:, t], h, w_rz, w_h, b_rz, b_h)
        ys.append(h)
    return torch.stack(ys, dim=1), h


# ----------------------------------------------------------------- sequence
@register("trapz", aliases=[])
def _trapz(y, x=None, axis=-1):
    if x is None:
        return torch.trapezoid(y, dim=axis)
    return torch.trapezoid(y, x, dim=axis)


# ---------------------------------------------------------- spectral / signal
register("fft", lambda x, n=None, axis=-1: torch.fft.fft(x, n=n, dim=axis),
         aliases=["FFT"])
register("ifft", lambda x, n=None, axis=-1: torch.fft.ifft(x, n=n, dim=axis),
         aliases=["IFFT"])
register("rfft", lambda x, n=None, axis=-1: torch.fft.rfft(x, n=n, dim=axis),
         aliases=["RFFT"])
register("irfft", lambda x, n=None, axis=-1:
         torch.fft.irfft(x, n=n, dim=axis), aliases=["IRFFT"])
register("fft2", lambda x: torch.fft.fft2(x), aliases=["FFT2D"])
register("ifft2", lambda x: torch.fft.ifft2(x), aliases=["IFFT2D"])


# ----------------------------------------------------------------- ctc loss
def ctc_loss_lattice(logits, logit_pad, labels, label_pad, blank_id=0,
                     log_epsilon=-1e5):
    """Per-sequence CTC loss over the blank-inserted alignment lattice,
    the formulation the reference takes from optax (``ctc_loss``): the
    inputs are log-softmaxed, padded frames carry the state through, and
    log(0) is ``log_epsilon``."""
    b, t_len, k = logits.shape
    n = labels.shape[1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    labellens = n - torch.sum(label_pad, dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).float()
    repeat = F.pad(repeat, (0, 1))
    logp_phi = logp[:, :, blank_id:blank_id + 1].transpose(0, 1)  # T, B, 1
    one_hot = F.one_hot(labels.long(), k).float()                  # B, N, K
    logp_emit = torch.einsum("btk,bnk->btn", logp, one_hot).transpose(0, 1)
    phi = torch.full((b, n + 1), log_epsilon, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), log_epsilon, device=logits.device)

    def upd(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)],
                         dim=-1)

    pads = logit_pad.float().transpose(0, 1)
    for t in range(t_len):
        prev_phi_orig = phi
        prev_phi = upd(phi, emit + log_epsilon * repeat)
        le, lp = logp_emit[t], logp_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + le, emit + le)
        next_phi = prev_phi + lp
        next_phi = upd(next_phi, emit + lp + log_epsilon * (1.0 - repeat))
        pad = pads[t].reshape(b, 1)
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = upd(phi, emit)
    sel = F.one_hot(labellens, n + 1).float()
    return -torch.einsum("bn,bn->b", last, sel)


@register("ctc_loss", aliases=["CTCLoss", "ctc_loss_v2"])
def _ctc_loss(log_probs, labels, logit_lengths, label_lengths, blank_id=0):
    """Connectionist temporal classification loss: ``log_probs`` (B, T,
    C), ``labels`` (B, S) int, per-example valid lengths."""
    t_len, s_len = log_probs.shape[1], labels.shape[1]
    dev = log_probs.device
    logit_pad = (torch.arange(t_len, device=dev)[None, :]
                 >= _tensor_like(logit_lengths, log_probs)[:, None]).float()
    label_pad = (torch.arange(s_len, device=dev)[None, :]
                 >= _tensor_like(label_lengths, log_probs)[:, None]).float()
    return ctc_loss_lattice(log_probs, logit_pad, labels, label_pad,
                            blank_id=blank_id)


# ------------------------------------------------------------ linalg tranche
register("pinv", torch.linalg.pinv, aliases=["Pinv"])
register("kron", torch.kron, aliases=["Kron"])
register("matrix_power", lambda x, n: torch.linalg.matrix_power(x, int(n)),
         aliases=["MatrixPower"])
register("matrix_rank", lambda x: torch.linalg.matrix_rank(x),
         aliases=["MatrixRank"])


@register("norm", aliases=["Norm"])
def _norm_op(x, ord=None, axis=None, keepdims=False):
    if axis is None and ord is None:
        return torch.linalg.vector_norm(x.reshape(-1)).reshape(
            (1,) * x.dim() if keepdims else ())
    return torch.linalg.norm(x, ord=ord, dim=axis, keepdim=keepdims)


register("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
         aliases=["Outer"])
register("triu", lambda x, k=0: torch.triu(x, diagonal=int(k)),
         aliases=["Triu"])
register("tril", lambda x, k=0: torch.tril(x, diagonal=int(k)),
         aliases=["Tril"])
