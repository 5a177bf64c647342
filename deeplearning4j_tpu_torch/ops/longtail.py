"""The registry's third tranche: counterparts of the JAX package's
``ops/longtail.py`` (spatial and batch reshuffles, merge ops, unsorted
segments, quantization, loss stragglers, the RNN sequence runners, fused
NLP steps, the fused attention op, and the ONNX-layout recurrent, conv
and normalisation ops).

Same conventions as ``standard.py``: tensors positional, attributes as
keywords, NHWC unless an op says NCHW. The reference's ``lax.scan``
runners are plain loops over time here. ``multi_head_dot_product_attention``
takes its attention core through ``standard.routed_attention``: K1 on the
card, K2 under autograd, wherever ``attention_route`` says "kernel".
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.moments import one_pass_moments
from deeplearning4j_tpu_torch.ops.registry import exec_op, register
from deeplearning4j_tpu_torch.ops.standard import (
    conv2d, conv_transpose, conv_transpose_same_valid, promote_mm,
    routed_attention)


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    return [int(b) for b in np.atleast_1d(np.asarray(v))]


def _pairs(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    return [tuple(int(a) for a in p) for p in v]


def _pad_dims(x, pads, value=0.0):
    """``jnp.pad`` with (lo, hi) per leading dim (missing dims unpadded)."""
    flat = []
    pads = list(pads) + [(0, 0)] * (x.dim() - len(pads))
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=value)


# ------------------------------------------------- spatial/batch reshuffles
@register("space_to_batch", aliases=["SpaceToBatch"])
def space_to_batch(x, block_size=2, paddings=((0, 0), (0, 0))):
    """NHWC (N, H, W, C) → (N·b², H/b, W/b, C)."""
    return space_to_batch_nd(x, (int(block_size),) * 2, paddings)


@register("batch_to_space", aliases=["BatchToSpace"])
def batch_to_space(x, block_size=2, crops=((0, 0), (0, 0))):
    return batch_to_space_nd(x, (int(block_size),) * 2, crops)


@register("space_to_batch_nd", aliases=["SpaceToBatchND"])
def space_to_batch_nd(x, block_shape, paddings):
    block_shape = _ints(block_shape)
    m = len(block_shape)
    x = _pad_dims(x, [(0, 0)] + _pairs(paddings))
    n = x.shape[0]
    shape = [n]
    for i, b in enumerate(block_shape):
        shape += [x.shape[1 + i] // b, b]
    shape += list(x.shape[1 + m:])
    x = x.reshape(shape)
    perm = [2 * i + 2 for i in range(m)] + [0] \
        + [2 * i + 1 for i in range(m)] + list(range(2 * m + 1, x.dim()))
    x = x.permute(perm)
    out_shape = [n * int(np.prod(block_shape))] \
        + [x.shape[m + 1 + i] for i in range(m)] + list(x.shape[2 * m + 1:])
    return x.reshape(out_shape)


@register("batch_to_space_nd", aliases=["BatchToSpaceND"])
def batch_to_space_nd(x, block_shape, crops):
    block_shape = _ints(block_shape)
    m = len(block_shape)
    n = x.shape[0] // int(np.prod(block_shape))
    x = x.reshape(block_shape + [n] + list(x.shape[1:]))
    perm = [m]
    for i in range(m):
        perm += [m + 1 + i, i]
    perm += list(range(2 * m + 1, x.dim()))
    x = x.permute(perm)
    shape = [n] + [x.shape[1 + 2 * i] * block_shape[i] for i in range(m)] \
        + list(x.shape[2 * m + 1:])
    x = x.reshape(shape)
    idx = [slice(None)]
    for i, (lo, hi) in enumerate(_pairs(crops)):
        idx.append(slice(lo, x.shape[1 + i] - hi))
    return x[tuple(idx)]


@register("mirror_pad", aliases=["MirrorPad"])
def mirror_pad(x, paddings, mode="REFLECT"):
    return exec_op("pad", x, _pairs(paddings), mode=mode)


@register("col2im")
def col2im(cols, kernel, out_hw, strides=(1, 1), padding="VALID"):
    """Inverse of im2col: scatter-add (N, OH, OW, C·KH·KW) patches
    (channel-major packing, as im2col's) back to the (N, H, W, C) image,
    its exact adjoint."""
    kh, kw = (int(k) for k in kernel)
    sh, sw = (int(s) for s in strides)
    h, w = (int(v) for v in out_hw)
    n, oh, ow, _ = cols.shape
    c = cols.shape[-1] // (kh * kw)
    cols = cols.reshape(n, oh, ow, c, kh, kw).permute(0, 1, 2, 4, 5, 3)
    if padding.upper() == "SAME":
        ph = max((oh - 1) * sh + kh - h, 0)
        pw = max((ow - 1) * sw + kw - w, 0)
        pt, pl = ph // 2, pw // 2
    else:
        pt = pl = 0
    pad_h = max((oh - 1) * sh + kh, h + pt)
    pad_w = max((ow - 1) * sw + kw, w + pl)
    dev = cols.device
    oy = torch.arange(oh, device=dev) * sh
    ox = torch.arange(ow, device=dev) * sw
    yy = (oy[:, None] + torch.arange(kh, device=dev)[None, :]).reshape(-1)
    xx = (ox[:, None] + torch.arange(kw, device=dev)[None, :]).reshape(-1)
    cols_t = cols.permute(0, 1, 3, 2, 4, 5).reshape(n, oh * kh, ow * kw, c)
    lin = (yy[:, None] * pad_w + xx[None, :]).reshape(-1)
    flat = torch.zeros((n, pad_h * pad_w, c), dtype=cols.dtype, device=dev)
    flat = flat.index_add(1, lin, cols_t.reshape(n, -1, c))
    img = flat.reshape(n, pad_h, pad_w, c)
    return img[:, pt:pt + h, pl:pl + w]


@register("dilation2d", aliases=["Dilation2D"])
def dilation2d(x, w, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Morphological dilation: out = max over the window of (x + w)."""
    sh, sw = (int(s) for s in strides)
    rh, rw = (int(r) for r in rates)
    kh, kw, c = w.shape
    if padding.upper() == "SAME":
        eff_kh, eff_kw = (kh - 1) * rh + 1, (kw - 1) * rw + 1
        oh = -(-x.shape[1] // sh)
        ow = -(-x.shape[2] // sw)
        ph = max((oh - 1) * sh + eff_kh - x.shape[1], 0)
        pw = max((ow - 1) * sw + eff_kw - x.shape[2], 0)
        x = _pad_dims(x, [(0, 0), (ph // 2, ph - ph // 2),
                          (pw // 2, pw - pw // 2)], value=float("-inf"))
    outs = []
    for i in range(kh):
        for j in range(kw):
            sl = x[:, i * rh: x.shape[1] - (kh - 1 - i) * rh or None,
                   j * rw: x.shape[2] - (kw - 1 - j) * rw or None]
            outs.append(sl[:, ::sh, ::sw] + w[i, j])
    oh = min(o.shape[1] for o in outs)
    ow = min(o.shape[2] for o in outs)
    return torch.amax(torch.stack([o[:, :oh, :ow] for o in outs]), dim=0)


def _lowest(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@register("maxpool_with_argmax", num_outputs=2, aliases=["MaxPoolWithArgmax"])
def maxpool_with_argmax(x, kernel=(2, 2), strides=None, padding="VALID"):
    """(pooled, argmax) with TF's flat index ``((y · W) + x) · C + c`` in
    unpadded coordinates; SAME pads with the type's lowest value."""
    kh, kw = (int(k) for k in kernel)
    strides = strides or (kh, kw)
    sh, sw = (int(s) for s in strides)
    h, w, c = x.shape[1], x.shape[2], x.shape[-1]
    pt = pl_ = 0
    if padding.upper() == "SAME":
        oh_s, ow_s = -(-h // sh), -(-w // sw)
        ph = max((oh_s - 1) * sh + kh - h, 0)
        pw = max((ow_s - 1) * sw + kw - w, 0)
        pt, pl_ = ph // 2, pw // 2
        x = _pad_dims(x, [(0, 0), (pt, ph - pt), (pl_, pw - pl_)],
                      value=_lowest(x.dtype))
    patches = exec_op("extract_image_patches", x, ksizes=(kh, kw),
                      strides=strides, rates=(1, 1), padding="VALID")
    n, oh, ow, _ = patches.shape
    patches = patches.reshape(n, oh, ow, kh * kw, c)
    pooled = torch.amax(patches, dim=3)
    within = torch.argmax(patches, dim=3)
    dev = x.device
    oy = torch.arange(oh, device=dev)[None, :, None, None] * sh - pt
    ox = torch.arange(ow, device=dev)[None, None, :, None] * sw - pl_
    ky, kx = within // kw, within % kw
    cc = torch.arange(c, device=dev)[None, None, None, :]
    flat = ((oy + ky) * w + (ox + kx)) * c + cc
    return pooled, flat.to(torch.int32)


@register("upsampling3d", aliases=["Upsampling3D"])
def upsampling3d(x, scale=2):
    """(N, D, H, W, C) nearest ×scale."""
    s = int(scale)
    for d in (1, 2, 3):
        x = torch.repeat_interleave(x, s, dim=d)
    return x


@register("deconv3d", aliases=["DeConv3D", "Conv3DTranspose"])
def deconv3d(x, w, b=None, strides=(1, 1, 1), padding="SAME"):
    """(N, D, H, W, C) ``lax.conv_transpose`` over DHWIO weights (the
    correlation form, no kernel flip)."""
    strides = tuple(int(s) for s in strides)
    pads = conv_transpose_same_valid(tuple(w.shape[:3]), strides, padding)
    out = conv_transpose(x, torch.flip(w, (0, 1, 2)), strides, pads,
                         (1, 1, 1))
    return out + b if b is not None else out


@register("sconv2d", aliases=["SeparableConv2D", "separable_conv2d"])
def sconv2d(x, depth_w, point_w=None, b=None, strides=(1, 1), padding="SAME"):
    """Separable conv: depthwise, then an optional 1×1 pointwise."""
    out = exec_op("depthwise_conv2d", x, depth_w, strides=strides,
                  padding=padding)
    if point_w is not None:
        out = conv2d(out, point_w, None, (1, 1), "VALID")
    return out + b if b is not None else out


@register("pointwise_conv2d", aliases=["PointwiseConv2D"])
def pointwise_conv2d(x, w, b=None):
    out = conv2d(x, w, None, (1, 1), "VALID")
    return out + b if b is not None else out


# --------------------------------------------------------------- merge ops
register("mergeadd", lambda *xs: sum(xs[1:], xs[0]),
         aliases=["MergeAdd", "mergesum", "accumulate_n"])
register("mergeavg", lambda *xs: sum(xs[1:], xs[0]) / len(xs),
         aliases=["MergeAvg"])
register("mergemax", lambda *xs: torch.amax(torch.stack(xs), dim=0),
         aliases=["MergeMax"])
register("mergemaxindex",
         lambda *xs: torch.argmax(torch.stack(xs), dim=0).to(torch.int32),
         aliases=["MergeMaxIndex"])


# ------------------------------------------------------- unsorted segments
def _seg_rows(data, segment_ids):
    """(flat ids, data rows): ids over data's leading dims."""
    k = segment_ids.dim()
    rows = data.reshape((-1,) + tuple(data.shape[k:]))
    return segment_ids.long().reshape(-1), rows


def _unsorted(reduce, init):
    def op(data, segment_ids, num_segments=None):
        n = int(num_segments)
        ids, rows = _seg_rows(data, segment_ids)
        fill = init(data.dtype) if callable(init) else init
        out = torch.full((n,) + tuple(rows.shape[1:]), fill,
                         dtype=data.dtype, device=data.device)
        idx = ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand(rows.shape)
        return out.scatter_reduce(0, idx, rows, reduce, include_self=True)
    return op


def _dtype_max(dt):
    return (torch.finfo(dt).max if dt.is_floating_point
            else torch.iinfo(dt).max)


@register("unsorted_segment_sum", aliases=["UnsortedSegmentSum"])
def _unsorted_segment_sum(d, i, num_segments=None):
    ids, rows = _seg_rows(d, i)
    out = torch.zeros((int(num_segments),) + tuple(rows.shape[1:]),
                      dtype=d.dtype, device=d.device)
    return out.index_add(0, ids, rows)


# TF fills empty segments of the max (min) with the type's lowest
# (highest) finite value, not ∓inf
register("unsorted_segment_max", _unsorted("amax", _lowest),
         aliases=["UnsortedSegmentMax"])
register("unsorted_segment_min", _unsorted("amin", _dtype_max),
         aliases=["UnsortedSegmentMin"])
register("unsorted_segment_prod", _unsorted("prod", 1),
         aliases=["UnsortedSegmentProd"])


@register("unsorted_segment_mean", aliases=["UnsortedSegmentMean"])
def unsorted_segment_mean(data, segment_ids, num_segments):
    n = int(num_segments)
    tot = _unsorted_segment_sum(data, segment_ids, n)
    ids = segment_ids.long().reshape(-1)
    cnt = torch.zeros((n,), dtype=data.dtype, device=data.device).index_add(
        0, ids, torch.ones(ids.shape, dtype=data.dtype, device=data.device))
    cnt = torch.clamp_min(cnt, 1).reshape((n,) + (1,) * (tot.dim() - 1))
    return tot / cnt


# ------------------------------------------------------------ quantization
def _f32(v, ref):
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=ref.device)


@register("fake_quant_with_min_max_args", aliases=["FakeQuantWithMinMaxArgs"])
def fake_quant_args(x, min=-6.0, max=6.0, num_bits=8, narrow_range=False):
    return _fake_quant(x, _f32(min, x), _f32(max, x), int(num_bits),
                       bool(narrow_range))


@register("fake_quant_with_min_max_vars",
          aliases=["FakeQuantWithMinMaxVars",
                   "fake_quant_with_min_max_vars_per_channel",
                   "FakeQuantWithMinMaxVarsPerChannel"])
def fake_quant_vars(x, minv, maxv, num_bits=8, narrow_range=False):
    return _fake_quant(x, minv, maxv, int(num_bits), bool(narrow_range))


def _fake_quant(x, minv, maxv, num_bits, narrow):
    """TF's fake-quant nudging."""
    qmin = 1.0 if narrow else 0.0
    qmax = float(2 ** num_bits - 1)
    scale = (maxv - minv) / (qmax - qmin)
    zp_f = qmin - minv / scale
    nudged_zp = torch.clamp(torch.round(zp_f), qmin, qmax)
    nmin = (qmin - nudged_zp) * scale
    nmax = (qmax - nudged_zp) * scale
    xc = torch.minimum(torch.maximum(x, nmin), nmax)
    return torch.round((xc - nmin) / scale) * scale + nmin


@register("compare_and_bitpack", aliases=["CompareAndBitpack"])
def compare_and_bitpack(x, threshold):
    """Pack (…, 8k) comparisons into uint8 bytes, MSB first."""
    bits = (x > threshold).to(torch.int32)
    b = bits.reshape(tuple(bits.shape[:-1]) + (bits.shape[-1] // 8, 8))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=x.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


# ------------------------------------------------------------------ losses
register("l2_loss", lambda x: 0.5 * torch.sum(torch.square(x)),
         aliases=["L2Loss"])


@register("log_poisson_loss", aliases=["LogPoissonLoss"])
def log_poisson_loss(log_input, targets, full=False):
    loss = torch.exp(log_input) - targets * log_input
    if full:
        t = targets
        stirling = t * torch.log(torch.clamp_min(t, 1e-12)) - t \
            + 0.5 * torch.log(torch.clamp_min(2 * math.pi * t, 1e-12))
        loss = loss + torch.where(t > 1, stirling, torch.zeros_like(t))
    return loss


@register("mean_pairwssqerr_loss", aliases=["MeanPairwsSqErrLoss"])
def mean_pairwssqerr_loss(predictions, labels):
    """TF's mean_pairwise_squared_error with a scalar weight: per sample
    term1 − term2 over the TOTAL element count, then a batch sum."""
    d = (predictions - labels).reshape(predictions.shape[0], -1)
    n_total = d.numel()
    sum_d = torch.sum(d, dim=-1)
    sum_d2 = torch.sum(d * d, dim=-1)
    term1 = 2.0 * sum_d2 / max(n_total - 1, 1)
    term2 = 2.0 * sum_d ** 2 / max(n_total * (n_total - 1), 1)
    return torch.sum(term1 - term2)


# ------------------------------------------------------------- misc math
register("log_sigmoid", F.logsigmoid, aliases=["LogSigmoid"])
register("crelu", lambda x, axis=-1: torch.relu(
    torch.cat([x, -x], dim=axis)), aliases=["CRelu"])
register("axpy", lambda x, y, a=1.0: a * x + y, aliases=["Axpy"])
register("assign", lambda x, y: torch.broadcast_to(y, x.shape).to(x.dtype),
         aliases=["Assign"])


@register("zeta", aliases=["Zeta"])
def zeta(x, q):
    """Hurwitz zeta."""
    return torch.special.zeta(x, q)


@register("percentile", aliases=["Percentile"])
def percentile(x, q=50.0, axis=None, interpolation="linear"):
    xf = x if x.is_floating_point() else x.float()
    qs = torch.as_tensor(q, dtype=xf.dtype, device=x.device) / 100.0
    if axis is None:
        return torch.quantile(xf.reshape(-1), qs, interpolation=interpolation)
    return torch.quantile(xf, qs, dim=int(axis), interpolation=interpolation)


@register("nth_element", aliases=["NthElement"])
def nth_element(x, n, reverse=False):
    """n-th order statistic along the last axis."""
    s = torch.sort(x, dim=-1).values
    if reverse:
        s = torch.flip(s, (-1,))
    return s[..., int(n)]


@register("clip_by_global_norm", aliases=["ClipByGlobalNorm"])
def clip_by_global_norm(*tensors, clip_norm=1.0):
    g = torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))
    scale = torch.clamp_max(clip_norm / torch.clamp_min(g, 1e-12), 1.0)
    out = tuple(t * scale for t in tensors)
    return out if len(out) > 1 else out[0]


@register("clip_by_avg_norm", aliases=["ClipByAvgNorm"])
def clip_by_avg_norm(x, clip_norm=1.0):
    avg = torch.sqrt(torch.sum(torch.square(x))) / x.numel()
    return x * torch.clamp_max(clip_norm / torch.clamp_min(avg, 1e-12), 1.0)


def _compact(m, values):
    """Entries where ``m`` holds moved to the front in order, the rest
    zero: (values, positions)."""
    order = torch.argsort((~m).to(torch.int8), stable=True)
    first = torch.sort((~m).to(torch.int8), stable=True).values == 0
    return order, first


@register("choose", num_outputs=2, aliases=["Choose"])
def choose(x, scalar=0.0, mode=0):
    """(matching values compacted to the front, zero-filled; count): modes
    0..5 are <, >, ==, !=, <=, >=."""
    cmps = [x < scalar, x > scalar, x == scalar, x != scalar,
            x <= scalar, x >= scalar]
    m = cmps[int(mode)].reshape(-1)
    flat = x.reshape(-1)
    order, first = _compact(m, flat)
    vals = torch.where(first, flat[order], torch.zeros_like(flat))
    return vals.reshape(x.shape), torch.sum(m).to(torch.int32)


# ------------------------------------------------------------------ color
_YIQ = np.array([[0.299, 0.587, 0.114],
                 [0.5959, -0.2746, -0.3213],
                 [0.2115, -0.5227, 0.3112]], np.float32)


register("rgb_to_yiq", lambda x: x @ torch.as_tensor(
    _YIQ.T, dtype=x.dtype, device=x.device), aliases=["RgbToYiq"])
register("yiq_to_rgb", lambda x: x @ torch.as_tensor(
    np.linalg.inv(_YIQ).T, dtype=x.dtype, device=x.device),
    aliases=["YiqToRgb"])


# ------------------------------------------------------------------ image
@register("draw_bounding_boxes", aliases=["DrawBoundingBoxes"])
def draw_bounding_boxes(images, boxes, colors=None):
    """Paint 1-px box outlines; boxes (N, B, 4) normalised [y1, x1, y2,
    x2]."""
    n, h, w, c = images.shape
    nb = boxes.shape[1]
    if colors is None:
        colors = torch.ones((nb, c), dtype=images.dtype, device=images.device)
    dev = images.device
    ys = torch.arange(h, device=dev)[None, None, :]
    xs = torch.arange(w, device=dev)[None, None, :]
    y1 = torch.round(boxes[..., 0] * (h - 1))[..., None]
    x1 = torch.round(boxes[..., 1] * (w - 1))[..., None]
    y2 = torch.round(boxes[..., 2] * (h - 1))[..., None]
    x2 = torch.round(boxes[..., 3] * (w - 1))[..., None]
    in_y = (ys >= y1) & (ys <= y2)
    in_x = (xs >= x1) & (xs <= x2)
    edge_y = (ys == y1) | (ys == y2)
    edge_x = (xs == x1) | (xs == x2)
    mask = (edge_y[:, :, :, None] & in_x[:, :, None, :]) \
        | (in_y[:, :, :, None] & edge_x[:, :, None, :])
    out = images
    for b in range(nb):
        out = torch.where(mask[:, b, :, :, None],
                          colors[b].reshape(1, 1, 1, c).to(out.dtype), out)
    return out


@register("non_max_suppression_overlaps",
          aliases=["NonMaxSuppressionWithOverlaps"])
def nms_overlaps(overlaps, scores, max_output_size, overlap_threshold=0.5,
                 score_threshold=-float("inf")):
    """NMS over a precomputed pairwise overlap matrix; survivors in score
    order, padded with -1."""
    k = int(max_output_size)
    n = scores.shape[0]
    order = torch.argsort(-scores, stable=True)
    valid0 = scores[order] > score_threshold
    keep = torch.full((n,), -1, dtype=torch.int64, device=scores.device)
    sup = torch.zeros((n,), dtype=torch.bool, device=scores.device)
    for i in range(n):
        cand = order[i]
        ok = valid0[i] & ~sup[i]
        keep[i] = torch.where(ok, cand, torch.full_like(cand, -1))
        row = overlaps[cand][order] > overlap_threshold
        sup = torch.where(ok, sup | row, sup)
        sup[i] = sup[i] | ~ok
    alive = keep >= 0
    pos, first = _compact(alive, keep)
    sel = torch.where(first, keep[pos], torch.full_like(keep, -1))
    return sel[:k].to(torch.int32)


@register("random_crop", aliases=["RandomCrop"])
def random_crop(x, size, seed=0):
    """A ``size`` window of ``x`` at starts drawn from a generator seeded
    with ``seed`` (the reference's key from the same seed draws other
    starts)."""
    gen = torch.Generator().manual_seed(int(seed))
    size = tuple(int(s) for s in size)
    out = x
    for i, s in enumerate(size):
        start = int(torch.randint(0, x.shape[i] - s + 1, (), generator=gen))
        out = out.narrow(i, start, s)
    return out


# -------------------------------------------------------- RNN runners
@register("static_rnn", num_outputs=2,
          aliases=["StaticRNN", "dynamic_rnn", "DynamicRNN"])
def static_rnn(x, h0, c0, w, b, cell="lstm", forget_bias=0.0):
    """A cell stepped over (N, T, C) (the reference's ``lax.scan``).
    Returns (outputs, final state). For ``cell="gru"``, ``w``/``b`` pack
    (w_rz, w_h) and (b_rz, b_h)."""
    h, c = h0, c0
    ys = []
    for t in range(x.shape[1]):
        xt = x[:, t]
        if cell == "lstm":
            h, c = exec_op("lstm_cell", xt, h, c, w, b,
                           forget_bias=forget_bias)
        else:
            h = exec_op("gru_cell", xt, h, w[0], w[1], b[0], b[1])
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


@register("static_bidirectional_rnn", num_outputs=2,
          aliases=["StaticBidirectionalRNN", "dynamic_bidirectional_rnn",
                   "DynamicBidirectionalRNN"])
def static_bidirectional_rnn(x, h0f, c0f, wf, bf, h0b, c0b, wb, bb,
                             cell="lstm", forget_bias=0.0):
    """Forward + time-reversed backward pass, concatenated on features."""
    yf, sf = static_rnn(x, h0f, c0f, wf, bf, cell=cell,
                        forget_bias=forget_bias)
    yb, sb = static_rnn(torch.flip(x, (1,)), h0b, c0b, wb, bb, cell=cell,
                        forget_bias=forget_bias)
    return torch.cat([yf, torch.flip(yb, (1,))], dim=-1), (sf, sb)


@register("lstm_block", num_outputs=2, aliases=["LSTMBlock"])
def lstm_block(x, h0, c0, w, b, forget_bias=1.0):
    """Whole-sequence fused LSTM with TF's forget-bias default."""
    return exec_op("lstm_layer", x, h0, c0, w, b, forget_bias=forget_bias)


@register("sru", num_outputs=2, aliases=["SRU"])
def sru(x, c0, w, b):
    """Simple Recurrent Unit over (N, T, C): the products over the whole
    sequence at once, the elementwise recurrence stepped."""
    proj = promote_mm(x, w)
    xt_, f_, r_ = torch.chunk(proj, 3, dim=-1)
    bf, br = torch.chunk(b, 2)
    f = torch.sigmoid(f_ + bf)
    r = torch.sigmoid(r_ + br)
    c = c0
    hs = []
    for t in range(x.shape[1]):
        c = f[:, t] * c + (1 - f[:, t]) * xt_[:, t]
        hs.append(r[:, t] * torch.tanh(c) + (1 - r[:, t]) * x[:, t])
    return torch.stack(hs, dim=1), c


@register("sru_bi", num_outputs=2, aliases=["SRUBi"])
def sru_bi(x, c0f, wf, bf, c0b, wb, bb):
    hf, cf = sru(x, c0f, wf, bf)
    hb, cb = sru(torch.flip(x, (1,)), c0b, wb, bb)
    return torch.cat([hf, torch.flip(hb, (1,))], dim=-1), (cf, cb)


# ------------------------------------------------------- fused NLP steps
def _neg_sampling(syn0, syn1neg, v_in, tgt, lr):
    lbl = torch.zeros(tgt.shape, dtype=syn0.dtype, device=syn0.device)
    lbl[:, 0] = 1
    v_out = syn1neg[tgt]
    logits = torch.einsum("bd,bkd->bk", v_in, v_out)
    g = (lbl - torch.sigmoid(logits)) * lr
    d_in = torch.einsum("bk,bkd->bd", g, v_out)
    d_out = torch.einsum("bk,bd->bkd", g, v_in)
    syn1neg = syn1neg.index_add(0, tgt.reshape(-1),
                                d_out.reshape(-1, d_out.shape[-1]))
    return d_in, syn1neg


@register("skipgram", aliases=["SkipGram", "sg"])
def skipgram(syn0, syn1neg, center, context, neg, lr=0.025):
    """Fused skip-gram negative-sampling update; returns (syn0,
    syn1neg)."""
    center = center.long()
    tgt = torch.cat([context.long()[:, None], neg.long()], dim=1)
    d_in, syn1neg = _neg_sampling(syn0, syn1neg, syn0[center], tgt, lr)
    return syn0.index_add(0, center, d_in), syn1neg


@register("cbow", aliases=["CBOW"])
def cbow(syn0, syn1neg, context_words, target, neg, lr=0.025):
    """Fused CBOW negative-sampling update; the (B, W) context
    averaged."""
    ctx = context_words.long()
    tgt = torch.cat([target.long()[:, None], neg.long()], dim=1)
    v_in = torch.mean(syn0[ctx], dim=1)
    d_in, syn1neg = _neg_sampling(syn0, syn1neg, v_in, tgt, lr)
    d_in = d_in / ctx.shape[1]
    syn0 = syn0.index_add(0, ctx.reshape(-1),
                          torch.repeat_interleave(d_in, ctx.shape[1], dim=0))
    return syn0, syn1neg


# ----------------------------------------------------- fused attention op
@register("multi_head_dot_product_attention", num_outputs=1,
          aliases=["MultiHeadDotProductAttentionOp"])
def mh_attention(q, k, v, wq, wk, wv, wo, mask=None, causal=False):
    """Projected multi-head attention as one registry op: inputs (N, T,
    D), heads from wq (D, H, Dh). The attention core is
    ``standard.routed_attention`` at 1/sqrt(Dh), causal top-left aligned:
    K1 (and K2 under autograd) where ``attention_route`` says "kernel",
    else the plain arithmetic over f32 scores (the reference scores bf16
    inputs in bf16)."""
    def proj(x, w):
        return torch.einsum("ntd,dhk->nhtk", x, w)

    o = routed_attention(proj(q, wq), proj(k, wk), proj(v, wv), mask,
                         bool(causal))
    return torch.einsum("nhtk,hkd->ntd", o, wo)


# ---------------------------------------------------- tranche-4 stragglers
@register("maxout", aliases=["Maxout"])
def maxout(x, channels=2):
    """Max over groups of ``channels`` features."""
    c = int(channels)
    shp = tuple(x.shape[:-1]) + (x.shape[-1] // c, c)
    return torch.amax(x.reshape(shp), dim=-1)


@register("tri", aliases=["Tri"])
def _tri(rows, cols=None, diag=0):
    n = int(rows)
    m = int(cols) if cols is not None else n
    return torch.tril(torch.ones((n, m), dtype=torch.float32), int(diag))


@register("sufficient_statistics", num_outputs=3,
          aliases=["SufficientStatistics"])
def sufficient_statistics(x, axes):
    """(count, Σx, Σx²) over ``axes``."""
    axes = tuple(_ints(axes))
    count = float(np.prod([x.shape[a] for a in axes]))
    return (torch.tensor(count, dtype=x.dtype, device=x.device),
            torch.sum(x, dim=axes), torch.sum(torch.square(x), dim=axes))


# no TF aliases: standard's ``batchnorm`` owns the FusedBatchNorm family
# with the inference signature; this is the training-mode form
@register("fused_batch_norm", num_outputs=3)
def fused_batch_norm(x, scale, offset, mean=None, variance=None,
                     epsilon=1e-3, is_training=True):
    """TF training-mode FusedBatchNorm over NHWC: (y, batch_mean,
    batch_var), y normalised by the biased batch variance, the returned
    variance Bessel-corrected; the statistics in the moving variables'
    type (the incoming mean's, else scale's)."""
    stat_dtype = (mean if mean is not None else scale).dtype
    if is_training or mean is None:
        n = float(np.prod([x.shape[i] for i in (0, 1, 2)]))
        mean, variance = one_pass_moments(x, (0, 1, 2))
        var_out = variance * (n / max(n - 1.0, 1.0))
    else:
        var_out = variance
    inv = torch.rsqrt(variance + epsilon)
    y = (x - mean) * inv * scale + offset
    return y.to(x.dtype), mean.to(stat_dtype), var_out.to(stat_dtype)


@register("histogram", aliases=["Histogram"])
def histogram(x, num_bins=10):
    """Equal-width histogram over [min, max]."""
    n = int(num_bins)
    lo, hi = torch.min(x), torch.max(x)
    width = torch.clamp_min(hi - lo, 1e-12)
    idx = torch.clamp(((x - lo) / width * n).to(torch.int32), 0, n - 1)
    out = torch.zeros((n,), dtype=torch.int32, device=x.device)
    return out.index_add(0, idx.reshape(-1).long(),
                         torch.ones(idx.numel(), dtype=torch.int32,
                                    device=x.device))


@register("boolean_mask", num_outputs=2, aliases=["BooleanMask"])
def boolean_mask(x, mask):
    """Rows where ``mask`` holds compacted to the front, zero-filled tail,
    and their count (static-shape tf.boolean_mask)."""
    m = mask.reshape(-1).bool()
    flat = x.reshape((m.shape[0],) + tuple(x.shape[mask.dim():]))
    order, first = _compact(m, flat)
    first = first.reshape((-1,) + (1,) * (flat.dim() - 1))
    vals = torch.where(first, flat[order], torch.zeros_like(flat))
    return vals, torch.sum(m).to(torch.int32)


@register("sparse_to_dense", aliases=["SparseToDense"])
def sparse_to_dense(indices, values, dense_shape=None, default_value=0):
    """COO scatter; ``dense_shape`` a static attribute."""
    shape = tuple(_ints(dense_shape))
    dt = values.dtype if isinstance(values, torch.Tensor) else torch.float32
    dev = values.device if isinstance(values, torch.Tensor) else \
        indices.device
    out = torch.full(shape, default_value, dtype=dt, device=dev)
    idx = indices.long().reshape(-1, len(shape))
    vals = values if isinstance(values, torch.Tensor) else torch.tensor(
        values, dtype=dt, device=dev)
    return out.index_put(tuple(idx[:, i] for i in range(len(shape))),
                         torch.broadcast_to(vals, (idx.shape[0],)))


@register("sparse_dense_matmul", aliases=["SparseTensorDenseMatMul"])
def sparse_dense_matmul(indices, values, dense_shape, b):
    """(sparse A in COO) @ (dense B): B's rows gathered by A's column
    indices, scaled and summed per A row."""
    a_rows = _ints(dense_shape)[0]
    idx = indices.long()
    rows, cols = idx[:, 0], idx[:, 1]
    contrib = values[:, None] * b[cols]
    out = torch.zeros((a_rows, b.shape[1]), dtype=contrib.dtype,
                      device=b.device)
    return out.index_add(0, rows, contrib)


@register("log_matrix_determinant", num_outputs=2,
          aliases=["LogMatrixDeterminant"])
def log_matrix_determinant(x):
    sign, logdet = torch.linalg.slogdet(x)
    return sign, logdet


@register("reduce_sqnorm", aliases=["SquaredNorm"])
def _reduce_sqnorm(x, axis=None, keepdims=False):
    sq = torch.square(x)
    if x.dim() == 0:
        return sq
    dims = tuple(range(x.dim())) if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),))
    return torch.sum(sq, dim=dims, keepdim=keepdims)


@register("matrix_diag_part", aliases=["MatrixDiagPartV3Op"])
def matrix_diag_part(x):
    """Main diagonal of the last two axes."""
    return torch.diagonal(x, dim1=-2, dim2=-1)


# ----------------------------------------------- ONNX-layout recurrent ops
def _onnx_dirs(x, num_dirs, direction, run_dir):
    """Forward, reverse or bidirectional: ``run_dir(di, xd)`` returns (y
    (T, B, H), *finals); outputs stack to (T, D, B, H) and (D, B, H)."""
    dirs = ["forward"] if num_dirs == 1 else ["forward", "reverse"]
    if direction == "reverse":
        dirs = ["reverse"]
    outs, finals = [], None
    for di, kind in enumerate(dirs):
        xd = torch.flip(x, (0,)) if kind == "reverse" else x
        res = run_dir(di, xd)
        y, rest = res[0], res[1:]
        if kind == "reverse":
            y = torch.flip(y, (0,))
        outs.append(y)
        if finals is None:
            finals = [[] for _ in rest]
        for slot, v in zip(finals, rest):
            slot.append(v)
    return (torch.stack(outs, 1), *[torch.stack(s, 0) for s in finals])


def _onnx_lstm_dir(x, w, r, wb, rb, h0, c0):
    """One direction: x (T, B, I); w (4H, I); r (4H, H); gates i, o, f,
    c."""
    hsz = r.shape[1]
    h, c = h0, c0
    ys = []
    for t in range(x.shape[0]):
        z = x[t] @ w.T + h @ r.T + wb + rb
        i, o, f = (torch.sigmoid(z[:, a * hsz:(a + 1) * hsz])
                   for a in range(3))
        c = f * c + i * torch.tanh(z[:, 3 * hsz:])
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), h, c


def _zeros(shape, like):
    return torch.zeros(shape, dtype=like.dtype, device=like.device)


@register("onnx_lstm", num_outputs=3, aliases=["OnnxLSTM"])
def onnx_lstm(x, w, r, b=None, h0=None, c0=None, direction="forward"):
    """ONNX LSTM: x (T, B, I), W (D, 4H, I), R (D, 4H, H), B (D, 8H);
    gates i, o, f, c; default activations. Returns (Y (T, D, B, H), Y_h
    (D, B, H), Y_c)."""
    bsz = x.shape[1]
    d, four_h, hsz = w.shape[0], w.shape[1], r.shape[2]
    b = _zeros((d, 2 * four_h), x) if b is None else b
    h0 = _zeros((d, bsz, hsz), x) if h0 is None else h0
    c0 = _zeros((d, bsz, hsz), x) if c0 is None else c0
    return _onnx_dirs(x, d, direction, lambda di, xd: _onnx_lstm_dir(
        xd, w[di], r[di], b[di, :four_h], b[di, four_h:], h0[di], c0[di]))


@register("onnx_gru", num_outputs=2, aliases=["OnnxGRU"])
def onnx_gru(x, w, r, b=None, h0=None, direction="forward",
             linear_before_reset=0):
    """ONNX GRU: gates z, r, h; torch exports linear_before_reset=1."""
    bsz = x.shape[1]
    d, three_h, hsz = w.shape[0], w.shape[1], r.shape[2]
    b = _zeros((d, 2 * three_h), x) if b is None else b
    h0 = _zeros((d, bsz, hsz), x) if h0 is None else h0

    def one(di, xd):
        wd, rd = w[di], r[di]
        wbd, rbd = b[di, :three_h], b[di, three_h:]
        h = h0[di]
        ys = []
        for t in range(xd.shape[0]):
            xz = xd[t] @ wd.T + wbd
            hz = h @ rd.T + rbd
            z = torch.sigmoid(xz[:, :hsz] + hz[:, :hsz])
            rr = torch.sigmoid(xz[:, hsz:2 * hsz] + hz[:, hsz:2 * hsz])
            if linear_before_reset:
                ht = torch.tanh(xz[:, 2 * hsz:] + rr * hz[:, 2 * hsz:])
            else:
                ht = torch.tanh(xz[:, 2 * hsz:] + (rr * h) @ rd[2 * hsz:].T
                                + rbd[2 * hsz:])
            h = (1 - z) * ht + z * h
            ys.append(h)
        return torch.stack(ys), h

    return _onnx_dirs(x, d, direction, one)


@register("onnx_rnn", num_outputs=2, aliases=["OnnxRNN"])
def onnx_rnn(x, w, r, b=None, h0=None, direction="forward"):
    """ONNX vanilla RNN (tanh)."""
    bsz = x.shape[1]
    d, hsz = w.shape[0], r.shape[2]
    b = _zeros((d, 2 * hsz), x) if b is None else b
    h0 = _zeros((d, bsz, hsz), x) if h0 is None else h0

    def one(di, xd):
        h = h0[di]
        ys = []
        for t in range(xd.shape[0]):
            h = torch.tanh(xd[t] @ w[di].T + h @ r[di].T + b[di, :hsz]
                           + b[di, hsz:])
            ys.append(h)
        return torch.stack(ys), h

    return _onnx_dirs(x, d, direction, one)


@register("deconv2d_nchw", aliases=["ConvTransposeNCHW"])
def deconv2d_nchw(x, w, b=None, strides=(1, 1), padding=((0, 0), (0, 0))):
    """NCHW transposed conv over ONNX/torch (Cin, Cout, kH, kW) weights:
    the full output ((in − 1)·s + k), cropped by the ONNX pads."""
    pad = _pairs(padding)
    full = F.conv_transpose2d(x, w, None, tuple(int(s) for s in strides))
    (lo_h, hi_h), (lo_w, hi_w) = pad
    out = full[:, :, lo_h: full.shape[2] - hi_h or None,
               lo_w: full.shape[3] - hi_w or None]
    return out + b.reshape(1, -1, 1, 1) if b is not None else out


@register("scatter_elements", aliases=["ScatterElements"])
def scatter_elements(x, indices, updates, axis=0, reduction="none"):
    """ONNX ScatterElements / torch scatter: per-element writes along one
    axis."""
    axis = int(axis) % x.dim()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    updates = updates.to(x.dtype)
    if reduction in ("none", "", None):
        return x.scatter(axis, idx, updates)
    if reduction == "add":
        return x.scatter_add(axis, idx, updates)
    red = {"mul": "prod", "min": "amin", "max": "amax"}.get(reduction)
    if red is None:
        raise ValueError(f"scatter_elements: unknown reduction "
                         f"{reduction!r}")
    return x.scatter_reduce(axis, idx, updates, red, include_self=True)


register("trilu", lambda x, k=0, upper=True:
         (torch.triu(x, int(k)) if upper else torch.tril(x, int(k))),
         aliases=["Trilu"])
register("hardmax", lambda x, axis=-1: F.one_hot(
    torch.argmax(x, dim=axis), x.shape[axis]).movedim(-1, axis).to(x.dtype),
    aliases=["Hardmax"])
register("global_maxpool_nchw", lambda x: torch.amax(x, dim=(2, 3),
                                                     keepdim=True),
         aliases=["GlobalMaxPoolNCHW"])
register("shrink", lambda x, bias=0.0, lambd=0.5: torch.where(
    x < -lambd, x + bias, torch.where(x > lambd, x - bias,
                                      torch.zeros_like(x))),
    aliases=["Shrink"])
register("celu", lambda x, alpha=1.0: torch.clamp_min(x, 0)
         + torch.clamp_max(alpha * torch.expm1(x / alpha), 0),
         aliases=["Celu"])


@register("group_norm", aliases=["GroupNormalization", "group_normalization"])
def group_norm(x, scale, bias, num_groups, epsilon=1e-5):
    """NCHW group normalisation (ONNX GroupNormalization), statistics in
    at least f32."""
    n, c = x.shape[0], x.shape[1]
    g = int(num_groups)
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    mu, var = one_pass_moments(xg, tuple(range(2, xg.dim())), keepdim=True)
    xn = ((xg - mu) * torch.rsqrt(var + epsilon)).reshape(x.shape).to(x.dtype)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return xn * scale.reshape(shape) + bias.reshape(shape)


@register("reduce_logsumexp_axes", aliases=["ReduceLogSumExpOp"])
def _reduce_logsumexp_axes(x, axis=None, keepdims=False):
    dims = tuple(range(x.dim())) if axis is None else (
        tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),))
    xf = x if x.is_floating_point() else x.float()
    return torch.logsumexp(xf, dim=dims, keepdim=keepdims)


register("truncatemod", lambda a, b: torch.fmod(a, b),
         aliases=["TruncateMod", "fmod_op"])
