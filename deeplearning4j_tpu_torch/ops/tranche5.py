"""The registry's fifth tranche: counterparts of the JAX package's
``ops/tranche5.py`` (the legacy ``to_*`` casts, the legacy random family,
the reduce3 distances, linalg stragglers, arithmetic spellings, CTC
decoders, debug and state ops, attention v2 and its ``_bp``, and the
reference's alternate spellings bound as aliases of existing ops).

``dot_product_attention_v2`` takes ``standard.routed_attention`` (K1 on
the card where ``attention_route`` says "kernel");
``multi_head_dot_product_attention_bp`` is autograd over the routed
forward, so on the card it launches K2. The random ops take the
``generator`` keyword of ``tranche4.generator_for``.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.ops.extended import _popcount, _wrap
from deeplearning4j_tpu_torch.ops.registry import exec_op, register
from deeplearning4j_tpu_torch.ops.standard import promote_mm, routed_attention
from deeplearning4j_tpu_torch.ops.tranche4 import generator_for, vjp


# ------------------------------------------------------------- legacy casts
# 64-bit targets narrow as the reference's x32 mode narrows them; a
# float goes to an unsigned type saturating at 0, as XLA converts it
def _cast(dtype):
    def op(x):
        if x.is_floating_point() and dtype in (torch.uint8, torch.uint16,
                                               torch.uint32):
            x = torch.clamp(x, 0, torch.iinfo(dtype).max)
        return x.to(dtype)
    return op


for _name, _t in [("to_double", torch.float64), ("to_float32", torch.float32),
                  ("to_float16", torch.float16), ("to_int32", torch.int32),
                  ("to_int64", torch.int64), ("to_uint32", torch.uint32),
                  ("to_uint64", torch.uint64)]:
    register(_name, _cast(_dt.canonical(_t)))


# ---------------------------------------------------- legacy random family
# key-optional draws: a ``seed`` seeds its own generator, else the
# ``generator`` the graph engine hands the op, else torch's default
def _draw(fn, shape, seed, generator):
    gen = generator_for(seed, generator)
    dev = gen.device if gen is not None else None
    return fn(tuple(int(s) for s in shape), gen, dev)


@register("normal")
def _normal(shape, mean=0.0, stddev=1.0, seed=None, generator=None):
    return mean + stddev * _draw(lambda s, g, d: torch.randn(
        s, generator=g, device=d), shape, seed, generator)


@register("uniform")
def _uniform(shape, minval=0.0, maxval=1.0, seed=None, generator=None):
    u = _draw(lambda s, g, d: torch.rand(s, generator=g, device=d), shape,
              seed, generator)
    return u * (maxval - minval) + minval


@register("truncatednormal")
def _truncatednormal(shape, mean=0.0, stddev=1.0, seed=None, generator=None):
    """Normal draws truncated to two standard deviations (by the inverse
    CDF of a uniform over the kept mass)."""
    u = _draw(lambda s, g, d: torch.rand(s, generator=g, device=d), shape,
              seed, generator)
    lo = 0.5 * (1 + torch.special.erf(torch.tensor(-2.0 / 2 ** 0.5)))
    hi = 0.5 * (1 + torch.special.erf(torch.tensor(2.0 / 2 ** 0.5)))
    p = lo.to(u.device) + u * (hi - lo).to(u.device)
    z = (2 ** 0.5) * torch.special.erfinv(2 * p - 1)
    return mean + stddev * torch.clamp(z, -2.0, 2.0)


@register("lognormal")
def _lognormal(shape, mean=0.0, stddev=1.0, seed=None, generator=None):
    return torch.exp(mean + stddev * _draw(lambda s, g, d: torch.randn(
        s, generator=g, device=d), shape, seed, generator))


@register("binomial")
def _binomial(shape, trials=1, p=0.5, seed=None, generator=None):
    u = _draw(lambda s, g, d: torch.rand((int(trials),) + s, generator=g,
                                         device=d), shape, seed, generator)
    return torch.sum(u < p, dim=0).to(torch.float32)


@register("exponential_distribution")
def _exponential(shape, lam=1.0, seed=None, generator=None):
    return _draw(lambda s, g, d: torch.empty(s, device=d).exponential_(
        generator=g), shape, seed, generator) / lam


_SEED = [0]


@register("set_seed")
def _set_seed(seed):
    """Seeds torch's default generator (the reference seeds its global
    random state)."""
    _SEED[0] = int(seed)
    torch.manual_seed(int(seed))
    return torch.tensor(int(seed), dtype=torch.int32)


@register("get_seed")
def _get_seed():
    return torch.tensor(_SEED[0], dtype=torch.int32)


# ------------------------------------------------------ reduce3 distances
def _r3(fn):
    def f(x, y, *dims, keepdims=False):
        return fn(x, y, tuple(dims) or None, keepdims)
    return f


def _sum(x, axis, kd):
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis,
                                                       keepdim=kd)


register("euclidean", _r3(lambda x, y, ax, kd: torch.sqrt(
    _sum(torch.square(x - y), ax, kd))))
register("manhattan", _r3(lambda x, y, ax, kd: _sum(torch.abs(x - y), ax,
                                                     kd)))


@register("cosinesim")
def _cosinesim(x, y, *dims, keepdims=False, eps=1e-12):
    axis = tuple(dims) or None
    num = _sum(x * y, axis, keepdims)
    den = (torch.sqrt(_sum(torch.square(x), axis, keepdims))
           * torch.sqrt(_sum(torch.square(y), axis, keepdims)))
    return num / torch.clamp_min(den, eps)


register("cosinedistance",
         lambda x, y, *d, **k: 1.0 - exec_op("cosinesim", x, y, *d, **k))


@register("hammingdistance")
def _hamming(x, y, *dims, keepdims=False):
    return _sum((x != y).to(torch.float32), tuple(dims) or None, keepdims)


@register("jaccarddistance")
def _jaccard(x, y, *dims, keepdims=False, eps=1e-12):
    axis = tuple(dims) or None
    inter = _sum(torch.minimum(x, y), axis, keepdims)
    union = _sum(torch.maximum(x, y), axis, keepdims)
    return 1.0 - inter / torch.clamp_min(union, eps)


# ------------------------------------------------------------------ linalg
@register("cholesky_solve")
def _cholesky_solve(chol, rhs, lower=True):
    vec = rhs.dim() == chol.dim() - 1
    b = rhs.unsqueeze(-1) if vec else rhs
    out = torch.cholesky_solve(b, chol, upper=not lower)
    return out.squeeze(-1) if vec else out


@register("sqrtm")
def _sqrtm(x):
    """The principal square root's real part, by eigendecomposition (the
    reference takes Schur's; both give the principal root of a
    diagonalisable matrix)."""
    w, v = torch.linalg.eig(x)
    r = v @ torch.diag_embed(torch.sqrt(w)) @ torch.linalg.inv(v)
    return r.real.to(x.dtype)


@register("gemm")
def _gemm(a, b, c=None, alpha=1.0, beta=0.0, transA=False, transB=False):
    """alpha·op(A)·op(B) + beta·C."""
    a = a.T if transA else a
    b = b.T if transB else b
    out = alpha * promote_mm(a, b)
    return out + beta * c if c is not None else out


@register("gemv")
def _gemv(a, x, y=None, alpha=1.0, beta=0.0, transA=False):
    a = a.T if transA else a
    out = alpha * promote_mm(a, x.reshape(-1))
    return out + beta * y.reshape(-1) if y is not None else out


register("dot_product", lambda x, y: torch.sum(x * y))


# -------------------------------------------------------------- arithmetic
register("floormod", torch.remainder)
register("remainder", torch.remainder)
register("reversemod", lambda x, y: torch.remainder(y, x))
register("max_pairwise", torch.maximum)
register("min_pairwise", torch.minimum)
register("assign_add", lambda x, y: x + y)
register("assign_sub", lambda x, y: x - y)
register("set_scalar", lambda x, value: torch.full_like(x, value))
register("compare_and_set", lambda x, compare, set_to, eps=1e-9:
         torch.where(torch.abs(x - compare) < eps,
                     torch.as_tensor(set_to, dtype=x.dtype, device=x.device),
                     x))


@register("popcount", aliases=["bitcount", "countBits"])
def _popcount_op(x):
    if x.is_floating_point() or x.dtype == torch.bool:
        x = x.to(torch.int32)
    return _popcount(x)


@register("cyclic_rshift_bits")
def _cyclic_rshift(x, shift):
    """Rotate right within the input's own width, as its unsigned type."""
    bits = torch.iinfo(x.dtype).bits
    s = int(shift) % bits
    if s == 0:
        return x
    mask = (1 << bits) - 1
    v = x.to(torch.int64) & mask
    return _wrap(((v >> s) | (v << (bits - s))) & mask, x.dtype)


# ------------------------------------------------- activations/derivatives
register("tanhderivative", lambda x: 1.0 - torch.square(torch.tanh(x)))


@register("softmaxderivative")
def _softmaxderivative(x, axis=-1):
    s = torch.softmax(x, dim=axis)
    return s * (1.0 - s)


@register("alpha_dropout")
def _alpha_dropout(x, p=0.5, seed=None, training=True, generator=None):
    """SELU-preserving dropout: dropped units take the SELU saturation
    value, then an affine map keeps the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    gen = generator_for(seed, generator, x.device)
    dev = gen.device if gen is not None else x.device
    keep = (torch.rand(x.shape, generator=gen, device=dev) < 1.0 - p).to(
        x.device)
    a = 1.0 / ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** 0.5
    b = -a * p * alpha_p
    return a * torch.where(keep, x, torch.full_like(x, alpha_p)) + b


# ------------------------------------------------------------------ losses
@register("softmax_cross_entropy_with_logits",
          aliases=["SoftmaxCrossEntropyWithLogits"])
def _sce_logits(logits, labels, axis=-1):
    return -torch.sum(labels * torch.log_softmax(logits, dim=axis), dim=axis)


@register("ctc_loss_grad")
def _ctc_loss_grad(log_probs, labels, logit_lengths, label_lengths,
                   blank_id=0):
    """Gradient of the summed ctc_loss with respect to the
    log-probabilities."""
    return vjp(lambda lp: torch.sum(exec_op(
        "ctc_loss", lp, labels, logit_lengths, label_lengths,
        blank_id=blank_id)), (log_probs,),
        torch.ones((), device=log_probs.device))[0]


# ---------------------------------------------------------------- decoders
@register("ctc_greedy_decoder", num_outputs=2)
def _ctc_greedy(log_probs, seq_lengths=None, blank_id=0, merge_repeated=True):
    """Best-path decode: (decoded (B, T) padded with -1, the negative sum
    of the best log-probabilities over the valid frames)."""
    path = torch.argmax(log_probs, dim=-1)
    best = torch.amax(log_probs, dim=-1)
    b_len, t_len = path.shape
    if seq_lengths is not None:
        valid = (torch.arange(t_len, device=path.device)[None, :]
                 < seq_lengths.to(path.device)[:, None])
        path = torch.where(valid, path, torch.full_like(path, blank_id))
        best = torch.where(valid, best, torch.zeros_like(best))
    score = -torch.sum(best, dim=-1)
    decoded = np.full((b_len, t_len), -1, np.int32)
    p = path.cpu().numpy()
    for b in range(b_len):
        prev, j = -1, 0
        for t in range(t_len):
            tok = int(p[b, t])
            if tok != blank_id and not (merge_repeated and tok == prev):
                decoded[b, j] = tok
                j += 1
            prev = tok if not (merge_repeated and tok == blank_id) else -1
    return torch.as_tensor(decoded, device=log_probs.device), score


@register("ctc_beam", aliases=["ctc_beam_decoder"])
def _ctc_beam(log_probs, beam_width=4, blank_id=0):
    """Prefix beam-search decode on the host: each batch row's best label
    sequence, padded with -1."""
    lp = log_probs.detach().float().cpu().numpy()
    b_len, t_len, n_cls = lp.shape
    out = np.full((b_len, t_len), -1, np.int32)
    for b in range(b_len):
        beams = {(): (0.0, -np.inf)}        # prefix -> (p_blank, p_nonblank)
        for t in range(t_len):
            nxt = {}
            for prefix, (pb, pnb) in beams.items():
                for c in range(n_cls):
                    p = lp[b, t, c]
                    if c == blank_id:
                        key, add = prefix, (np.logaddexp(pb, pnb) + p,
                                            -np.inf)
                    elif prefix and prefix[-1] == c:
                        key, add = prefix, (-np.inf, pnb + p)
                        k2 = prefix + (c,)
                        o = nxt.get(k2, (-np.inf, -np.inf))
                        nxt[k2] = (o[0], np.logaddexp(o[1], pb + p))
                    else:
                        key, add = prefix + (c,), (
                            -np.inf, np.logaddexp(pb, pnb) + p)
                    o = nxt.get(key, (-np.inf, -np.inf))
                    nxt[key] = (np.logaddexp(o[0], add[0]),
                                np.logaddexp(o[1], add[1]))
            beams = dict(sorted(nxt.items(),
                                key=lambda kv: -np.logaddexp(*kv[1]))
                         [:int(beam_width)])
        best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0]
        out[b, :len(best)] = best
    return torch.as_tensor(out, device=log_probs.device)


# --------------------------------------------------------------- attention
@register("dot_product_attention_v2", aliases=["DotProductAttentionV2"])
def _dpa_v2(q, k, v, scale=None, dropout_p=0.0, causal=False, mask=None):
    """Attention with scale, causal and mask attributes in one op
    (``dropout_p`` is not applied, as in the reference): f32 scores, the
    weights in q's dtype; K1/K2 where ``attention_route`` says
    "kernel"."""
    return routed_attention(q, k, v, mask, bool(causal),
                            1.0 / float(q.shape[-1]) ** 0.5
                            if scale is None else float(scale))


@register("multi_head_dot_product_attention_bp", num_outputs=7)
def _mhdpa_bp(q, k, v, wq, wk, wv, wo, dout, mask=None, causal=False):
    """Gradients with respect to all seven inputs: autograd over the
    routed forward (K2 on the card)."""
    return vjp(lambda *args: exec_op("multi_head_dot_product_attention",
                                     *args, mask=mask, causal=causal),
               (q, k, v, wq, wk, wv, wo), dout)


@register("standardize_bp")
def _standardize_bp(x, dout, axis=-1, epsilon=1e-5):
    return vjp(lambda t: exec_op("standardize", t, axis=axis,
                                 epsilon=epsilon), (x,), dout)[0]


# ----------------------------------------------------------- structural
register("parallel_stack", lambda *xs: torch.stack(xs, dim=0),
         aliases=["ParallelConcat"])
register("where_np", lambda cond, x=None, y=None:
         torch.where(cond.bool(), x, y) if x is not None
         else torch.nonzero(cond))
register("flatten_2d", lambda x, axis=1: x.reshape(
    (int(np.prod(x.shape[:axis])) if axis else 1, -1)),
    aliases=["Flatten2D"])
register("order", lambda x, order="c": x)


@register("shapes_of", num_outputs=-1)
def _shapes_of(*xs):
    return tuple(torch.tensor(tuple(x.shape), dtype=torch.int32,
                              device=x.device) for x in xs)


@register("tear", num_outputs=-1)
def _tear(x, *dims):
    """Sub-tensors along the first dim not listed in ``dims``."""
    keep = tuple(d for d in range(x.dim()) if d not in dims) or (0,)
    moved = torch.movedim(x, keep[0], 0)
    return tuple(moved[i] for i in range(moved.shape[0]))


@register("logentropy")
def _logentropy(x, *dims):
    p = torch.abs(x)
    e = -_sum(p * torch.log(torch.clamp_min(p, 1e-12)), tuple(dims) or None,
              False)
    return torch.log(torch.clamp_min(e, 1e-12))


@register("biasadd", aliases=["BiasAdd", "biasadd_bp_passthrough"])
def _biasadd(x, bias, data_format="NHWC"):
    if data_format in ("NCHW", "channels_first") and x.dim() > 2:
        return x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return x + bias


@register("grs_to_rgb", aliases=["GrayscaleToRgb"])
def _grs_to_rgb(x):
    if x.shape[-1] == 1:
        return torch.broadcast_to(x, tuple(x.shape[:-1]) + (3,))
    return torch.stack([x] * 3, dim=-1)


@register("apply_gradient_descent", aliases=["ApplyGradientDescent"])
def _apply_gd(params, grads, lr=0.1):
    return params - lr * grads


@register("compat_sparse_to_dense")
def _compat_sparse_to_dense(indices, shape, values, default=0.0):
    shp = tuple(int(s) for s in np.asarray(
        shape.cpu() if isinstance(shape, torch.Tensor) else shape))
    vals = values if isinstance(values, torch.Tensor) else torch.as_tensor(
        values)
    out = torch.full(shp, default, dtype=vals.dtype, device=vals.device)
    idx = torch.as_tensor(indices, device=vals.device).long()
    return out.index_put(tuple(idx.T), torch.broadcast_to(
        vals, (idx.shape[0],)))


@register("compat_string_split", num_outputs=2)
def _compat_string_split(strings, delimiter=" "):
    """Host string split: (indices (n, 2), values), numpy arrays (strings
    have no tensor type)."""
    arr = np.asarray(strings).reshape(-1)
    idx, vals = [], []
    for i, s in enumerate(arr):
        for j, tok in enumerate(str(s).split(delimiter)):
            idx.append((i, j))
            vals.append(tok)
    return np.asarray(idx, np.int64), np.asarray(vals, object)


@register("expose")
def _expose(*xs):
    """Identity pass-through marking graph outputs."""
    return xs if len(xs) > 1 else xs[0]


@register("print_variable")
def _print_variable(x, message=""):
    print(f"{message}{x}")
    return x


@register("print_affinity")
def _print_affinity(x):
    print(f"device: {x.device}")
    return x


# ----------------------------------- reference alternate-spelling aliases
_alias = registry.alias      # raises on collision with a different op


register("hard_swish", lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
         aliases=["hardswish", "HardSwish"])


@register("reduce_norm_max", aliases=["norm_max", "normmax_reduce"])
def _reduce_norm_max(x, *dims, keepdims=False):
    a = torch.abs(x)
    return torch.amax(a) if not dims else torch.amax(a, dim=tuple(dims),
                                                     keepdim=keepdims)


_alias("conv3d", "conv3dnew")
_alias("avgpool3d", "avgpool3dnew")
_alias("maxpool3d", "maxpool3dnew")
_alias("deconv2d", "deconv2d_tf")
_alias("hard_tanh", "hardtanh")
_alias("hard_sigmoid", "hardsigmoid")
_alias("clipbynorm", "clip_by_norm")
_alias("clip_by_avg_norm", "clipbyavgnorm")
_alias("clip_by_global_norm", "clipbyglobalnorm")
_alias("gru_cell", "gruCell")
_alias("lstm_cell", "lstmCell")
_alias("sru_cell", "sruCell")
_alias("lstm_block", "lstmBlock")
_alias("sigmoid_cross_entropy", "sigm_cross_entropy")
_alias("static_bidirectional_rnn", "bidirectional")
_alias("dot_product_attention", "attention")
_alias("batchnorm", "batch_norm")
_alias("non_max_suppression", "nms_v3", "non_max_suppression_v3")
_alias("isnan", "is_nan")
_alias("isinf", "is_inf")
_alias("isfinite", "is_finite")
_alias("crop_and_resize", "cropandresize")
_alias("Assert", "assert")
_alias("match_condition", "matchcondition")
