"""The registry's fourth tranche: counterparts of the JAX package's
``ops/tranche4.py`` (morphology, quantization and compression, the
updater ops, the explicit backward ``_bp`` ops, the legacy derivative
transforms, the index reductions, Barnes-Hut t-SNE helpers, stragglers).

Each ``_bp`` op is ``torch.autograd.grad`` over the registered forward,
where the reference takes ``jax.vjp``. The ops that draw without a key
(``random_multinomial``, ``bernoulli_sample``) take a ``generator``
keyword, which the graph engine hands them (``autodiff/samediff.py``); a
``seed`` attribute seeds a generator of its own, as the reference seeds a
key, and with neither they draw from torch's default generator, where
the reference draws from its global random state.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops.registry import _REGISTRY, exec_op, register


def generator_for(seed=None, generator=None, device=None):
    """The generator a drawing op uses: one seeded with ``seed`` (on
    ``generator``'s device, else ``device``), else ``generator``, else
    None (torch's default generator)."""
    if seed is not None:
        dev = generator.device if generator is not None else (
            device if device is not None else "cpu")
        return torch.Generator(device=dev).manual_seed(int(seed))
    return generator


# ------------------------------------------------------------ named aliases
# the reference's spelling variants of ops registered earlier
_REGISTRY["max_pool_with_argmax"] = _REGISTRY["maxpool_with_argmax"]
_REGISTRY["softmax_cross_entropy_loss"] = _REGISTRY["softmax_cross_entropy"]
_REGISTRY["sigmoid_cross_entropy_loss"] = _REGISTRY["sigmoid_cross_entropy"]
_REGISTRY["batch_matmul"] = _REGISTRY["batched_gemm"]


# --------------------------------------------------------------- morphology
@register("erosion2d", aliases=["Erosion2D"])
def erosion2d(x, w, strides=(1, 1), rates=(1, 1), padding="SAME"):
    """Morphological erosion, the dual of dilation2d:
    −dilation2d(−x, reverse(w))."""
    wr = torch.flip(w, (0, 1))
    return -exec_op("dilation2d", -x, wr, strides=strides, rates=rates,
                    padding=padding)


# ------------------------------------------------------------- quantization
def _f32(v, ref):
    return torch.as_tensor(v, dtype=torch.float32, device=ref.device)


@register("quantize", aliases=["Quantize", "quantize_v2"])
def quantize(x, min_range, max_range, num_bits=8, narrow_range=False):
    """Uniform affine quantisation to int32 codes (TF QuantizeV2
    MIN_COMBINED)."""
    lo, hi = _f32(min_range, x), _f32(max_range, x)
    qmin = 1 if narrow_range else 0
    qmax = (1 << int(num_bits)) - 1
    scale = (hi - lo) / (qmax - qmin)
    q = torch.round((x.to(torch.float32) - lo) / scale) + qmin
    return torch.clamp(q, qmin, qmax).to(torch.int32)


@register("dequantize", aliases=["Dequantize"])
def dequantize(q, min_range, max_range, num_bits=8, narrow_range=False):
    lo, hi = _f32(min_range, q), _f32(max_range, q)
    qmin = 1 if narrow_range else 0
    qmax = (1 << int(num_bits)) - 1
    scale = (hi - lo) / (qmax - qmin)
    return (q.to(torch.float32) - qmin) * scale + lo


@register("bucketize", aliases=["Bucketize"])
def bucketize(x, boundaries):
    """Bucket index of each value; ``boundaries`` ascending, result in
    [0, len]."""
    b = _f32(boundaries, x).reshape(-1)
    return torch.searchsorted(b, x.to(torch.float32).contiguous(),
                              side="right").to(torch.int32)


@register("encode_bitmap", num_outputs=2, aliases=["EncodeBitmap"])
def encode_bitmap(x, threshold=1e-3):
    """Sign-flag codec: dense int8 flags {-1, 0, +1} and the residual."""
    t = torch.as_tensor(threshold, dtype=x.dtype, device=x.device)
    flags = ((x >= t).to(torch.int8) - (x <= -t).to(torch.int8))
    return flags, x - flags.to(x.dtype) * t


@register("decode_bitmap", aliases=["DecodeBitmap"])
def decode_bitmap(flags, threshold=1e-3, dtype="float32"):
    dt = _dt.to_torch(dtype)
    return flags.to(dt) * torch.as_tensor(threshold, dtype=dt,
                                          device=flags.device)


# ------------------------------------------------------------- updater ops
# (gradient, state…) → (update, new state…)
@register("sgd_updater")
def sgd_updater(grad, lr=0.01):
    return grad * lr


@register("nesterovs_updater", num_outputs=2)
def nesterovs_updater(grad, v, lr=0.01, momentum=0.9):
    v_new = momentum * v - lr * grad
    return -(momentum * v_new - lr * grad), v_new


@register("adam_updater", num_outputs=3)
def adam_updater(grad, m, v, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                 iteration=0):
    t = iteration + 1
    m_new = beta1 * m + (1 - beta1) * grad
    v_new = beta2 * v + (1 - beta2) * grad * grad
    m_hat = m_new / (1 - beta1 ** t)
    v_hat = v_new / (1 - beta2 ** t)
    return lr * m_hat / (torch.sqrt(v_hat) + eps), m_new, v_new


@register("ada_max_updater", num_outputs=3)
def ada_max_updater(grad, m, u, lr=2e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                    iteration=0):
    t = iteration + 1
    m_new = beta1 * m + (1 - beta1) * grad
    u_new = torch.maximum(beta2 * u, torch.abs(grad))
    return lr * m_new / ((1 - beta1 ** t) * (u_new + eps)), m_new, u_new


@register("nadam_updater", num_outputs=3)
def nadam_updater(grad, m, v, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  iteration=0):
    """Dozat's NAdam: the look-ahead momentum bias-corrected at t + 1, the
    raw-gradient term at t."""
    t = iteration + 1
    m_new = beta1 * m + (1 - beta1) * grad
    v_new = beta2 * v + (1 - beta2) * grad * grad
    v_hat = v_new / (1 - beta2 ** t)
    nud = (beta1 * m_new / (1 - beta1 ** (t + 1))
           + (1 - beta1) * grad / (1 - beta1 ** t))
    return lr * nud / (torch.sqrt(v_hat) + eps), m_new, v_new


@register("ams_grad_updater", num_outputs=4)
def ams_grad_updater(grad, m, v, vhat, lr=1e-3, beta1=0.9, beta2=0.999,
                     eps=1e-8, iteration=0):
    t = iteration + 1
    m_new = beta1 * m + (1 - beta1) * grad
    v_new = beta2 * v + (1 - beta2) * grad * grad
    vhat_new = torch.maximum(vhat, v_new)
    m_c = m_new / (1 - beta1 ** t)
    v_c = vhat_new / (1 - beta2 ** t)
    return lr * m_c / (torch.sqrt(v_c) + eps), m_new, v_new, vhat_new


@register("ada_grad_updater", num_outputs=2)
def ada_grad_updater(grad, h, lr=0.01, eps=1e-8):
    h_new = h + grad * grad
    return lr * grad / (torch.sqrt(h_new) + eps), h_new


@register("ada_delta_updater", num_outputs=3)
def ada_delta_updater(grad, msg, msdx, rho=0.95, eps=1e-6):
    msg_new = rho * msg + (1 - rho) * grad * grad
    update = grad * torch.sqrt(msdx + eps) / torch.sqrt(msg_new + eps)
    msdx_new = rho * msdx + (1 - rho) * update * update
    return update, msg_new, msdx_new


@register("rms_prop_updater", num_outputs=2)
def rms_prop_updater(grad, g2, lr=1e-3, decay=0.95, eps=1e-8):
    g2_new = decay * g2 + (1 - decay) * grad * grad
    return lr * grad / (torch.sqrt(g2_new) + eps), g2_new


# ----------------------------------------------------------- backward (_bp)
def vjp(fn, inputs, grad):
    """Gradients of ``fn(*inputs)`` against ``grad`` for each input (zeros
    where an input does not reach the output), by autograd over detached
    copies: the reference's ``jax.vjp``."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in inputs]
        out = fn(*xs)
        got = torch.autograd.grad(out, xs, grad, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, got))


def _register_bp(name, fwd_name, n_in, **fixed):
    def bp(*args, **attrs):
        xs, g = args[:n_in], args[n_in]
        grads = vjp(lambda *inner: exec_op(fwd_name, *inner,
                                           **{**fixed, **attrs}),
                    xs, g.to(xs[0].dtype))
        return grads if len(grads) > 1 else grads[0]
    bp.__name__ = name
    bp.__doc__ = (f"Backward of {fwd_name}: autograd over the registered "
                  f"forward. Args: {n_in} forward inputs + upstream "
                  f"gradient.")
    register(name, bp, num_outputs=n_in)
    return bp


_register_bp("conv1d_bp", "conv1d", 2)
_register_bp("conv2d_bp", "conv2d", 2)
_register_bp("conv3d_bp", "conv3d", 2)
_register_bp("deconv2d_bp", "deconv2d", 2)
_register_bp("depthwise_conv2d_bp", "depthwise_conv2d", 2)
_register_bp("maxpool2d_bp", "maxpool2d", 1)
_register_bp("avgpool2d_bp", "avgpool2d", 1)
_register_bp("maxpool3d_bp", "maxpool3d", 1)
_register_bp("avgpool3d_bp", "avgpool3d", 1)
_register_bp("pnormpool2d_bp", "pnormpool2d", 1)
_register_bp("upsampling2d_bp", "upsampling2d", 1)
_register_bp("upsampling3d_bp", "upsampling3d", 1)
_register_bp("lrn_bp", "lrn", 1)
_register_bp("layer_norm_bp", "layer_norm", 3)
_register_bp("im2col_bp", "im2col", 1)


@register("biasadd_bp", num_outputs=2, aliases=["BiasAddGrad"])
def biasadd_bp(x, bias, grad):
    """Backward of bias_add: (dx, db)."""
    return grad, torch.sum(grad, dim=tuple(range(grad.dim() - 1)))


@register("batchnorm_bp", num_outputs=3)
def batchnorm_bp(x, mean, var, gamma, beta, grad, epsilon=1e-5):
    """Backward of batchnorm wrt (x, gamma, beta) at fixed statistics."""
    return vjp(lambda x_, g_, b_: exec_op("batchnorm", x_, mean, var, g_, b_,
                                          epsilon=epsilon),
               (x, gamma, beta), grad.to(x.dtype))


@register("dropout_bp")
def dropout_bp(mask, grad, p=0.5):
    """Backward of dropout given the forward's keep mask."""
    return grad * mask / torch.as_tensor(p, dtype=grad.dtype,
                                         device=grad.device)


# -------------------------------------------------- legacy derivative ops
def _register_derivative(name, act_name):
    def deriv(x):
        return vjp(lambda v: exec_op(act_name, v), (x,),
                   torch.ones_like(x))[0]
    deriv.__name__ = name
    deriv.__doc__ = f"d({act_name})/dx, elementwise."
    register(name, deriv)
    return deriv


for _act in ("cube", "elu", "selu", "softsign", "softplus", "hard_sigmoid",
             "hard_tanh", "rationaltanh", "rectifiedtanh", "leakyrelu",
             "relu", "relu6", "swish", "mish", "gelu"):
    _register_derivative(_act.replace("hard_", "hard") + "_derivative", _act)


# ------------------------------------------------------ index-reduce family
def _cond_fn(condition):
    return {"gt": torch.gt, "gte": torch.ge, "lt": torch.lt,
            "lte": torch.le, "eq": torch.eq, "neq": torch.ne,
            "abs_gt": lambda a, v: torch.abs(a) > v,
            "abs_lt": lambda a, v: torch.abs(a) < v}[condition]


@register("first_index")
def first_index(x, condition="gt", value=0.0):
    """Index of the first matching element; -1 when none match."""
    mask = _cond_fn(condition)(x.reshape(-1), value)
    idx = torch.argmax(mask.to(torch.int8))
    return torch.where(torch.any(mask), idx, torch.full_like(idx, -1))


@register("last_index")
def last_index(x, condition="gt", value=0.0):
    flat = x.reshape(-1)
    mask = _cond_fn(condition)(flat, value)
    idx = flat.shape[0] - 1 - torch.argmax(torch.flip(mask, (0,)).to(
        torch.int8))
    return torch.where(torch.any(mask), idx, torch.full_like(idx, -1))


@register("iamax", aliases=["IMax"])
def iamax(x, axis=None):
    """Index of the largest |value|."""
    return torch.argmax(torch.abs(x), dim=axis)


@register("iamin", aliases=["IMin"])
def iamin(x, axis=None):
    return torch.argmin(torch.abs(x), dim=axis)


@register("match_condition", aliases=["MatchCondition"])
def match_condition(x, condition="gt", value=0.0):
    """Count of matching elements."""
    return torch.sum(_cond_fn(condition)(x, value))


@register("match_condition_transform", aliases=["MatchConditionTransform"])
def match_condition_transform(x, condition="gt", value=0.0):
    return _cond_fn(condition)(x, value)


# ------------------------------------------------------ Barnes-Hut t-SNE
@register("barnes_gains")
def barnes_gains(gains, gradient, y_incs):
    """t-SNE gains: +0.2 where gradient and velocity disagree in sign,
    ×0.8 where they agree, floored at 0.01."""
    agree = torch.sign(gradient) == torch.sign(y_incs)
    return torch.clamp_min(torch.where(agree, gains * 0.8, gains + 0.2),
                           0.01)


def _dense(rows, cols, vals, n, accumulate):
    P = torch.zeros((int(n), int(n)), dtype=vals.dtype, device=vals.device)
    return P.index_put((rows.reshape(-1).long(), cols.reshape(-1).long()),
                       vals.reshape(-1), accumulate=accumulate)


@register("barnes_symmetrized")
def barnes_symmetrized(rows, cols, vals, n):
    """P ← (P + Pᵀ)/2 of the COO affinities, dense (N, N)."""
    P = _dense(rows, cols, vals, n, True)
    return (P + P.T) / 2.0


@register("barnes_edge_forces")
def barnes_edge_forces(rows, cols, vals, n, y):
    """Attractive forces Σ_j p_ij (y_i − y_j)/(1 + ‖y_i − y_j‖²)."""
    P = _dense(rows, cols, vals, n, False)
    diff = y[:, None, :] - y[None, :, :]
    w = 1.0 / (1.0 + torch.sum(diff * diff, dim=-1))
    return torch.sum((P * w)[..., None] * diff, dim=1)


@register("cell_contains")
def cell_contains(corner, width, point):
    c, w, p = corner.reshape(-1), width.reshape(-1), point.reshape(-1)
    return torch.all((p >= c - w) & (p <= c + w))


# --------------------------------------------------------------- stragglers
# ternary select: the lowercase spelling of the "where" op
_REGISTRY["select"] = _REGISTRY["where"]


@register("check_numerics", aliases=["CheckNumerics"])
def check_numerics(x, message="CheckNumerics failed"):
    """Pass-through that raises on NaN or Inf (a host sync on the
    card)."""
    if not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError(message)
    return x


@register("is_numeric_tensor", aliases=["IsNumericTensor"])
def is_numeric_tensor(x):
    return torch.tensor(x.dtype != torch.bool, device=x.device)


@register("assert_op", aliases=["Assert"])
def assert_op(cond, *data):
    """Raises when ``cond`` is false anywhere; passes ``cond`` through."""
    if not bool(torch.all(cond)):
        raise AssertionError(
            f"Assert failed: {[d.detach().cpu().numpy() for d in data]}")
    return cond


@register("zeros_as", aliases=["zerosAs"])
def zeros_as(x):
    return torch.zeros_like(x)


@register("ones_as", aliases=["onesAs"])
def ones_as(x):
    return torch.ones_like(x)


@register("random_multinomial", aliases=["RandomMultinomial"])
def random_multinomial(logits, num_samples=1, seed=None, generator=None):
    """(N, num_samples) class draws from each row's logits."""
    gen = generator_for(seed, generator, logits.device)
    probs = torch.softmax(logits.float(), dim=-1)
    if gen is not None and gen.device != logits.device:
        probs = probs.to(gen.device)
    out = torch.multinomial(probs.reshape(-1, probs.shape[-1]),
                            int(num_samples), replacement=True,
                            generator=gen)
    return out.reshape(tuple(logits.shape[:-1]) + (int(num_samples),)).to(
        logits.device)


@register("eig", num_outputs=2)
def eig(x):
    """General eigendecomposition (complex eigenvalues and vectors)."""
    w, v = torch.linalg.eig(x)
    return w, v


def _shape_of(s):
    return tuple(int(v) for v in np.asarray(
        s.detach().cpu() if isinstance(s, torch.Tensor) else s).reshape(-1))


@register("broadcast_dynamic_shape", aliases=["BroadcastDynamicShape"])
def broadcast_dynamic_shape(s1, s2):
    """The broadcast shape of two shape vectors."""
    out = np.broadcast_shapes(_shape_of(s1), _shape_of(s2))
    return torch.tensor(out, dtype=torch.int32)


@register("broadcastgradientargs", num_outputs=2,
          aliases=["BroadcastGradientArgs"])
def broadcastgradientargs(s1, s2):
    """Axes each operand was broadcast over (its gradient's reduction
    axes)."""
    a, b = _shape_of(s1), _shape_of(s2)
    out = np.broadcast_shapes(a, b)
    ndim = len(out)
    ap = (1,) * (ndim - len(a)) + a
    bp = (1,) * (ndim - len(b)) + b
    ra = [i for i in range(ndim) if ap[i] == 1 and out[i] != 1]
    rb = [i for i in range(ndim) if bp[i] == 1 and out[i] != 1]
    return (torch.tensor(ra, dtype=torch.int32),
            torch.tensor(rb, dtype=torch.int32))


@register("knn_mindistance")
def knn_mindistance(point, low, high):
    """Distance from a point to an axis-aligned box."""
    p = point.reshape(-1)
    clamped = torch.minimum(torch.maximum(p, low.reshape(-1)),
                            high.reshape(-1))
    return torch.sqrt(torch.sum((p - clamped) ** 2))


_M32 = (1 << 32) - 1


def _pow31(n, device):
    """31^(k+1) mod 2^32 for k < n (square and multiply in int64)."""
    e = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    out = torch.ones_like(e)
    base = torch.full_like(e, 31)
    while bool((e > 0).any()):
        out = torch.where((e & 1) == 1, (out * base) & _M32, out)
        base = (base * base) & _M32
        e = e >> 1
    return out


@register("hashcode", aliases=["HashCode"])
def hashcode(x):
    """Σ bits_k · 31^(k+1) over the f32 bit patterns, in wrapping int32
    arithmetic (the reference's x32 mode)."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    bits = flat.view(torch.int32).to(torch.int64) & _M32
    terms = (bits * _pow31(flat.numel(), x.device)) & _M32
    total = torch.sum(terms) & _M32
    return (total - ((total >> 31) & 1) * (1 << 32)).to(torch.int32)


@register("lstm_block_cell", num_outputs=7, aliases=["LSTMBlockCell"])
def lstm_block_cell(x, h_prev, c_prev, w, b, forget_bias=1.0):
    """One fused LSTM step with TF LSTMBlockCell's seven outputs (i, cs,
    f, o, ci, co, h), ci = tanh(pre-gate), co = tanh(cs)."""
    from deeplearning4j_tpu_torch.ops.standard import promote_mm
    zcat = promote_mm(torch.cat([x, h_prev], dim=-1), w) + b
    i, ci, f, o = torch.chunk(zcat, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    o = torch.sigmoid(o)
    ci = torch.tanh(ci)
    cs = f * c_prev + i * ci
    co = torch.tanh(cs)
    return i, cs, f, o, ci, co, o * co


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def resize_weights(in_size: int, out_size: int, kernel, antialias: bool
                   ) -> np.ndarray:
    """(in, out) weights of ``jax.image.resize`` along one axis (its
    ``compute_weight_mat``, in f32): half-pixel sample points, the kernel
    widened by the downscale factor when antialiasing, each column
    normalised, columns whose sample lies outside the input zeroed."""
    scale = np.float32(out_size / in_size)
    inv = np.float32(1.0) / scale
    kscale = max(inv, np.float32(1.0)) if antialias else np.float32(1.0)
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv
              - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / kscale
    w = kernel(x).astype(np.float32)
    tot = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_axis(x, axis, size, kernel, antialias):
    if x.shape[axis] == size:
        return x
    w = torch.as_tensor(resize_weights(x.shape[axis], size, kernel,
                                       antialias), device=x.device)
    moved = torch.movedim(x, axis, -1)
    return torch.movedim(moved @ w.to(x.dtype), -1, axis)


def _resize_nearest(x, axis, size):
    m = x.shape[axis]
    if m == size:
        return x
    off = np.floor(((np.arange(size, dtype=np.float32) + np.float32(0.5))
                    * np.float32(m) / np.float32(size)).astype(np.float32))
    idx = torch.as_tensor(off.astype(np.int64), device=x.device)
    return torch.index_select(x, axis, idx)


@register("image_resize", aliases=["ImageResize"])
def image_resize(x, size, method="bilinear", antialias=False):
    """The resize family by method (``jax.image.resize``'s weights);
    'area' box-averages integer downscales and antialiases linear
    otherwise."""
    h, w = (int(s) for s in np.asarray(size).reshape(-1))
    m = str(method).lower()
    hx, wx = x.dim() - 3, x.dim() - 2
    if m == "nearest":
        return _resize_nearest(_resize_nearest(x, hx, h), wx, w)
    if m == "area":
        ih, iw = x.shape[-3], x.shape[-2]
        if ih % h == 0 and iw % w == 0:
            xr = x.reshape(tuple(x.shape[:-3]) + (h, ih // h, w, iw // w,
                                                  x.shape[-1]))
            return torch.mean(xr, dim=(-4, -2)).to(x.dtype)
        kernel, anti = _triangle, True
    else:
        kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[m]
        anti = bool(antialias)
    xf = x if x.is_floating_point() else x.float()
    out = _resize_axis(_resize_axis(xf, hx, h, kernel, anti), wx, w, kernel,
                       anti)
    return out.to(x.dtype)


_register_bp("softmax_bp", "softmax", 1)
_register_bp("log_softmax_bp", "log_softmax", 1)
_register_bp("prelu_bp", "prelu", 2)
_register_bp("tanh_bp", "tanh", 1)
_register_bp("sigmoid_bp", "sigmoid", 1)


@register("dynamic_bidirectional_rnn", num_outputs=4,
          aliases=["DynamicBidirectionalRNN"])
def dynamic_bidirectional_rnn(x, h0f, c0f, wf, bf, h0b, c0b, wb, bb,
                              cell="lstm", forget_bias=0.0):
    """Forward and time-reversed backward cell passes: (y_fwd, y_bwd,
    final_fwd, final_bwd)."""
    yf, sf = exec_op("static_rnn", x, h0f, c0f, wf, bf, cell=cell,
                     forget_bias=forget_bias)
    yb, sb = exec_op("static_rnn", torch.flip(x, (1,)), h0b, c0b, wb, bb,
                     cell=cell, forget_bias=forget_bias)
    return yf, torch.flip(yb, (1,)), sf, sb


@register("gather_elements", aliases=["GatherElements"])
def gather_elements(x, indices, axis=0):
    """take_along_axis (ONNX GatherElements)."""
    axis = int(axis) % x.dim()
    idx = indices.long()
    idx = torch.where(idx < 0, idx + x.shape[axis], idx)
    return torch.gather(x, axis, idx)


@register("nonzero_coords", aliases=["NonZero"])
def nonzero_coords(x):
    """(rank, n) coordinates of the nonzero elements (ONNX NonZero): a
    data-dependent shape."""
    return torch.nonzero(x).T


@register("bernoulli_sample", aliases=["Bernoulli"])
def bernoulli_sample(p, seed=None, generator=None):
    """A Bernoulli draw per element of the probability tensor ``p``."""
    gen = generator_for(seed, generator, p.device)
    dev = gen.device if gen is not None else p.device
    u = torch.rand(p.shape, generator=gen, device=dev).to(p.device)
    return (u < p).to(p.dtype)


@register("fill_dynamic")
def fill_dynamic(dims, value):
    """Fill whose dims arrive as a tensor (read on the host)."""
    shape = _shape_of(dims)
    if isinstance(value, torch.Tensor):
        return value.reshape(()).expand(shape).contiguous()
    return torch.full(shape, value, device=dims.device if isinstance(
        dims, torch.Tensor) else None)


@register("fill_template")
def fill_template(value, *refs, template):
    """Fill whose dims mix ints with ("shape", ref_idx, axis) entries read
    from the reference tensors' shapes (TF's Fill(Pack(Shape(x)[i], …),
    v))."""
    shape = tuple(refs[e[1]].shape[e[2]] if isinstance(e, (tuple, list))
                  else int(e) for e in template)
    if isinstance(value, torch.Tensor):
        return value.reshape(()).expand(shape).contiguous()
    dev = refs[0].device if refs else None
    return torch.full(shape, value, device=dev)
