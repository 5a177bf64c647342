"""Eager elementwise/transform ops: counterpart of
``deeplearning4j_tpu/ops/transforms.py`` (ref:
``org.nd4j.linalg.ops.transforms.Transforms`` plus the commonly used
``Nd4j.math`` surface), over the port's NDArray.

The activations follow the reference's formulas, which are jax's: GELU is
the tanh form (``jax.nn.gelu``'s default; ``F.gelu``'s default is erf),
``softplus`` is ``logaddexp(x, 0)``, ``hardSigmoid`` is
``relu6(x + 3) / 6``, ``selu`` is ``scale · elu(x, alpha)``, ``mish`` is
``x · tanh(softplus(x))``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ndarray.ndarray import (
    NDArray, _operand, as_tensor, r_mean, r_std, r_sum)


def _t(x):
    return as_tensor(x)


def _u1(fn):
    def op(x, *args, **kwargs):
        t = _t(x)
        return NDArray._new(fn(t, *[_operand(a, t) for a in args],
                               **kwargs))
    return op


def _float(fn):
    """A float op: integer and bool inputs compute in float32, as jnp
    promotes them."""
    def f(t, *a, **k):
        return fn(t if (t.is_floating_point() or t.is_complex())
                  else t.float(), *a, **k)
    return f


def _cbrt(t):
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


# --- strict transforms
exp = _u1(_float(torch.exp))
log = _u1(_float(torch.log))
log1p = _u1(_float(torch.log1p))
expm1 = _u1(_float(torch.expm1))
sqrt = _u1(_float(torch.sqrt))
cbrt = _u1(_float(_cbrt))
abs = _u1(torch.abs)
sign = _u1(torch.sign)
floor = _u1(torch.floor)
ceil = _u1(torch.ceil)
round = _u1(torch.round)
sin = _u1(_float(torch.sin))
cos = _u1(_float(torch.cos))
tan = _u1(_float(torch.tan))
asin = _u1(_float(torch.asin))
acos = _u1(_float(torch.acos))
atan = _u1(_float(torch.atan))
sinh = _u1(_float(torch.sinh))
cosh = _u1(_float(torch.cosh))
tanh = _u1(_float(torch.tanh))
atanh = _u1(_float(torch.atanh))
asinh = _u1(_float(torch.asinh))
acosh = _u1(_float(torch.acosh))
reciprocal = _u1(torch.reciprocal)
square = _u1(torch.square)
erf = _u1(_float(torch.erf))
erfc = _u1(_float(torch.erfc))


def pow(x, p):
    t = _t(x)
    return NDArray._new(torch.pow(t, _operand(p, t)))


def max(x, y):
    t = _t(x)
    return NDArray._new(torch.maximum(t, torch.as_tensor(
        _operand(y, t), device=t.device)))


def min(x, y):
    t = _t(x)
    return NDArray._new(torch.minimum(t, torch.as_tensor(
        _operand(y, t), device=t.device)))


def clip(x, lo, hi):
    return NDArray._new(torch.clamp(_t(x), lo, hi))


def atan2(y, x):
    t = _t(y)
    return NDArray._new(torch.atan2(_float(lambda a: a)(t),
                                    torch.as_tensor(_operand(x, t),
                                                    device=t.device)))


def isNaN(x):
    return NDArray._new(torch.isnan(_t(x)))


def isInf(x):
    return NDArray._new(torch.isinf(_t(x)))


# --- neural activations (jax.nn's formulas)
def _softplus(t):
    return torch.logaddexp(t, torch.zeros((), dtype=t.dtype,
                                          device=t.device))


def _selu(t):
    alpha = 1.6732632423543772848170429916717
    scale = 1.0507009873554804934193349852946
    return scale * torch.where(t > 0, t, alpha * torch.expm1(
        torch.where(t > 0, 0.0, t)))


def _elu(t, alpha=1.0):
    return torch.where(t > 0, t, alpha * torch.expm1(
        torch.where(t > 0, 0.0, t)))


sigmoid = _u1(_float(torch.sigmoid))
relu = _u1(torch.relu)
relu6 = _u1(lambda t: torch.clamp(t, 0, 6))
elu = _u1(_float(_elu))
selu = _u1(_float(_selu))
gelu = _u1(_float(lambda t: F.gelu(t, approximate="tanh")))
softplus = _u1(_float(_softplus))
softsign = _u1(_float(lambda t: t / (torch.abs(t) + 1)))
hardSigmoid = _u1(_float(lambda t: torch.clamp(t + 3.0, 0, 6) / 6.0))
hardTanh = _u1(lambda t: torch.clamp(t, -1.0, 1.0))
swish = _u1(_float(lambda t: t * torch.sigmoid(t)))
mish = _u1(_float(lambda t: t * torch.tanh(_softplus(t))))


def leakyRelu(x, alpha=0.01):
    t = _float(lambda a: a)(_t(x))
    return NDArray._new(torch.where(t >= 0, t, alpha * t))


def softmax(x, axis=-1):
    t = _float(lambda a: a)(_t(x))
    return NDArray._new(torch.softmax(t, dim=axis))


def logSoftmax(x, axis=-1):
    t = _float(lambda a: a)(_t(x))
    return NDArray._new(torch.log_softmax(t, dim=axis))


def logSumExp(x, axis=None):
    t = _float(lambda a: a)(_t(x))
    dims = tuple(range(t.dim())) if axis is None else axis
    return NDArray._new(torch.logsumexp(t, dim=dims))


def step(x):
    return NDArray._new((_t(x) > 0).to(torch.float32))


# --- distance / similarity (ref: Transforms#cosineSim etc.)
def _pair(a, b):
    ta = _t(a)
    tb = _t(b).to(ta.device)
    dt = torch.promote_types(ta.dtype, tb.dtype)
    return ta.reshape(-1).to(dt), tb.reshape(-1).to(dt)


def _norm(t):
    return torch.sqrt(r_sum(t * t))


def cosineSim(a, b) -> float:
    a, b = _pair(a, b)
    return float(torch.dot(a, b) / (_norm(a) * _norm(b)))


def cosineDistance(a, b) -> float:
    return 1.0 - cosineSim(a, b)


def euclideanDistance(a, b) -> float:
    a, b = _pair(a, b)
    return float(_norm(a - b))


def manhattanDistance(a, b) -> float:
    a, b = _pair(a, b)
    return float(r_sum(torch.abs(a - b)))


def hammingDistance(a, b) -> float:
    a, b = _pair(a, b)
    return float(r_sum(a != b))


def jaccardDistance(a, b) -> float:
    a, b = _pair(a, b)
    mn = r_sum(torch.minimum(a, b))
    mx = r_sum(torch.maximum(a, b))
    return float(1.0 - mn / mx)


# --- normalization
def unitVec(x):
    t = _t(x)
    return NDArray._new(t / _norm(t))


def normalizeZeroMeanAndUnitVariance(x):
    t = _t(x)
    return NDArray._new((t - r_mean(t, 0)) / (r_std(t, 0) + 1e-12))


def stabilize(x, k=1.0):
    """ref: Transforms.stabilize — clamp to the numerically safe exp range."""
    lim = 80.0 / k
    return NDArray._new(torch.clamp(_t(x), -lim, lim))


def _logic(fn, a, b):
    ta = _t(a)
    return NDArray._new(fn(ta.to(torch.bool),
                           _t(b).to(device=ta.device, dtype=torch.bool)))


def andOp(a, b):
    return _logic(torch.logical_and, a, b)


def orOp(a, b):
    return _logic(torch.logical_or, a, b)


def xorOp(a, b):
    return _logic(torch.logical_xor, a, b)


def notOp(a):
    return NDArray._new(~_t(a).to(torch.bool))


def greaterThanOrEqual(a, b):
    t = _t(a)
    return NDArray._new(torch.ge(t, _operand(b, t)))


def lessThanOrEqual(a, b):
    t = _t(a)
    return NDArray._new(torch.le(t, _operand(b, t)))


def _rows(a, b, dim):
    A = _t(a)
    B = _t(b).to(A.device)
    if dim == 0:
        A, B = A.T, B.T
    return A, B


def allEuclideanDistances(a, b, dim=1):
    """ref: Transforms.allEuclideanDistances — pairwise row distances."""
    A, B = _rows(a, b, dim)
    d2 = (r_sum(A * A, 1)[:, None] - 2.0 * torch.matmul(A, B.T)
          + r_sum(B * B, 1)[None, :])
    return NDArray._new(torch.sqrt(torch.clamp_min(d2, 0.0)))


def allManhattanDistances(a, b, dim=1):
    A, B = _rows(a, b, dim)
    return NDArray._new(r_sum(torch.abs(A[:, None, :] - B[None, :, :]), -1))


def allCosineSimilarities(a, b, dim=1):
    A, B = _rows(a, b, dim)
    An = A / (torch.sqrt(r_sum(A * A, 1, True)) + 1e-12)
    Bn = B / (torch.sqrt(r_sum(B * B, 1, True)) + 1e-12)
    return NDArray._new(torch.matmul(An, Bn.T))


def cross(a, b):
    ta = _t(a)
    return NDArray._new(torch.linalg.cross(ta, _t(b).to(ta.device)))


def dot(a, b):
    from deeplearning4j_tpu_torch.ndarray.factory import dot as _dot
    return _dot(a, b)


def reverse(x, *dims):
    t = _t(x)
    return NDArray._new(torch.flip(t, dims or tuple(range(t.dim()))))


class Transforms:
    """Reference-spelled static facade (ref: org.nd4j.linalg.ops.transforms
    .Transforms). All module functions as statics, incl. python-keyword-safe
    names (``Transforms.and_`` for Java's ``Transforms.and``)."""
    pass


def _populate_transforms_facade():
    import sys
    mod = sys.modules[__name__]
    for name in dir(mod):
        if name.startswith("_") or name == "Transforms":
            continue
        obj = getattr(mod, name)
        if callable(obj) and getattr(obj, "__module__", "") == __name__:
            setattr(Transforms, name, staticmethod(obj))
    Transforms.and_ = staticmethod(andOp)
    Transforms.or_ = staticmethod(orOp)
    Transforms.xor_ = staticmethod(xorOp)
    Transforms.not_ = staticmethod(notOp)


_populate_transforms_facade()
