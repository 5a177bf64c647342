"""SameDiff's define-then-run graph engine, run eagerly with torch autograd.

Counterpart of ``deeplearning4j_tpu/autodiff/samediff.py`` (the
reference's ``org.nd4j.autodiff.samediff.SameDiff``, ``SDVariable``, the
namespaced op factories, ``TrainingConfig``, ``fit``, ``output``,
``save``/``load``).

A graph is a list of :class:`OpNode` in insertion order, which is
topological by construction. Where the JAX package emits one jitted
function over the pruned op list, the port walks the same pruned list
eagerly, each op by name through the op registry (``ops/registry.py``'s
``exec_op``, which the op profiler instruments), and differentiates with
torch autograd where the reference takes ``jax.value_and_grad``. The
walk is built once and cached per (outputs, placeholder signature,
``graph_opt_enabled()``), as the reference's jitted programs are.
``Identity`` aliases its input, so the many Identity nodes of a frozen
TF graph launch nothing.

Control flow: ``__cond__`` reads its predicate on the host and runs one
branch; ``__while__`` runs its body ``trip_count`` times when the loop is
counted (``_counted_trip``: the reference lowers that to a
reverse-differentiable ``lax.scan``), else while its condition, read on
the host each trip, holds. Random ops draw from a ``torch.Generator``
seeded from (execution seed, node index, node seed), where the reference
folds the same three into a JAX key: draws are deterministic per seed,
not equal to the reference's.

Types follow the JAX package with 64-bit types off: constants, variables
and feeds of f64 or int64 become f32 or int32 (``ops/dtypes.py``).

Persistence: the reference's zip (``graph.json`` + ``values.npz``, with
``updater.npz`` or ``updater_named.npz``) and its FlatBuffers FlatGraph
(``autodiff/flatgraph.py``); either package loads what the other wrote.
The updater state is the port's ``optim/updaters.py`` chain, whose leaves
line up one for one with the reference's optax state.

Not ported here: ``set_mesh`` (data-parallel training over several
cards, ROADMAP queue 1 item 7), and the ``SDImage``/``SDBitwise`` methods
whose ops live in the reference's ``ops/extended.py`` (queue 1 item 9's
rest): they raise.
"""
from __future__ import annotations

import collections.abc as _abc
import enum
import io
import json
import warnings
import zipfile
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.ops import dtypes as _dt
from deeplearning4j_tpu_torch.ops import registry as op_registry  # filled
from deeplearning4j_tpu_torch.optim import transforms as _T


class History(list):
    """Training history: the per-iteration losses (ref: ``History`` +
    ``LossCurve``)."""

    def loss_curve(self):
        return list(self)

    lossCurve = loss_curve

    def final_loss(self) -> float:
        return float(self[-1]) if self else float("nan")

    finalTrainingLoss = final_loss


class VariableType(enum.Enum):
    """Mirror of ``org.nd4j.autodiff.samediff.VariableType``."""

    VARIABLE = "VARIABLE"        # trainable, persisted
    CONSTANT = "CONSTANT"        # non-trainable, persisted
    PLACEHOLDER = "PLACEHOLDER"  # fed at exec time
    ARRAY = "ARRAY"              # op output, computed


class SDVariable:
    """Symbolic graph variable. Holds no data for ARRAY type;
    VARIABLE/CONSTANT values live in the owning ``SameDiff``'s value
    store. Arithmetic operators create graph ops. ``dtype`` is a torch
    dtype."""

    def __init__(self, sd: "SameDiff", name: str, var_type: VariableType,
                 shape: Optional[Tuple[int, ...]], dtype):
        self.sd = sd
        self.name = name
        self.var_type = var_type
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _dt.to_torch(dtype) if dtype is not None else None

    # ---- graph-building arithmetic ------------------------------------
    def _bin(self, op: str, other, reverse=False):
        other = self.sd._lift(other)
        a, b = (other, self) if reverse else (self, other)
        return self.sd._op(op, a, b)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, reverse=True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, reverse=True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, reverse=True)
    def __truediv__(self, o): return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, reverse=True)
    def __pow__(self, o): return self._bin("pow", o)
    def __neg__(self): return self.sd._op("neg", self)
    def __matmul__(self, o): return self.mmul(o)

    def gt(self, o): return self._bin("greater", o)
    def gte(self, o): return self._bin("greater_equal", o)
    def lt(self, o): return self._bin("less", o)
    def lte(self, o): return self._bin("less_equal", o)
    def eq(self, o): return self._bin("equals", o)
    def neq(self, o): return self._bin("not_equals", o)
    __gt__ = gt
    __ge__ = gte
    __lt__ = lt
    __le__ = lte
    # (__eq__ stays identity — variables live in dict keys)

    def add(self, o): return self.__add__(o)
    def sub(self, o): return self.__sub__(o)
    def mul(self, o): return self.__mul__(o)
    def div(self, o): return self.__truediv__(o)
    def rdiv(self, o): return self.__rtruediv__(o)
    def mmul(self, o): return self.sd._op("matmul", self, self.sd._lift(o))
    def dot(self, o):
        return self.sd._op("tensordot", self, self.sd._lift(o), axes=1)
    def transpose(self, *perm):
        return self.sd._op("transpose", self, axes=list(perm) or None)
    def permute(self, *perm): return self.transpose(*perm)
    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", self, shape=list(shape))
    def sum(self, *axis, keepdims=False):
        return self.sd._op("reduce_sum", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def mean(self, *axis, keepdims=False):
        return self.sd._op("reduce_mean", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def max(self, *axis, keepdims=False):
        return self.sd._op("reduce_max", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def min(self, *axis, keepdims=False):
        return self.sd._op("reduce_min", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def prod(self, *axis, keepdims=False):
        return self.sd._op("reduce_prod", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def std(self, *axis, keepdims=False):
        return self.sd._op("reduce_stdev", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def norm2(self, *axis, keepdims=False):
        return self.sd._op("reduce_norm2", self, axis=list(axis) or None,
                           keepdims=keepdims)
    def argmax(self, axis=-1): return self.sd._op("argmax", self, axis=axis)
    def argmin(self, axis=-1): return self.sd._op("argmin", self, axis=axis)
    def squeeze(self, axis=None):
        return self.sd._op("squeeze", self, axis=axis)
    def cast(self, dtype):
        return self.sd._op("cast", self, dtype=_dt.name_of(dtype))
    def rank(self): return len(self.shape) if self.shape is not None else None
    def get(self, *slices):
        return self.__getitem__(slices if len(slices) > 1 else slices[0])

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        begins, ends, strides, squeeze_axes = [], [], [], []
        for ax, s in enumerate(idx):
            if isinstance(s, int):
                if s == -1:
                    # end=0 would make an empty slice; 2**31-1 = "to the end"
                    begins.append(s); ends.append(2**31 - 1)
                else:
                    begins.append(s); ends.append(s + 1)
                strides.append(1)
                squeeze_axes.append(ax)
            elif isinstance(s, slice):
                dim = self.shape[ax] if self.shape is not None else None
                begins.append(s.start if s.start is not None else 0)
                ends.append(s.stop if s.stop is not None else
                            (dim if dim is not None else 2**31 - 1))
                strides.append(s.step if s.step is not None else 1)
            else:
                raise TypeError(f"Unsupported index {s!r}")
        out = self.sd._op("strided_slice", self, begin=begins, end=ends,
                          strides=strides)
        if squeeze_axes:
            out = self.sd._op("squeeze", out, axis=squeeze_axes)
        return out

    # ---- graph metadata ------------------------------------------------
    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    def convert_to_constant(self):
        self.var_type = VariableType.CONSTANT
        return self

    def convert_to_variable(self):
        self.var_type = VariableType.VARIABLE
        return self

    def eval(self, placeholders: Optional[Dict[str, Any]] = None):
        """Compute this variable's value (``SDVariable#eval``)."""
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def get_arr(self):
        if self.var_type in (VariableType.VARIABLE, VariableType.CONSTANT):
            return self.sd._values[self.name]
        return self.eval()

    def set_arr(self, value):
        if self.var_type not in (VariableType.VARIABLE, VariableType.CONSTANT):
            raise ValueError(f"{self.name} is {self.var_type}, has no "
                             f"stored array")
        value = _dt.as_tensor(value, self.sd.device)
        self.sd._values[self.name] = value
        self.shape = tuple(value.shape)
        self.sd._invalidate_cache()
        return self

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.var_type.value}, "
                f"shape={self.shape})")


def _scalar_value(t) -> Optional[float]:
    if t is None or t.numel() != 1:
        return None
    return float(t.reshape(()).item())


def _counted_trip(c_sd, b_sd, loop_vars):
    """The static trip count of a counted while, or None. Pattern (what TF
    emits for ``i < T`` loops): the cond output is Cmp(arg_k, K) (or
    Cmp(K, arg_k)) through Identity/Squeeze wrappers, K a scalar constant;
    body output k is arg_k ± step, step a scalar constant; the k-th loop
    var's initial value is a scalar constant."""
    def _resolve(sd, name, depth=8):
        for _ in range(depth):
            prod = sd._producer.get(name)
            if prod is None:
                return name, None
            if prod.op_name in ("Identity", "identity", "Squeeze",
                                "squeeze"):
                name = prod.inputs[0]
                continue
            return name, prod
        return name, None

    def _scalar_const(sd, name):
        name, _ = _resolve(sd, name)
        return _scalar_value(sd._values.get(name))

    def _arg_index(sd, name):
        name, prod = _resolve(sd, name)
        if prod is None and name.startswith("arg"):
            try:
                return int(name[3:].split(":")[0])
            except ValueError:
                return None
        return None

    try:
        _, cmp_op = _resolve(c_sd, c_sd._branch_outputs[0])
        if cmp_op is None:
            return None
        cmps = {"Less": "<", "less": "<", "LessEqual": "<=",
                "less_equal": "<=", "Greater": ">", "greater": ">",
                "GreaterEqual": ">=", "greater_equal": ">="}
        sym = cmps.get(cmp_op.op_name)
        if sym is None or len(cmp_op.inputs) != 2:
            return None
        a_idx = _arg_index(c_sd, cmp_op.inputs[0])
        b_idx = _arg_index(c_sd, cmp_op.inputs[1])
        if a_idx is not None and b_idx is None:
            k, bound = a_idx, _scalar_const(c_sd, cmp_op.inputs[1])
            flipped = False
        elif b_idx is not None and a_idx is None:
            k, bound = b_idx, _scalar_const(c_sd, cmp_op.inputs[0])
            flipped = True
        else:
            return None
        if bound is None:
            return None
        _, upd = _resolve(b_sd, b_sd._branch_outputs[k])
        if upd is None or upd.op_name not in ("Add", "add", "AddV2",
                                              "Sub", "sub"):
            return None
        u_args = [_arg_index(b_sd, i) for i in upd.inputs]
        if u_args[0] == k:
            step = _scalar_const(b_sd, upd.inputs[1])
        elif len(u_args) > 1 and u_args[1] == k \
                and upd.op_name in ("Add", "add", "AddV2"):
            step = _scalar_const(b_sd, upd.inputs[0])
        else:
            return None
        if step is None or step == 0:
            return None
        if upd.op_name in ("Sub", "sub"):
            step = -step
        init_v = loop_vars[k]
        raw = init_v.sd._values.get(init_v.name)
        if init_v.var_type != VariableType.CONSTANT or raw is None \
                or raw.numel() != 1:
            return None
        init = _scalar_value(raw)
        if flipped:                      # Cmp(K, arg_k) — mirror it
            sym = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[sym]
        if sym in ("<", "<=") and step > 0:
            span = bound - init + (1 if sym == "<=" else 0)
            trip = int(np.ceil(span / step))
        elif sym in (">", ">=") and step < 0:
            span = init - bound + (1 if sym == ">=" else 0)
            trip = int(np.ceil(span / -step))
        else:
            return None                  # diverging loop — leave dynamic
        return max(0, trip)
    except Exception:                    # detection must never break import
        return None


class OpNode:
    """One node of the op graph (ref: ``samediff.internal.SameDiffOp``)."""

    __slots__ = ("name", "op_name", "inputs", "outputs", "attrs", "fn",
                 "subgraphs")

    def __init__(self, name, op_name, inputs, outputs, attrs, fn=None,
                 subgraphs=None):
        self.name = name
        self.op_name = op_name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.attrs = dict(attrs)
        self.fn = fn  # only for non-serializable lambda ops
        # control-flow bodies: {"true"/"false"} for __cond__,
        # {"cond"/"body"} for __while__ — nested SameDiff graphs
        self.subgraphs = subgraphs

    def to_dict(self):
        if self.fn is not None:
            raise ValueError(
                f"op {self.name!r} wraps a Python lambda and cannot be "
                f"serialized; rebuild it from registered ops")
        d = {"name": self.name, "op": self.op_name, "inputs": self.inputs,
             "outputs": self.outputs, "attrs": self.attrs}
        if self.subgraphs:
            # subgraph VALUES ride the enclosing graph's npz, keyed
            # "__sub__/<op>/<branch>/<var>" — only structure goes in json
            d["subgraphs"] = {
                k: {"graph": sg.to_dict(), "outputs": sg._branch_outputs}
                for k, sg in self.subgraphs.items()}
        return d


class TrainingConfig:
    """Ref: ``org.nd4j.autodiff.samediff.TrainingConfig``. ``updater`` is
    one of ``optim.updaters``' configs (or an ``optim.transforms``
    Transform); None is SGD at 1e-3, as the reference's default."""

    def __init__(self, updater=None, l1=0.0, l2=0.0,
                 data_set_feature_mapping: Sequence[str] = (),
                 data_set_label_mapping: Sequence[str] = (),
                 loss_variables: Sequence[str] = ()):
        self.updater = updater
        self.l1 = float(l1)
        self.l2 = float(l2)
        self.data_set_feature_mapping = list(data_set_feature_mapping)
        self.data_set_label_mapping = list(data_set_label_mapping)
        self.loss_variables = list(loss_variables)

    def transform(self) -> _T.Transform:
        """The counterpart of the reference's ``to_optax()``."""
        from deeplearning4j_tpu_torch.optim.updaters import Sgd

        u = self.updater
        if u is None:
            return Sgd(1e-3).transform()
        if hasattr(u, "transform"):
            return u.transform()
        return u

    def to_dict(self):
        u = self.updater
        return {"l1": self.l1, "l2": self.l2,
                "featureMapping": self.data_set_feature_mapping,
                "labelMapping": self.data_set_label_mapping,
                "lossVariables": self.loss_variables,
                "updater": getattr(u, "to_dict", lambda: None)()}

    @staticmethod
    def from_dict(d: dict) -> "TrainingConfig":
        from deeplearning4j_tpu_torch.optim.updaters import Updater
        upd = Updater.from_dict(d["updater"]) if d.get("updater") else None
        return TrainingConfig(
            updater=upd, l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            data_set_feature_mapping=d.get("featureMapping", ()),
            data_set_label_mapping=d.get("labelMapping", ()),
            loss_variables=d.get("lossVariables", ()))


class _Namespace:
    def __init__(self, sd: "SameDiff"):
        self.sd = sd

    def _op(self, name, *args, **attrs):
        args = [self.sd._lift(a) for a in args]
        return self.sd._op(name, *args, **attrs)

    def __getattr__(self, item):
        # every namespace reaches every registered op by name
        if op_registry.has(item):
            def call(*args, **attrs):
                return self._op(item, *args, **attrs)
            return call
        raise AttributeError(item)


class SDMath(_Namespace):
    """Ref: ``SDMath`` / ``SDBaseOps`` transform ops."""

    def square(self, x): return self._op("square", x)
    def abs(self, x): return self._op("abs", x)
    def exp(self, x): return self._op("exp", x)
    def log(self, x): return self._op("log", x)
    def sqrt(self, x): return self._op("sqrt", x)
    def tanh(self, x): return self._op("tanh", x)
    def cos(self, x): return self._op("cos", x)
    def sin(self, x): return self._op("sin", x)
    def pow(self, x, p): return self._op("pow", x, p)
    def neg(self, x): return self._op("neg", x)
    def max(self, a, b): return self._op("maximum", a, b)
    def min(self, a, b): return self._op("minimum", a, b)
    def isnan(self, x): return self._op("isnan", x)
    def confusion_matrix(self, labels, pred, num_classes):
        return self._op("confusion_matrix", labels, pred,
                        num_classes=num_classes)


class SDNN(_Namespace):
    """Ref: ``SDNN``."""

    def relu(self, x): return self._op("relu", x)
    def relu6(self, x): return self._op("relu6", x)
    def gelu(self, x): return self._op("gelu", x)
    def elu(self, x): return self._op("elu", x)
    def selu(self, x): return self._op("selu", x)
    def sigmoid(self, x): return self._op("sigmoid", x)
    def tanh(self, x): return self._op("tanh", x)
    def softmax(self, x, axis=-1): return self._op("softmax", x, axis=axis)
    def log_softmax(self, x, axis=-1):
        return self._op("log_softmax", x, axis=axis)
    def softplus(self, x): return self._op("softplus", x)
    def swish(self, x): return self._op("swish", x)
    def leakyrelu(self, x, alpha=0.01):
        return self._op("leakyrelu", x, alpha=alpha)
    def linear(self, x, w, b=None):
        out = self._op("matmul", x, w)
        return out + b if b is not None else out
    def layer_norm(self, x, gamma=None, beta=None, axis=-1, epsilon=1e-5):
        args = [x] + [a for a in (gamma, beta) if a is not None]
        return self._op("layer_norm", *args, axis=axis, epsilon=epsilon)
    def batch_norm(self, x, mean, var, gamma, beta, epsilon=1e-5, axis=-1):
        return self._op("batchnorm", x, mean, var, gamma, beta,
                        epsilon=epsilon, axis=axis)
    def dropout(self, x, p, seed=0):
        return self.sd._random_op("dropout_inverted", x, p=p, seed=seed)
    def multi_head_dot_product_attention(self, q, k, v, mask=None,
                                         scaled=True):
        """The registry's ``dot_product_attention``: on the card the hand
        flash kernels K1/K2 wherever ``ops.standard.attention_route``
        says "kernel" (a (B, 1, 1, T) key mask included)."""
        args = [q, k, v] + ([mask] if mask is not None else [])
        return self._op("dot_product_attention", *args, scaled=scaled)
    def pad(self, x, paddings, value=0.0):
        return self._op("pad", x, paddings=paddings, value=value)


class SDCNN(_Namespace):
    """Ref: ``SDCNN``."""

    def conv2d(self, x, w, b=None, strides=(1, 1), padding="SAME",
               dilation=(1, 1)):
        args = [x, w] + ([b] if b is not None else [])
        return self._op("conv2d", *args, strides=list(strides),
                        padding=padding, dilation=list(dilation))
    def deconv2d(self, x, w, b=None, strides=(1, 1), padding="SAME"):
        args = [x, w] + ([b] if b is not None else [])
        return self._op("deconv2d", *args, strides=list(strides),
                        padding=padding)
    def depthwise_conv2d(self, x, w, b=None, strides=(1, 1), padding="SAME"):
        args = [x, w] + ([b] if b is not None else [])
        return self._op("depthwise_conv2d", *args, strides=list(strides),
                        padding=padding)
    def max_pooling2d(self, x, kernel=(2, 2), strides=None, padding="VALID"):
        return self._op("maxpool2d", x, kernel=list(kernel),
                        strides=list(strides) if strides else None,
                        padding=padding)
    def avg_pooling2d(self, x, kernel=(2, 2), strides=None, padding="VALID"):
        return self._op("avgpool2d", x, kernel=list(kernel),
                        strides=list(strides) if strides else None,
                        padding=padding)
    def upsampling2d(self, x, size=2):
        return self._op("upsampling2d", x, size=size)
    def im2col(self, x, kernel, strides=(1, 1), padding="VALID"):
        return self._op("im2col", x, kernel=list(kernel),
                        strides=list(strides), padding=padding)
    def space_to_depth(self, x, block):
        return self._op("space_to_depth", x, block_size=block)
    def depth_to_space(self, x, block):
        return self._op("depth_to_space", x, block_size=block)


class SDRNN(_Namespace):
    """Ref: ``SDRNN`` — cell-level ops."""

    def lstm_cell(self, x, h, c, w, b, forget_bias=1.0):
        return self._op("lstm_cell", x, h, c, w, b, forget_bias=forget_bias,
                        n_out=2)
    def gru_cell(self, x, h, w_rz, w_h, b_rz, b_h):
        return self._op("gru_cell", x, h, w_rz, w_h, b_rz, b_h)
    def sru_cell(self, x, c, w, b):
        return self._op("sru_cell", x, c, w, b, n_out=2)


class SDLoss(_Namespace):
    """Ref: ``SDLoss``. Each returns a scalar mean loss."""

    def mse(self, labels, predictions):
        return ((predictions - labels) * (predictions - labels)).mean()
    def mean_squared_error(self, labels, predictions):
        return self.mse(labels, predictions)
    def l2_loss(self, x):
        return (x * x).sum() * 0.5
    def absolute_difference(self, labels, predictions):
        return self._op("abs", predictions - labels).mean()
    def softmax_cross_entropy(self, labels, logits, axis=-1):
        return self._op("softmax_cross_entropy", logits, labels,
                        axis=axis).mean()
    def sparse_softmax_cross_entropy(self, labels, logits):
        return self._op("sparse_softmax_cross_entropy", logits,
                        labels).mean()
    def sigmoid_cross_entropy(self, labels, logits):
        return self._op("sigmoid_cross_entropy", logits, labels).mean()
    def log_loss(self, labels, predictions, epsilon=1e-7):
        p = self._op("clipbyvalue", predictions, clip_value_min=epsilon,
                     clip_value_max=1.0 - epsilon)
        term = labels * self._op("log", p) + \
            (1.0 - labels) * self._op("log", 1.0 - p)
        return -term.mean()
    def cosine_distance(self, labels, predictions, axis=-1):
        a = self._op("l2_normalize", labels, axis=axis)
        b = self._op("l2_normalize", predictions, axis=axis)
        return (1.0 - (a * b).sum(axis)).mean()
    def huber_loss(self, labels, predictions, delta=1.0):
        err = predictions - labels
        abs_err = self._op("abs", err)
        quad = self._op("minimum", abs_err, delta)
        return (0.5 * quad * quad + delta * (abs_err - quad)).mean()
    def hinge_loss(self, labels, predictions):
        sign = labels * 2.0 - 1.0           # labels in {0,1} → {-1,1}
        return self._op("relu", 1.0 - sign * predictions).mean()


class SDLinalg(_Namespace):
    def cholesky(self, x): return self._op("cholesky", x)
    def svd(self, x): return self._op("svd", x, n_out=3)
    def qr(self, x): return self._op("qr", x, n_out=2)
    def solve(self, a, b): return self._op("solve", a, b)
    def inverse(self, x): return self._op("matrix_inverse", x)
    def det(self, x): return self._op("matrix_determinant", x)
    def matmul(self, a, b, transpose_a=False, transpose_b=False):
        return self._op("matmul", a, b, transpose_a=transpose_a,
                        transpose_b=transpose_b)


class SDRandom(_Namespace):
    """Ref: ``SDRandom``. Random ops draw from a generator seeded from the
    execution-time seed (exec arg ``rng_seed``) and the node, so a graph
    stays deterministic per seed without a stateful RNG in it."""

    def normal(self, mean, stddev, shape, seed=0):
        return self.sd._random_op("random_normal", shape=list(shape),
                                  mean=mean, stddev=stddev, seed=seed)
    def uniform(self, low, high, shape, seed=0):
        return self.sd._random_op("random_uniform", shape=list(shape),
                                  minval=low, maxval=high, seed=seed)
    def bernoulli(self, p, shape, seed=0):
        return self.sd._random_op("random_bernoulli", shape=list(shape),
                                  p=p, seed=seed)


class SDBitwise(_Namespace):
    """Ref: ``SDBitwise``. Its ops live in the reference's
    ``ops/extended.py``, which the port's registry does not hold yet
    (ROADMAP queue 1 item 9's rest): each method raises
    ``registry.UnknownOpError`` naming its op."""

    def and_(self, a, b): return self._op("bitwise_and", a, b)
    def or_(self, a, b): return self._op("bitwise_or", a, b)
    def xor(self, a, b): return self._op("bitwise_xor", a, b)
    def left_shift(self, x, n): return self._op("shift_bits", x, n)
    def right_shift(self, x, n): return self._op("rshift_bits", x, n)
    def left_shift_cyclic(self, x, n):
        return self._op("cyclic_shift_bits", x, n)
    def bits_hamming_distance(self, a, b):
        return self._op("bits_hamming_distance", a, b)
    bitwiseAnd, bitwiseOr, bitwiseXor = and_, or_, xor
    leftShift, rightShift = left_shift, right_shift


class SDImage(_Namespace):
    """Ref: ``SDImage``. ``resize_bilinear`` and ``non_max_suppression``
    run (their ops are standard); the others' ops live in the reference's
    ``ops/extended.py`` (ROADMAP queue 1 item 9's rest) and raise
    ``registry.UnknownOpError``."""

    def resize_bilinear(self, x, h, w):
        return self._op("resize_bilinear", x, size=(h, w))
    def resize_nearest(self, x, h, w):
        return self._op("resize_nearest_neighbor", x, size=(h, w))
    def resize_bicubic(self, x, h, w):
        return self._op("resize_bicubic", x, size=(h, w))
    def crop_and_resize(self, image, boxes, box_indices, crop_h, crop_w):
        return self._op("crop_and_resize", image, boxes, box_indices,
                        crop_size=(crop_h, crop_w))
    def extract_image_patches(self, x, kh, kw, sh, sw, rh=1, rw=1,
                              same_mode=False):
        return self._op("extract_image_patches", x, ksizes=(kh, kw),
                        strides=(sh, sw), rates=(rh, rw),
                        padding="SAME" if same_mode else "VALID")
    def rgb_to_hsv(self, x): return self._op("rgb_to_hsv", x)
    def hsv_to_rgb(self, x): return self._op("hsv_to_rgb", x)
    def rgb_to_yuv(self, x): return self._op("rgb_to_yuv", x)
    def yuv_to_rgb(self, x): return self._op("yuv_to_rgb", x)
    def adjust_contrast(self, x, factor):
        return self._op("adjust_contrast", x, factor)
    def adjust_saturation(self, x, factor):
        return self._op("adjust_saturation", x, factor)
    def adjust_hue(self, x, delta): return self._op("adjust_hue", x, delta)
    def non_max_suppression(self, boxes, scores, max_out, iou_threshold=0.5,
                            score_threshold=float("-inf")):
        return self._op("non_max_suppression", boxes, scores,
                        max_output_size=max_out, iou_threshold=iou_threshold,
                        score_threshold=score_threshold)


_MASK64 = (1 << 64) - 1


def _fold(seed: int, data: int) -> int:
    """Mix ``data`` into ``seed`` (splitmix64), as ``jax.random.fold_in``
    derives a key from a key and an int."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) \
        & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def _meta(v: SDVariable, fill: Optional[int] = None) -> torch.Tensor:
    """A meta tensor of ``v``'s shape and dtype; ``fill`` stands for
    unknown extents (else an unknown extent raises)."""
    if v.shape is None:
        raise ValueError(f"{v.name} has no known rank")
    if fill is None and any(d is None for d in v.shape):
        raise ValueError(f"{v.name} has unknown extents")
    shape = tuple(fill if d is None else int(d) for d in v.shape)
    return torch.empty(shape, dtype=v.dtype or torch.float32, device="meta")


def _infer(fn, inputs, attrs):
    """Output shapes/dtypes of ``fn`` over ``inputs``' abstract values, in
    the reference's order: exact shapes, else (every input's rank known)
    a dtype-only retry with unknown extents set to 2, which keeps the
    rank as (None,)*rank. Returns (outputs or None, dtype_only)."""
    try:
        return fn(*[_meta(v) for v in inputs], **attrs), False
    except Exception:
        pass
    if inputs and all(v.shape is not None for v in inputs):
        try:
            return fn(*[_meta(v, 2) for v in inputs], **attrs), True
        except Exception:
            pass
    return None, False


_RANDOM_OPS = {"random_normal", "random_uniform", "random_bernoulli",
               "dropout", "dropout_inverted"}


class SameDiff:
    """The graph builder and session owner (ref: ``SameDiff``).

    Create with ``SameDiff.create(device=...)``; build variables and ops;
    run with ``output``/``exec``; train with ``fit`` after
    ``set_training_config``. ``device`` None is the card: the graph's
    values and feeds live there, unless the caller asks for the CPU.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._values: Dict[str, torch.Tensor] = {}
        self._ops: List[OpNode] = []
        self._producer: Dict[str, OpNode] = {}   # var name -> producing op
        self._name_counter: Dict[str, int] = {}
        self._loss_variables: List[str] = []
        self._branch_outputs: List[str] = []   # set when used as a CF body
        self.training_config: Optional[TrainingConfig] = None
        self._compiled_cache: Dict[Any, Callable] = {}
        self._train_step = None
        self._train_sig = None
        self._opt_state = None
        self._pending_opt_leaves = None
        self._pending_opt_named = None   # {paramName: {key: array}} from a
                                         # FlatGraph UpdaterState table
        self._pending_opt_updater = None  # class name of the updater that
                                          # produced the pending state
        self._seed = 12345
        self.listeners: List[Any] = []
        self.epoch_count = 0
        self.iteration_count = 0
        self.math = SDMath(self)
        self.nn = SDNN(self)
        self.cnn = SDCNN(self)
        self.rnn = SDRNN(self)
        self.loss = SDLoss(self)
        self.linalg = SDLinalg(self)
        self.random = SDRandom(self)
        self.bitwise = SDBitwise(self)
        self.image = SDImage(self)

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    # ---- multi-device -------------------------------------------------
    def set_mesh(self, mesh) -> "SameDiff":
        """Data-parallel training over several cards: not ported yet
        (ROADMAP queue 1 item 7, the multi-GPU slice)."""
        raise NotImplementedError(
            "SameDiff.set_mesh (data-parallel training over several cards) "
            "is not ported yet: ROADMAP queue 1 item 7")

    def _shard_feed(self, ph):
        raise NotImplementedError(
            "SameDiff._shard_feed belongs to set_mesh: ROADMAP queue 1 "
            "item 7")

    def _unique(self, base: str) -> str:
        if base not in self._vars and base not in self._name_counter:
            self._name_counter[base] = 0
            return base
        n = self._name_counter.get(base, 0) + 1
        self._name_counter[base] = n
        return f"{base}:{n}"

    def _register(self, v: SDVariable) -> SDVariable:
        self._vars[v.name] = v
        return v

    def _tensor(self, value, dtype=None) -> torch.Tensor:
        return _dt.as_tensor(value, self.device, dtype)

    def var(self, name: str, shape=None, dtype=torch.float32, init=None,
            weight_init=None) -> SDVariable:
        """Trainable variable. ``init`` may be a concrete array or a
        weight-init name from ``nn.weights`` (e.g. 'xavier', 'relu')."""
        name = self._unique(name)
        if init is not None and not isinstance(init, str):
            arr = self._tensor(init, dtype)
        else:
            if shape is None:
                raise ValueError("var() needs a shape or a concrete init "
                                 "array")
            from deeplearning4j_tpu_torch.nn import weights as _w
            scheme = init if isinstance(init, str) else (weight_init
                                                         or "xavier")
            shape = tuple(shape)
            fan_in = shape[0] if len(shape) >= 2 else max(
                1, int(np.prod(shape)))
            fan_out = shape[-1] if len(shape) >= 2 else fan_in
            # stable per-name seed (Python's hash() is salted per process)
            gen = torch.Generator().manual_seed(
                _fold(self._seed, zlib.crc32(name.encode("utf-8"))))
            arr = self._tensor(_w.init(scheme, gen, shape, fan_in, fan_out),
                               dtype)
        v = SDVariable(self, name, VariableType.VARIABLE, tuple(arr.shape),
                       arr.dtype)
        self._values[name] = arr
        self._invalidate_cache()
        return self._register(v)

    def constant(self, value, name: str = "const") -> SDVariable:
        arr = self._tensor(value)
        name = self._unique(name)
        v = SDVariable(self, name, VariableType.CONSTANT, tuple(arr.shape),
                       arr.dtype)
        self._values[name] = arr
        self._invalidate_cache()
        return self._register(v)

    def placeholder(self, name: str, shape=None,
                    dtype=torch.float32) -> SDVariable:
        name = self._unique(name)
        v = SDVariable(self, name, VariableType.PLACEHOLDER, shape, dtype)
        return self._register(v)

    def variable(self, *a, **k): return self.var(*a, **k)
    def one(self, name, shape):
        return self.constant(np.ones(shape, np.float32), name)
    def zero(self, name, shape):
        return self.constant(np.zeros(shape, np.float32), name)

    def _lift(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            if x.sd is not self:
                raise ValueError("variable belongs to a different SameDiff")
            return x
        return self.constant(x)

    # ---- op creation ---------------------------------------------------
    def _add_node(self, node: OpNode, out_names, out, dtype_only):
        """Register ``node``'s outputs from inferred ``out`` (meta tensors,
        or None when inference failed)."""
        self._ops.append(node)
        n_out = len(out_names)
        outs = []
        for i, on in enumerate(out_names):
            o = out if n_out == 1 else (
                out[i] if isinstance(out, (tuple, list)) else None)
            if not isinstance(o, torch.Tensor):
                shape, dtype = None, torch.float32
            elif dtype_only:
                # extents from the dummy pass are not trustworthy; the rank
                # is, so later ops' dtype-only retry still fires
                shape, dtype = (None,) * o.dim(), o.dtype
            else:
                shape, dtype = tuple(o.shape), o.dtype
            ov = SDVariable(self, on, VariableType.ARRAY, shape, dtype)
            self._register(ov)
            self._producer[on] = node
            outs.append(ov)
        self._invalidate_cache()
        return outs[0] if n_out == 1 else tuple(outs)

    def _op(self, op_name: str, *inputs: SDVariable, n_out: int = 1,
            name: str = None, **attrs):
        opdef = op_registry.get(op_name)
        node_name = self._unique(name or op_name)
        n_out = max(n_out, opdef.num_outputs)
        out_names = ([node_name] if n_out == 1
                     else [f"{node_name}#{i}" for i in range(n_out)])
        node = OpNode(node_name, op_name, [v.name for v in inputs],
                      out_names, attrs)
        out, dtype_only = _infer(opdef, inputs, attrs)
        return self._add_node(node, out_names, out, dtype_only)

    def _random_op(self, op_name: str, *inputs, **attrs):
        """Random ops draw from a per-node generator derived from the
        execution-time seed (see ``SDRandom``)."""
        attrs["__random_index__"] = len(self._ops)
        return self._op(op_name, *inputs, **attrs)

    def lambda_op(self, fn: Callable, *inputs: SDVariable, n_out: int = 1,
                  name: str = "lambda"):
        """Embed an arbitrary function of torch tensors as a graph node
        (non-serializable: ``save`` refuses it)."""
        node_name = self._unique(name)
        out_names = ([node_name] if n_out == 1
                     else [f"{node_name}#{i}" for i in range(n_out)])
        node = OpNode(node_name, "__lambda__", [v.name for v in inputs],
                      out_names, {}, fn=fn)
        try:
            out = fn(*[_meta(v) for v in inputs])
        except Exception:
            out = None
        return self._add_node(node, out_names, out, False)

    # ---- control flow ---------------------------------------------------
    def _build_body(self, builder: Callable, operands: Sequence[SDVariable]):
        """Trace ``builder(sub_sd, *arg_phs)`` into a nested SameDiff whose
        placeholders arg0..argN mirror the operands."""
        sub = SameDiff(self.device)
        phs = [sub.placeholder(f"arg{i}", v.shape, v.dtype)
               for i, v in enumerate(operands)]
        out = builder(sub, *phs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        sub._branch_outputs = [o.name for o in outs]
        return sub, outs

    def _cf_node(self, op_name, name, inputs, subgraphs, out_templates,
                 attrs=None):
        """A control-flow OpNode whose outputs take the branch's traced
        outputs' shapes and dtypes."""
        node_name = self._unique(name or op_name.strip("_"))
        n_out = len(out_templates)
        out_names = ([node_name] if n_out == 1
                     else [f"{node_name}#{i}" for i in range(n_out)])
        node = OpNode(node_name, op_name, [v.name for v in inputs],
                      out_names, attrs or {}, subgraphs=subgraphs)
        self._ops.append(node)
        outs = []
        for on, tmpl in zip(out_names, out_templates):
            ov = SDVariable(self, on, VariableType.ARRAY, tmpl.shape,
                            tmpl.dtype)
            self._register(ov)
            self._producer[on] = node
            outs.append(ov)
        self._invalidate_cache()
        return outs[0] if n_out == 1 else tuple(outs)

    def if_cond(self, pred: SDVariable, true_body: Callable,
                false_body: Callable, *operands: SDVariable,
                name: str = None):
        """Conditional (ref: ``SameDiff#ifCond``; TF If/StatelessIf).
        ``true_body``/``false_body`` are ``fn(sub_sd, *args) -> var(s)``
        builders traced into nested graphs; the predicate is read on the
        host and one branch runs. Branches must return matching
        shapes/dtypes."""
        pred = self._lift(pred)
        operands = [self._lift(o) for o in operands]
        t_sd, t_outs = self._build_body(true_body, operands)
        f_sd, f_outs = self._build_body(false_body, operands)
        if [(o.shape, o.dtype) for o in t_outs] != \
                [(o.shape, o.dtype) for o in f_outs]:
            raise ValueError("if_cond branches must return matching "
                             "shapes/dtypes")
        return self._cf_node("__cond__", name, [pred] + operands,
                             {"true": t_sd, "false": f_sd}, t_outs)

    ifCond = if_cond

    def while_loop(self, cond_body: Callable, loop_body: Callable,
                   *loop_vars: SDVariable, name: str = None):
        """While loop (ref: ``SameDiff#whileLoop``; TF While).
        ``cond_body(sub_sd, *state) -> scalar bool``; ``loop_body(sub_sd,
        *state) -> new state`` (same shapes/dtypes). A counted loop
        (``i < K; i += step`` with constant init, bound and step) records
        its trip count and runs its body that many times, with gradients,
        as the reference's ``lax.scan``; other loops read their condition
        on the host each trip."""
        loop_vars = [self._lift(v) for v in loop_vars]
        c_sd, c_outs = self._build_body(cond_body, loop_vars)
        if len(c_outs) != 1:
            raise ValueError("while_loop cond must return one scalar")
        b_sd, b_outs = self._build_body(loop_body, loop_vars)
        if len(b_outs) != len(loop_vars):
            raise ValueError("while_loop body must return one var per "
                             "loop var")

        def compatible(a, b):
            # None = unknown rank, None dim = unknown extent
            if a is None or b is None:
                return True
            if len(a) != len(b):
                return False
            return all(da is None or db is None or da == db
                       for da, db in zip(a, b))

        mismatched = [
            (v.name, v.shape, v.dtype, o.shape, o.dtype)
            for v, o in zip(loop_vars, b_outs)
            if v.dtype != o.dtype or not compatible(v.shape, o.shape)]
        if mismatched:
            raise ValueError(
                f"while_loop body must preserve loop-var shapes/dtypes; "
                f"mismatches (var, init shape/dtype, body shape/dtype): "
                f"{mismatched}")
        trip = _counted_trip(c_sd, b_sd, loop_vars)
        return self._cf_node("__while__", name, loop_vars,
                             {"cond": c_sd, "body": b_sd}, b_outs,
                             attrs=({"trip_count": int(trip)}
                                    if trip is not None else None))

    whileLoop = while_loop

    # ---- introspection -------------------------------------------------
    def get_variable(self, name: str) -> SDVariable:
        return self._vars[name]

    def has_variable(self, name: str) -> bool:
        return name in self._vars

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def variable_names(self) -> List[str]:
        return list(self._vars.keys())

    def trainable_names(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.var_type == VariableType.VARIABLE]

    def placeholders(self) -> List[str]:
        return [n for n, v in self._vars.items()
                if v.var_type == VariableType.PLACEHOLDER]

    # ---- updater-state naming (FlatGraph UpdaterState table) -----------
    def _walk_opt_state(self, state, fn):
        """``state`` with every leaf replaced by ``fn(paramName, stateKey,
        leaf)``: the reference's ``_opt_leaf_key`` naming of optax state
        paths (Adam's mu['w'] → ('w', '0/mu'); a step count → ('',
        '0/count')). A list of tensors is a param tree in sorted-name
        order."""
        names = sorted(self.trainable_names())

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + [str(k)]) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                if node and all(isinstance(x, torch.Tensor) for x in node) \
                        and len(node) == len(names):
                    key = "/".join(path) or "_"
                    return [fn(n, key, x) for n, x in zip(names, node)]
                return [walk(v, path + [str(i)]) for i, v in enumerate(node)]
            return fn("", "/".join(path) or "_", node)

        return walk(state, [])

    def _updater_state_by_param(self):
        """Current optimizer state grouped per parameter (None when no
        state exists), the FlatGraph ``updaterState`` payload. A graph
        loaded but not yet re-fit still holds its state as
        ``_pending_opt_named``."""
        if self._opt_state is None:
            if self._pending_opt_named is not None:
                return {p: dict(kv)
                        for p, kv in self._pending_opt_named.items()}
            return None
        out: Dict[str, Dict[str, np.ndarray]] = {}

        def take(pname, key, leaf):
            out.setdefault(pname, {})[key] = _leaf_numpy(leaf)
            return leaf

        self._walk_opt_state(self._opt_state, take)
        return out

    def ops(self) -> List[OpNode]:
        return list(self._ops)

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, "
                 f"{len(self._ops)} ops"]
        for v in self._vars.values():
            if v.var_type != VariableType.ARRAY:
                lines.append(f"  {v.var_type.value:<12} {v.name:<24} "
                             f"{v.shape}")
        for op in self._ops:
            lines.append(f"  op {op.op_name:<20} {op.inputs} -> "
                         f"{op.outputs}")
        return "\n".join(lines)

    def _rename(self, old: str, new: str):
        if new in self._vars:
            raise ValueError(f"variable {new!r} already exists")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._values:
            self._values[new] = self._values.pop(old)
        if old in self._producer:
            self._producer[new] = self._producer.pop(old)
        for op in self._ops:
            op.inputs = [new if i == old else i for i in op.inputs]
            op.outputs = [new if o == old else o for o in op.outputs]
        self._loss_variables = [new if n == old else n
                                for n in self._loss_variables]
        self._invalidate_cache()

    def set_loss_variables(self, *names):
        self._loss_variables = [n.name if isinstance(n, SDVariable) else n
                                for n in names]
        self._invalidate_cache()

    def set_training_config(self, config: TrainingConfig):
        self.training_config = config
        if config.loss_variables and not self._loss_variables:
            self._loss_variables = list(config.loss_variables)
        self._train_step = None
        self._opt_state = None

    def add_listener(self, listener):
        self.listeners.append(listener)

    def _invalidate_cache(self):
        self._compiled_cache.clear()
        self._train_step = None

    # ---- execution plan (the AbstractSession topo-walk) ----------------
    def _needed_ops(self, outputs: Sequence[str],
                    ops: Optional[List[OpNode]] = None) -> List[OpNode]:
        """Ops needed to compute ``outputs``, in graph order."""
        needed_vars = set(outputs)
        needed_ops: List[OpNode] = []
        for op in reversed(self._ops if ops is None else ops):
            if any(o in needed_vars for o in op.outputs):
                needed_ops.append(op)
                needed_vars.update(op.inputs)
        return list(reversed(needed_ops))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _emit(self, outputs: Sequence[str]) -> Callable:
        """``fn(values, placeholders, rng_seed) -> tuple``: one eager walk
        over the pruned op list in insertion order. The graph passes
        (``autodiff/passes.py``) rewrite a copy; pruning follows them so
        orphaned motif remnants drop out."""
        from deeplearning4j_tpu_torch.autodiff.passes import (
            optimize_for_emission)
        ops = self._needed_ops(outputs, optimize_for_emission(self._ops))
        outputs = list(outputs)

        def fn(values: Dict[str, torch.Tensor],
               placeholders: Dict[str, torch.Tensor], rng_seed=0):
            env: Dict[str, torch.Tensor] = dict(values)
            env.update(placeholders)
            for op_idx, op in enumerate(ops):
                args = [env[i] for i in op.inputs]
                if op.op_name == "__cond__":
                    key = _fold(rng_seed, 1 + op_idx)
                    branch = "true" if bool(torch.squeeze(args[0])) \
                        else "false"
                    res = op.subgraphs[branch]._branch_fn()(
                        *args[1:], rng_seed=key)
                    if len(op.outputs) == 1 and isinstance(res, tuple):
                        res = res[0]
                elif op.op_name == "__while__":
                    res = self._run_while(op, args,
                                          _fold(rng_seed, 1 + op_idx))
                elif op.fn is not None:
                    res = op.fn(*args)
                elif "__random_index__" in op.attrs:
                    res = self._run_random(op, args, rng_seed)
                else:
                    res = op_registry.exec_op(op.op_name, *args, **op.attrs)
                if len(op.outputs) == 1:
                    env[op.outputs[0]] = res
                else:
                    for on, r in zip(op.outputs, res):
                        env[on] = r
            return tuple(env[o] for o in outputs)

        return fn

    def _run_random(self, op: OpNode, args, rng_seed):
        attrs = dict(op.attrs)
        seed = _fold(rng_seed, attrs.pop("__random_index__"))
        node_seed = attrs.pop("seed", 0)
        if node_seed:
            seed = _fold(seed, node_seed)
        gen = self._generator(seed)
        if op.op_name in ("dropout", "dropout_inverted"):
            return op_registry.exec_op(op.op_name, args[0], gen, **attrs)
        return op_registry.exec_op(op.op_name, gen, **attrs)

    @staticmethod
    def _run_while(op: OpNode, args, key):
        b_fn = op.subgraphs["body"]._branch_fn()

        def body(st):
            r = b_fn(*st, rng_seed=key)
            r = r if isinstance(r, tuple) else (r,)
            # the carry keeps the initial dtypes exactly
            return tuple(x.to(s.dtype) for x, s in zip(r, st))

        state = tuple(args)
        trip = op.attrs.get("trip_count")
        if trip is not None:
            for _ in range(int(trip)):
                state = body(state)
        else:
            c_fn = op.subgraphs["cond"]._branch_fn()
            while bool(torch.squeeze(c_fn(*state))):
                state = body(state)
        return state[0] if len(op.outputs) == 1 else state

    def _branch_fn(self) -> Callable:
        """Executor for a control-flow body: g(*args) over placeholders
        arg0..argN, closing over this subgraph's constant values."""
        from deeplearning4j_tpu_torch.autodiff.passes import graph_opt_enabled
        outs = self._branch_outputs
        key = ("__branch__", graph_opt_enabled())
        emit = self._compiled_cache.get(key)
        if emit is None:
            emit = self._emit(outs)
            self._compiled_cache[key] = emit

        def g(*xs, rng_seed=0):
            ph = {f"arg{i}": x for i, x in enumerate(xs)}
            res = emit(self._values, ph, rng_seed)
            return res if len(outs) > 1 else res[0]

        return g

    # ---- execution ----------------------------------------------------
    def _feeds(self, placeholders) -> Dict[str, torch.Tensor]:
        return {k: self._tensor(v) for k, v in (placeholders or {}).items()}

    def _plan(self, outputs: Sequence[str], ph) -> Callable:
        """The cached walk for (outputs, graph-opt flag, feed signature):
        toggling the flag re-emits, as the reference's cache key does."""
        from deeplearning4j_tpu_torch.autodiff.passes import graph_opt_enabled
        key = (tuple(outputs), graph_opt_enabled(),
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in ph.items())))
        fn = self._compiled_cache.get(key)
        if fn is None:
            fn = self._emit(outputs)
            self._compiled_cache[key] = fn
        return fn

    def output(self, placeholders: Dict[str, Any],
               outputs: Union[str, Sequence[str], None] = None,
               rng_seed: int = 0) -> Dict[str, torch.Tensor]:
        """Whole-graph inference (ref: ``SameDiff#output``): tensors on
        the graph's device, by output name."""
        if outputs is None:
            produced = {o for op in self._ops for o in op.outputs}
            consumed = {i for op in self._ops for i in op.inputs}
            outputs = sorted(produced - consumed)
        if isinstance(outputs, str):
            outputs = [outputs]
        outputs = [o.name if isinstance(o, SDVariable) else o
                   for o in outputs]
        ph = self._feeds(placeholders)
        needed_inputs = {i for op in self._needed_ops(outputs)
                         for i in op.inputs}
        missing = [p for p in self.placeholders()
                   if p not in ph and p in needed_inputs]
        if missing:
            raise ValueError(f"missing placeholders: {missing}")
        with torch.no_grad():
            res = self._plan(outputs, ph)(self._values, ph, rng_seed)
        return dict(zip(outputs, res))

    def exec(self, placeholders=None, *outputs):
        return self.output(placeholders or {}, list(outputs) or None)

    def batch_output(self, placeholders, outputs):
        return self.output(placeholders, outputs)

    # ---- gradients ----------------------------------------------------
    def calculate_gradients(self, placeholders: Dict[str, Any],
                            wrt: Sequence[str] = None,
                            rng_seed: int = 0) -> Dict[str, torch.Tensor]:
        """Ref: ``SameDiff#calculateGradients``: the gradient of the sum of
        the loss variables, by torch autograd over the eager walk."""
        if not self._loss_variables:
            raise ValueError("no loss variables set (set_loss_variables)")
        wrt = list(wrt) if wrt else self.trainable_names()
        ph = self._feeds(placeholders)
        emitted = self._plan(self._loss_variables, ph)
        train = {n: self._values[n].detach().requires_grad_(True)
                 for n in wrt}
        fixed = {n: v for n, v in self._values.items() if n not in train}
        with torch.enable_grad():
            outs = emitted({**fixed, **train}, ph, rng_seed)
            loss = sum(o.sum() for o in outs)
        grads = torch.autograd.grad(loss, list(train.values()),
                                    allow_unused=True)
        return {n: (g if g is not None else torch.zeros_like(t))
                for (n, t), g in zip(train.items(), grads)}

    grad = calculate_gradients

    # ---- training -----------------------------------------------------
    def _build_train_step(self, ph_sig):
        tc = self.training_config
        transform = tc.transform()
        loss_names = list(self._loss_variables)
        emitted = self._emit(loss_names)
        names = sorted(self.trainable_names())     # the optax leaf order
        l1, l2 = tc.l1, tc.l2

        def step(params, fixed_vals, opt_state, ph, rng_seed):
            leaves = [p.detach().requires_grad_(True) for p in params]
            with torch.enable_grad():
                outs = emitted({**fixed_vals, **dict(zip(names, leaves))},
                               ph, rng_seed)
                loss = sum(o.sum() for o in outs)
                if l2:
                    loss = loss + l2 * sum((p * p).sum() for p in leaves)
                if l1:
                    # |p| with the reference's derivative at 0 (+1, as
                    # lax.abs differentiates), which zero-init biases hit
                    loss = loss + l1 * sum(torch.where(p >= 0, p, -p).sum()
                                           for p in leaves)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, params)]
            with torch.no_grad():
                updates, opt_state = transform.update(grads, opt_state,
                                                      params)
                params = _T.apply_updates(params, updates)
            return params, opt_state, loss.detach()

        init_state = transform.init([self._values[n] for n in names])
        if self._pending_opt_leaves is not None:
            # updater state from a zip checkpoint, leaf for leaf
            same_upd = (self._pending_opt_updater is None
                        or tc.updater is None
                        or self._pending_opt_updater
                        == type(tc.updater).__name__)
            leaves = list(self._pending_opt_leaves)
            if same_upd and len(leaves) == len(_T.state_leaves(init_state)):
                it = iter(leaves)
                init_state = self._walk_opt_state(
                    init_state, lambda p, k, leaf: _leaf_like(next(it), leaf))
            self._pending_opt_leaves = None
            self._pending_opt_updater = None
        elif self._pending_opt_named is not None:
            # per-parameter state from a FlatGraph UpdaterState table,
            # matched by (paramName, stateKey): robust to leaf order
            ok = not (self._pending_opt_updater is not None
                      and tc.updater is not None
                      and self._pending_opt_updater
                      != type(tc.updater).__name__)
            named = self._pending_opt_named

            def take(pname, key, leaf):
                nonlocal ok
                arr = named.get(pname, {}).get(key) if ok else None
                if arr is None or tuple(np.shape(arr)) != _leaf_shape(leaf):
                    ok = False
                    return leaf
                return _leaf_like(arr, leaf)

            restored = self._walk_opt_state(init_state, take)
            if ok:
                init_state = restored
            else:
                warnings.warn(
                    "saved updaterState does not match the updater's "
                    "state tree (different updater config?) — starting "
                    "from fresh optimizer state", stacklevel=2)
            self._pending_opt_named = None
            self._pending_opt_updater = None
        return step, init_state

    def evaluate(self, iterator, output_name: str, evaluation=None,
                 label_index: int = 0):
        """Evaluate a graph output against iterator labels (ref:
        ``SameDiff#evaluate``); placeholders bind by the training config's
        feature mapping; ``evaluation`` defaults to ``Evaluation``."""
        from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                           MultiDataSet)
        from deeplearning4j_tpu_torch.eval.classification import Evaluation

        if self.training_config is None:
            raise ValueError("call set_training_config first (the feature "
                             "mapping binds iterator columns to "
                             "placeholders)")
        ev = evaluation if evaluation is not None else Evaluation()
        tc = self.training_config
        if hasattr(iterator, "reset"):
            iterator.reset()
        data = iterator
        if isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        for ds in data:
            feats = ds.features if isinstance(ds.features, (list, tuple)) \
                else [ds.features]
            labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
                else [ds.labels]
            ph = dict(zip(tc.data_set_feature_mapping, feats))
            out = self.output(ph, [output_name])[output_name]
            ev.eval(_numpy(labs[label_index]), out.detach().cpu().numpy())
        return ev

    def _batches(self, data):
        from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                           MultiDataSet)
        tc = self.training_config
        if isinstance(data, dict):
            yield self._feeds(data)
            return
        it = data
        if isinstance(it, (DataSet, MultiDataSet)):
            it = [it]
        for ds in it:
            feats = ds.features if isinstance(ds.features, (list, tuple)) \
                else [ds.features]
            labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
                else [ds.labels]
            ph = {}
            for name, arr in zip(tc.data_set_feature_mapping, feats):
                ph[name] = self._tensor(_numpy(arr))
            for name, arr in zip(tc.data_set_label_mapping, labs):
                ph[name] = self._tensor(_numpy(arr))
            yield ph

    def fit(self, data=None, epochs: int = 1, batch_size: int = None,
            rng_seed: int = 0):
        """Train (ref: ``SameDiff#fit``). ``data`` is a DataSet/
        MultiDataSet, an iterable of them, or a dict of placeholder
        arrays; placeholders bind by the training config's feature and
        label mappings. Returns the per-step losses."""
        if self.training_config is None:
            raise ValueError("call set_training_config first")
        tc = self.training_config
        losses = []
        # a one-shot iterator would yield nothing on epochs 2..N
        if (epochs > 1 and isinstance(data, _abc.Iterator)
                and not hasattr(data, "reset")):
            data = list(data)
        from deeplearning4j_tpu_torch.autodiff.passes import graph_opt_enabled
        trainable = self.trainable_names()
        sig = (tuple(trainable), tuple(self._loss_variables),
               graph_opt_enabled(),
               json.dumps(tc.to_dict(), sort_keys=True, default=str))
        if self._train_step is None or self._train_sig != sig:
            keep_state = (self._train_sig == sig
                          and self._opt_state is not None
                          and self._pending_opt_leaves is None
                          and self._pending_opt_named is None)
            self._train_step, fresh_state = self._build_train_step(sig)
            if not keep_state:
                self._opt_state = fresh_state
            self._train_sig = sig
        names = sorted(trainable)
        train_set = set(trainable)
        fixed_vals = {n: v for n, v in self._values.items()
                      if n not in train_set}
        for epoch in range(epochs):
            if epoch > 0 and hasattr(data, "reset"):
                data.reset()
            for ph in self._batches(data):
                params = [self._values[n] for n in names]
                params, self._opt_state, loss = self._train_step(
                    params, fixed_vals, self._opt_state, ph,
                    rng_seed + self.iteration_count)
                self._values.update(zip(names, params))
                loss = float(loss)
                losses.append(loss)
                self.iteration_count += 1
                for lst in self.listeners:
                    if hasattr(lst, "iteration_done"):
                        lst.iteration_done(self, self.iteration_count, loss)
            self.epoch_count += 1
            for lst in self.listeners:
                if hasattr(lst, "on_epoch_end"):
                    lst.on_epoch_end(self, self.epoch_count)
        return History(losses)

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu.samediff/1",
            "variables": [
                {"name": v.name, "type": v.var_type.value,
                 "shape": list(v.shape) if v.shape is not None else None,
                 "dtype": _dt.name_of(v.dtype or torch.float32)}
                for v in self._vars.values()],
            "ops": [op.to_dict() for op in self._ops],
            "lossVariables": self._loss_variables,
            "trainingConfig": (self.training_config.to_dict()
                               if self.training_config else None),
        }

    def _gather_values(self, prefix: str = "") -> Dict[str, np.ndarray]:
        """This graph's values plus all control-flow subgraph values,
        flattened under npz-safe prefixed keys."""
        out = {prefix + n: _numpy(v) for n, v in self._values.items()}
        for op in self._ops:
            if op.subgraphs:
                for k, sg in op.subgraphs.items():
                    out.update(sg._gather_values(
                        f"{prefix}__sub__/{op.name}/{k}/"))
        return out

    def as_flat_buffers(self, include_updater_state: bool = False) -> bytes:
        """The graph as a FlatGraph binary (ref: ``SameDiff#asFlatBuffers``;
        ``autodiff/flatgraph.py``)."""
        from deeplearning4j_tpu_torch.autodiff import flatgraph

        return flatgraph.to_flat_buffers(
            self, include_updater_state=include_updater_state)

    asFlatBuffers = as_flat_buffers

    @staticmethod
    def from_flat_buffers(data: bytes, device=None) -> "SameDiff":
        """Parse a FlatGraph binary (ref: ``SameDiff#fromFlatBuffers``)."""
        from deeplearning4j_tpu_torch.autodiff import flatgraph

        return flatgraph.from_flat_buffers(data, device=device)

    fromFlatBuffers = from_flat_buffers

    def save(self, path: str, save_updater_state: bool = False):
        """Persist graph and values: a ``.fb``/``.fbs``/``.sdfb`` path
        writes the FlatGraph binary, anything else the zip container.
        With ``save_updater_state`` both keep the optimizer state."""
        if str(path).endswith((".fb", ".fbs", ".sdfb")):
            with open(path, "wb") as f:
                f.write(self.as_flat_buffers(
                    include_updater_state=save_updater_state))
            return
        d = self.to_dict()
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(d, indent=1))
            buf = io.BytesIO()
            np.savez(buf, **self._gather_values())
            zf.writestr("values.npz", buf.getvalue())
            if not save_updater_state:
                return
            leaves = None
            if self._opt_state is not None:
                leaves = [_leaf_numpy(x)
                          for x in _T.state_leaves(self._opt_state)]
            elif self._pending_opt_leaves is not None:
                leaves = [np.asarray(x) for x in self._pending_opt_leaves]
            elif self._pending_opt_named is not None:
                # named fb-style state has no flat order: write it named
                buf = io.BytesIO()
                np.savez(buf, **{
                    f"{p}||{k}": np.asarray(v)
                    for p, kv in self._pending_opt_named.items()
                    for k, v in kv.items()})
                zf.writestr("updater_named.npz", buf.getvalue())
            if leaves is not None:
                buf = io.BytesIO()
                np.savez(buf, **{f"leaf{i}": x
                                 for i, x in enumerate(leaves)})
                zf.writestr("updater.npz", buf.getvalue())

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """Load a zip or FlatGraph file, written by either package, onto
        ``device`` (None: the card)."""
        from deeplearning4j_tpu_torch.autodiff import flatgraph

        if str(path).endswith((".fb", ".fbs", ".sdfb")):
            return flatgraph.load_flatbuffers(path, device=device)
        if not zipfile.is_zipfile(path):
            try:
                return flatgraph.load_flatbuffers(path, device=device)
            except Exception as e:
                raise ValueError(
                    f"{path!r} is neither a SameDiff zip (corrupt or "
                    f"truncated?) nor a readable FlatGraph binary: "
                    f"{e!r}") from e
        opt_leaves = None
        opt_named = None
        with zipfile.ZipFile(path) as zf:
            d = json.loads(zf.read("graph.json"))
            with zf.open("values.npz") as f:
                values = dict(np.load(io.BytesIO(f.read())))
            if "updater.npz" in zf.namelist():
                with zf.open("updater.npz") as f:
                    raw = dict(np.load(io.BytesIO(f.read())))
                opt_leaves = [raw[f"leaf{i}"] for i in range(len(raw))]
            elif "updater_named.npz" in zf.namelist():
                with zf.open("updater_named.npz") as f:
                    raw = dict(np.load(io.BytesIO(f.read())))
                opt_named = {}
                for key, arr in raw.items():
                    pname, _, skey = key.partition("||")
                    opt_named.setdefault(pname, {})[skey] = arr
        sd = SameDiff._restore(d, values, resolve_device(device))
        sd._pending_opt_leaves = opt_leaves
        sd._pending_opt_named = opt_named
        if opt_leaves is not None or opt_named is not None:
            upd = getattr(sd.training_config, "updater", None)
            if upd is not None:
                sd._pending_opt_updater = type(upd).__name__
        return sd

    @staticmethod
    def _restore(d: dict, values: Dict[str, np.ndarray],
                 device) -> "SameDiff":
        """Rebuild a SameDiff (or a control-flow subgraph) from its dict."""
        sd = SameDiff(device)
        for vd in d["variables"]:
            v = SDVariable(sd, vd["name"], VariableType(vd["type"]),
                           tuple(vd["shape"]) if vd["shape"] is not None
                           else None, vd["dtype"])
            sd._vars[v.name] = v
            if v.name in values and v.var_type in (VariableType.VARIABLE,
                                                   VariableType.CONSTANT):
                sd._values[v.name] = sd._tensor(values[v.name])
        for od in d["ops"]:
            subgraphs = None
            if od.get("subgraphs"):
                subgraphs = {}
                for k, sub_d in od["subgraphs"].items():
                    p = f"__sub__/{od['name']}/{k}/"
                    sub_vals = {n[len(p):]: v for n, v in values.items()
                                if n.startswith(p)}
                    sub = SameDiff._restore(sub_d["graph"], sub_vals, device)
                    sub._branch_outputs = list(sub_d["outputs"])
                    subgraphs[k] = sub
            node = OpNode(od["name"], od["op"], od["inputs"], od["outputs"],
                          od["attrs"], subgraphs=subgraphs)
            sd._ops.append(node)
            for o in node.outputs:
                sd._producer[o] = node
        sd._loss_variables = d.get("lossVariables", [])
        if d.get("trainingConfig"):
            sd.training_config = TrainingConfig.from_dict(d["trainingConfig"])
        sd._reseed_name_counters()
        return sd

    def _reseed_name_counters(self):
        """Make future ``_unique`` names skip past every loaded name."""
        for n in self._vars:
            base = n.split(":")[0].split("#")[0]
            cur = self._name_counter.get(base, 0)
            try:
                suffix = int(n.split(":")[1]) if ":" in n else 0
            except ValueError:
                suffix = 0
            self._name_counter[base] = max(cur, suffix)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaf_numpy(leaf) -> np.ndarray:
    """An optimizer-state leaf as the reference stores it: a step count is
    an int32 scalar, as optax keeps it."""
    if isinstance(leaf, torch.Tensor):
        return _numpy(leaf)
    return np.asarray(leaf, np.int32)


def _leaf_shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _leaf_like(arr, leaf):
    """``arr`` (numpy) in the place of the fresh state leaf ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        return torch.as_tensor(np.array(arr), dtype=leaf.dtype,
                               device=leaf.device)
    return int(np.asarray(arr))
