"""Layer configurations and their functional implementations: counterpart
of the feed-forward and CNN layers of ``deeplearning4j_tpu/nn/conf/layers.py``.

As in the reference, one dataclass per layer carries both the
JSON-serializable config and the functional ``init_params`` / ``apply``
pair; autograd replaces the reference's hand-written backward per layer.

Conventions (the reference's):
- activations NHWC; conv weights HWIO (``W`` of a ``ConvolutionLayer`` is
  (kh, kw, in, out)); ``ops.standard.conv2d`` hands cuDNN the OIHW view;
- ``apply(params, x, training, gen, state)`` returns ``(y, new_state)``;
  ``state`` carries batch-norm running stats (the only stateful layer);
  ``gen`` is the network's ``torch.Generator`` for dropout, or None;
- the ``dropout`` field is the RETAIN probability;
- param dict insertion order defines the flat-param-vector layout.

Ported here: ``Layer``, ``DenseLayer``, ``OutputLayer``, ``LossLayer``,
``ActivationLayer``, ``DropoutLayer``, ``FlattenLayer``,
``ConvolutionLayer``, ``SubsamplingLayer``, ``ZeroPaddingLayer``,
``GlobalPoolingLayer``, ``BatchNormalization`` and
``LocalResponseNormalization``. The recurrent, attention, 1-D/3-D,
embedding and ``layers2`` layers wait (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import losses as _loss
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, conv_out_size
from deeplearning4j_tpu_torch.ops import standard as _ops
from deeplearning4j_tpu_torch.ops.moments import one_pass_moments

_LAYER_TYPES: Dict[str, type] = {}


def register_layer(cls):
    _LAYER_TYPES[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict) -> "Layer":
    d = dict(d)
    kind = d.pop("@layer")
    if kind not in _LAYER_TYPES:
        raise ValueError(f"layer type {kind!r} is not ported yet (have "
                         f"{sorted(_LAYER_TYPES)})")
    cls = _LAYER_TYPES[kind]
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: _revive(k, v) for k, v in d.items() if k in field_names})


def _revive(k, v):
    if k == "dropout" and isinstance(v, dict):
        from deeplearning4j_tpu_torch.nn.conf.dropout import dropout_from_dict
        return dropout_from_dict(v)
    if isinstance(v, list):
        return tuple(v)
    return v


def _pad4(v):
    """int | (h, w) | (top, bottom, left, right) → 4-tuple."""
    if isinstance(v, int):
        return (v, v, v, v)
    v = tuple(v)
    if len(v) == 2:
        return (v[0], v[0], v[1], v[1])
    return v


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@dataclasses.dataclass
class Layer:
    """Base layer config."""
    name: Optional[str] = None
    # trainable-layer hyperparams; None = inherit network default
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None     # retain probability
    bias_init: float = 0.0
    # weight noise (a dict in the reference's JSON): not ported yet, so a
    # network with it set raises at init (nn/_network.py)
    weight_noise: Any = None

    # ---------------- config protocol
    def to_dict(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if not k.startswith("_") and (v is not None or k in ("name",))}
        from deeplearning4j_tpu_torch.nn.conf.dropout import IDropout
        if isinstance(self.dropout, IDropout):
            d["dropout"] = self.dropout.to_dict()
        d["@layer"] = type(self).__name__
        return d

    def apply_global_defaults(self, defaults: dict):
        """Fill None fields from NeuralNetConfiguration global defaults."""
        for k in ("activation", "weight_init", "l1", "l2", "dropout"):
            if getattr(self, k, None) is None and defaults.get(k) is not None:
                setattr(self, k, defaults[k])
        if self.activation is None:
            self.activation = "identity"
        if self.weight_init is None:
            self.weight_init = "xavier"

    # ---------------- shape protocol
    def set_n_in(self, input_type: InputType):
        pass

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    # ---------------- param protocol
    def init_params(self, gen) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        return {}

    def has_params(self) -> bool:
        return bool(self.param_shapes())

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Ordered name->shape; defines flat-vector layout."""
        return {}

    def n_params(self) -> int:
        total = 0
        for s in self.param_shapes().values():
            n = 1
            for d in s:
                n *= int(d)
            total += n
        return total

    # ---------------- execution protocol
    def apply(self, params, x, training=False, gen=None, state=None):
        raise NotImplementedError

    def _maybe_dropout(self, x, training, gen):
        """Input dropout: a float is the retain probability; an IDropout
        object is its own scheme."""
        if not training or self.dropout is None or gen is None:
            return x
        from deeplearning4j_tpu_torch.nn.conf.dropout import IDropout
        if isinstance(self.dropout, IDropout):
            return self.dropout.apply(x, gen, training)
        if self.dropout < 1.0:
            return _ops.dropout_inverted(x, gen, p=self.dropout)
        return x

    def _act(self, z):
        return _act.get(self.activation or "identity")(z)


# --------------------------------------------------------------------- dense
@register_layer
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully connected."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = (input_type.size if input_type.kind == "rnn"
                         else input_type.array_elements())

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn":
            return InputType.recurrent(self.n_out, input_type.timeseries_length)
        return InputType.feed_forward(self.n_out)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        p = {"W": _winit.init(self.weight_init, gen, (self.n_in, self.n_out),
                              self.n_in, self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def _affine(self, params, x):
        if x.dim() >= 4 or (x.dim() == 3 and x.shape[-1] != self.n_in):
            x = x.reshape(x.shape[0], -1)   # implicit CNN→FF flatten
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        return self._act(self._affine(params, x)), state


@register_layer
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head."""
    loss_function: str = "mcxent"

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        """Score contribution; the fused logits form where there is one."""
        x = self._maybe_dropout(x, training, gen)
        z = self._affine(params, x)
        fused = _loss.get_fused(self.loss_function, self.activation)
        if fused is not None:
            return fused(z, labels, mask)
        return _loss.get(self.loss_function)(self._act(z), labels, mask)


@register_layer
@dataclasses.dataclass
class LossLayer(Layer):
    """Loss without params."""
    loss_function: str = "mse"

    def apply(self, params, x, training=False, gen=None, state=None):
        return self._act(x), state

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        fused = _loss.get_fused(self.loss_function,
                                self.activation or "identity")
        if fused is not None:
            return fused(x, labels, mask)
        return _loss.get(self.loss_function)(self._act(x), labels, mask)


@register_layer
@dataclasses.dataclass
class ActivationLayer(Layer):
    def apply(self, params, x, training=False, gen=None, state=None):
        return self._act(x), state


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    def apply(self, params, x, training=False, gen=None, state=None):
        return self._maybe_dropout(x, training, gen), state


@register_layer
@dataclasses.dataclass
class FlattenLayer(Layer):
    """(N, ...) → (N, ∏dims) row-major (NHWC order)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.array_elements())

    def apply(self, params, x, training=False, gen=None, state=None):
        return x.reshape(x.shape[0], -1), state


# ---------------------------------------------------------------------- conv
@dataclasses.dataclass
class _ConvBase(Layer):
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Any = 0                       # int, (int,int), or "same"
    dilation: Tuple[int, int] = (1, 1)
    n_in: Optional[int] = None             # input channels
    n_out: Optional[int] = None            # output channels
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        self.dilation = _pair(self.dilation)
        if not isinstance(self.padding, str):
            self.padding = _pair(self.padding)

    def _lax_padding(self):
        if isinstance(self.padding, str):
            return self.padding.upper()
        return [(p, p) for p in self.padding]

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.channels

    def _spatial_out(self, input_type: InputType):
        same = isinstance(self.padding, str) and self.padding.lower() == "same"
        ph, pw = (0, 0) if same else self.padding
        h = conv_out_size(input_type.height, self.kernel_size[0],
                          self.stride[0], ph, self.dilation[0], same)
        w = conv_out_size(input_type.width, self.kernel_size[1],
                          self.stride[1], pw, self.dilation[1], same)
        return h, w


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(_ConvBase):
    """2-D convolution, NHWC activations, HWIO weights."""

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial_out(input_type)
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        fan_in = kh * kw * self.n_in
        fan_out = kh * kw * self.n_out
        p = {"W": _winit.init(self.weight_init, gen,
                              (kh, kw, self.n_in, self.n_out), fan_in, fan_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        z = _ops.conv2d(x, params["W"], params.get("b"), strides=self.stride,
                        padding=self._lax_padding(), dilation=self.dilation)
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling: max, avg or pnorm."""
    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Any = 0
    pnorm: int = 2

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        if not isinstance(self.padding, str):
            self.padding = _pair(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        same = isinstance(self.padding, str) and self.padding.lower() == "same"
        ph, pw = (0, 0) if same else self.padding
        h = conv_out_size(input_type.height, self.kernel_size[0],
                          self.stride[0], ph, 1, same)
        w = conv_out_size(input_type.width, self.kernel_size[1],
                          self.stride[1], pw, 1, same)
        return InputType.convolutional(h, w, input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        pad = (self.padding.upper() if isinstance(self.padding, str)
               else self.padding)
        kind = self.pooling_type.lower()
        if kind == "max":
            return _ops.maxpool2d(x, self.kernel_size, self.stride, pad), state
        if kind == "avg":
            return _ops.avgpool2d(x, self.kernel_size, self.stride, pad), state
        if kind == "pnorm":
            return _ops.pnormpool2d(x, self.kernel_size, self.stride, pad,
                                    pnorm=self.pnorm), state
        raise KeyError(self.pooling_type)


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)  # top,bottom,left,right

    def __post_init__(self):
        self.padding = _pad4(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.padding
        return InputType.convolutional(input_type.height + t + b,
                                       input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        t, b, l, r = self.padding
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Pools CNN spatial dims or RNN time."""
    pooling_type: str = "max"

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind in ("cnn", "cnn3d"):
            return InputType.feed_forward(input_type.channels)
        if input_type.kind == "rnn":
            return InputType.feed_forward(input_type.size)
        return input_type

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        dims = tuple(range(1, x.dim() - 1))
        pt = self.pooling_type.lower()
        if pt == "max":
            return torch.amax(x, dim=dims), state
        if pt == "avg":
            if mask is not None and x.dim() == 3:
                m = mask[..., None].to(x.dtype)
                return (torch.sum(x * m, dim=1)
                        / torch.clamp_min(torch.sum(m, dim=1), 1.0)), state
            return torch.mean(x, dim=dims), state
        if pt == "sum":
            return torch.sum(x, dim=dims), state
        if pt == "pnorm":
            return torch.sum(torch.abs(x) ** 2, dim=dims) ** 0.5, state
        raise ValueError(self.pooling_type)


# ------------------------------------------------------------ normalization
@register_layer
@dataclasses.dataclass
class BatchNormalization(Layer):
    """The only stateful layer: running mean and var in ``state``.

    Training normalizes by the batch's one-pass moments (in >= f32) and
    moves each running statistic to ``decay·old + (1 − decay)·batch`` with
    the batch's biased variance; inference normalizes by the running
    statistics. ``F.batch_norm``'s training mode is not used: it updates
    running_var with the unbiased variance and the other momentum."""
    n_out: Optional[int] = None    # feature count, inferred
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False

    def set_n_in(self, input_type: InputType):
        if self.n_out is None:
            self.n_out = (input_type.channels
                          if input_type.kind in ("cnn", "cnn3d")
                          else input_type.size)

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def init_params(self, gen):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.ones((self.n_out,)),
                "beta": torch.zeros((self.n_out,))}

    def init_state(self):
        return {"mean": torch.zeros((self.n_out,)),
                "var": torch.ones((self.n_out,))}

    def apply(self, params, x, training=False, gen=None, state=None):
        if training:
            mean, var = one_pass_moments(x, tuple(range(x.dim() - 1)))
            new_state = {
                "mean": self.decay * state["mean"]
                + (1 - self.decay) * mean.detach(),
                "var": self.decay * state["var"]
                + (1 - self.decay) * var.detach(),
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        out = _ops.batchnorm(x, mean, var, params.get("gamma"),
                             params.get("beta"), epsilon=self.eps)
        return out, new_state


@register_layer
@dataclasses.dataclass
class LocalResponseNormalization(Layer):
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, training=False, gen=None, state=None):
        return _ops.lrn(x, depth_radius=self.n // 2, bias=self.k,
                        alpha=self.alpha, beta=self.beta), state
