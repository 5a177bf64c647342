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
``GlobalPoolingLayer``, ``BatchNormalization``,
``LocalResponseNormalization``, ``EmbeddingLayer``,
``EmbeddingSequenceLayer`` and the recurrent layers (``LSTM``,
``GravesLSTM``, ``GRU``, ``SimpleRnn``, ``Bidirectional``,
``RnnOutputLayer``, ``LastTimeStep``; their time loops in
``kernels/rnn_cell.py``) and the attention layers
(``SelfAttentionLayer``, ``CrossAttentionLayer``,
``LearnedSelfAttentionLayer``, ``RecurrentAttentionLayer``: each computes
``ops.standard.dot_product_attention``, which runs on the flash kernels
K1/K2 with the sequence mask as a key mask). The other layers of the
reference (``CenterLossOutputLayer``, the 1-D/3-D and deconvolution
layers, ``layers2``) wait (ROADMAP queue 1 item 8.3).
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
from deeplearning4j_tpu_torch.ops.standard import promote_mm

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
        z = promote_mm(x, params["W"])
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


# ---------------------------------------------------------------- embedding
@register_layer
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index → vector: (N,) or (N, 1) indices → (N, n_out), a gather."""
    n_in: Optional[int] = None   # vocab
    n_out: Optional[int] = None
    has_bias: bool = False

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.array_elements()

    def output_type(self, input_type: InputType) -> InputType:
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
            p["b"] = torch.zeros((self.n_out,))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[1] == 1:
            idx = idx[:, 0]
        z = params["W"][idx]
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """(N, T) indices → (N, T, n_out)."""
    input_length: int = -1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.input_length)


# ---------------------------------------------------------------- recurrent
@dataclasses.dataclass
class _RnnBase(Layer):
    """A recurrent layer: ``run`` is the time loop over ``step``, with the
    reference's mask semantics (a masked step freezes the carry and zeroes
    the output; the float mask counts as set where it is nonzero). The
    carries are f32. Here the loop runs the torch ``step`` under autograd;
    an LSTM on a kernel's route runs ``kernels/rnn_cell.py``'s
    ``LSTMLayer``, one autograd node a layer."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None

    def apply_global_defaults(self, defaults: dict):
        # recurrent layers default to tanh, not identity
        if self.activation is None and defaults.get("activation") is None:
            self.activation = "tanh"
        super().apply_global_defaults(defaults)

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def initial_carry(self, batch: int, device=None, dtype=torch.float32):
        return (torch.zeros((batch, self.n_out), device=device,
                            dtype=dtype),)

    def carry_for(self, x):
        """Zero carries for the input ``x``: f32, as the reference's (f64
        for an f64 input)."""
        return self.initial_carry(x.shape[0], x.device,
                                  torch.promote_types(x.dtype,
                                                      torch.float32))

    def step(self, params, carry, x_t):
        raise NotImplementedError

    def run(self, params, x, carry0, mask=None):
        """(N, T, C) + carry → ((N, T, H), final carry)."""
        carry, outs = tuple(carry0), []
        for t in range(x.shape[1]):
            new, h = self.step(params, carry, x[:, t])
            if mask is not None:
                m = mask[:, t, None]
                keep = m != 0
                new = tuple(torch.where(keep, a, b)
                            for a, b in zip(new, carry))
                h = h * m
            carry = new
            outs.append(h)
        return torch.stack(outs, dim=1), carry

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        x = self._maybe_dropout(x, training, gen)
        out, _ = self.run(params, x, self.carry_for(x), mask=mask)
        return out, state


@register_layer
@dataclasses.dataclass
class LSTM(_RnnBase):
    """Fused-gate LSTM, gate order (i, f, g, o). Its time loop is the
    layer Function ``kernels/rnn_cell.py`` ``LSTMLayer`` when K11 takes the
    cell activation (``rnn_cell.ACTIVATIONS``: tanh, identity, relu,
    sigmoid, hardtanh, softsign): on the card one K11L launch a layer each
    way up to ``rnn_cell.MAX_LAYER_HIDDEN`` units, K11 a step past it; the
    plain versions on the CPU. With any other activation it is the plain
    step in ``_RnnBase.run``'s loop. The route follows from the
    configuration (:meth:`cell_route`), never from a failed launch."""
    forget_gate_bias_init: float = 1.0

    def param_shapes(self):
        # order W (input), RW (recurrent), b
        return {"W": (self.n_in, 4 * self.n_out),
                "RW": (self.n_out, 4 * self.n_out),
                "b": (4 * self.n_out,)}

    def init_params(self, gen):
        h = self.n_out
        b = torch.zeros((4 * h,))
        b[h:2 * h] = self.forget_gate_bias_init      # the forget gate
        return {
            "W": _winit.init(self.weight_init, gen, (self.n_in, 4 * h),
                             self.n_in, h),
            "RW": _winit.init(self.weight_init, gen, (h, 4 * h), h, h),
            "b": b,
        }

    def initial_carry(self, batch: int, device=None, dtype=torch.float32):
        return tuple(torch.zeros((batch, self.n_out), device=device,
                                 dtype=dtype) for _ in range(2))

    def cell_route(self) -> str:
        """"k11_layer" (the whole layer a K11L launch), "k11" (the fused
        cell a step, for a layer too wide for K11L) or "step" (the plain
        step in a loop): ``rnn_cell.cell_route``."""
        from deeplearning4j_tpu_torch.kernels.rnn_cell import cell_route
        return cell_route(self.activation or "identity", self.n_out)

    def _peepholes(self, params):
        return None, None, None

    def run(self, params, x, carry0, mask=None):
        route = self.cell_route()
        if route == "step":
            return super().run(params, x, carry0, mask)
        from deeplearning4j_tpu_torch.kernels import rnn_cell
        p_i, p_f, p_o = self._peepholes(params)
        y, h, c = rnn_cell.LSTMLayer.apply(
            rnn_cell.act_code(self.activation or "identity"), route, x,
            params["W"], params["RW"], params["b"], p_i, p_f, p_o,
            carry0[0], carry0[1], mask)
        return y, (h, c)

    def step(self, params, carry, x_t):
        h_prev, c_prev = carry
        z = (promote_mm(x_t, params["W"]) + promote_mm(h_prev, params["RW"])
             + params["b"])
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * self._act(c)
        return (h, c), h


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections ``pI``, ``pF``, ``pO`` (the char-RNN
    BASELINE config's layer); K11 takes them."""

    def param_shapes(self):
        shapes = dict(super().param_shapes())
        shapes["pI"] = (self.n_out,)
        shapes["pF"] = (self.n_out,)
        shapes["pO"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        p = super().init_params(gen)
        for k in ("pI", "pF", "pO"):
            p[k] = torch.zeros((self.n_out,))
        return p

    def _peepholes(self, params):
        return params["pI"], params["pF"], params["pO"]

    def step(self, params, carry, x_t):
        h_prev, c_prev = carry
        z = (promote_mm(x_t, params["W"]) + promote_mm(h_prev, params["RW"])
             + params["b"])
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i = torch.sigmoid(i + params["pI"] * c_prev)
        f = torch.sigmoid(f + params["pF"] * c_prev)
        c = f * c_prev + i * torch.tanh(g)
        o = torch.sigmoid(o + params["pO"] * c)
        h = o * self._act(c)
        return (h, c), h


@register_layer
@dataclasses.dataclass
class GRU(_RnnBase):
    """GRU, gate order (r, u, n), the reset gate applied after the
    recurrent product (``reset_after``); ``recurrent_bias`` adds that
    formulation's recurrent bias ``bR``. No kernel yet (ROADMAP queue 2,
    K12): its step runs in ``_RnnBase.run``'s loop."""
    recurrent_bias: bool = False

    def param_shapes(self):
        shapes = {"W": (self.n_in, 3 * self.n_out),
                  "RW": (self.n_out, 3 * self.n_out),
                  "b": (3 * self.n_out,)}
        if self.recurrent_bias:
            shapes["bR"] = (3 * self.n_out,)
        return shapes

    def init_params(self, gen):
        h = self.n_out
        p = {
            "W": _winit.init(self.weight_init, gen, (self.n_in, 3 * h),
                             self.n_in, h),
            "RW": _winit.init(self.weight_init, gen, (h, 3 * h), h, h),
            "b": torch.zeros((3 * h,)),
        }
        if self.recurrent_bias:
            p["bR"] = torch.zeros((3 * h,))
        return p

    def step(self, params, carry, x_t):
        (h_prev,) = carry
        hn = self.n_out
        zx = promote_mm(x_t, params["W"]) + params["b"]
        zh = promote_mm(h_prev, params["RW"])
        if self.recurrent_bias:
            zh = zh + params["bR"]
        r = torch.sigmoid(zx[..., :hn] + zh[..., :hn])
        u = torch.sigmoid(zx[..., hn:2 * hn] + zh[..., hn:2 * hn])
        n = self._act(zx[..., 2 * hn:] + r * zh[..., 2 * hn:])
        h = (1 - u) * n + u * h_prev
        return (h,), h


@register_layer
@dataclasses.dataclass
class SimpleRnn(_RnnBase):
    """Vanilla RNN; its step runs in ``_RnnBase.run``'s loop."""

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out),
                "RW": (self.n_out, self.n_out),
                "b": (self.n_out,)}

    def init_params(self, gen):
        return {
            "W": _winit.init(self.weight_init, gen, (self.n_in, self.n_out),
                             self.n_in, self.n_out),
            "RW": _winit.init(self.weight_init, gen, (self.n_out, self.n_out),
                              self.n_out, self.n_out),
            "b": torch.zeros((self.n_out,)),
        }

    def step(self, params, carry, x_t):
        (h_prev,) = carry
        h = self._act(promote_mm(x_t, params["W"])
                      + promote_mm(h_prev, params["RW"]) + params["b"])
        return (h,), h


@register_layer
@dataclasses.dataclass
class Bidirectional(Layer):
    """A recurrent layer run both ways, the backward one over the reversed
    sequence (and mask); modes concat, add, mul and average; the two
    layers' params prefixed ``f_`` and ``b_``."""
    fwd: Optional[dict] = None   # serialized inner layer conf
    mode: str = "concat"

    _fwd_layer: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)
    _bwd_layer: Any = dataclasses.field(default=None, repr=False,
                                        compare=False)

    @staticmethod
    def wrap(inner: _RnnBase, mode: str = "concat") -> "Bidirectional":
        b = Bidirectional(fwd=inner.to_dict(), mode=mode)
        b._materialize()
        return b

    def _materialize(self):
        if self._fwd_layer is None and self.fwd is not None:
            self._fwd_layer = layer_from_dict(self.fwd)
            self._bwd_layer = layer_from_dict(self.fwd)

    def apply_global_defaults(self, defaults):
        super().apply_global_defaults(defaults)
        self._materialize()
        self._fwd_layer.apply_global_defaults(defaults)
        self._bwd_layer.apply_global_defaults(defaults)

    def set_n_in(self, input_type: InputType):
        self._materialize()
        self._fwd_layer.set_n_in(input_type)
        self._bwd_layer.set_n_in(input_type)
        self.fwd = self._fwd_layer.to_dict()

    def output_type(self, input_type: InputType) -> InputType:
        inner = self._fwd_layer.output_type(input_type)
        if self.mode == "concat":
            return InputType.recurrent(inner.size * 2,
                                       inner.timeseries_length)
        return inner

    def param_shapes(self):
        self._materialize()
        shapes = {}
        for k, v in self._fwd_layer.param_shapes().items():
            shapes["f_" + k] = v
        for k, v in self._bwd_layer.param_shapes().items():
            shapes["b_" + k] = v
        return shapes

    def init_params(self, gen):
        p = {}
        for k, v in self._fwd_layer.init_params(gen).items():
            p["f_" + k] = v
        for k, v in self._bwd_layer.init_params(gen).items():
            p["b_" + k] = v
        return p

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        fp = {k[2:]: v for k, v in params.items() if k.startswith("f_")}
        bp = {k[2:]: v for k, v in params.items() if k.startswith("b_")}
        out_f, _ = self._fwd_layer.apply(fp, x, training, gen, None,
                                         mask=mask)
        x_rev = torch.flip(x, dims=(1,))
        m_rev = torch.flip(mask, dims=(1,)) if mask is not None else None
        out_b, _ = self._bwd_layer.apply(bp, x_rev, training, gen, None,
                                         mask=m_rev)
        out_b = torch.flip(out_b, dims=(1,))
        if self.mode == "concat":
            return torch.cat([out_f, out_b], dim=-1), state
        if self.mode == "add":
            return out_f + out_b, state
        if self.mode == "mul":
            return out_f * out_b, state
        if self.mode == "average":
            return 0.5 * (out_f + out_b), state
        raise ValueError(self.mode)


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output head on (N, T, C), its loss over every step
    (a (N, T) label mask weights the steps)."""

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def _logits(self, params, x):
        z = promote_mm(x, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return z

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        return self._act(self._logits(params, x)), state

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        x = self._maybe_dropout(x, training, gen)
        z = self._logits(params, x)
        fused = _loss.get_fused(self.loss_function, self.activation)
        if fused is not None:
            return fused(z, labels, mask)
        return _loss.get(self.loss_function)(self._act(z), labels, mask)


@register_layer
@dataclasses.dataclass
class LastTimeStep(Layer):
    """Wraps a layer and collapses its (N, T, C) output to (N, C) at the
    last step, or under a mask at index sum(mask) − 1 (the reference's
    rule, which an interior gap in the mask misplaces; ROADMAP queue 3)."""
    inner: Optional[dict] = None
    _inner_layer: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)

    @staticmethod
    def wrap(inner: Layer) -> "LastTimeStep":
        lts = LastTimeStep(inner=inner.to_dict())
        lts._materialize()
        return lts

    def _materialize(self):
        if self._inner_layer is None and self.inner is not None:
            self._inner_layer = layer_from_dict(self.inner)

    def apply_global_defaults(self, defaults):
        super().apply_global_defaults(defaults)
        self._materialize()
        self._inner_layer.apply_global_defaults(defaults)

    def set_n_in(self, input_type):
        self._materialize()
        self._inner_layer.set_n_in(input_type)
        self.inner = self._inner_layer.to_dict()

    def output_type(self, input_type):
        t = self._inner_layer.output_type(input_type)
        return InputType.feed_forward(t.size)

    def param_shapes(self):
        self._materialize()
        return self._inner_layer.param_shapes()

    def init_params(self, gen):
        return self._inner_layer.init_params(gen)

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        out, state = self._inner_layer.apply(params, x, training, gen, state,
                                             mask=mask)
        if mask is not None:
            last = torch.clamp_min(torch.sum(mask, dim=1).int() - 1, 0)
            return out[torch.arange(out.shape[0], device=out.device),
                       last.long()], state
        return out[:, -1], state


# ---------------------------------------------------------------- attention
@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(Layer):
    """Multi-head self-attention over (N, T, C): with ``project_input``
    the Q, K, V projections (``Wq``, ``Wk``, ``Wv``; biases with
    ``qkv_bias``, as Keras imports carry them) and the output projection
    ``Wo``; without, one head of width n_in over the input itself. The
    sequence mask masks keys. Attention is
    ``ops.standard.dot_product_attention`` on the (N, H, T, head_size)
    views of the projections (no copy on the kernels' route)."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    qkv_bias: bool = False

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.head_size is None:
            self.head_size = self.n_out // self.n_heads

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(
            self.n_out if self.project_input else self.n_in,
            input_type.timeseries_length)

    def param_shapes(self):
        if not self.project_input:
            return {}
        hs = self.n_heads * self.head_size
        shapes = {"Wq": (self.n_in, hs), "Wk": (self.n_in, hs),
                  "Wv": (self.n_in, hs), "Wo": (hs, self.n_out)}
        if self.qkv_bias:
            shapes.update({"bq": (hs,), "bk": (hs,), "bv": (hs,),
                           "bo": (self.n_out,)})
        return shapes

    def _projection_params(self, gen, shapes):
        """Xavier-style draws of each weight in ``shapes`` by its own fans,
        zero biases; insertion order is ``shapes``'."""
        p = {}
        for name, shape in shapes.items():
            if name.startswith("b"):
                p[name] = torch.zeros(shape)
            else:
                p[name] = _winit.init(self.weight_init, gen, shape,
                                      shape[0], shape[1])
        return p

    def init_params(self, gen):
        if not self.project_input:
            return {}
        return self._projection_params(gen, self.param_shapes())

    def _heads(self, z):
        """(N, T, H·hs) → the (N, H, T, hs) view."""
        return z.reshape(z.shape[0], z.shape[1], self.n_heads,
                         self.head_size).transpose(1, 2)

    def _project(self, params, x, w, b):
        z = promote_mm(x, params[w])
        if self.qkv_bias:
            z = z + params[b]
        return self._heads(z)

    def _out(self, params, out, n, t):
        """(N, H, T, hs) attention → (N, T, n_out) through ``Wo``."""
        out = out.transpose(1, 2).reshape(n, t, -1)
        out = promote_mm(out, params["Wo"])
        if self.qkv_bias:
            out = out + params["bo"]
        return out

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        n, t, _ = x.shape
        if self.project_input:
            q = self._project(params, x, "Wq", "bq")
            k = self._project(params, x, "Wk", "bk")
            v = self._project(params, x, "Wv", "bv")
        else:
            q = k = v = x[:, None]          # one head
        attn_mask = None
        if mask is not None:
            attn_mask = (mask != 0)[:, None, None, :]   # (N, 1, 1, T) keys
        out = _ops.dot_product_attention(q, k, v, mask=attn_mask)
        if self.project_input:
            out = self._out(params, out, n, t)
        else:
            out = out.transpose(1, 2).reshape(n, t, -1)
        return self._act(out), state


@register_layer
@dataclasses.dataclass
class CrossAttentionLayer(SelfAttentionLayer):
    """Multi-head cross attention: queries from the first input, keys and
    values from the second (Keras ``MultiHeadAttention(query, value[,
    key])``). Inputs ``[query (N, Tq, Cq), value (N, Tkv, Ckv)[, key (N,
    Tkv, Ckv)]]``; output (N, Tq, n_out). It refuses a sequence mask: the
    network's mask follows the query input."""
    kv_in: Optional[int] = None        # value feature dim
    key_in: Optional[int] = None       # key feature dim (defaults kv_in)
    multi_input = True                 # the graph hands apply every input

    def set_n_in_multi(self, input_types):
        self.set_n_in(input_types[0])
        if self.kv_in is None and len(input_types) > 1 \
                and input_types[1] is not None:
            self.kv_in = getattr(input_types[1], "size", None) or self.n_in
        if self.key_in is None and len(input_types) > 2 \
                and input_types[2] is not None:
            self.key_in = getattr(input_types[2], "size", None)

    def _dims(self):
        kv = self.kv_in if self.kv_in is not None else self.n_in
        return kv, (self.key_in if self.key_in is not None else kv)

    def param_shapes(self):
        hs = self.n_heads * self.head_size
        kv, kk = self._dims()
        shapes = {"Wq": (self.n_in, hs), "Wk": (kk, hs), "Wv": (kv, hs),
                  "Wo": (hs, self.n_out)}
        if self.qkv_bias:
            shapes.update({"bq": (hs,), "bk": (hs,), "bv": (hs,),
                           "bo": (self.n_out,)})
        return shapes

    def init_params(self, gen):
        return self._projection_params(gen, self.param_shapes())

    def apply(self, params, xs, training=False, gen=None, state=None,
              mask=None):
        if mask is not None:
            raise ValueError(
                "CrossAttentionLayer does not support sequence masks: the "
                "network mask follows the query input, but attention "
                "masking needs the key/value sequence's mask")
        xq, xv = xs[0], xs[1]
        xk = xs[2] if len(xs) > 2 else xv
        n, tq, _ = xq.shape
        q = self._project(params, xq, "Wq", "bq")
        k = self._project(params, xk, "Wk", "bk")
        v = self._project(params, xv, "Wv", "bv")
        out = _ops.dot_product_attention(q, k, v)
        return self._act(self._out(params, out, n, tq)), state


@register_layer
@dataclasses.dataclass
class LearnedSelfAttentionLayer(Layer):
    """Attention with a learned bank ``Q`` of ``n_queries`` query vectors
    over the input sequence: (N, T, C) → (N, n_queries, n_out). The
    sequence mask masks keys. The bank is broadcast over the batch (stride
    0), which the op hands the kernels as a contiguous copy."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 1
    head_size: Optional[int] = None
    n_queries: int = 1

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.head_size is None:
            self.head_size = self.n_out // self.n_heads

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self.n_queries)

    def param_shapes(self):
        hs = self.n_heads * self.head_size
        return {"Q": (self.n_queries, hs), "Wk": (self.n_in, hs),
                "Wv": (self.n_in, hs), "Wo": (hs, self.n_out)}

    def init_params(self, gen):
        hs = self.n_heads * self.head_size
        fans = {"Q": (hs, hs), "Wk": (self.n_in, hs), "Wv": (self.n_in, hs),
                "Wo": (hs, self.n_out)}
        return {name: _winit.init(self.weight_init, gen, shape, *fans[name])
                for name, shape in self.param_shapes().items()}

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        n, t, _ = x.shape
        nh, hs = self.n_heads, self.head_size
        q = params["Q"].expand((n,) + tuple(params["Q"].shape))
        q = q.reshape(n, self.n_queries, nh, hs).transpose(1, 2)
        k = promote_mm(x, params["Wk"]).reshape(n, t, nh, hs).transpose(1, 2)
        v = promote_mm(x, params["Wv"]).reshape(n, t, nh, hs).transpose(1, 2)
        attn_mask = None
        if mask is not None:
            attn_mask = (mask != 0)[:, None, None, :]
        out = _ops.dot_product_attention(q, k, v, mask=attn_mask)
        out = out.transpose(1, 2).reshape(n, self.n_queries, -1)
        return self._act(promote_mm(out, params["Wo"])), state


@register_layer
@dataclasses.dataclass
class RecurrentAttentionLayer(Layer):
    """A recurrent layer whose recurrent input is attention over the whole
    input sequence queried by the previous hidden state: ``h_t =
    act(x_t·W + attn(q = h_{t-1}·Wq, kv = x)·Wr + b)``. The reference's
    ``lax.scan`` is a plain loop here, as GRU's: each step one query
    against the whole sequence through the same op (keys and values
    projected once). The sequence mask masks keys only; h0 is zero in
    the input's dtype."""
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    n_heads: int = 1
    head_size: Optional[int] = None

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size
        if self.n_out is None:
            self.n_out = self.n_in
        if self.head_size is None:
            self.head_size = self.n_out // self.n_heads

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timeseries_length)

    def param_shapes(self):
        hs = self.n_heads * self.head_size
        return {"W": (self.n_in, self.n_out), "Wr": (hs, self.n_out),
                "b": (self.n_out,), "Wq": (self.n_out, hs),
                "Wk": (self.n_in, hs), "Wv": (self.n_in, hs)}

    def init_params(self, gen):
        p = {}
        for name, shape in self.param_shapes().items():
            if name == "b":
                p[name] = torch.full(shape, float(self.bias_init))
            else:
                p[name] = _winit.init(self.weight_init, gen, shape, *shape)
        return p

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        n, t, _ = x.shape
        nh, hs = self.n_heads, self.head_size
        # keys and values over the whole sequence, once (N, nh, T, hs)
        k = promote_mm(x, params["Wk"]).reshape(n, t, nh, hs).transpose(1, 2)
        v = promote_mm(x, params["Wv"]).reshape(n, t, nh, hs).transpose(1, 2)
        key_mask = None
        if mask is not None:
            key_mask = (mask != 0)[:, None, None, :]
        xw = promote_mm(x, params["W"])       # (N, T, n_out), out of the loop
        h = torch.zeros((n, self.n_out), dtype=x.dtype, device=x.device)
        outs = []
        for step in range(t):
            q = promote_mm(h, params["Wq"]).reshape(n, nh, 1, hs)
            a = _ops.dot_product_attention(q, k, v, mask=key_mask)
            a = a.reshape(n, nh * hs)
            h = self._act(xw[:, step] + promote_mm(a, params["Wr"])
                          + params["b"])
            outs.append(h)
        return torch.stack(outs, dim=1), state
