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

Every class of the reference's ``layers.py`` is here, and its tranche
``layers2.py`` is re-exported at the end (``nn/conf/layers2.py``). The
convolutions are cuDNN's on NHWC views (``ops/standard.py``); the
recurrent layers' time loops are in ``kernels/rnn_cell.py``; the attention
layers compute ``ops.standard.dot_product_attention``, which runs on the
flash kernels K1/K2 with the sequence mask as a key mask. A layer's
``weight_noise`` (``nn/weightnoise.py``) acts on its weights in the
networks' training forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import losses as _loss
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, conv_out_size
from deeplearning4j_tpu_torch.ops import standard as _ops
from deeplearning4j_tpu_torch.ops.moments import batch_moments, one_pass_moments
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
    if k == "weight_noise" and isinstance(v, dict):
        from deeplearning4j_tpu_torch.nn.weightnoise import noise_from_dict
        return noise_from_dict(v)
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
    # a DropConnect or WeightNoise (nn/weightnoise.py): applied to the
    # layer's weights by the networks' training forward
    weight_noise: Any = None

    # ---------------- config protocol
    def to_dict(self) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if not k.startswith("_") and (v is not None or k in ("name",))}
        if self.weight_noise is not None:
            d["weight_noise"] = self.weight_noise.to_dict()
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
class CenterLossOutputLayer(OutputLayer):
    """Softmax head plus center loss: each example's feature vector is
    pulled toward its class center, weighted by ``lambda_``; the centers
    (one per class, in feature space) move toward the features at rate
    ``alpha``. As in the reference, the centers are parameters driven by a
    split loss: ``pull`` with the centers detached, ``update`` with the
    features detached, so the optimizer moves a center at lr · alpha
    (alpha composes with the learning rate). ``gradient_check=True`` keeps
    both terms without the detaches."""
    alpha: float = 0.05
    lambda_: float = 2e-4
    gradient_check: bool = False
    #: centers are statistics, not weights: no L1/L2, no weight noise
    non_weight_params = ("centers",)

    def param_shapes(self):
        shapes = super().param_shapes()
        shapes["centers"] = (self.n_out, self.n_in)
        return shapes

    def init_params(self, gen):
        p = super().init_params(gen)
        p["centers"] = torch.zeros((self.n_out, self.n_in))
        return p

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        x = self._maybe_dropout(x, training, gen)
        if x.dim() >= 4 or (x.dim() == 3 and x.shape[-1] != self.n_in):
            x = x.reshape(x.shape[0], -1)
        head = {k: v for k, v in params.items() if k != "centers"}
        ce = OutputLayer.loss(self, head, x, labels, mask=mask)
        cy = promote_mm(labels.to(params["centers"].dtype),
                        params["centers"])            # (N, n_in)
        w = (torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
             if mask is None else mask.reshape(-1).to(x.dtype))

        def sq(a, b):
            return torch.sum(w * torch.sum(torch.square(a - b), dim=-1)) \
                / torch.maximum(torch.sum(w), torch.ones((), dtype=w.dtype,
                                                         device=w.device))

        if self.gradient_check:
            return ce + 0.5 * (self.lambda_ + self.alpha) * sq(x, cy)
        pull = 0.5 * self.lambda_ * sq(x, cy.detach())
        update = 0.5 * self.alpha * sq(x.detach(), cy)
        return ce + pull + update


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
class SpatialDropoutLayer(Layer):
    """Channel-wise dropout: whole feature maps drop together. ``dropout``
    is the retain probability, one draw per (example, channel)."""

    def apply(self, params, x, training=False, gen=None, state=None):
        from deeplearning4j_tpu_torch.nn.conf.dropout import IDropout
        if isinstance(self.dropout, IDropout):
            raise ValueError(
                "SpatialDropoutLayer defines its own channel-wise scheme; "
                "IDropout objects are not composable here — use a plain "
                "retain probability")
        if not training or gen is None or self.dropout is None \
                or self.dropout >= 1.0:
            return x, state
        keep = self.dropout
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        mask = torch.rand(shape, generator=gen, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)), state


@register_layer
@dataclasses.dataclass
class FlattenLayer(Layer):
    """(N, ...) → (N, ∏dims) row-major (NHWC order)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.array_elements())

    def apply(self, params, x, training=False, gen=None, state=None):
        return x.reshape(x.shape[0], -1), state


@register_layer
@dataclasses.dataclass
class ReshapeLayer(Layer):
    """Row-wise reshape to ``target_shape`` (one -1 resolved from the
    input's size); the batch dim is untouched."""
    target_shape: Tuple[int, ...] = ()

    def __post_init__(self):
        self.target_shape = tuple(int(s) for s in self.target_shape)

    def _resolved(self, total: Optional[int]) -> Tuple[int, ...]:
        t = self.target_shape
        if -1 not in t:
            return t
        if t.count(-1) > 1:
            raise ValueError(f"reshape target {t} has multiple -1 dims")
        if not total:
            raise ValueError(
                f"reshape target {t} needs a known input size to resolve -1")
        known = math.prod(d for d in t if d != -1)
        return tuple(total // known if d == -1 else d for d in t)

    def output_type(self, input_type: InputType) -> InputType:
        t = self._resolved(input_type.array_elements())
        self.target_shape = t            # pinned for apply
        if len(t) == 1:
            return InputType.feed_forward(t[0])
        if len(t) == 2:
            return InputType.recurrent(t[1], t[0])
        if len(t) == 3:
            return InputType.convolutional(t[0], t[1], t[2])
        raise ValueError(f"unsupported reshape target {t}")

    def apply(self, params, x, training=False, gen=None, state=None):
        shape = self._resolved(math.prod(x.shape[1:]))
        return x.reshape((x.shape[0],) + shape), state


@register_layer
@dataclasses.dataclass
class PermuteLayer(Layer):
    """Permute the non-batch dims, 1-indexed as Keras' ``Permute``."""
    dims: Tuple[int, ...] = ()

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "rnn" and self.dims == (2, 1):
            tsl = input_type.timeseries_length
            if tsl is None or tsl < 0:
                raise ValueError(
                    "Permute((2,1)) on variable-length recurrent input: the "
                    "permuted feature size would be the (unknown) sequence "
                    "length — fix the input length")
            return InputType.recurrent(tsl, input_type.size)
        if input_type.kind == "cnn" and len(self.dims) == 3:
            hwc = (input_type.height, input_type.width, input_type.channels)
            return InputType.convolutional(*(hwc[d - 1] for d in self.dims))
        raise ValueError(
            f"Permute dims {self.dims} unsupported for input kind "
            f"{input_type.kind!r}")

    def apply(self, params, x, training=False, gen=None, state=None):
        return x.permute((0,) + self.dims), state


@register_layer
@dataclasses.dataclass
class RepeatVectorLayer(Layer):
    """(N, C) → (N, n, C)."""
    n: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.size, self.n)

    def apply(self, params, x, training=False, gen=None, state=None):
        return torch.repeat_interleave(x[:, None, :], int(self.n),
                                       dim=1), state


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


def deconv_pad_pairs(kernel_size, stride, dilation, padding,
                     output_padding):
    """Explicit (lo, hi) pads of the stride-dilated input of a transposed
    convolution (out = (in − 1)·s + lo + hi − k_eff + 2), the reference's
    rule for Deconvolution2D/3D: forward padding p gives lo = hi =
    k_eff − 1 − p, and Keras' output_padding extends the high side.
    "same": without output_padding pad_total = k_eff − s (TF's forward
    "same" split, the odd pad high); with it pad_total = 2·(k_eff // 2) −
    op."""
    keff = tuple((k - 1) * d + 1 for k, d in zip(kernel_size, dilation))
    op = output_padding or (0,) * len(keff)
    if isinstance(padding, str) and padding.lower() == "same":
        pairs = []
        for k, s, o in zip(keff, stride, op):
            total = (max(k - s, 0) if output_padding is None
                     else 2 * (k // 2) - o)
            lo_f = total // 2
            pairs.append((k - 1 - lo_f, k - 1 - (total - lo_f)))
        return pairs
    pads = (0,) * len(keff) if isinstance(padding, str) else padding
    return [(k - 1 - p, k - 1 - p + o) for k, p, o in zip(keff, pads, op)]


def _deconv_pads(layer):
    """The pads of a Deconvolution2D/3D's ``lax.conv_transpose``: a plain
    layer (no output_padding, no dilation) with string padding takes lax's
    own "SAME"/"VALID" rule, every other one ``deconv_pad_pairs``."""
    plain = (not layer.output_padding
             and all(d == 1 for d in layer.dilation))
    if plain and isinstance(layer.padding, str):
        return _ops.conv_transpose_same_valid(layer.kernel_size,
                                              layer.stride, layer.padding)
    return deconv_pad_pairs(layer.kernel_size, layer.stride, layer.dilation,
                            layer.padding, layer.output_padding)


@register_layer
@dataclasses.dataclass
class Deconvolution2D(_ConvBase):
    """Transposed convolution (Keras ``Conv2DTranspose``, with
    output_padding and dilation): ``W`` (kh, kw, n_in, n_out), the
    reference's ``lax.conv_transpose(x, W.transpose(0, 1, 3, 2),
    transpose_kernel=True)`` under its explicit pads, computed as
    ``ops.standard.conv_transpose``: cuDNN's ``F.conv_transpose2d``
    unpadded, then cropped to the reference's asymmetric pads."""
    output_padding: Optional[Tuple[int, int]] = None

    def _k_eff(self):
        return tuple((k - 1) * d + 1
                     for k, d in zip(self.kernel_size, self.dilation))

    def _pad_pairs(self):
        return deconv_pad_pairs(self.kernel_size, self.stride,
                                self.dilation, self.padding,
                                self.output_padding)

    def output_type(self, input_type: InputType) -> InputType:
        same = isinstance(self.padding, str) and self.padding.lower() == "same"
        if same and not self.output_padding \
                and all(d == 1 for d in self.dilation):
            h = input_type.height * self.stride[0]
            w = input_type.width * self.stride[1]
        else:
            keff = self._k_eff()
            pairs = self._pad_pairs()
            h = (self.stride[0] * (input_type.height - 1) + sum(pairs[0])
                 - keff[0] + 2)
            w = (self.stride[1] * (input_type.width - 1) + sum(pairs[1])
                 - keff[1] + 2)
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        p = {"W": _winit.init(self.weight_init, gen,
                              (kh, kw, self.n_in, self.n_out),
                              kh * kw * self.n_in, kh * kw * self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        z = _ops.conv_transpose(x, params["W"], self.stride,
                                _deconv_pads(self), self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class SeparableConvolution2D(_ConvBase):
    """Depthwise-separable convolution: ``dW`` (kh, kw, n_in, m) convolves
    each input channel with its m filters (``ops.standard
    .depthwise_conv2d``: cuDNN's grouped convolution, groups n_in, channel
    c's filter j at output channel c·m + j), then ``pW`` (1, 1, n_in·m,
    n_out) mixes them (a 1×1 convolution, plus ``b``)."""
    depth_multiplier: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial_out(input_type)
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        m = self.depth_multiplier
        shapes = {"dW": (kh, kw, self.n_in, m),
                  "pW": (1, 1, self.n_in * m, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        m = self.depth_multiplier
        p = {"dW": _winit.init(self.weight_init, gen, (kh, kw, self.n_in, m),
                               kh * kw * self.n_in, kh * kw * m),
             "pW": _winit.init(self.weight_init, gen,
                               (1, 1, self.n_in * m, self.n_out),
                               self.n_in * m, self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        z = _ops.depthwise_conv2d(x, params["dW"], strides=self.stride,
                                  padding=self._lax_padding(),
                                  dilation=self.dilation)
        z = _ops.conv2d(z, params["pW"], params.get("b"), strides=(1, 1),
                        padding="VALID")
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
class Upsampling2D(Layer):
    """Nearest (each row and column repeated) or bilinear (``jax.image
    .resize``'s, ``ops.standard.resize_bilinear``) upsampling by
    ``size``."""
    size: Tuple[int, int] = (2, 2)
    interpolation: str = "nearest"

    def __post_init__(self):
        self.size = _pair(self.size)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(input_type.height * self.size[0],
                                       input_type.width * self.size[1],
                                       input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        if self.interpolation == "bilinear":
            h, w = x.shape[1] * self.size[0], x.shape[2] * self.size[1]
            return _ops.resize_bilinear(x, (h, w)), state
        return _ops.upsampling2d(x, self.size), state


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
class Cropping2D(Layer):
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)  # top,bottom,left,right

    def __post_init__(self):
        self.cropping = _pad4(self.cropping)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = self.cropping
        return InputType.convolutional(input_type.height - t - b,
                                       input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        t, b, l, r = self.cropping
        return x[:, t:x.shape[1] - b or None,
                 l:x.shape[2] - r or None, :], state


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
            mean, var = batch_moments(x, tuple(range(x.dim() - 1)))
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


# ------------------------------------------------------------ conv1d/conv3d
@register_layer
@dataclasses.dataclass
class Convolution1DLayer(Layer):
    """1-D convolution over (N, T, C) sequences (``ops.standard.conv1d``).
    ``padding``: an int, "same", or "causal" (left pad (k − 1)·dilation)."""
    kernel_size: int = 3
    stride: int = 1
    padding: Any = 0
    dilation: int = 1
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        if t is None or t < 0:
            return InputType.recurrent(self.n_out, -1)
        if isinstance(self.padding, str):  # same/causal keep ceil(T/s)
            t_out = -(-t // self.stride)
        else:
            t_out = conv_out_size(t, self.kernel_size, self.stride,
                                  self.padding, self.dilation)
        return InputType.recurrent(self.n_out, t_out)

    def param_shapes(self):
        shapes = {"W": (self.kernel_size, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        k = self.kernel_size
        p = {"W": _winit.init(self.weight_init, gen, (k, self.n_in, self.n_out),
                              k * self.n_in, k * self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        pad = self.padding
        if isinstance(pad, str) and pad.lower() == "causal":
            left = (self.kernel_size - 1) * self.dilation
            x = F.pad(x, (0, 0, left, 0))
            pad = 0
        z = _ops.conv1d(x, params["W"], params.get("b"), stride=self.stride,
                        padding=(pad.upper() if isinstance(pad, str)
                                 else [(pad, pad)]),
                        dilation=self.dilation)
        return self._act(z), state


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


@register_layer
@dataclasses.dataclass
class Convolution3D(Layer):
    """3-D convolution over NDHWC volumes (``ops.standard.conv3d``:
    ``F.conv3d`` on the NCDHW view)."""
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Any = 0
    dilation: Tuple[int, int, int] = (1, 1, 1)
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _triple(self.kernel_size)
        self.stride = _triple(self.stride)
        self.dilation = _triple(self.dilation)
        if not isinstance(self.padding, str):
            self.padding = _triple(self.padding)

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.channels

    def output_type(self, input_type: InputType) -> InputType:
        same = isinstance(self.padding, str) and self.padding.lower() == "same"
        pads = (0, 0, 0) if same else self.padding
        d, h, w = (conv_out_size(s, k, st, p, dl, same)
                   for s, k, st, p, dl in zip(
                       (input_type.depth, input_type.height, input_type.width),
                       self.kernel_size, self.stride, pads, self.dilation))
        return InputType.convolutional3d(d, h, w, self.n_out)

    def param_shapes(self):
        kd, kh, kw = self.kernel_size
        shapes = {"W": (kd, kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        vol = math.prod(self.kernel_size)
        p = {"W": _winit.init(self.weight_init, gen,
                              self.kernel_size + (self.n_in, self.n_out),
                              vol * self.n_in, vol * self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        pad = (self.padding.upper() if isinstance(self.padding, str)
               else [(p, p) for p in self.padding])
        z = _ops.conv3d(x, params["W"], params.get("b"), strides=self.stride,
                        padding=pad, dilation=self.dilation)
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class CnnLossLayer(Layer):
    """Per-pixel loss over NHWC activations, no params; a label mask of
    (N, H, W) or (N, H, W, 1) weights the pixels."""
    loss_function: str = "mcxent"

    def apply(self, params, x, training=False, gen=None, state=None):
        return self._act(x), state

    def loss(self, params, x, labels, mask=None, training=False, gen=None,
             state=None):
        n, h, w, c = x.shape
        z = x.reshape(n * h * w, c)
        lbl = labels.reshape(n * h * w, -1)
        m = None if mask is None else mask.reshape(n * h * w)
        fused = _loss.get_fused(self.loss_function,
                                self.activation or "identity")
        if fused is not None:
            return fused(z, lbl, m)
        return _loss.get(self.loss_function)(self._act(z), lbl, m)


@register_layer
@dataclasses.dataclass
class LayerNormalization(Layer):
    """Layer norm over the last axis with a learned gain and bias, its
    statistics in >= f32 (``one_pass_moments``)."""
    n_out: Optional[int] = None
    eps: float = 1e-3
    axis: int = -1

    def set_n_in(self, input_type: InputType):
        rank = len(input_type.batch_shape())
        if self.axis not in (-1, rank - 1):
            raise ValueError(
                f"LayerNormalization normalizes the last axis; got "
                f"axis={self.axis} for rank-{rank} input")
        if self.n_out is None:
            self.n_out = (input_type.channels
                          if input_type.kind in ("cnn", "cnn3d")
                          else input_type.size)

    def param_shapes(self):
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def init_params(self, gen):
        return {"gamma": torch.ones((self.n_out,)),
                "beta": torch.zeros((self.n_out,))}

    def apply(self, params, x, training=False, gen=None, state=None):
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mu, var = one_pass_moments(xf, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        y = y * params["gamma"].to(acc) + params["beta"].to(acc)
        return self._act(y.to(x.dtype)), state


#: lambda bodies by name: a body is code and does not serialize, so JSON
#: stores the name and revival looks the body up here
LAMBDA_REGISTRY: Dict[str, Any] = {}


@register_layer
@dataclasses.dataclass
class LambdaLayer(Layer):
    """A torch function as a layer. It serializes by name: a LambdaLayer
    built with a body and a name registers it in ``LAMBDA_REGISTRY``; one
    revived by name takes its body from there, and raises if none is
    registered."""
    fn: Any = None
    output_type_fn: Any = None       # optional InputType -> InputType

    def __post_init__(self):
        if self.fn is None and self.name:
            entry = LAMBDA_REGISTRY.get(self.name)
            if entry is None:
                raise ValueError(
                    f"LambdaLayer {self.name!r}: body not registered — "
                    f"build it once with its fn, or put (fn, output_type_fn) "
                    f"in LAMBDA_REGISTRY[{self.name!r}], before loading")
            self.fn, self.output_type_fn = entry
        elif self.fn is not None and self.name:
            LAMBDA_REGISTRY.setdefault(self.name,
                                       (self.fn, self.output_type_fn))

    def apply(self, params, x, training=False, gen=None, state=None):
        return self.fn(x), state

    def output_type(self, input_type):
        if self.output_type_fn is not None:
            return self.output_type_fn(input_type)
        return input_type

    def to_dict(self):
        return {"@layer": "LambdaLayer", "name": self.name}


# layers2.py's tranche, re-exported so that one ``layers`` module holds
# every layer (and ``layer_from_dict`` revives them all)
from deeplearning4j_tpu_torch.nn.conf.layers2 import (  # noqa: E402,F401
    CapsuleLayer, CapsuleStrengthLayer, ConvLSTM2D, Cropping1D, Cropping3D,
    Deconvolution3D, DepthwiseConvolution2D, FrozenLayer, PrimaryCapsules,
    FrozenLayerWithBackprop, LocallyConnected1D, LocallyConnected2D,
    MaskLayer, MaskZeroLayer, PReLULayer, SeparableConvolution1D,
    Subsampling1DLayer, Subsampling3DLayer, Upsampling1D, Upsampling3D,
    ZeroPadding1DLayer, ZeroPadding3DLayer)
