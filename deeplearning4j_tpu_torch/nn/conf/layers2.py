"""The second tranche of layers: counterpart of
``deeplearning4j_tpu/nn/conf/layers2.py`` (``DepthwiseConvolution2D``,
``LocallyConnected1D/2D``, ``PReLULayer``, the 1-D/3-D cropping, padding,
upsampling and pooling layers, ``MaskLayer`` and ``MaskZeroLayer``, the
freeze wrappers, the capsule trio, ``Deconvolution3D``,
``SeparableConvolution1D`` and ``ConvLSTM2D``).

- The locally connected layers take their windows with ``F.unfold`` and
  contract them with one einsum: no loop over positions.
- 1-D pooling runs the 2-D pooling ops on a (N, T, 1, C) view; 3-D
  pooling and convolution the NDHWC ops of ``ops/standard.py``.
- ``FrozenLayer`` detaches its params and its input (the reference stops
  both gradients); ``FrozenLayerWithBackprop`` only its params. A
  detached param gets a zero gradient, so the updater leaves it as it is.
- ``ConvLSTM2D``'s ``lax.scan`` is a time loop of cuDNN convolutions.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType, conv_out_size
from deeplearning4j_tpu_torch.nn.conf.layers import (Layer, _ConvBase, _pair,
                                                     _triple, _deconv_pads,
                                                     layer_from_dict,
                                                     register_layer)
from deeplearning4j_tpu_torch.ops import standard as _ops
from deeplearning4j_tpu_torch.ops.standard import promote_mm


def _same(padding) -> bool:
    return isinstance(padding, str) and padding.lower() == "same"


def _einsum(eq, a, b):
    """``torch.einsum`` in the promoted type of its operands, as
    ``jnp.einsum`` takes mixed types."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.einsum(eq, a, b)


@register_layer
@dataclasses.dataclass
class DepthwiseConvolution2D(_ConvBase):
    """Each input channel convolved with ``depth_multiplier`` filters;
    n_out = n_in · depth_multiplier (``ops.standard.depthwise_conv2d``)."""
    depth_multiplier: int = 1

    def set_n_in(self, input_type: InputType):
        super().set_n_in(input_type)
        if self.n_out is None:
            self.n_out = self.n_in * self.depth_multiplier
        elif self.n_out != self.n_in * self.depth_multiplier:
            raise ValueError(
                f"DepthwiseConvolution2D: nOut={self.n_out} inconsistent "
                f"with nIn*depthMultiplier="
                f"{self.n_in * self.depth_multiplier} (depthwise output "
                f"channels are structural, not configurable)")

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial_out(input_type)
        return InputType.convolutional(h, w,
                                       self.n_in * self.depth_multiplier)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"dW": (kh, kw, self.n_in, self.depth_multiplier)}
        if self.has_bias:
            shapes["b"] = (self.n_in * self.depth_multiplier,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        m = self.depth_multiplier
        p = {"dW": _winit.init(self.weight_init, gen, (kh, kw, self.n_in, m),
                               kh * kw * self.n_in, kh * kw * m)}
        if self.has_bias:
            p["b"] = torch.full((self.n_in * m,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        z = _ops.depthwise_conv2d(x, params["dW"], strides=self.stride,
                                  padding=self._lax_padding(),
                                  dilation=self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class PReLULayer(Layer):
    """Parametric ReLU with a learned negative-side slope ``alpha``: the
    full per-example feature shape (H, W, C) on a CNN input, (n_in,) on a
    feed-forward one; ``alpha_shape`` overrides."""
    n_in: Optional[int] = None
    alpha_init: float = 0.0
    alpha_shape: Optional[Tuple[int, ...]] = None

    def set_n_in(self, input_type: InputType):
        if input_type.kind == "cnn" and self.alpha_shape is None:
            self.alpha_shape = (input_type.height, input_type.width,
                                input_type.channels)
        if self.n_in is None:
            self.n_in = (input_type.channels
                         if input_type.kind == "cnn" else input_type.size)

    def _ashape(self):
        return tuple(self.alpha_shape) if self.alpha_shape else (self.n_in,)

    def param_shapes(self):
        return {"alpha": self._ashape()}

    def init_params(self, gen):
        return {"alpha": torch.full(self._ashape(), float(self.alpha_init))}

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        return torch.where(x >= 0, x, params["alpha"] * x), state


class _LocallyConnectedBase(Layer):
    """Unshared-weight convolution: one weight tensor per output position,
    contracted with the input's windows in one einsum."""

    def _patches(self, x, kernel, stride):
        """(N, *out, k·C) windows, flattened (*k, C) as the Keras/DL4J
        kernels are (``F.unfold`` gives them channel-major)."""
        n, c = x.shape[0], x.shape[-1]
        if len(kernel) == 1:
            x4, k2, s2 = x[:, :, None, :], (kernel[0], 1), (stride[0], 1)
        else:
            x4, k2, s2 = x, tuple(kernel), tuple(stride)
        cols = F.unfold(x4.permute(0, 3, 1, 2), k2, stride=s2)
        out = [(x.shape[1 + i] - k) // s + 1
               for i, (k, s) in enumerate(zip(kernel, stride))]
        kk = math.prod(kernel)
        p = cols.reshape(n, c, kk, cols.shape[-1]).permute(0, 3, 2, 1)
        return p.reshape(n, *out, kk * c)


@register_layer
@dataclasses.dataclass
class LocallyConnected2D(_LocallyConnectedBase):
    """``W`` (Ho, Wo, kh·kw·n_in, n_out) and a per-position bias."""
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    input_size: Optional[Tuple[int, int]] = None   # (H, W), from the input
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.channels
        if self.input_size is None:
            self.input_size = (input_type.height, input_type.width)

    def _out_hw(self):
        h, w = self.input_size
        return (conv_out_size(h, self.kernel_size[0], self.stride[0], 0, 1,
                              False),
                conv_out_size(w, self.kernel_size[1], self.stride[1], 0, 1,
                              False))

    def output_type(self, input_type: InputType) -> InputType:
        oh, ow = self._out_hw()
        return InputType.convolutional(oh, ow, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        oh, ow = self._out_hw()
        shapes = {"W": (oh, ow, kh * kw * self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (oh, ow, self.n_out)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        oh, ow = self._out_hw()
        fan_in = kh * kw * self.n_in
        p = {"W": _winit.init(self.weight_init, gen,
                              (oh, ow, fan_in, self.n_out), fan_in,
                              self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((oh, ow, self.n_out), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        pat = self._patches(x, self.kernel_size, self.stride)
        z = _einsum("nhwk,hwko->nhwo", pat, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class LocallyConnected1D(_LocallyConnectedBase):
    """Over (N, T, C): ``W`` (To, k·n_in, n_out), a per-step bias."""
    kernel_size: int = 2
    stride: int = 1
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    input_size: Optional[int] = None       # T, from the input type
    has_bias: bool = True

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size
        if self.input_size is None and input_type.timeseries_length > 0:
            self.input_size = input_type.timeseries_length

    def _out_t(self):
        return conv_out_size(self.input_size, self.kernel_size, self.stride,
                             0, 1, False)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, self._out_t())

    def param_shapes(self):
        shapes = {"W": (self._out_t(), self.kernel_size * self.n_in,
                        self.n_out)}
        if self.has_bias:
            shapes["b"] = (self._out_t(), self.n_out)
        return shapes

    def init_params(self, gen):
        fan_in = self.kernel_size * self.n_in
        p = {"W": _winit.init(self.weight_init, gen,
                              (self._out_t(), fan_in, self.n_out), fan_in,
                              self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self._out_t(), self.n_out),
                                float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        pat = self._patches(x, (self.kernel_size,), (self.stride,))
        z = _einsum("ntk,tko->nto", pat, params["W"])
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


# ------------------------------------------------------- 1D/3D structural
@register_layer
@dataclasses.dataclass
class Cropping1D(Layer):
    """Input (N, T, C)."""
    cropping: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.cropping = _pair(self.cropping)

    def output_type(self, input_type: InputType) -> InputType:
        a, b = self.cropping
        t = input_type.timeseries_length
        return InputType.recurrent(input_type.size,
                                   t - a - b if t > 0 else -1)

    def apply(self, params, x, training=False, gen=None, state=None):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b or None, :], state


@register_layer
@dataclasses.dataclass
class Cropping3D(Layer):
    """Input (N, D, H, W, C)."""
    cropping: Tuple[int, int, int, int, int, int] = (0,) * 6

    def output_type(self, input_type: InputType) -> InputType:
        c = self.cropping
        return InputType.convolutional3d(
            input_type.depth - c[0] - c[1], input_type.height - c[2] - c[3],
            input_type.width - c[4] - c[5], input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        c = self.cropping
        return x[:, c[0]:x.shape[1] - c[1] or None,
                 c[2]:x.shape[2] - c[3] or None,
                 c[4]:x.shape[3] - c[5] or None, :], state


@register_layer
@dataclasses.dataclass
class ZeroPadding1DLayer(Layer):
    """Input (N, T, C)."""
    padding: Tuple[int, int] = (0, 0)

    def __post_init__(self):
        self.padding = _pair(self.padding)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        return InputType.recurrent(input_type.size,
                                   t + sum(self.padding) if t > 0 else -1)

    def apply(self, params, x, training=False, gen=None, state=None):
        a, b = self.padding
        return F.pad(x, (0, 0, a, b)), state


@register_layer
@dataclasses.dataclass
class ZeroPadding3DLayer(Layer):
    """Input (N, D, H, W, C)."""
    padding: Tuple[int, int, int, int, int, int] = (0,) * 6

    def output_type(self, input_type: InputType) -> InputType:
        p = self.padding
        return InputType.convolutional3d(
            input_type.depth + p[0] + p[1], input_type.height + p[2] + p[3],
            input_type.width + p[4] + p[5], input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        p = self.padding
        return F.pad(x, (0, 0, p[4], p[5], p[2], p[3], p[0], p[1])), state


@register_layer
@dataclasses.dataclass
class Upsampling1D(Layer):
    """Each timestep repeated ``size`` times."""
    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        return InputType.recurrent(input_type.size,
                                   t * self.size if t > 0 else -1)

    def apply(self, params, x, training=False, gen=None, state=None):
        return torch.repeat_interleave(x, self.size, dim=1), state


@register_layer
@dataclasses.dataclass
class Upsampling3D(Layer):
    """Nearest repeat along D, H and W."""
    size: Tuple[int, int, int] = (2, 2, 2)

    def __post_init__(self):
        self.size = _triple(self.size)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional3d(
            input_type.depth * self.size[0], input_type.height * self.size[1],
            input_type.width * self.size[2], input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        for ax, s in zip((1, 2, 3), self.size):
            x = torch.repeat_interleave(x, s, dim=ax)
        return x, state


@register_layer
@dataclasses.dataclass
class Subsampling1DLayer(Layer):
    """Pooling over time, the 2-D pooling ops on a (N, T, 1, C) view."""
    pooling_type: str = "max"
    kernel_size: int = 2
    stride: int = 2
    padding: Any = 0                       # 0/"valid" or "same"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timeseries_length
        return InputType.recurrent(
            input_type.size,
            conv_out_size(t, self.kernel_size, self.stride, 0, 1,
                          _same(self.padding)) if t > 0 else -1)

    def apply(self, params, x, training=False, gen=None, state=None):
        pool = (_ops.maxpool2d if self.pooling_type.lower() == "max"
                else _ops.avgpool2d)
        z = pool(x[:, :, None, :], (self.kernel_size, 1), (self.stride, 1),
                 "SAME" if _same(self.padding) else "VALID")
        return z[:, :, 0, :], state


@register_layer
@dataclasses.dataclass
class Subsampling3DLayer(Layer):
    """Pooling over NDHWC volumes."""
    pooling_type: str = "max"
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Any = 0                       # 0/"valid" or "same"

    def __post_init__(self):
        self.kernel_size = _triple(self.kernel_size)
        self.stride = _triple(self.stride)

    def output_type(self, input_type: InputType) -> InputType:
        same = _same(self.padding)
        d, h, w = (conv_out_size(v, k, st, 0, 1, same)
                   for v, k, st in zip(
                       (input_type.depth, input_type.height,
                        input_type.width), self.kernel_size, self.stride))
        return InputType.convolutional3d(d, h, w, input_type.channels)

    def apply(self, params, x, training=False, gen=None, state=None):
        pool = (_ops.maxpool3d if self.pooling_type.lower() == "max"
                else _ops.avgpool3d)
        return pool(x, self.kernel_size, self.stride,
                    "SAME" if _same(self.padding) else "VALID"), state


# ----------------------------------------------------------- masking pair
@register_layer
@dataclasses.dataclass
class MaskLayer(Layer):
    """Zeroes the activations at masked timesteps; the identity without a
    mask."""

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        if mask is not None and x.dim() == 3:
            return x * mask.to(x.dtype)[..., None], state
        return x, state


class _WrapperBase(Layer):
    """A layer that wraps another, serialized in ``inner``."""

    def _materialize(self):
        if self._inner_layer is None and self.inner is not None:
            self._inner_layer = layer_from_dict(self.inner)

    def apply_global_defaults(self, defaults):
        super().apply_global_defaults(defaults)
        self._materialize()
        self._inner_layer.apply_global_defaults(defaults)

    def set_n_in(self, input_type: InputType):
        self._materialize()
        self._inner_layer.set_n_in(input_type)
        self.inner = self._inner_layer.to_dict()

    def output_type(self, input_type: InputType) -> InputType:
        self._materialize()
        return self._inner_layer.output_type(input_type)

    def param_shapes(self):
        self._materialize()
        return self._inner_layer.param_shapes()

    def init_params(self, gen):
        self._materialize()
        return self._inner_layer.init_params(gen)

    def init_state(self):
        self._materialize()
        return self._inner_layer.init_state()


@register_layer
@dataclasses.dataclass
class MaskZeroLayer(_WrapperBase):
    """Derives a timestep mask from the steps whose every feature equals
    ``mask_value`` and hands it to the wrapped layer."""
    inner: Optional[dict] = None
    mask_value: float = 0.0
    _inner_layer: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)

    @staticmethod
    def wrap(inner: Layer, mask_value: float = 0.0) -> "MaskZeroLayer":
        layer = MaskZeroLayer(inner=inner.to_dict(), mask_value=mask_value)
        layer._materialize()
        return layer

    def apply(self, params, x, training=False, gen=None, state=None,
              mask=None):
        self._materialize()
        if mask is None:
            mask = (~torch.all(x == self.mask_value, dim=-1)).to(x.dtype)
        if "mask" in inspect.signature(self._inner_layer.apply).parameters:
            return self._inner_layer.apply(params, x, training=training,
                                           gen=gen, state=state, mask=mask)
        return self._inner_layer.apply(params, x, training=training, gen=gen,
                                       state=state)


# ---------------------------------------------------------- freeze pair
@register_layer
@dataclasses.dataclass
class FrozenLayer(_WrapperBase):
    """No param updates and no backprop through: the params and the input
    detached."""
    inner: Optional[dict] = None
    _inner_layer: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)

    @staticmethod
    def wrap(inner: Layer) -> "FrozenLayer":
        layer = FrozenLayer(inner=inner.to_dict())
        layer._materialize()
        return layer

    def apply(self, params, x, training=False, gen=None, state=None):
        self._materialize()
        params = {k: v.detach() for k, v in params.items()}
        return self._inner_layer.apply(params, x.detach(), training=training,
                                       gen=gen, state=state)


@register_layer
@dataclasses.dataclass
class FrozenLayerWithBackprop(_WrapperBase):
    """The params frozen (detached), the input's gradient flowing, so the
    layers before it train through it."""
    inner: Optional[dict] = None
    _inner_layer: Any = dataclasses.field(default=None, repr=False,
                                          compare=False)

    @staticmethod
    def wrap(inner: Layer) -> "FrozenLayerWithBackprop":
        layer = FrozenLayerWithBackprop(inner=inner.to_dict())
        layer._materialize()
        return layer

    def apply(self, params, x, training=False, gen=None, state=None):
        self._materialize()
        params = {k: v.detach() for k, v in params.items()}
        return self._inner_layer.apply(params, x, training=training, gen=gen,
                                       state=state)


# ----------------------------------------------------------- capsnet trio
def _squash(s, dim=-1, eps=1e-8):
    """v = |s|²/(1 + |s|²) · s/|s| (Sabour et al.)."""
    sq = torch.sum(s * s, dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s / torch.sqrt(sq + eps)


@register_layer
@dataclasses.dataclass
class PrimaryCapsules(Layer):
    """A convolution into ``channels`` capsule maps of
    ``capsule_dimensions`` each, flattened to (N, caps, capDim) and
    squashed. Input (N, H, W, C)."""
    capsule_dimensions: int = 8
    channels: int = 8
    kernel_size: Tuple[int, int] = (9, 9)
    stride: Tuple[int, int] = (2, 2)
    n_in: Optional[int] = None
    input_size: Optional[Tuple[int, int]] = None
    has_bias: bool = True

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.channels
        if self.input_size is None:
            self.input_size = (input_type.height, input_type.width)

    def _out_hw(self):
        h, w = self.input_size
        return (conv_out_size(h, self.kernel_size[0], self.stride[0], 0, 1,
                              False),
                conv_out_size(w, self.kernel_size[1], self.stride[1], 0, 1,
                              False))

    def n_capsules(self):
        oh, ow = self._out_hw()
        return self.channels * oh * ow

    def output_type(self, input_type: InputType) -> InputType:
        # the capsules ride the (N, T, C) convention: T capsules of C dims
        return InputType.recurrent(self.capsule_dimensions, self.n_capsules())

    def param_shapes(self):
        kh, kw = self.kernel_size
        cout = self.channels * self.capsule_dimensions
        shapes = {"W": (kh, kw, self.n_in, cout)}
        if self.has_bias:
            shapes["b"] = (cout,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        cout = self.channels * self.capsule_dimensions
        p = {"W": _winit.init(self.weight_init, gen, (kh, kw, self.n_in, cout),
                              kh * kw * self.n_in, kh * kw * cout)}
        if self.has_bias:
            p["b"] = torch.full((cout,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        z = _ops.conv2d(x, params["W"], params.get("b"), strides=self.stride,
                        padding="VALID")
        return _squash(z.reshape(z.shape[0], -1,
                                 self.capsule_dimensions)), state


@register_layer
@dataclasses.dataclass
class CapsuleLayer(Layer):
    """Capsules with dynamic routing (Sabour et al. 2017): (N, inCaps,
    inDim) → (N, capsules, capsule_dimensions). The predictions are one
    einsum over a (inCaps, capsules, outDim, inDim) weight; the gradient
    flows through every one of the ``routings`` iterations."""
    capsules: int = 10
    capsule_dimensions: int = 16
    routings: int = 3
    input_capsules: Optional[int] = None
    input_capsule_dimensions: Optional[int] = None

    def set_n_in(self, input_type: InputType):
        if self.input_capsules is None:
            self.input_capsules = input_type.timeseries_length
        if self.input_capsule_dimensions is None:
            self.input_capsule_dimensions = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.capsule_dimensions, self.capsules)

    def param_shapes(self):
        return {"W": (self.input_capsules, self.capsules,
                      self.capsule_dimensions,
                      self.input_capsule_dimensions)}

    def init_params(self, gen):
        return {"W": _winit.init(self.weight_init, gen,
                                 self.param_shapes()["W"],
                                 self.input_capsule_dimensions,
                                 self.capsule_dimensions)}

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        u_hat = _einsum("ijde,nie->nijd", params["W"], x)
        b = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype,
                        device=u_hat.device)                 # (N, i, j)
        v = None
        for r in range(self.routings):
            c = torch.softmax(b, dim=2)        # coupling over OUT capsules
            v = _squash(torch.einsum("nij,nijd->njd", c, u_hat))
            if r < self.routings - 1:
                b = b + torch.einsum("nijd,njd->nij", u_hat, v)
        return v, state


@register_layer
@dataclasses.dataclass
class CapsuleStrengthLayer(Layer):
    """Each capsule's L2 norm: (N, caps, capDim) → (N, caps)."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.timeseries_length)

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        return torch.sqrt(torch.sum(x * x, dim=-1) + 1e-12), state


@register_layer
@dataclasses.dataclass
class Deconvolution3D(Layer):
    """Transposed 3-D convolution over NDHWC volumes (Keras
    ``Conv3DTranspose``, with output_padding and dilation): Deconvolution2D's
    rule in three dims (``ops.standard.conv_transpose``)."""
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Any = 0
    dilation: Tuple[int, int, int] = (1, 1, 1)
    output_padding: Optional[Tuple[int, int, int]] = None
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

    def _k_eff(self):
        return tuple((k - 1) * d + 1
                     for k, d in zip(self.kernel_size, self.dilation))

    def _pad_pairs(self):
        from deeplearning4j_tpu_torch.nn.conf.layers import deconv_pad_pairs
        return deconv_pad_pairs(self.kernel_size, self.stride, self.dilation,
                                self.padding, self.output_padding)

    def output_type(self, input_type: InputType) -> InputType:
        dims = (input_type.depth, input_type.height, input_type.width)
        if _same(self.padding) and not self.output_padding \
                and all(d == 1 for d in self.dilation):
            d, h, w = (s * st for s, st in zip(dims, self.stride))
        else:
            d, h, w = (st * (s - 1) + sum(pr) - k + 2
                       for s, st, k, pr in zip(dims, self.stride,
                                               self._k_eff(),
                                               self._pad_pairs()))
        return InputType.convolutional3d(d, h, w, self.n_out)

    def param_shapes(self):
        shapes = {"W": self.kernel_size + (self.n_in, self.n_out)}
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
        z = _ops.conv_transpose(x, params["W"], self.stride,
                                _deconv_pads(self), self.dilation)
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


@register_layer
@dataclasses.dataclass
class SeparableConvolution1D(Layer):
    """Depthwise-separable 1-D convolution over (N, T, C) (Keras
    ``SeparableConv1D``): the depthwise op on a (N, T, 1, C) view with a
    (k, 1, C, m) kernel, then the (n_in·m, n_out) pointwise product."""
    kernel_size: int = 3
    stride: int = 1
    padding: Any = 0
    dilation: int = 1
    depth_multiplier: int = 1
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    def __post_init__(self):
        for f in ("kernel_size", "stride", "dilation"):
            v = getattr(self, f)
            if isinstance(v, (tuple, list)):
                setattr(self, f, int(v[0]))
        if not isinstance(self.padding, str) \
                and isinstance(self.padding, (tuple, list)):
            self.padding = int(self.padding[0])

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.size

    def output_type(self, input_type: InputType) -> InputType:
        # same AND causal keep ceil(T/s); a "valid" string pads nothing
        same = isinstance(self.padding, str) \
            and self.padding.lower() in ("same", "causal")
        pad = 0 if isinstance(self.padding, str) else self.padding
        t = (conv_out_size(input_type.timeseries_length, self.kernel_size,
                           self.stride, pad, self.dilation, same)
             if input_type.timeseries_length else None)
        return InputType.recurrent(self.n_out, t)

    def param_shapes(self):
        m = self.depth_multiplier
        shapes = {"dW": (self.kernel_size, self.n_in, m),
                  "pW": (self.n_in * m, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init_params(self, gen):
        k, m = self.kernel_size, self.depth_multiplier
        p = {"dW": _winit.init(self.weight_init, gen, (k, self.n_in, m),
                               k * self.n_in, k * m),
             "pW": _winit.init(self.weight_init, gen,
                               (self.n_in * m, self.n_out), self.n_in * m,
                               self.n_out)}
        if self.has_bias:
            p["b"] = torch.full((self.n_out,), float(self.bias_init))
        return p

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        if isinstance(self.padding, str) \
                and self.padding.lower() == "causal":
            # left pad, so step t sees only inputs <= t
            pad = [((self.kernel_size - 1) * self.dilation, 0), (0, 0)]
        elif isinstance(self.padding, str):
            pad = self.padding.upper()
        else:
            pad = [(self.padding, self.padding), (0, 0)]
        z = _ops.depthwise_conv2d(x[:, :, None, :], params["dW"][:, None],
                                  strides=(self.stride, 1), padding=pad,
                                  dilation=(self.dilation, 1))[:, :, 0, :]
        z = promote_mm(z, params["pW"])
        if self.has_bias:
            z = z + params["b"]
        return self._act(z), state


def _hard_sigmoid(z):
    """Keras' hard_sigmoid: clip(0.2·z + 0.5, 0, 1)."""
    return torch.clamp(0.2 * z + 0.5, 0.0, 1.0)


@register_layer
@dataclasses.dataclass
class ConvLSTM2D(Layer):
    """Convolutional LSTM over (N, T, H, W, C) sequences (Keras
    ``ConvLSTM2D``): the gates (i, f, c, o, split on the channel axis) are
    2-D convolutions. The input convolutions of every step run as one
    batched convolution; the recurrent ones in a time loop of cuDNN
    convolutions, as GRU's loop."""
    n_out: int = 1                       # filters
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Any = "valid"
    n_in: Optional[int] = None
    has_bias: bool = True
    return_sequences: bool = False
    recurrent_activation: str = "sigmoid"

    def __post_init__(self):
        self.kernel_size = _pair(self.kernel_size)
        self.stride = _pair(self.stride)
        if not (isinstance(self.padding, str)
                and self.padding.lower() in ("same", "valid")):
            raise ValueError(
                f"ConvLSTM2D: padding must be 'same' or 'valid' (got "
                f"{self.padding!r}); explicit numeric padding is not "
                f"implemented for the recurrent conv")
        if self.activation is None:
            self.activation = "tanh"

    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.channels

    def _spatial(self, input_type):
        same = _same(self.padding)
        return (conv_out_size(input_type.height, self.kernel_size[0],
                              self.stride[0], 0, 1, same),
                conv_out_size(input_type.width, self.kernel_size[1],
                              self.stride[1], 0, 1, same))

    def output_type(self, input_type: InputType) -> InputType:
        h, w = self._spatial(input_type)
        if self.return_sequences:
            return InputType.convolutional3d(input_type.depth, h, w,
                                             self.n_out)
        return InputType.convolutional(h, w, self.n_out)

    def param_shapes(self):
        kh, kw = self.kernel_size
        shapes = {"W": (kh, kw, self.n_in, 4 * self.n_out),
                  "RW": (kh, kw, self.n_out, 4 * self.n_out)}
        if self.has_bias:
            shapes["b"] = (4 * self.n_out,)
        return shapes

    def init_params(self, gen):
        kh, kw = self.kernel_size
        f = self.n_out
        p = {"W": _winit.init(self.weight_init, gen, (kh, kw, self.n_in, 4 * f),
                              kh * kw * self.n_in, kh * kw * f),
             "RW": _winit.init(self.weight_init, gen, (kh, kw, f, 4 * f),
                               kh * kw * f, kh * kw * f)}
        if self.has_bias:
            b = torch.zeros((4 * f,))
            b[f:2 * f] = 1.0                  # unit forget-gate bias
            p["b"] = b
        return p

    def _rec_act(self):
        if self.recurrent_activation == "sigmoid":
            return torch.sigmoid
        if self.recurrent_activation == "hard_sigmoid":
            return _hard_sigmoid
        return _act.get(self.recurrent_activation)

    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(x, training, gen)
        pad = self.padding.upper()
        rec_act = self._rec_act()
        n, t = x.shape[0], x.shape[1]
        xc = _ops.conv2d(x.reshape((n * t,) + tuple(x.shape[2:])),
                         params["W"], params.get("b"), strides=self.stride,
                         padding=pad)
        xc = xc.reshape((n, t) + tuple(xc.shape[1:]))
        h = torch.zeros((n,) + tuple(xc.shape[2:4]) + (self.n_out,),
                        dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        hs = []
        for step in range(t):
            z = xc[:, step] + _ops.conv2d(h, params["RW"], None,
                                          strides=(1, 1), padding="SAME")
            i, fg, g, o = torch.chunk(z, 4, dim=-1)
            c = rec_act(fg) * c + rec_act(i) * self._act(g)
            h = rec_act(o) * self._act(c)
            hs.append(h)
        if self.return_sequences:
            return torch.stack(hs, dim=1), state
        return h, state
