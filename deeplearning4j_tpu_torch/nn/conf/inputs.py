"""Config-time shape inference: a copy of
``deeplearning4j_tpu/nn/conf/inputs.py`` (the reference's ``InputType``:
FF/recurrent/CNN/CNNFlat; host code).

Layout, as the JAX package's:
- Convolutional activations are **NHWC** (DL4J: NCHW). On the card a
  contiguous NHWC tensor is an NCHW view in channels-last memory, which
  cuDNN convolves without a copy.
- Recurrent activations are **(batch, time, channels)** (reference: NCW
  (batch, channels, time)).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str                      # "ff" | "rnn" | "cnn" | "cnn_flat" | "cnn3d"
    size: int = 0                  # ff/rnn channel size
    timeseries_length: int = -1    # rnn; -1 = variable
    height: int = 0
    width: int = 0
    channels: int = 0
    depth: int = 0                 # cnn3d

    # ---- factory methods (ref: InputType.feedForward etc.)
    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=size)

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType("rnn", size=size, timeseries_length=timeseries_length)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=height, width=width, channels=channels)

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn_flat", height=height, width=width, channels=channels,
                         size=height * width * channels)

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn3d", depth=depth, height=height, width=width, channels=channels)

    def array_elements(self) -> int:
        if self.kind in ("ff", "cnn_flat"):
            return self.size
        if self.kind == "rnn":
            return self.size * max(1, self.timeseries_length)
        if self.kind == "cnn":
            return self.height * self.width * self.channels
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

    def batch_shape(self, n: int = -1) -> Tuple[int, ...]:
        """Shape of a batch of activations with this type (NHWC / NTC)."""
        if self.kind in ("ff", "cnn_flat"):
            return (n, self.size)
        if self.kind == "rnn":
            return (n, self.timeseries_length, self.size)
        if self.kind == "cnn":
            return (n, self.height, self.width, self.channels)
        if self.kind == "cnn3d":
            return (n, self.depth, self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        return InputType(**d)


def conv_out_size(in_size: int, kernel: int, stride: int, pad, dilation: int = 1,
                  same_mode: bool = False) -> int:
    """Spatial output size (ref: ConvolutionUtils#getOutputSize)."""
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    if same_mode:
        return -(-in_size // stride)  # ceil
    return (in_size + 2 * pad - eff_k) // stride + 1
