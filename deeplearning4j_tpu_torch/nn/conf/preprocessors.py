"""Explicit input preprocessors: a copy of
``deeplearning4j_tpu/nn/conf/preprocessors.py`` (ref:
``org.deeplearning4j.nn.conf.preprocessor.{CnnToFeedForwardPreProcessor,
FeedForwardToCnnPreProcessor,RnnToFeedForwardPreProcessor,
FeedForwardToRnnPreProcessor,RnnToCnnPreProcessor,CnnToRnnPreProcessor}`` —
SURVEY D1/D2).

The framework inserts the common conversions implicitly (DenseLayer's
CNN→FF flatten, per-timestep dense on rnn input); these classes exist for
users who set them EXPLICITLY via
``.input_pre_processor(idx, proc)``, matching the reference API. Layout
divergence note: activations are NHWC / (N, T, C) here (reference NCHW /
NCW), so flatten orders differ from the reference by design.

All are pure reshapes — autograd provides the backprop the reference
hand-writes in each class's ``backprop``.
"""
from __future__ import annotations

from typing import Dict, Optional

_PREPROC_TYPES: Dict[str, type] = {}


def register_preprocessor(cls):
    _PREPROC_TYPES[cls.__name__] = cls
    return cls


def preprocessor_from_dict(d: dict) -> "InputPreProcessor":
    d = dict(d)
    cls = _PREPROC_TYPES[d.pop("@preproc")]
    return cls(**d)


class InputPreProcessor:
    """ref: org.deeplearning4j.nn.conf.InputPreProcessor."""

    def pre_process(self, x, batch_size: Optional[int] = None):
        raise NotImplementedError

    preProcess = pre_process

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()
             if not k.startswith("_")}
        d["@preproc"] = type(self).__name__
        return d


@register_preprocessor
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(N, H, W, C) → (N, H·W·C)."""

    def __init__(self, input_height: int = 0, input_width: int = 0,
                 num_channels: int = 0):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, batch_size=None):
        return x.reshape(x.shape[0], -1)


@register_preprocessor
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(N, H·W·C) → (N, H, W, C)."""

    def __init__(self, input_height: int, input_width: int,
                 num_channels: int):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, batch_size=None):
        return x.reshape(x.shape[0], self.input_height, self.input_width,
                         self.num_channels)


@register_preprocessor
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(N, T, C) → (N·T, C) — per-timestep flattening for dense stacks."""

    def pre_process(self, x, batch_size=None):
        return x.reshape(-1, x.shape[-1])


@register_preprocessor
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(N·T, C) → (N, T, C), N recovered from the net's input batch size
    (the reference stores it during the paired RnnToFf preProcess)."""

    def pre_process(self, x, batch_size=None):
        if batch_size is None:
            raise ValueError("FeedForwardToRnnPreProcessor needs the "
                             "original batch size")
        return x.reshape(batch_size, -1, x.shape[-1])


@register_preprocessor
class RnnToCnnPreProcessor(InputPreProcessor):
    """(N, T, H·W·C) → (N·T, H, W, C)."""

    def __init__(self, input_height: int, input_width: int,
                 num_channels: int):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, batch_size=None):
        return x.reshape(-1, self.input_height, self.input_width,
                         self.num_channels)


@register_preprocessor
class CnnToRnnPreProcessor(InputPreProcessor):
    """(N·T, H, W, C) → (N, T, H·W·C)."""

    def __init__(self, input_height: int = 0, input_width: int = 0,
                 num_channels: int = 0):
        self.input_height = input_height
        self.input_width = input_width
        self.num_channels = num_channels

    def pre_process(self, x, batch_size=None):
        if batch_size is None:
            raise ValueError("CnnToRnnPreProcessor needs the original batch "
                             "size")
        import numpy as np
        feat = int(np.prod(x.shape[1:]))
        return x.reshape(batch_size, -1, feat)
