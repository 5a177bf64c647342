"""IDropout family: counterpart of ``deeplearning4j_tpu/nn/conf/dropout.py``
(the reference's ``Dropout``, ``GaussianDropout``, ``GaussianNoise``,
``AlphaDropout``). A layer's ``dropout=`` takes a float (the RETAIN
probability) or one of these objects. Each draws from the network's
``torch.Generator`` on the activation's device; all are train-only.
"""
from __future__ import annotations

import dataclasses

import torch

_DROPOUT_TYPES = {}


def register_dropout(cls):
    _DROPOUT_TYPES[cls.__name__] = cls
    return cls


class IDropout:
    """Protocol: ``apply(x, gen, training) -> x`` + dict round-trip."""

    def apply(self, x, gen, training):  # pragma: no cover - interface
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@dropout"] = type(self).__name__
        return d


def dropout_from_dict(d: dict) -> IDropout:
    d = dict(d)
    cls = _DROPOUT_TYPES[d.pop("@dropout")]
    return cls(**d)


def _randn(x, gen):
    return torch.randn(x.shape, generator=gen, device=x.device,
                       dtype=x.dtype)


@register_dropout
@dataclasses.dataclass
class Dropout(IDropout):
    """Inverted dropout at retain probability ``p``."""
    p: float = 0.5

    def apply(self, x, gen, training):
        if not training or self.p >= 1.0:
            return x
        from deeplearning4j_tpu_torch.ops.standard import dropout_inverted
        return dropout_inverted(x, gen, p=self.p)


@register_dropout
@dataclasses.dataclass
class GaussianDropout(IDropout):
    """Multiplicative N(1, sqrt(rate / (1 - rate))) noise."""
    rate: float = 0.5

    def apply(self, x, gen, training):
        if not training or self.rate <= 0.0:
            return x
        stddev = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + stddev * _randn(x, gen))


@register_dropout
@dataclasses.dataclass
class GaussianNoise(IDropout):
    """Additive N(0, stddev) noise."""
    stddev: float = 0.1

    def apply(self, x, gen, training):
        if not training or self.stddev <= 0.0:
            return x
        return x + self.stddev * _randn(x, gen)


@register_dropout
@dataclasses.dataclass
class AlphaDropout(IDropout):
    """SELU-preserving dropout: dropped units take alpha' and an affine
    (a, b) correction keeps zero mean and unit variance."""
    p: float = 0.95                       # retain probability

    _ALPHA_PRIME = -1.7580993408473766

    def apply(self, x, gen, training):
        if not training or self.p >= 1.0:
            return x
        q = self.p
        ap = self._ALPHA_PRIME
        a = (q + ap * ap * q * (1 - q)) ** -0.5
        b = -a * ap * (1 - q)
        keep = torch.rand(x.shape, generator=gen, device=x.device) < q
        return (a * torch.where(keep, x, torch.full_like(x, ap)) + b
                ).to(x.dtype)
