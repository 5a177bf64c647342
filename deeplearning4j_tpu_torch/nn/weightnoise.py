"""Weight noise: counterpart of ``deeplearning4j_tpu/nn/weightnoise.py``
(the reference's ``DropConnect`` and ``WeightNoise``). Unlike dropout it
acts on a layer's WEIGHTS, in the networks' training forward; biases and
normalization params stay as they are (``apply_to_bias=False``, the
default). The draws come from the network's ``torch.Generator``; the
reference's threefry bits cannot be reproduced, so a scheme is held to the
reference by its distribution, and by the function it applies to given
draws (``apply``'s ``draws``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


def is_weight_param(pname: str, value, layer=None) -> bool:
    """Weights are the >= 2-D params (matrices, kernels); 1-D params
    (biases, BN gamma/beta) are not. A layer whose 2-D params are
    statistics names them in ``non_weight_params``."""
    if pname in getattr(layer, "non_weight_params", ()):
        return False
    return value.dim() >= 2


def _noisy(scheme, params: dict, layer) -> list:
    """The params ``scheme`` acts on, in the reference's (sorted) order."""
    return [k for k, w in sorted(params.items())
            if k not in getattr(layer, "non_weight_params", ())
            and (scheme.apply_to_bias or is_weight_param(k, w, layer))]


@dataclasses.dataclass
class DropConnect:
    """Bernoulli weight masking (Wan et al. 2013). ``p`` is the RETAIN
    probability; kept weights are scaled by 1/p, so expectations match
    inference."""
    p: float = 0.5
    apply_to_bias: bool = False

    def apply(self, params: dict, gen, layer=None,
              draws: Optional[Dict[str, Any]] = None) -> dict:
        """``params`` with the noisy ones masked; ``draws`` (name → bool
        keep mask) in place of draws from ``gen``."""
        out = dict(params)
        for k in _noisy(self, params, layer):
            w = params[k]
            keep = (draws[k] if draws is not None else
                    torch.rand(w.shape, generator=gen, device=w.device)
                    < self.p)
            out[k] = torch.where(keep, w / self.p, torch.zeros_like(w))
        return out

    def to_dict(self):
        return {"@noise": "DropConnect", "p": self.p,
                "apply_to_bias": self.apply_to_bias}


@dataclasses.dataclass
class WeightNoise:
    """Additive (default) or multiplicative Gaussian weight noise of
    standard deviation ``std``."""
    std: float = 0.01
    additive: bool = True
    apply_to_bias: bool = False

    def apply(self, params: dict, gen, layer=None,
              draws: Optional[Dict[str, Any]] = None) -> dict:
        """``params`` with noise on the noisy ones; ``draws`` (name → a
        standard normal f32 draw) in place of draws from ``gen``."""
        out = dict(params)
        for k in _noisy(self, params, layer):
            w = params[k]
            z = (draws[k] if draws is not None else
                 torch.randn(w.shape, generator=gen, device=w.device,
                             dtype=torch.float32))
            n = z * self.std
            out[k] = (w + n.to(w.dtype) if self.additive
                      else w * (1.0 + n).to(w.dtype))
        return out

    def to_dict(self):
        return {"@noise": "WeightNoise", "std": self.std,
                "additive": self.additive,
                "apply_to_bias": self.apply_to_bias}


def noise_from_dict(d: Any):
    if d is None or not isinstance(d, dict) or "@noise" not in d:
        return d
    d = dict(d)
    kind = d.pop("@noise")
    return {"DropConnect": DropConnect, "WeightNoise": WeightNoise}[kind](**d)
