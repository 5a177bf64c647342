"""One-pass layer-norm moments: ``E[x^2] - E[x]^2``, clamped at 0.

Counterpart of ``deeplearning4j_tpu/ops/moments.py``. The one-pass form
loses accuracy to cancellation when ``|mean| >> std`` and can go slightly
negative, so the variance is clamped at zero; accumulation is in at least
float32 whatever the input dtype, and the result stays in that
accumulation dtype (callers cast back at their boundary).
"""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def one_pass_variance(x: torch.Tensor, mean: torch.Tensor, dims,
                      keepdim: bool = False) -> torch.Tensor:
    """``max(E[x^2] - mean^2, 0)`` given ``mean`` over the same dims."""
    ex2 = torch.mean(torch.square(_acc(x)), dim=dims, keepdim=keepdim)
    return torch.clamp_min(ex2 - torch.square(_acc(mean)), 0)


def one_pass_moments(x: torch.Tensor, dims, keepdim: bool = False):
    """``(mean, var)`` over ``dims`` in the >= f32 accumulation dtype;
    ``var`` is clamped to ``>= 0``."""
    xf = _acc(x)
    mean = torch.mean(xf, dim=dims, keepdim=keepdim)
    return mean, one_pass_variance(xf, mean, dims, keepdim)
