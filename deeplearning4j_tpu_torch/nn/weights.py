"""Weight initialization: counterpart of ``deeplearning4j_tpu/nn/weights.py``
(the reference's ``WeightInit`` enum). fan_in / fan_out follow the
reference (conv: fan_in = kh·kw·in_ch, fan_out = kh·kw·out_ch).

Draws come from an explicit CPU ``torch.Generator``, so a seed gives the
same weights whatever device the network then lives on. JAX's threefry
bits cannot be reproduced: each scheme matches the reference in
distribution (tests hold mean and std), and parity tests carry the
reference's weights across.
"""
from __future__ import annotations

import math

import torch


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _uniform(gen, shape, a):
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (2 * a) - a


def _truncated_normal(gen, shape, lo=-2.0, hi=2.0):
    """Standard normal truncated to [lo, hi], by the inverse CDF (the
    distribution of ``jax.random.truncated_normal``)."""
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    a, b = cdf(lo), cdf(hi)
    u = torch.rand(shape, generator=gen, dtype=torch.float64) * (b - a) + a
    x = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
    return torch.clamp(x, lo, hi).float()


def init(name, gen: torch.Generator, shape, fan_in: float, fan_out: float
         ) -> torch.Tensor:
    """An f32 CPU tensor of ``shape`` drawn by scheme ``name``."""
    name = str(name).lower()
    shape = tuple(shape)
    if name in ("zero", "zeros", "constant"):
        return torch.zeros(shape)
    if name in ("one", "ones"):
        return torch.ones(shape)
    if name in ("normal", "xavier_fan_in", "lecun_normal"):
        return _normal(gen, shape) / math.sqrt(fan_in)
    if name == "uniform":
        return _uniform(gen, shape, 1.0 / math.sqrt(fan_in))
    if name == "xavier":
        return _normal(gen, shape) * math.sqrt(2.0 / (fan_in + fan_out))
    if name in ("xavier_uniform", "var_scaling_uniform_fan_avg"):
        return _uniform(gen, shape, math.sqrt(6.0 / (fan_in + fan_out)))
    if name in ("relu", "he", "he_normal"):
        return _normal(gen, shape) * math.sqrt(2.0 / fan_in)
    if name in ("relu_uniform", "he_uniform"):
        return _uniform(gen, shape, math.sqrt(6.0 / fan_in))
    if name in ("lecun_uniform", "var_scaling_uniform_fan_in"):
        return _uniform(gen, shape, math.sqrt(3.0 / fan_in))
    if name == "var_scaling_uniform_fan_out":
        return _uniform(gen, shape, math.sqrt(3.0 / fan_out))
    if name == "sigmoid_uniform":
        return _uniform(gen, shape, 4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    if name == "identity":
        if len(shape) == 2 and shape[0] == shape[1]:
            return torch.eye(shape[0])
        raise ValueError("IDENTITY init requires square 2-D shape")
    if name == "var_scaling_normal_fan_avg":
        return _truncated_normal(gen, shape) * math.sqrt(2.0 / (fan_in + fan_out))
    if name in ("var_scaling_normal_fan_in", "truncated_normal",
                "truncatednormal"):
        return _truncated_normal(gen, shape) / math.sqrt(fan_in)
    if name == "var_scaling_normal_fan_out":
        return _truncated_normal(gen, shape) / math.sqrt(fan_out)
    if name == "orthogonal":
        rows = shape[0] if len(shape) == 2 else int(math.prod(shape[:-1]))
        cols = shape[-1]
        big, small = max(rows, cols), min(rows, cols)
        q, r = torch.linalg.qr(_normal(gen, (big, small)))
        q = q * torch.sign(torch.diagonal(r))[None, :]
        q = q.T if rows < cols else q
        return q.reshape(shape).contiguous()
    raise ValueError(f"Unknown weight init: {name!r}")
