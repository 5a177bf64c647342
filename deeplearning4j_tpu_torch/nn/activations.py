"""Activation registry: counterpart of ``deeplearning4j_tpu/nn/activations.py``
(the reference's ``Activation`` enum). Names match the reference,
case-insensitive, with the parametrized forms ``"leakyrelu:0.1"``,
``"elu:0.5"`` and ``"thresholdedrelu:2"``.

``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default;
``hardsigmoid`` is DL4J's ``clip(0.2x + 0.5, 0, 1)``, not PyTorch's
``relu6(x + 3) / 6``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _thresholded(alpha):
    return lambda x: torch.where(x > alpha, x, torch.zeros_like(x))


_ACTIVATIONS = {
    "identity": lambda x: x,
    "linear": lambda x: x,
    "relu": F.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hardsigmoid,
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": lambda x: 1.7159 * torch.tanh(2.0 * x / 3.0),
    "rectifiedtanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x ** 3,
    "swish": F.silu,
    "mish": F.mish,
    "thresholdedrelu": _thresholded(1.0),
}


def get(name):
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    if ":" in key:
        base, arg = key.split(":", 1)
        alpha = float(arg)
        if base == "leakyrelu":
            return lambda x: F.leaky_relu(x, alpha)
        if base == "elu":
            return lambda x: F.elu(x, alpha)
        if base == "thresholdedrelu":
            return _thresholded(alpha)
        raise ValueError(f"Unknown parametrized activation: {name!r}")
    if key not in _ACTIVATIONS:
        raise ValueError(f"Unknown activation: {name!r} (have {sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[key]


def names():
    return sorted(_ACTIVATIONS)
