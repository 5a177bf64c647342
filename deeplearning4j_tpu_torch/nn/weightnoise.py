"""The weight-vs-bias rule of ``deeplearning4j_tpu/nn/weightnoise.py``,
which L1/L2 regularization shares with weight noise. The noise schemes
themselves (``DropConnect``, ``WeightNoise``) wait (ROADMAP queue 1 item
8): a network whose layer sets ``weight_noise`` raises at ``init``."""
from __future__ import annotations


def is_weight_param(pname: str, value, layer=None) -> bool:
    """Weights are the >= 2-D params (matrices, kernels); 1-D params
    (biases, BN gamma/beta) are not. A layer whose 2-D params are
    statistics names them in ``non_weight_params``."""
    if pname in getattr(layer, "non_weight_params", ()):
        return False
    return value.dim() >= 2
