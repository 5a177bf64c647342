"""Loss functions: counterpart of ``deeplearning4j_tpu/nn/losses.py`` (the
reference's ``LossFunctions``: MCXENT, NEGATIVELOGLIKELIHOOD, MSE, XENT, …).

Each loss is ``fn(predictions, labels, mask) -> scalar mean loss`` over
POST-activation outputs; the softmax + NLL and sigmoid + XENT pairs have
logits forms that an output layer uses when it knows its pre-activation.
"""
from __future__ import annotations

import torch


def _masked_mean(per_example, mask):
    """Mean over the batch of per-example sums; a mask weights entries
    (per-timestep masks weight accordingly)."""
    if mask is not None:
        m = mask.reshape(tuple(mask.shape)
                         + (1,) * (per_example.dim() - mask.dim()))
        per_example = per_example * m
        scale = 1
        if m.dim() < per_example.dim():
            scale = per_example[0].numel() // max(1, m[0].numel())
        return torch.sum(per_example) / (
            torch.clamp_min(torch.sum(m), 1.0) * scale)
    if per_example.dim() > 1:
        return torch.mean(torch.sum(
            per_example.reshape(per_example.shape[0], -1), dim=-1))
    return torch.mean(per_example)


def mse(pred, labels, mask=None):
    return _masked_mean(torch.square(pred - labels), mask)


l2 = mse


def mae(pred, labels, mask=None):
    return _masked_mean(torch.abs(pred - labels), mask)


l1 = mae


def negativeloglikelihood(pred, labels, mask=None):
    """NLL over probabilities (post-softmax), one-hot or soft labels."""
    return _masked_mean(-labels * torch.log(pred + 1e-10), mask)


mcxent = negativeloglikelihood


def mcxent_logits(logits, labels, mask=None):
    """The stable form used when the output activation is softmax."""
    return _masked_mean(-labels * torch.log_softmax(logits, dim=-1), mask)


def xent(pred, labels, mask=None):
    """Binary cross-entropy on sigmoid outputs."""
    eps = 1e-10
    per = -(labels * torch.log(pred + eps)
            + (1 - labels) * torch.log(1 - pred + eps))
    return _masked_mean(per, mask)


def xent_logits(logits, labels, mask=None):
    per = (torch.clamp_min(logits, 0) - logits * labels
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return _masked_mean(per, mask)


def hinge(pred, labels, mask=None):
    """labels ±1."""
    return _masked_mean(torch.clamp_min(1.0 - labels * pred, 0.0), mask)


def squared_hinge(pred, labels, mask=None):
    return _masked_mean(
        torch.square(torch.clamp_min(1.0 - labels * pred, 0.0)), mask)


def kl_divergence(pred, labels, mask=None):
    eps = 1e-10
    return _masked_mean(
        labels * (torch.log(labels + eps) - torch.log(pred + eps)), mask)


def poisson(pred, labels, mask=None):
    return _masked_mean(pred - labels * torch.log(pred + 1e-10), mask)


def cosine_proximity(pred, labels, mask=None):
    p = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-10)
    lb = labels / (torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
                   + 1e-10)
    return -torch.mean(torch.sum(p * lb, dim=-1))


def mean_squared_logarithmic_error(pred, labels, mask=None):
    return _masked_mean(
        torch.square(torch.log1p(pred) - torch.log1p(labels)), mask)


def mape(pred, labels, mask=None):
    return _masked_mean(
        100.0 * torch.abs((labels - pred) / (torch.abs(labels) + 1e-10)),
        mask)


def wasserstein(pred, labels, mask=None):
    return _masked_mean(pred * labels, mask)


def sparse_mcxent(logits, labels, mask=None):
    logp = torch.log_softmax(logits, dim=-1)
    per = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(per * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(per)


_LOSSES = {
    "mse": mse, "l2": l2, "mae": mae, "l1": l1,
    "negativeloglikelihood": negativeloglikelihood,
    "nll": negativeloglikelihood,
    "mcxent": mcxent, "xent": xent, "hinge": hinge,
    "squaredhinge": squared_hinge,
    "kldivergence": kl_divergence, "reconstructioncrossentropy": xent,
    "poisson": poisson, "cosineproximity": cosine_proximity,
    "meansquaredlogarithmicerror": mean_squared_logarithmic_error,
    "msle": mean_squared_logarithmic_error,
    "meanabsolutepercentageerror": mape, "mape": mape,
    "wasserstein": wasserstein, "sparsemcxent": sparse_mcxent,
}

# stable logits-form pairs: (loss, output activation) -> fused fn
_FUSED = {
    ("mcxent", "softmax"): mcxent_logits,
    ("negativeloglikelihood", "softmax"): mcxent_logits,
    ("nll", "softmax"): mcxent_logits,
    ("xent", "sigmoid"): xent_logits,
    ("sparsemcxent", "softmax"): sparse_mcxent,
}


def get(name):
    if callable(name):
        return name
    key = str(name).lower().replace("_", "")
    if key not in _LOSSES:
        raise ValueError(f"Unknown loss: {name!r} (have {sorted(_LOSSES)})")
    return _LOSSES[key]


def get_fused(loss_name, activation_name):
    """The fused logits-form loss of the pair, or None."""
    key = (str(loss_name).lower().replace("_", ""),
           str(activation_name).lower())
    return _FUSED.get(key)
