"""One-pass layer-norm moments: ``E[x^2] - E[x]^2``, clamped at 0.

Counterpart of ``deeplearning4j_tpu/ops/moments.py``. The one-pass form
loses accuracy to cancellation when ``|mean| >> std`` and can go slightly
negative, so the variance is clamped at zero; accumulation is in at least
float32 whatever the input dtype, and the result stays in that
accumulation dtype (callers cast back at their boundary).
"""
from __future__ import annotations

import contextlib
import threading

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


# ------------------------------------------------ data-parallel batch moments
_batch = threading.local()


@contextlib.contextmanager
def global_batch(group, world: int):
    """Within this context :func:`batch_moments` takes its moments over the
    whole data-parallel batch: each rank's E[x] and E[x²] are summed over
    ``group`` by a differentiable all-reduce and divided by ``world`` (equal
    shards), so the formula is the global batch's, with sums in another
    order. ``parallel.ShardedTrainer``'s dense exchange sets it."""
    prev = getattr(_batch, "group", None)
    _batch.group = (group, world)
    try:
        yield
    finally:
        _batch.group = prev


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; its backward sums the output gradients
    over the group the same way (each rank's loss reaches every rank's
    moments)."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        out = grad.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def batch_moments(x: torch.Tensor, dims):
    """BatchNormalization's training moments: :func:`one_pass_moments`,
    over the global batch inside :func:`global_batch`."""
    over = getattr(_batch, "group", None)
    if over is None:
        return one_pass_moments(x, dims)
    group, world = over
    xf = _acc(x)
    both = torch.stack([torch.mean(xf, dim=dims),
                        torch.mean(torch.square(xf), dim=dims)])
    both = _AllReduceSum.apply(both, group) / world
    mean, ex2 = both[0], both[1]
    return mean, torch.clamp_min(ex2 - torch.square(mean), 0)
