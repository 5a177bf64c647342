"""Rematerialisation: recompute a function's activations in the backward
instead of keeping them.

Counterpart of ``deeplearning4j_tpu/nn/_remat.py`` over
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. A policy names
which products' outputs stay saved, so the recompute replays only the
rest:

- ``None`` / ``"nothing"``: keep nothing, recompute everything;
- ``"dots"``: keep every matrix product's output (``aten.mm``,
  ``aten.addmm``, ``aten.bmm`` and ``aten.mm.dtype``), as JAX's
  ``checkpoint_dots``;
- ``"dots_no_batch"``: keep ``mm`` and ``addmm`` only, not the batched
  ``bmm`` (the MoE expert products), as ``checkpoint_dots_with_no_batch_dims``.

The port's CUDA kernels are launched through ctypes, not as aten ops, so a
policy cannot keep their outputs: the flash attention forward is recomputed
under every policy.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: the policy names a config may carry
_POLICY_NAMES = ("dots", "dots_no_batch", "nothing")

_aten = torch.ops.aten
_SAVED = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.mm.dtype),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def checkpoint_policy(name: Optional[str]):
    """The selective-checkpoint policy function of a policy name, or None
    for full recompute (``None``, ``""`` or ``"nothing"``). An unknown name
    raises ValueError."""
    if not name or name == "nothing":
        return None
    if name not in _SAVED:
        raise ValueError(f"unknown remat policy {name!r} (one of "
                         f"{_POLICY_NAMES} or None)")
    saved = frozenset(_SAVED[name])

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat(fn: Callable, policy_name: Optional[str] = None) -> Callable:
    """``fn`` wrapped so that calling it saves only its inputs (and, under a
    policy, the named products' outputs) and recomputes the rest in the
    backward: the one spelling every remat call site routes through."""
    policy = checkpoint_policy(policy_name)
    kwargs = {}
    if policy is not None:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    @functools.wraps(fn)
    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return wrapped
