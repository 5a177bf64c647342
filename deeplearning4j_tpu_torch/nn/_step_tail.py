"""Shared tail of the train steps: freeze masking, the optimizer, and the
numerics health and skip.

Counterpart of ``deeplearning4j_tpu/nn/_step_tail.py``. Frozen layers
zero BOTH their gradients and their updates (decoupled weight decay moves
params even at zero gradient); the health terms are taken on the masked
gradients; a skipped (non-finite) step keeps the old value of every
carried tree — params, optimizer state and layer states — or the poison
survives inside an accumulator. Every tree here is a list of leaves
(``optim/transforms.py``'s layout), or a layer-state tree in ``guarded``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from deeplearning4j_tpu_torch.observability import numerics as _num
from deeplearning4j_tpu_torch.optim.transforms import apply_updates


def _mask(leaves, frozen: Sequence[bool]):
    return [torch.zeros_like(t) if f else t for t, f in zip(leaves, frozen)]


def finish_train_step(opt, params: List[torch.Tensor], opt_state,
                      grads: List[torch.Tensor], loss: torch.Tensor,
                      frozen: Sequence[bool], guarded=()):
    """Apply the optimizer and numerics tail. ``frozen`` flags each leaf;
    ``guarded`` is a tuple of ``(new_tree, old_tree)`` pairs a skipped step
    rolls back too. Returns ``(new_params, new_opt_state, guarded_news,
    health)``, ``guarded_news`` in the pairs' order."""
    any_frozen = any(frozen)
    if any_frozen:
        grads = _mask(grads, frozen)
    if params:
        updates, new_opt_state = opt.update(grads, opt_state, params)
        if any_frozen:
            updates = _mask(updates, frozen)
        new_params = apply_updates(params, updates)
    else:                     # a net without params (a pooling-only graph)
        updates, new_opt_state, new_params = [], opt_state, []
    news = [new for new, _ in guarded]
    health = None
    if _num.numerics_enabled():
        health = _num.health_terms(loss, grads, params, updates)
        if _num.skip_on_nonfinite():
            # the one host read of the skip policy (see numerics.select)
            ok = bool(torch.logical_and(health["loss_finite"],
                                        health["grads_finite"]))
            new_params = _num.select(ok, new_params, params)
            new_opt_state = _num.select(ok, new_opt_state, opt_state)
            news = [_num.select(ok, new, old) for new, old in guarded]
            health["skipped"] = torch.tensor(not ok, device=loss.device)
    return new_params, new_opt_state, news, health
