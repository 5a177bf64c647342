"""AdamW with optax's interface, on trees of torch tensors.

Counterpart of the ``optax.adamw`` the JAX package trains
``TransformerLM`` with (``bench.py`` runs ``optax.adamw(3e-4)``), with
optax's defaults and arithmetic:

- ``weight_decay`` defaults to 1e-4 (``torch.optim.AdamW``'s is 1e-2);
- ``eps`` is added outside the square root (optax's ``eps_root`` is 0);
- there is no mask: decay applies to every leaf, LayerNorm gains, biases
  and both embeddings included;
- the update is −lr·(m̂ / (√v̂ + eps) + wd·p), with m̂ = m / (1 − b1^t)
  and v̂ = v / (1 − b2^t) at step t = count + 1.

``update`` moves the state's moments in place (the JAX step donates them)
and returns a state with the next count; the count is a Python int, so an
update never waits on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from deeplearning4j_tpu_torch.tree import tree_leaves, tree_unflatten


@dataclasses.dataclass
class AdamWState:
    """optax's ``ScaleByAdamState``: updates taken, first and second
    moments (trees shaped like the params, f32)."""
    count: int
    mu: Any
    nu: Any


class AdamW:
    """The ``optax.adamw`` transformation; build it with :func:`adamw`."""

    def __init__(self, learning_rate: float, b1: float, b2: float,
                 eps: float, weight_decay: float):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)

    def init(self, params) -> AdamWState:
        zeros = [torch.zeros_like(p) for p in tree_leaves(params)]
        return AdamWState(0, tree_unflatten(params, zeros),
                          tree_unflatten(params,
                                         [torch.zeros_like(z) for z in zeros]))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(updates, state) for ``grads`` at ``params``; the moments of
        ``state`` are updated in place."""
        g, p = tree_leaves(grads), tree_leaves(params)
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        count = state.count + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.learning_rate)
        return (tree_unflatten(params, upd),
                AdamWState(count, state.mu, state.nu))


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (constant learning rate)."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)


@torch.no_grad()
def apply_updates(params, updates):
    """``optax.apply_updates``, in place: params += updates. Returns
    ``params``."""
    torch._foreach_add_(tree_leaves(params), tree_leaves(updates))
    return params

