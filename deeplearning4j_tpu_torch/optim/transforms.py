"""Gradient transformations with optax's arithmetic and state layout, over
lists of tensors.

The DL4J updaters (``optim/updaters.py``) lower to chains of these, as the
reference's ``to_optax()`` lowers to optax chains. A transform works on
the leaves of a param tree in ``tree.tree_leaves`` order (dict keys
sorted, as JAX flattens), so its state lines up leaf for leaf with the
reference's optax state:

- a NamedTuple state is a dict of its fields, in field order
  (``EmptyState()`` is ``{}``);
- a chain's tuple of states is a list;
- a param-shaped tree is a list of tensors (f32, like the params);
- a step count is a Python int, so an update never waits on the device.

:func:`state_leaves` flattens such a state in the order ``jax.tree.leaves``
flattens the optax one; :func:`state_from_optax` turns an optax state
(converted to numpy) into this layout. Updates are out of place: the old
state stays whole, so a step that is skipped keeps it.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

Leaves = List[torch.Tensor]


class Transform:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, every tree a list of leaves."""

    def init(self, params: Leaves):
        return {}

    def update(self, grads: Leaves, state, params: Leaves):
        raise NotImplementedError


class Chain(Transform):
    """``optax.chain``: each transform feeds the next."""

    def __init__(self, *transforms: Transform):
        self.transforms = list(transforms)

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, grads, state, params):
        out = []
        for t, s in zip(self.transforms, state):
            grads, s = t.update(grads, s, params)
            out.append(s)
        return grads, out


class Identity(Transform):
    def update(self, grads, state, params):
        return grads, state


def _zeros(params):
    return [torch.zeros_like(p) for p in params]


class ScaleBySchedule(Transform):
    """``scale_by_learning_rate(schedule)``: updates = −lr(count) · g."""

    def __init__(self, schedule: Callable[[int], float], sign: float = -1.0):
        self.schedule, self.sign = schedule, sign

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params):
        lr = self.sign * float(self.schedule(state["count"]))
        return torch._foreach_mul(grads, lr), {"count": state["count"] + 1}


class Trace(Transform):
    """``optax.trace``: t ← g + decay·t; Nesterov updates g + decay·t."""

    def __init__(self, decay: float, nesterov: bool = False):
        self.decay, self.nesterov = float(decay), nesterov

    def init(self, params):
        return {"trace": _zeros(params)}

    def update(self, grads, state, params):
        t = torch._foreach_add(grads, state["trace"], alpha=self.decay)
        upd = (torch._foreach_add(grads, t, alpha=self.decay)
               if self.nesterov else t)
        return upd, {"trace": t}


def _moment(grads, m, decay, order=1):
    """(1 − decay)·g^order + decay·m."""
    g = grads if order == 1 else torch._foreach_mul(grads, grads)
    out = torch._foreach_mul(m, decay)
    torch._foreach_add_(out, g, alpha=1.0 - decay)
    return out


def _bias_correct(m, decay, count):
    """m / (1 − decay^count), the divisor in f32 as optax computes it
    (in double, 1 − 0.999 differs from optax's by 1.3e-5 relative)."""
    one = np.float32(1.0)
    return torch._foreach_div(
        m, float(one - np.power(np.float32(decay), np.float32(count))))


class ScaleByAdam(Transform):
    """``scale_by_adam`` (``nesterov=True`` is ``nadam``'s)."""

    def __init__(self, b1, b2, eps, eps_root=0.0, nesterov=False):
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)
        self.nesterov = nesterov

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, grads, state, params):
        mu = _moment(grads, state["mu"], self.b1)
        nu = _moment(grads, state["nu"], self.b2, 2)
        count = state["count"] + 1
        if self.nesterov:
            mu_hat = torch._foreach_mul(_bias_correct(mu, self.b1, count + 1),
                                        self.b1)
            torch._foreach_add_(mu_hat, _bias_correct(grads, self.b1, count),
                                alpha=1.0 - self.b1)
        else:
            mu_hat = _bias_correct(mu, self.b1, count)
        den = _bias_correct(nu, self.b2, count)
        if self.eps_root:
            torch._foreach_add_(den, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return (torch._foreach_div(mu_hat, den),
                {"count": count, "mu": mu, "nu": nu})


class ScaleByAmsgrad(Transform):
    def __init__(self, b1, b2, eps, eps_root=0.0):
        self.b1, self.b2 = float(b1), float(b2)
        self.eps, self.eps_root = float(eps), float(eps_root)

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params),
                "nu_max": _zeros(params)}

    def update(self, grads, state, params):
        mu = _moment(grads, state["mu"], self.b1)
        nu = _moment(grads, state["nu"], self.b2, 2)
        count = state["count"] + 1
        mu_hat = _bias_correct(mu, self.b1, count)
        nu_max = torch._foreach_maximum(state["nu_max"],
                                        _bias_correct(nu, self.b2, count))
        den = torch._foreach_add(nu_max, self.eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        return (torch._foreach_div(mu_hat, den),
                {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max})


class ScaleByAdamax(Transform):
    def __init__(self, b1, b2, eps):
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)

    def init(self, params):
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    def update(self, grads, state, params):
        count = state["count"] + 1
        mu = _moment(grads, state["mu"], self.b1)
        g_abs = torch._foreach_abs(grads)
        torch._foreach_add_(g_abs, self.eps)
        nu = torch._foreach_maximum(g_abs,
                                    torch._foreach_mul(state["nu"], self.b2))
        return (torch._foreach_div(_bias_correct(mu, self.b1, count), nu),
                {"count": count, "mu": mu, "nu": nu})


class ScaleByRms(Transform):
    """``scale_by_rms`` (eps inside the square root, no bias correction,
    ``initial_scale`` 0: optax's defaults)."""

    def __init__(self, decay, eps, initial_scale=0.0):
        self.decay, self.eps = float(decay), float(eps)
        self.initial_scale = float(initial_scale)

    def init(self, params):
        return {"nu": [torch.full_like(p, self.initial_scale) for p in params]}

    def update(self, grads, state, params):
        nu = _moment(grads, state["nu"], self.decay, 2)
        scale = torch._foreach_add(nu, self.eps)
        torch._foreach_rsqrt_(scale)
        return torch._foreach_mul(scale, grads), {"nu": nu}


class ScaleByRss(Transform):
    """``scale_by_rss`` (AdaGrad's accumulator starts at
    ``initial_accumulator_value``)."""

    def __init__(self, initial_accumulator_value=0.1, eps=1e-7):
        self.initial = float(initial_accumulator_value)
        self.eps = float(eps)

    def init(self, params):
        return {"sum_of_squares": [torch.full_like(p, self.initial)
                                   for p in params]}

    def update(self, grads, state, params):
        sq = torch._foreach_addcmul(state["sum_of_squares"], grads, grads)
        upd = [torch.where(s > 0, torch.rsqrt(s + self.eps),
                           torch.zeros_like(s)) * g for s, g in zip(sq, grads)]
        return upd, {"sum_of_squares": sq}


class ScaleByAdaDelta(Transform):
    def __init__(self, rho, eps):
        self.rho, self.eps = float(rho), float(eps)

    def init(self, params):
        return {"e_g": _zeros(params), "e_x": _zeros(params)}

    def update(self, grads, state, params):
        e_g = _moment(grads, state["e_g"], self.rho, 2)
        upd = [torch.sqrt(ex + self.eps) / torch.sqrt(eg + self.eps) * g
               for g, eg, ex in zip(grads, e_g, state["e_x"])]
        e_x = _moment(upd, state["e_x"], self.rho, 2)
        return upd, {"e_g": e_g, "e_x": e_x}


class AddDecayedWeights(Transform):
    """updates + weight_decay · params."""

    def __init__(self, weight_decay):
        self.weight_decay = float(weight_decay)

    def update(self, grads, state, params):
        return torch._foreach_add(grads, params, alpha=self.weight_decay), state


class SetToZero(Transform):
    def update(self, grads, state, params):
        return [torch.zeros_like(g) for g in grads], state


class Clip(Transform):
    """``optax.clip``: each entry into [−t, t]."""

    def __init__(self, max_delta):
        self.max_delta = float(max_delta)

    def update(self, grads, state, params):
        return ([torch.clamp(g, -self.max_delta, self.max_delta)
                 for g in grads], state)


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


class ClipByGlobalNorm(Transform):
    """``optax.clip_by_global_norm``: all leaves scaled by t / ‖g‖ when
    ‖g‖ ≥ t."""

    def __init__(self, max_norm):
        self.max_norm = float(max_norm)

    def update(self, grads, state, params):
        norm = global_norm(grads)
        keep = norm < self.max_norm
        return ([torch.where(keep, g, g / norm.to(g.dtype) * self.max_norm)
                 for g in grads], state)


class ClipL2PerLeaf(Transform):
    """Each leaf rescaled to L2 norm t where its norm exceeds t."""

    def __init__(self, threshold):
        self.threshold = float(threshold)

    def update(self, grads, state, params):
        out = []
        for g in grads:
            n = torch.sqrt(torch.sum(torch.square(g)) + 1e-12)
            out.append(torch.where(n > self.threshold,
                                   g * (self.threshold / n), g))
        return out, state


class RenormL2PerLeaf(Transform):
    """Each leaf divided by its L2 norm."""

    def update(self, grads, state, params):
        return [g / torch.sqrt(torch.sum(torch.square(g)) + 1e-12)
                for g in grads], state


def apply_updates(params: Leaves, updates: Leaves) -> Leaves:
    """``optax.apply_updates``: new leaves p + u (out of place)."""
    return torch._foreach_add(params, updates)


# ------------------------------------------------------------ state helpers
def state_leaves(state) -> list:
    """The tensors and counts of ``state`` in ``jax.tree.leaves`` order of
    the matching optax state."""
    if isinstance(state, dict):
        return [x for v in state.values() for x in state_leaves(v)]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in state_leaves(v)]
    return [state]


def map_state(fn, state):
    """``fn`` over every tensor of ``state`` (counts pass through)."""
    if isinstance(state, dict):
        return {k: map_state(fn, v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [map_state(fn, v) for v in state]
    if isinstance(state, torch.Tensor):
        return fn(state)
    return state


def _tree_leaves_sorted(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves_sorted(tree[k])]
    return [tree]


def state_from_optax(state, device=None):
    """An optax state, its arrays converted to numpy (e.g. by
    ``jax.tree.map(np.asarray, opt_state)``), in this module's layout:
    NamedTuples become dicts of their fields, tuples lists, param trees
    lists of f32 tensors in sorted-key order, 0-d integer counts ints."""
    if hasattr(state, "_asdict"):
        return {k: state_from_optax(v, device)
                for k, v in state._asdict().items()}
    if isinstance(state, (list, tuple)):
        return [state_from_optax(v, device) for v in state]
    if isinstance(state, dict):
        return [torch.as_tensor(np.array(a, dtype=np.float32), device=device)
                for a in _tree_leaves_sorted(state)]
    arr = np.asarray(state)
    if arr.ndim == 0 and np.issubdtype(arr.dtype, np.integer):
        return int(arr)
    return torch.as_tensor(np.array(arr), device=device)
