"""Gradient checks in float64: counterpart of
``deeplearning4j_tpu/autodiff/validation.py`` (the reference's
``GradCheckUtil`` / ``OpValidation``).

- ``grad_check``: central finite differences in float64 against torch
  autograd of a scalar function of a param tree (nested dicts and lists
  of tensors, walked by ``tree``), the reference's methodology.
- ``check_vjp``: the VJP/JVP inner-product identity and a finite-
  difference directional derivative, cheaper for large inputs.

Both run on the CPU in float64, whatever the inputs' device and dtype.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten


def _f64(t):
    return torch.as_tensor(np.asarray(
        t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t,
        dtype=np.float64))


def grad_check(fn: Callable, params, epsilon: float = 1e-5,
               max_rel_error: float = 1e-3, min_abs_error: float = 1e-8,
               subset: int = None, seed: int = 0) -> bool:
    """Central finite-difference check of the autograd gradient of ``fn``
    (tree -> scalar tensor) at ``params``; raises AssertionError at the
    first element out of tolerance."""
    params64 = tree_map(_f64, params)
    flat_p = tree_leaves(params64)
    leaves = [p.clone().requires_grad_(True) for p in flat_p]
    out = fn(tree_unflatten(params64, leaves))
    flat_g = torch.autograd.grad(out, leaves, allow_unused=True)
    rng = np.random.default_rng(seed)
    for leaf_idx, (p, g) in enumerate(zip(flat_p, flat_g)):
        p_np = p.numpy()
        g_np = np.zeros_like(p_np) if g is None else g.numpy()
        n = p_np.size
        idxs = range(n) if subset is None or n <= subset else \
            rng.choice(n, subset, replace=False)
        for i in idxs:
            orig = p_np.flat[i]

            def eval_at(v):
                p_mod = p_np.copy()
                p_mod.flat[i] = v
                mod = list(flat_p)
                mod[leaf_idx] = torch.as_tensor(p_mod)
                with torch.no_grad():
                    return float(fn(tree_unflatten(params64, mod)))

            num = (eval_at(orig + epsilon) - eval_at(orig - epsilon)) / \
                (2 * epsilon)
            ana = float(g_np.flat[i])
            abs_err = abs(num - ana)
            denom = max(abs(num), abs(ana))
            rel_err = abs_err / denom if denom > 0 else 0.0
            if abs_err > min_abs_error and rel_err > max_rel_error:
                raise AssertionError(
                    f"Gradient check FAILED at leaf {leaf_idx} flat-index "
                    f"{i}: numerical={num:.8g} analytic={ana:.8g} "
                    f"relErr={rel_err:.3g}")
    return True


def check_vjp(fn: Callable, *primals, atol: float = 1e-4, rtol: float = 1e-4,
              eps: float = 1e-4) -> bool:
    """Directional check: FD directional derivative vs JVP, and the
    VJP/JVP inner-product identity <J v, u> == <v, J^T u>."""
    primals64 = tuple(_f64(p) for p in primals)
    rng = np.random.default_rng(0)
    tangents = tuple(torch.as_tensor(rng.normal(size=tuple(p.shape)))
                     for p in primals64)
    y, jvp_out = torch.func.jvp(fn, primals64, tangents)
    ys = y if isinstance(y, (tuple, list)) else (y,)
    jvps = jvp_out if isinstance(jvp_out, (tuple, list)) else (jvp_out,)
    cot = tuple(torch.as_tensor(rng.normal(size=tuple(o.shape)))
                for o in ys)
    _, vjp_fn = torch.func.vjp(fn, *primals64)
    vjp_out = vjp_fn(cot if isinstance(y, (tuple, list)) else cot[0])
    lhs = sum(float(torch.sum(a * b)) for a, b in zip(jvps, cot))
    rhs = sum(float(torch.sum(a * b)) for a, b in zip(vjp_out, tangents))
    np.testing.assert_allclose(lhs, rhs, atol=atol, rtol=rtol)
    plus = fn(*[p + eps * d for p, d in zip(primals64, tangents)])
    minus = fn(*[p - eps * d for p, d in zip(primals64, tangents)])
    plus = plus if isinstance(plus, (tuple, list)) else (plus,)
    minus = minus if isinstance(minus, (tuple, list)) else (minus,)
    for a, b, j in zip(plus, minus, jvps):
        np.testing.assert_allclose(((a - b) / (2 * eps)).numpy(), j.numpy(),
                                   atol=1e-3, rtol=1e-3)
    return True
