"""Param trees: nested dicts and lists of tensors, walked as JAX walks them.

Dict keys are visited in sorted order (as JAX flattens a dict), so two
trees of one layout line up whatever order their dicts were built in.
"""
from __future__ import annotations

from typing import List

import torch


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``; a tree of the same layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, dict keys in sorted order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in
    :func:`tree_leaves`' order."""
    it = iter(leaves)
    return tree_map(lambda _a: next(it), tree)
