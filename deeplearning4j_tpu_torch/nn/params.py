"""Flat parameter vector ↔ param tree.

Counterpart of ``deeplearning4j_tpu/nn/params.py``: the reference's
``MultiLayerNetwork#init`` allocates one contiguous parameter vector, and
``net.params()`` / ``net.setParams`` work on it. Here, as in the JAX
package, the params live as a tree ``{layer key: {param name: tensor}}``
and this module keeps the flat contract: one order, pack and unpack.

The order is the JAX package's ``params()`` order: layer keys sorted as
strings, then param names sorted (``"0", "1", "10", "2"``; ``"beta"``
before ``"gamma"``), because the reference's param dicts come out of
``jax.tree.map`` with sorted keys. (The reference's ``setParams`` unpacks
in layer-insertion order instead, so there ``setParams(params())``
swaps a BatchNormalization's gamma and beta: ROADMAP queue 3.) The port
packs and unpacks in the one order, so ``setParams(params())`` is the
identity and ``setParams`` takes the reference's ``params()``.

``params()`` is the reference's write-through NDArray view
(:func:`params_view`): reading it flattens the tree in that one order,
writing it unpacks into the live params, so ``net.params().muli(0.9)``
scales the net and ``net.params().get(interval(a, b)).assign(0)`` zeroes
that slice of it. ``.buf()`` is the flat tensor.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import NDArray

ParamTree = Dict[str, Dict[str, torch.Tensor]]


def leaf_keys(tree) -> List[Tuple[str, str]]:
    """(layer key, param name) of every leaf, in flat order."""
    return [(k, p) for k in sorted(tree) for p in sorted(tree[k])]


def num_params(shapes_per_layer) -> int:
    return int(sum(int(np.prod(s)) for layer in shapes_per_layer.values()
                   for s in layer.values()))


def flatten_params(params: ParamTree, device=None) -> torch.Tensor:
    """Pack to a single flat f32 vector (ref: net.params())."""
    leaves = [params[k][p].detach().reshape(-1)
              for k, p in leaf_keys(params)]
    if not leaves:
        return torch.zeros((0,), device=device)
    return torch.cat(leaves)


def unflatten_params(flat, shapes_per_layer, device) -> ParamTree:
    """Unpack a flat vector into a tree (ref: net.setParams)."""
    flat = to_tensor(flat, device)
    total = num_params(shapes_per_layer)
    if flat.dim() != 1 or flat.shape[0] != total:
        raise ValueError(f"Expected flat vector of length {total}, got "
                         f"{tuple(flat.shape)}")
    out: ParamTree = {k: {} for k in sorted(shapes_per_layer)}
    off = 0
    for k, p in leaf_keys(shapes_per_layer):
        shape = tuple(shapes_per_layer[k][p])
        size = int(np.prod(shape)) if shape else 1
        out[k][p] = flat[off:off + size].reshape(shape).clone()
        off += size
    return out


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` (NDArray, numpy, tensor, list) as a tensor on ``device``;
    floating input becomes f32 (the JAX package's default dtype) unless
    ``dtype`` says otherwise."""
    if isinstance(a, NDArray):
        a = a.buf()
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        t = torch.as_tensor(arr if arr.flags.writeable else arr.copy())
    if dtype is None and t.is_floating_point() and t.dtype != torch.bfloat16:
        dtype = torch.float32
    return t.to(device=device, dtype=dtype)


def tree_to_device(tree, device) -> ParamTree:
    """A two-level tree of arrays as f32 tensors on ``device``, copied (the
    caller's arrays are never aliased), keys sorted."""
    return {k: {p: to_tensor(tree[k][p], device).clone()
                for p in sorted(tree[k])} for k in sorted(tree)}


def tree_to_numpy(tree) -> Dict[str, Dict[str, np.ndarray]]:
    return {k: {p: v.detach().float().cpu().numpy() for p, v in layer.items()}
            for k, layer in tree.items()}


class _ModelParamAdapter:
    """The base of ``net.params()``: an NDArray view base whose ``buf()``
    is the flat vector of a network's live params and whose ``_write``
    unpacks a flat vector into them (ref: ``nn/params.py``'s adapter)."""

    def __init__(self, model):
        self._model = model

    def buf(self) -> torch.Tensor:
        return flatten_params(self._model._params, self._model.device)

    def _write(self, new_buf):
        m = self._model
        m._params = unflatten_params(new_buf, m._param_shapes, m.device)


def params_view(model) -> NDArray:
    """``net.params()``: a write-through NDArray over the flat params."""
    return NDArray(None, base=_ModelParamAdapter(model), index=slice(None))
