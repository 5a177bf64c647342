"""Parameter-sharding rules: ``{layer: {param: tensor}}`` → placement specs.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. The name-keyed
tensor-parallel rule is kept as a pure function for ROADMAP queue 1 item
7B; a spec is a tuple with one entry a dimension (an axis name or None),
``()`` meaning replicated. Only the replicated placement is built in this
slice: :func:`tp_shardings` with ``enable=False`` (or without a ``model``
axis past 1) gives every leaf ``()``, and ``enable=True`` over a ``model``
axis raises.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.parallel.mesh import (ITEM_7B, MODEL_AXIS,
                                                    axis_size)


def param_pspec(pname: str, ndim: int, model_axis: str = MODEL_AXIS) -> tuple:
    """The reference's tensor-parallel rule for one parameter: 2-D kernels
    (in, out) shard out, 4-D convs (H, W, I, O) shard O, a bias of a
    sharded out-dim shards with it; recurrent weights and normalization
    parameters replicate."""
    if pname.startswith(("RW", "bR", "gamma", "beta", "mean", "var", "p")):
        return ()
    if ndim == 2:
        return (None, model_axis)
    if ndim == 4:
        return (None, None, None, model_axis)
    if ndim == 1 and pname.startswith("b"):
        return (model_axis,)
    return ()


def tp_shardings(params, mesh, enable: bool = True):
    """A spec tree for a ``{layer: {param: tensor}}`` tree: replicated
    everywhere unless ``enable`` and the mesh has a ``model`` axis past 1,
    which is ROADMAP queue 1 item 7B and raises."""
    if enable and axis_size(mesh, MODEL_AXIS) > 1:
        raise NotImplementedError(
            f"tensor-parallel shardings are not ported yet: {ITEM_7B}")
    return replicate_tree(params, mesh)


def replicate_tree(tree, mesh):
    """``()`` (replicated) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: replicate_tree(v, mesh) for k, v in tree.items()}
    return ()
