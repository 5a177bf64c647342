"""Mixed-precision policy helpers: counterpart of
``deeplearning4j_tpu/nn/_precision.py`` (the reference's
``Builder#dataType``). Hidden layers compute in bf16; master params,
updater state, the loss and the running statistics stay f32. ``half`` and
``float16`` also map to bf16: fp16 would need loss scaling, bf16 shares
f32's exponent range."""
from __future__ import annotations

import torch

_COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.bfloat16,
    "half": torch.bfloat16,
}


def _cast_float(a, dtype):
    """Cast floating tensors; leave ints and bools (labels, indices)."""
    if isinstance(a, torch.Tensor) and a.is_floating_point():
        return a.to(dtype)
    return a


def cast_params(tree, dtype):
    """A layer's param dict with its floating leaves in ``dtype``."""
    return {k: _cast_float(v, dtype) for k, v in tree.items()}


def recast_like(ref_tree, tree):
    """``tree``'s floating leaves cast back to ``ref_tree``'s dtypes, so
    stored states keep their f32 dtype across steps."""
    return {k: _cast_float(tree[k], ref_tree[k].dtype) for k in tree}
