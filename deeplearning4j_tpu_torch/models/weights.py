"""Parameters in the JAX package's layout, moved into the port.

``from_jax_params`` takes the param pytree of
``deeplearning4j_tpu.models.transformer.TransformerLM`` as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, params)`` gives
it) and returns the port's params: the same dict layout, f32 torch
tensors on one device, blocks always as a per-layer list (the JAX
``scan_layers`` storage stacks every block leaf on a leading layer axis;
it is unstacked here). ``to_jax_params`` goes the other way, so params
trained in either package can be compared or carried on in the other;
``adamw_state_to_numpy`` / ``adamw_state_from_numpy`` do the same for
AdamW's moments.
``init_jax_layout`` draws a random tree in that layout with numpy, so both
packages can be handed the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.optim.adamw import AdamWState


def _block_layout(c, normal) -> Dict:
    C, ones, zeros = c.d_model, np.ones, np.zeros
    if c.fused_qkv:
        attn = {"wqkv": normal(C, 3 * C), "wo": normal(C, C)}
    else:
        attn = {"wq": normal(C, C), "wk": normal(C, C), "wv": normal(C, C),
                "wo": normal(C, C)}
    return {
        "ln1": {"g": ones(C, np.float32), "b": zeros(C, np.float32)},
        "ln2": {"g": ones(C, np.float32), "b": zeros(C, np.float32)},
        "attn": attn,
        "mlp": {"w_up": normal(C, c.d_ff), "b_up": zeros(c.d_ff, np.float32),
                "w_down": normal(c.d_ff, C),
                "b_down": zeros(C, np.float32)},
    }


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def init_jax_layout(config, seed: int = 0) -> Dict:
    """A random f32 param tree in the JAX ``init_params`` layout: N(0,
    0.02²) weights and embeddings, unit LN gains, zero biases, drawn from
    ``np.random.default_rng(seed)``; block leaves stacked when
    ``config.scan_layers``."""
    c = config
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    tree = {
        "tok_emb": normal(c.vocab_size, c.d_model),
        "pos_emb": normal(c.max_len, c.d_model),
        "ln_f": {"g": np.ones(c.d_model, np.float32),
                 "b": np.zeros(c.d_model, np.float32)},
        "blocks": [_block_layout(c, normal) for _ in range(c.n_layers)],
    }
    if c.scan_layers and tree["blocks"]:
        tree["blocks"] = _stack(tree["blocks"])
    return tree


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def from_jax_params(tree: Dict, config,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict:
    """The JAX param tree (numpy leaves) → the port's f32 params on
    ``device`` (``None`` = the card). Checks the layout against
    ``config`` and raises on a mismatch."""
    dev = resolve_device(device)
    c = config
    blocks = tree["blocks"]
    if isinstance(blocks, dict):                 # scan_layers storage
        n = int(np.shape(blocks["attn"]["wo"])[0])
        blocks = [_unstack(blocks, i) for i in range(n)]
    if len(blocks) != c.n_layers:
        raise ValueError(f"param tree has {len(blocks)} blocks, config "
                         f"says n_layers={c.n_layers}")
    want_attn = ({"wqkv", "wo"} if c.fused_qkv
                 else {"wq", "wk", "wv", "wo"})
    for i, blk in enumerate(blocks):
        if set(blk["attn"]) != want_attn:
            raise ValueError(f"block {i} attention params "
                             f"{sorted(blk['attn'])} do not match "
                             f"fused_qkv={c.fused_qkv}")
        if "mlp" not in blk:
            raise ValueError(f"block {i} has no dense 'mlp' params "
                             "(MoE blocks are not ported yet)")
    expect = {"tok_emb": (c.vocab_size, c.d_model),
              "pos_emb": (c.max_len, c.d_model)}
    for name, shape in expect.items():
        if tuple(np.shape(tree[name])) != shape:
            raise ValueError(f"{name} has shape {np.shape(tree[name])}, "
                             f"config wants {shape}")

    def to_t(a):
        return torch.from_numpy(
            np.require(a, np.float32, ["C_CONTIGUOUS", "WRITEABLE"])).to(dev)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return to_t(t)

    return {"tok_emb": to_t(tree["tok_emb"]),
            "pos_emb": to_t(tree["pos_emb"]),
            "ln_f": conv(tree["ln_f"]),
            "blocks": [conv(b) for b in blocks]}


def to_jax_params(params: Dict, config) -> Dict:
    """The port's params (or any tree in their layout, such as AdamW's
    moments) → numpy f32 leaves in the JAX ``init_params`` layout, block
    leaves stacked on a leading layer axis when ``config.scan_layers``:
    the inverse of :func:`from_jax_params`."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().to("cpu", torch.float32).numpy()

    blocks = [conv(b) for b in params["blocks"]]
    if len(blocks) != config.n_layers:
        raise ValueError(f"params have {len(blocks)} blocks, config says "
                         f"n_layers={config.n_layers}")
    if config.scan_layers and blocks:
        blocks = _stack(blocks)
    return {"tok_emb": conv(params["tok_emb"]),
            "pos_emb": conv(params["pos_emb"]),
            "ln_f": conv(params["ln_f"]), "blocks": blocks}


def adamw_state_to_numpy(state: AdamWState, config) -> Dict:
    """``{"count", "mu", "nu"}``, the fields of optax's
    ``ScaleByAdamState``, with mu and nu as numpy trees in the JAX param
    layout (:func:`to_jax_params`)."""
    return {"count": np.int32(state.count),
            "mu": to_jax_params(state.mu, config),
            "nu": to_jax_params(state.nu, config)}


def adamw_state_from_numpy(tree: Dict, config,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> AdamWState:
    """The inverse of :func:`adamw_state_to_numpy` (``device=None`` means
    the card); also takes optax's ``ScaleByAdamState`` fields read into a
    dict of numpy leaves."""
    return AdamWState(int(tree["count"]),
                      from_jax_params(tree["mu"], config, device),
                      from_jax_params(tree["nu"], config, device))
