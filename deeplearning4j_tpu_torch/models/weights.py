"""Parameters in the JAX package's layout, moved into the port.

``from_jax_params`` takes the param pytree of
``deeplearning4j_tpu.models.transformer.TransformerLM`` as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, params)`` gives
it) and returns the port's params: the same dict layout, f32 torch
tensors on one device, blocks always as a per-layer list (the JAX
``scan_layers`` storage stacks every block leaf on a leading layer axis,
the ``pipeline_stages`` storage on leading (stage, layer-in-stage) axes;
both are unstacked here, stage-major, in the order the JAX model runs the
blocks). ``to_jax_params`` goes the other way, so params
trained in either package can be compared or carried on in the other;
``adamw_state_to_numpy`` / ``adamw_state_from_numpy`` do the same for
AdamW's moments.
``init_jax_layout`` draws a random tree in that layout with numpy, so both
packages can be handed the same weights. A MoE model's blocks carry
``"moe"`` (``Wg``, ``W1``, ``b1``, ``W2``, ``b2``) in place of ``"mlp"``;
every function here handles both.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.optim.adamw import AdamWState
from deeplearning4j_tpu_torch.parallel.moe import moe_layout


def _block_layout(c, normal) -> Dict:
    C, ones, zeros = c.d_model, np.ones, np.zeros
    if c.fused_qkv:
        attn = {"wqkv": normal(C, 3 * C), "wo": normal(C, C)}
    else:
        attn = {"wq": normal(C, C), "wk": normal(C, C), "wv": normal(C, C),
                "wo": normal(C, C)}
    blk = {
        "ln1": {"g": ones(C, np.float32), "b": zeros(C, np.float32)},
        "ln2": {"g": ones(C, np.float32), "b": zeros(C, np.float32)},
        "attn": attn,
    }
    if c.moe is not None:
        blk["moe"] = moe_layout(c.moe, normal)
    else:
        blk["mlp"] = {"w_up": normal(C, c.d_ff),
                      "b_up": zeros(c.d_ff, np.float32),
                      "w_down": normal(c.d_ff, C),
                      "b_down": zeros(C, np.float32)}
    return blk


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack(blocks)


def _stack_blocks(blocks, c):
    """Per-layer blocks → the JAX storage of ``c``: the list itself, one
    leading layer axis (``scan_layers``) or (stage, layer-in-stage) axes
    (``pipeline_stages > 1``)."""
    if not blocks:
        return blocks
    if c.scan_layers:
        return _stack(blocks)
    if c.pipeline_stages > 1:
        lps = c.n_layers // c.pipeline_stages
        return _stack([_stack(blocks[s:s + lps])
                       for s in range(0, c.n_layers, lps)])
    return blocks


def init_jax_layout(config, seed: int = 0) -> Dict:
    """A random f32 param tree in the JAX ``init_params`` layout: N(0,
    0.02²) weights and embeddings, unit LN gains, zero biases, drawn from
    ``np.random.default_rng(seed)``; block leaves stacked as
    ``config.scan_layers`` or ``config.pipeline_stages`` store them."""
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
    tree["blocks"] = _stack_blocks(tree["blocks"], c)
    return tree


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _leaf_shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _leaf_shapes(v, f"{prefix}/{k}").items()}
    return {prefix: tuple(np.shape(tree))}


def _unstack_blocks(blocks, c) -> list:
    """The JAX block storage → per-layer blocks, stage-major for
    ``pipeline_stages``. Raises when the storage's leading axes disagree
    with the config's layers or stages."""
    if not isinstance(blocks, dict):
        if c.pipeline_stages > 1 and c.n_layers:
            raise ValueError(f"param tree has a list of blocks, config says "
                             f"pipeline_stages={c.pipeline_stages} (blocks "
                             f"stacked (S, L/S, ...))")
        return list(blocks)
    lead = {s[:2] for s in _leaf_shapes(blocks).values()}
    if c.pipeline_stages > 1:
        S, lps = c.pipeline_stages, c.n_layers // c.pipeline_stages
        if lead != {(S, lps)}:
            raise ValueError(f"stage-stacked blocks lead with "
                             f"{sorted(lead)}, config wants (S={S}, "
                             f"L/S={lps}) from pipeline_stages={S}, "
                             f"n_layers={c.n_layers}")
        return [_unstack(_unstack(blocks, s), i)
                for s in range(S) for i in range(lps)]
    lead = {s[:1] for s in _leaf_shapes(blocks).values()}
    if len(lead) != 1:
        raise ValueError(f"stacked blocks lead with {sorted(lead)}, not one "
                         f"layer axis")
    return [_unstack(blocks, i) for i in range(lead.pop()[0])]


def from_jax_params(tree: Dict, config,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict:
    """The JAX param tree (numpy leaves) → the port's f32 params on
    ``device`` (``None`` = the card). Checks the layout against
    ``config`` and raises on a mismatch."""
    dev = resolve_device(device)
    c = config
    blocks = _unstack_blocks(tree["blocks"], c)
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
        ffn = "moe" if c.moe is not None else "mlp"
        if ffn not in blk:
            raise ValueError(f"block {i} has no {ffn!r} params, as "
                             f"moe={c.moe} wants")
    if blocks:
        want = _leaf_shapes(_block_layout(
            c, lambda *shape: np.broadcast_to(np.float32(0), shape)))
        for i, blk in enumerate(blocks):
            got = _leaf_shapes(blk)
            if got != want:
                bad = sorted(k for k in set(got) | set(want)
                             if got.get(k) != want.get(k))
                raise ValueError(f"block {i} leaves {bad} have shapes "
                                 f"{[got.get(k) for k in bad]}, config wants "
                                 f"{[want.get(k) for k in bad]}")
    expect = {"tok_emb": (c.vocab_size, c.d_model),
              "pos_emb": (c.max_len, c.d_model)}
    for name, shape in expect.items():
        if tuple(np.shape(tree[name])) != shape:
            raise ValueError(f"{name} has shape {np.shape(tree[name])}, "
                             f"config wants {shape}")

    def to_t(a):
        # a copy even on the CPU: the train step updates params in place,
        # and must not write through into the caller's arrays
        return torch.from_numpy(
            np.require(a, np.float32, ["C_CONTIGUOUS", "WRITEABLE"])).to(
            dev, copy=True)

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
    leaves stacked as ``config.scan_layers`` or ``config.pipeline_stages``
    store them: the inverse of :func:`from_jax_params`."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().to("cpu", torch.float32).numpy()

    blocks = [conv(b) for b in params["blocks"]]
    if len(blocks) != config.n_layers:
        raise ValueError(f"params have {len(blocks)} blocks, config says "
                         f"n_layers={config.n_layers}")
    return {"tok_emb": conv(params["tok_emb"]),
            "pos_emb": conv(params["pos_emb"]),
            "ln_f": conv(params["ln_f"]),
            "blocks": _stack_blocks(blocks, config)}


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
