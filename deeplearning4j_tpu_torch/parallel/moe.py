"""Mixture-of-experts FFN (Switch top-1, GShard top-2) on one device.

Counterpart of ``deeplearning4j_tpu/parallel/moe.py``: ``MoEConfig``,
``init_moe_params``, ``moe_ffn`` and ``moe_reference_dense``. Routing runs
in plain torch ((G, E) in size): the router product and softmax, the
first-index argmax, top-2's second choice queued behind every first
choice, capacity ``C = ceil(G / E · capacity_factor · top_k)``, each
choice's place in its expert's queue, the drops past C, and the aux loss
and stats in the reference's dtypes. The reference multiplies (G, E, C)
one-hot tensors through to move tokens; here routing hands two index maps
to the K7 kernels (``kernels/moe_route.py``: dispatch and combine, each the
other's backward), and the expert products ``(E, C, d)·(E, d, f)`` and
``(E, C, f)·(E, f, d)`` stay ``torch.bmm``, as the reference leaves them to
``einsum``.

Queue positions are an exact int32 count. The reference counts them with a
cumsum in ``x.dtype``, which in bf16 is exact only up to 256: past that,
tokens of one expert share slots and are summed there (ROADMAP §3). The
port keeps every kept token in a slot of its own.

The expert-sharding specs (``moe_param_specs``, ``moe_param_shardings``)
wait for multi-GPU training.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels import moe_route as mr


@dataclasses.dataclass
class MoEConfig:
    d_model: Optional[int] = None   # None: filled in from the host model's
    d_ff: Optional[int] = None      # config (TransformerConfig.moe path)
    num_experts: int = 8
    capacity_factor: float = 1.25
    router_noise: float = 0.0       # jitter for load-balancing exploration
    top_k: int = 1                  # 1 = Switch; 2 = GShard top-2 routing
                                    # (renormalized gates, second choices
                                    # queue behind ALL first choices)

    def __post_init__(self):
        if self.top_k not in (1, 2):
            raise ValueError(f"top_k must be 1 or 2 (got {self.top_k})")


def _check_resolved(cfg: MoEConfig):
    if not cfg.d_model or not cfg.d_ff:
        raise ValueError(
            "MoEConfig.d_model/d_ff are unset — pass them explicitly, or "
            "hand the config to TransformerConfig(moe=...) which fills them "
            "from the host model")


def moe_layout(cfg: MoEConfig, normal) -> Dict[str, np.ndarray]:
    """The MoE leaves as numpy f32 arrays, weights from ``normal(*shape)``,
    biases zero: router ``Wg`` (d, E), ``W1`` (E, d, f), ``b1`` (E, f),
    ``W2`` (E, f, d), ``b2`` (E, d)."""
    _check_resolved(cfg)
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"Wg": normal(d, E), "W1": normal(E, d, f),
            "b1": np.zeros((E, f), np.float32), "W2": normal(E, f, d),
            "b2": np.zeros((E, d), np.float32)}


def init_moe_params(cfg: MoEConfig, seed: int = 0, scale: float = 0.02,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Random f32 MoE params on ``device`` (``None`` = the card): N(0,
    scale²) weights drawn with numpy from ``seed``, zero biases."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)

    return {k: torch.from_numpy(v).to(dev)
            for k, v in moe_layout(cfg, normal).items()}


def capacity(tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: ``ceil(G / E · capacity_factor · top_k)``, the
    reference's float arithmetic."""
    return int(math.ceil(tokens / cfg.num_experts * cfg.capacity_factor
                         * cfg.top_k))


def _queue_positions(idx: torch.Tensor, n_experts: int,
                     before: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's place in its expert's queue (int32): how many earlier
    tokens chose the same expert, plus ``before[e]`` (the first choices
    queued ahead of second ones)."""
    # (E, G): the scan runs along the contiguous token axis (a scan down
    # the G rows of (G, E) runs E lanes wide on the card: 1.3 ms at G 8192)
    onehot = F.one_hot(idx, n_experts).to(torch.int32).T.contiguous()
    pos = onehot.cumsum(1, dtype=torch.int32).gather(0, idx[None])[0] - 1
    if before is not None:
        pos = pos + before[idx]
    return pos


def route(probs: torch.Tensor, cfg: MoEConfig, n_cap: int):
    """The routing of ``moe_ffn`` from router probabilities (G, E):
    (choices (G, K) expert ids, gates (G, K) in probs' dtype, slot (G, K)
    int32, src (E·C,) int32, first-choice one-hot (G, E) in probs' dtype).
    slot is ``e·C + pos`` of each kept choice and −1 past capacity; src is
    the inverse map, ``g·K + k`` of the choice in each slot or −1."""
    G, E = probs.shape
    idx = probs.argmax(-1)                        # first index on ties
    gate = probs.gather(-1, idx[:, None])[:, 0]
    onehot = F.one_hot(idx, E).to(probs.dtype)
    pos = _queue_positions(idx, E)
    choices, gates, positions = [idx], [gate], [pos]
    if cfg.top_k == 2:
        probs2 = probs * (1.0 - onehot)
        idx2 = probs2.argmax(-1)
        gate2 = probs2.gather(-1, idx2[:, None])[:, 0]
        denom = gate + gate2 + 1e-9
        first = torch.bincount(idx, minlength=E).to(torch.int32)
        choices.append(idx2)
        gates = [gate / denom, gate2 / denom]
        positions.append(_queue_positions(idx2, E, first))
    choices = torch.stack(choices, -1)
    pos = torch.stack(positions, -1)
    slot = torch.where(pos < n_cap, choices.to(torch.int32) * n_cap + pos,
                       torch.full_like(pos, -1))
    src = torch.full((E * n_cap,), -1, dtype=torch.int32,
                     device=probs.device)
    kept = slot >= 0
    order = torch.arange(slot.numel(), dtype=torch.int32,
                         device=probs.device).view(slot.shape)
    src[slot[kept].long()] = order[kept]
    return choices, torch.stack(gates, -1), slot, src, onehot


class _Dispatch(torch.autograd.Function):
    """Tokens (G, d) into the expert buffers (E·C, d) through ``src``; the
    gradient goes back through ``slot`` with unit weights (K7c)."""

    @staticmethod
    def forward(ctx, x, src, slot):
        ctx.save_for_backward(slot)
        return mr.moe_dispatch(x, src, slot.shape[1])

    @staticmethod
    def backward(ctx, d_ei):
        (slot,) = ctx.saved_tensors
        return mr.moe_combine(d_ei.contiguous(), slot), None, None


class _Combine(torch.autograd.Function):
    """The experts' outputs (E·C, d) back to tokens (G, d), weighted by
    ``gates`` (G, K); the gradient of both is K7d with gates."""

    @staticmethod
    def forward(ctx, out_e, gates, slot, src):
        ctx.save_for_backward(out_e, gates, src)
        return mr.moe_combine(out_e, slot, gates)

    @staticmethod
    def backward(ctx, dy):
        out_e, gates, src = ctx.saved_tensors
        d_out, d_gates = mr.moe_dispatch_grad(dy.contiguous(), src,
                                              gates.shape[1], gates, out_e)
        return d_out, d_gates, None, None


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: MoEConfig, rng: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """MoE FFN over (B, T, d). Returns (y, aux) where aux carries the
    Switch load-balancing loss and routing stats (``aux_loss``,
    ``dropped_fraction``, ``expert_fraction``). ``rng``, an integer seed,
    adds the router's uniform jitter when ``cfg.router_noise > 0``; it is
    drawn from a generator of its own and held to the reference by
    distribution (the reference draws threefry bits)."""
    _check_resolved(cfg)
    B, T, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    G = B * T
    xt = x.reshape(G, d)
    logits = xt @ params["Wg"]                        # (G, E)
    if rng is not None and cfg.router_noise > 0:
        g = torch.Generator(device=x.device)
        g.manual_seed(int(rng))
        noise = torch.rand(logits.shape, generator=g, device=x.device)
        # uniform in [1 - noise, 1 + noise) in f32, which promotes the
        # logits as the reference's f32 jitter does
        logits = logits + (1.0 - cfg.router_noise
                           + 2.0 * cfg.router_noise * noise)
    probs = torch.softmax(logits, dim=-1)
    n_cap = capacity(G, cfg)
    _choices, gates, slot, src, onehot = route(probs, cfg, n_cap)

    ei = _Dispatch.apply(xt.contiguous(), src, slot).view(E, n_cap, d)
    h = F.gelu(torch.bmm(ei, params["W1"]) + params["b1"][:, None, :],
               approximate="tanh")                    # jax.nn.gelu default
    out_e = torch.bmm(h, params["W2"]) + params["b2"][:, None, :]
    y = _Combine.apply(out_e.reshape(E * n_cap, d),
                       gates.to(x.dtype).contiguous(), slot, src)

    # Switch/GShard aux loss: E · Σ_e fraction_first_choice_e · mean_prob_e
    frac = onehot.to(x.dtype).mean(0)
    mean_prob = probs.mean(0)
    aux_loss = E * (frac * mean_prob).sum()
    n_kept = (slot >= 0).sum().to(x.dtype)
    dropped = torch.clamp(1.0 - n_kept / float(K * G), min=0.0)
    return y.view(B, T, d), {"aux_loss": aux_loss,
                             "dropped_fraction": dropped,
                             "expert_fraction": frac}


def moe_reference_dense(params: Dict[str, torch.Tensor], x: torch.Tensor,
                        cfg: MoEConfig) -> torch.Tensor:
    """Unrouted check path: every token through its top-k expert(s) with no
    capacity limit (the semantics dispatch must match when nothing
    drops)."""
    B, T, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt @ params["Wg"], dim=-1)

    def expert_out(idx):
        h = F.gelu(torch.einsum("gd,gdf->gf", xt, params["W1"][idx])
                   + params["b1"][idx], approximate="tanh")
        return (torch.einsum("gf,gfd->gd", h, params["W2"][idx])
                + params["b2"][idx])

    idx = probs.argmax(-1)
    gate = probs.gather(-1, idx[:, None])[:, 0]
    if cfg.top_k == 1:
        y = expert_out(idx) * gate[:, None]
    else:
        probs2 = probs * (1.0 - F.one_hot(idx, cfg.num_experts)
                          .to(x.dtype))
        idx2 = probs2.argmax(-1)
        gate2 = probs2.gather(-1, idx2[:, None])[:, 0]
        denom = gate + gate2 + 1e-9
        y = (expert_out(idx) * (gate / denom)[:, None]
             + expert_out(idx2) * (gate2 / denom)[:, None])
    return y.reshape(B, T, d)
