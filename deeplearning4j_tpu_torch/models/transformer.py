"""TransformerLM — the decoder-only LM of ``deeplearning4j_tpu``, in PyTorch.

Counterpart of ``deeplearning4j_tpu/models/transformer.py`` on one
device: the forward (``apply``), ``prefill``, the dense and paged KV-cache
decode steps and the cache layouts, and training (``loss_fn``,
``loss_and_grads``, ``make_train_step``). Parameters are a plain dict in
the JAX package's layout (``init_params``): weights stored ``(in, out)``
and used as raw matmul operands, f32 master weights cast to
``config.dtype`` for compute by a differentiable cast (``_cast_params``),
so gradients land on the f32 masters, and logits in f32 from
f32-accumulated products.

Full-sequence attention runs in the CUDA flash kernels on the card, the
forward and its backward under one ``autograd.Function``, and in their
plain versions on the CPU (``kernels/flash_attention.py``); the JAX
package's TPU crossover policy is not carried over. Decode attention is
plain tensor code, as in the JAX package. The decode steps update the
cache tensors in place (the JAX functions return new arrays) and return
them, so a caller keeps one cache allocation for a whole generation; the
train step updates params and optimizer state in place (the JAX step
donates them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.ops.moments import one_pass_moments
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_NEG_INF = -1e30


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 256
    n_layers: int = 2
    n_heads: int = 4
    d_model: int = 128
    d_ff: Optional[int] = None
    max_len: int = 256
    dropout: float = 0.0              # training with an rng only: not
                                      # ported (raises there)
    dtype: Any = torch.float32        # torch.float32 / torch.bfloat16 or
                                      # the strings "float32" / "bfloat16"
    causal: bool = True
    scan_layers: bool = False         # a storage layout of the JAX params
                                      # only; from_jax_params unstacks it
    fused_qkv: bool = False
    remat: bool = False
    moe: Any = None
    pipeline_stages: int = 0
    ce_chunks: int = 0

    def __post_init__(self):
        if self.d_ff is None:
            self.d_ff = 4 * self.d_model
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} must divide into "
                             f"n_heads {self.n_heads}")
        if isinstance(self.dtype, str):
            if self.dtype not in _DTYPES:
                raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                                 f"got {self.dtype!r}")
            self.dtype = _DTYPES[self.dtype]
        if self.dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.dtype}")
        for name, on in (("remat", self.remat),
                         ("moe", self.moe is not None),
                         ("pipeline_stages", self.pipeline_stages > 1),
                         ("ce_chunks", bool(self.ce_chunks))):
            if on:
                raise NotImplementedError(
                    f"TransformerConfig.{name} is not ported yet "
                    "(see ROADMAP.md, queue 1)")


class _TiedHead(torch.autograd.Function):
    """bf16 x (B, T, C) times bf16 eᵀ into f32 logits on the card, the
    JAX head's ``preferred_element_type=f32`` (``aten::mm.dtype``: f32
    accumulation and output). The backward casts dlogits to bf16 before
    its two products, as the JAX package's ``chunked_ce._bwd`` does."""

    @staticmethod
    def forward(ctx, x, e):
        ctx.save_for_backward(x, e)
        return torch.mm(x.reshape(-1, x.shape[-1]), e.t(),
                        out_dtype=torch.float32).view(*x.shape[:-1],
                                                      e.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        return ((g2 @ e).view(x.shape),
                g2.t() @ x.reshape(-1, x.shape[-1]))


class TransformerLM:
    """Decoder-only LM on one device (``device=None`` means the card)."""

    def __init__(self, config: TransformerConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)

    # ------------------------------------------------------------ params
    def init_params(self, seed: int = 0) -> Dict:
        """Random f32 params in the JAX package's layout, N(0, 0.02²)
        weights drawn with numpy from ``seed`` (the same numbers
        :func:`~deeplearning4j_tpu_torch.models.weights.init_jax_layout`
        hands to the JAX model in a parity test)."""
        from deeplearning4j_tpu_torch.models.weights import (
            from_jax_params, init_jax_layout)
        return from_jax_params(init_jax_layout(self.config, seed),
                               self.config, self.device)

    def _cast_params(self, params):
        """The mixed-precision cast: f32 master params, compute in
        ``config.dtype``. Already-cast params pass through unchanged."""
        dt = self.config.dtype
        return tree_map(
            lambda a: a.to(dt) if a.is_floating_point() and a.dtype != dt
            else a, params)

    # ----------------------------------------------------------- forward
    def _ln(self, p, x):
        # layernorm statistics in f32 regardless of compute dtype
        xf = x.float()
        mu, var = one_pass_moments(xf, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        y = y * p["g"].float() + p["b"].float()
        return y.to(x.dtype)

    @staticmethod
    def _proj(p, x):
        """The attention projection of x (B, T, C): ``(x @ wqkv,)`` when
        fused, else ``(x @ wq, x @ wk, x @ wv)``."""
        if "wqkv" in p:
            return (x @ p["wqkv"],)
        return (x @ p["wq"], x @ p["wk"], x @ p["wv"])

    def _qkv(self, p, x):
        """(B, T, C) → (B, T, H, hd) q, k, v, fused or unfused."""
        c = self.config
        b, t, _ = x.shape
        xs = self._proj(p, x)
        if len(xs) == 1:
            xs = torch.split(xs[0], c.d_model, dim=-1)
        return tuple(a.reshape(b, t, c.n_heads, c.d_model // c.n_heads)
                     for a in xs)

    def _attn(self, p, x):
        """Full-sequence attention through ``fa.FlashAttention``: the
        flash kernels on the card (forward, and backward when a gradient
        is taken), their plain versions on the CPU. The kernels read q, k,
        v as (B, H, T, hd) views of the projection, write o through a view
        of a (B, T, H, hd) buffer and the gradient straight into one buffer
        shaped like the projection, so no copy is made around them.
        Returns (out, k, v), k and v as (B, T, H, hd) views."""
        c = self.config
        b, t, _ = x.shape
        h, hd = c.n_heads, c.d_model // c.n_heads
        xs = self._proj(p, x)
        kv = (torch.split(xs[0], c.d_model, dim=-1) if len(xs) == 1
              else xs)[1:]
        o = fa.FlashAttention.apply(h, c.causal, 1.0 / math.sqrt(hd), *xs)
        k, v = (a.view(b, t, h, hd) for a in kv)
        return o @ p["wo"], k, v

    def _ffn(self, blk, h):
        hdn = F.gelu(h @ blk["mlp"]["w_up"] + blk["mlp"]["b_up"],
                     approximate="tanh")       # jax.nn.gelu's default
        return hdn @ blk["mlp"]["w_down"] + blk["mlp"]["b_down"]

    def _head(self, params, x):
        """Tied LM head: f32 logits from f32-accumulated products of the
        compute-dtype operands (the JAX ``preferred_element_type=f32``):
        on the card a bf16 product with f32 output (``_TiedHead``), else
        the exact f32 cast of both operands (the CPU build has no
        ``mm.dtype``)."""
        e = params["tok_emb"]
        if x.is_cuda and x.dtype == torch.bfloat16:
            return _TiedHead.apply(x, e)
        return torch.matmul(x.float(), e.float().T)

    def _forward(self, params, tokens, keep_kv: bool, rng=None):
        c = self.config
        if rng is not None and c.dropout > 0.0:
            raise NotImplementedError(
                "dropout in training is not ported yet (see ROADMAP.md, "
                "queue 1)")
        params = self._cast_params(params)
        tokens = tokens.long()
        t = tokens.shape[1]
        x = (params["tok_emb"][tokens] + params["pos_emb"][:t]).to(c.dtype)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for blk in params["blocks"]:
            a, k, v = self._attn(blk["attn"], self._ln(blk["ln1"], x))
            x = x + a
            x = x + self._ffn(blk, self._ln(blk["ln2"], x))
            if keep_kv:
                ks.append(k)
                vs.append(v)
        logits = self._head(params, self._ln(params["ln_f"], x))
        return logits, ks, vs

    def apply(self, params, tokens: torch.Tensor, rng=None) -> torch.Tensor:
        """tokens (B, T) → logits (B, T, V) f32. ``rng`` asks for dropout
        (training mode), which raises while ``config.dropout > 0``: it is
        not ported."""
        return self._forward(params, tokens, keep_kv=False, rng=rng)[0]

    # ---------------------------------------------------------- training
    def loss_fn(self, params, tokens, targets, rng=None,
                with_aux: bool = False):
        """Mean token cross-entropy of ``apply``'s f32 logits against
        ``targets`` (B, T): logsumexp minus the target logit, as the JAX
        ``loss_fn`` with ``ce_chunks=0``. With ``with_aux``, (loss, aux)
        with the JAX aux keys (the MoE entries are zeros for the dense
        FFN)."""
        logits = self.apply(params, tokens, rng)
        correct = logits.gather(-1, targets.long()[..., None])[..., 0]
        loss = (torch.logsumexp(logits, dim=-1) - correct).mean()
        if not with_aux:
            return loss
        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        return loss, {"lm_loss": loss, "moe_aux_loss": zero,
                      "moe_dropped_fraction": zero,
                      "moe_expert_fraction": torch.zeros(
                          (0,), dtype=torch.float32, device=loss.device)}

    def loss_and_grads(self, params, tokens, targets, rng=None,
                       with_aux: bool = False):
        """``jax.value_and_grad(loss_fn)``: (loss, grads) — or ((loss,
        aux), grads) with ``with_aux`` — with grads a tree shaped like
        ``params`` (f32, the masters' dtype). ``params`` are left as they
        are (no ``requires_grad`` on them); the loss is a device tensor."""
        leaves = [a.detach().requires_grad_() for a in tree_leaves(params)]
        with torch.enable_grad():
            out = self.loss_fn(tree_unflatten(params, leaves), tokens,
                               targets, rng, with_aux)
            loss = out[0] if with_aux else out
            grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten(params, grads)
        if with_aux:
            return (loss.detach(), {k: a.detach() for k, a in
                                    out[1].items()}), grads
        return loss.detach(), grads

    def make_train_step(self, optimizer, return_metrics: bool = False):
        """``step(params, opt_state, tokens, targets, rng=None) → (params,
        opt_state, loss)`` — or a metrics dict (``loss``, ``lm_loss`` and
        the MoE aux entries) in place of the loss with
        ``return_metrics``. One forward and backward and an optax-style
        ``optimizer`` update (``deeplearning4j_tpu_torch.optim.adamw``);
        params and the optimizer's state are updated in place and
        returned, and the loss stays on the device (no host sync)."""
        from deeplearning4j_tpu_torch.optim.adamw import apply_updates

        def step(params, opt_state, tokens, targets, rng=None):
            out, grads = self.loss_and_grads(params, tokens, targets, rng,
                                             with_aux=return_metrics)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            if return_metrics:
                loss, aux = out
                return params, opt_state, {"loss": loss, **aux}
            return params, opt_state, out
        return step

    # ---------------------------------------------- prefill / decode
    def init_cache(self, batch: int, max_len: int,
                   dtype: Optional[torch.dtype] = None) -> Dict:
        """Dense per-layer KV cache ``{"k","v"}``: (L, B, S, H, hd)."""
        c = self.config
        shape = (c.n_layers, batch, max_len, c.n_heads,
                 c.d_model // c.n_heads)
        dt = dtype if dtype is not None else c.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def prefill(self, params, tokens: torch.Tensor) -> Tuple[torch.Tensor,
                                                             Dict]:
        """tokens (B, T) → (logits (B, T, V) f32, kv ``{"k","v"}``
        (L, B, T, H, hd)) — the cache entries the causal forward computed
        for every prompt position."""
        logits, ks, vs = self._forward(params, tokens, keep_kv=True)
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _window_embed(self, params, tokens, positions):
        """(B, W) tokens at (B, W) positions → (B, W, C) activations."""
        x = params["tok_emb"][tokens.long()] + params["pos_emb"][
            positions.long()]
        return x.to(self.config.dtype)

    def _window_attend(self, q, ck, cv, mask, hd):
        """q (B, W, H, hd) against caches (B, S, H, hd) under mask
        (B, W, S): scores in the compute dtype, max-subtract, exp and
        normalise in f32, P back in the compute dtype."""
        s = torch.einsum("bwhd,bshd->bwhs", q, ck) / float(math.sqrt(hd))
        s = torch.where(mask[:, :, None, :], s,
                        torch.tensor(_NEG_INF, dtype=s.dtype,
                                     device=s.device))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp((s - m).float())
        p = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
        return torch.einsum("bwhs,bshd->bwhd", p, cv)

    def _decode_layers(self, params, x, mask, write):
        """Shared decode body: per layer, project the window, let
        ``write(li, k, v)`` store its rows and return the (B, S, H, hd)
        caches to attend, then attention and FFN. Returns f32 logits."""
        c = self.config
        B, W, _ = x.shape
        hd = c.d_model // c.n_heads
        for li, blk in enumerate(params["blocks"]):
            q, k, v = self._qkv(blk["attn"], self._ln(blk["ln1"], x))
            ck, cv = write(li, k, v)
            o = self._window_attend(q, ck, cv, mask, hd)
            x = x + o.reshape(B, W, c.d_model) @ blk["attn"]["wo"]
            x = x + self._ffn(blk, self._ln(blk["ln2"], x))
        return self._head(params, self._ln(params["ln_f"], x))

    def decode_step_math(self, params, cache, tokens, positions):
        """One step for a slot batch: ``tokens`` (B,) at ``positions``
        (B,). Writes each slot's k/v at its position (clamped into the
        cache like ``dynamic_update_slice``) in place, then single-query
        attention over positions ``<= positions``. Returns (logits (B, V)
        f32, cache)."""
        params = self._cast_params(params)
        positions = positions.long()
        B = tokens.shape[0]
        S = cache["k"].shape[2]
        x = self._window_embed(params, tokens[:, None], positions[:, None])
        mask = (torch.arange(S, device=x.device)[None, None, :]
                <= positions[:, None, None])
        at = positions.clamp(0, S - 1)
        bidx = torch.arange(B, device=x.device)

        def write(li, k, v):
            ck, cv = cache["k"][li], cache["v"][li]
            ck[bidx, at] = k[:, 0]
            cv[bidx, at] = v[:, 0]
            return ck, cv

        logits = self._decode_layers(params, x, mask, write)
        return logits[:, 0], cache

    def decode_window_math(self, params, cache, tokens, positions):
        """Dense-cache W-window decode: ``tokens`` (B, W), token j at
        ``positions[b] + j``. Writes the window's k/v in place (rows past
        the cache are dropped, as the JAX scatter drops them), then
        attends under ``pos <= query_pos``. Returns (logits (B, W, V)
        f32, cache)."""
        params = self._cast_params(params)
        B, W = tokens.shape
        S = cache["k"].shape[2]
        pos_w = positions.long()[:, None] + torch.arange(
            W, device=tokens.device)[None, :]
        x = self._window_embed(params, tokens, pos_w)
        mask = (torch.arange(S, device=x.device)[None, None, :]
                <= pos_w[:, :, None])
        keep = pos_w < S
        bidx = torch.arange(B, device=x.device)[:, None].expand(B, W)[keep]
        at = pos_w[keep]

        def write(li, k, v):
            ck, cv = cache["k"][li], cache["v"][li]
            ck[bidx, at] = k[keep]
            cv[bidx, at] = v[keep]
            return ck, cv

        return self._decode_layers(params, x, mask, write), cache

    # ------------------------------------------------------- paged cache
    def init_paged_cache(self, n_pages: int, page_tokens: int,
                         dtype: Optional[torch.dtype] = None) -> Dict:
        """Page pool ``{"k","v"}``: (L, n_pages, P, H, hd). The last
        physical page is the trash page that no table row owns."""
        c = self.config
        shape = (c.n_layers, n_pages, page_tokens, c.n_heads,
                 c.d_model // c.n_heads)
        dt = dtype if dtype is not None else c.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def decode_window_paged(self, params, pool, tables, tokens, positions,
                            page_tokens: int):
        """Paged W-window decode: scatter the window's k/v rows into the
        pool through the per-slot page table ``tables`` (B,
        pages_per_slot) in place, gather each slot's pages back, attend
        under the causal mask. Rows past the last logical page go to the
        trash page (the last physical page). Returns (logits (B, W, V)
        f32, pool)."""
        if "k_scale" in pool:
            raise NotImplementedError("int8 KV pages are not ported yet "
                                      "(see ROADMAP.md, queue 1)")
        params = self._cast_params(params)
        B, W = tokens.shape
        P = int(page_tokens)
        tables = tables.long()
        n_lp = tables.shape[1]
        S = n_lp * P
        pos_w = positions.long()[:, None] + torch.arange(
            W, device=tokens.device)[None, :]
        x = self._window_embed(params, tokens, pos_w)
        mask = (torch.arange(S, device=x.device)[None, None, :]
                <= pos_w[:, :, None])
        bidx = torch.arange(B, device=x.device)[:, None]
        trash = pool["k"].shape[1] - 1
        phys = torch.where(pos_w < S,
                           tables[bidx, torch.clamp(pos_w // P, max=n_lp - 1)],
                           torch.full_like(pos_w, trash))
        off = pos_w % P

        def write(li, k, v):
            views = []
            for pl_, rows in ((pool["k"][li], k), (pool["v"][li], v)):
                pl_[phys, off] = rows
                views.append(pl_[tables].reshape(B, S, *pl_.shape[-2:]))
            return views

        return self._decode_layers(params, x, mask, write), pool
