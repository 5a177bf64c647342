"""TransformerLM — the decoder-only LM of ``deeplearning4j_tpu``, in PyTorch.

Counterpart of ``deeplearning4j_tpu/models/transformer.py`` on one
device: the forward (``apply``), ``prefill``, the dense and paged KV-cache
decode steps and the cache layouts, and training (``loss_fn``,
``loss_and_grads``, ``make_train_step``) with every single-device option:
the vocab-chunked cross-entropy (``ce_chunks``), per-block
rematerialisation (``remat`` with ``remat_policy``), dropout with an rng,
and the MoE FFN (``moe``, top-1 and top-2). Parameters are a plain dict in
the JAX package's layout (``init_params``): weights stored ``(in, out)``
and used as raw matmul operands, f32 master weights cast to
``config.dtype`` for compute by a differentiable cast (``_cast_params``),
so gradients land on the f32 masters, and logits in f32 from
f32-accumulated products.

Full-sequence attention runs in the CUDA flash kernels on the card, the
forward and its backward under one ``autograd.Function``, and in their
plain versions on the CPU (``kernels/flash_attention.py``); the JAX
package's TPU crossover policy is not carried over. The chunked
cross-entropy (``kernels/chunked_ce.py``) and the MoE token movement
(``kernels/moe_route.py``) likewise run in CUDA kernels on the card, and
so does every decode path's store and attention, dense and paged, bf16,
f32 or int8 pages: one launch a layer (K4a+w,
``kernels/paged_attention.py``, which quantizes the rows of an int8 pool
as K4w does). The decode steps
update the cache tensors in place (the JAX functions return new arrays) and
return them, so a caller keeps one cache allocation for a whole generation;
the train step updates params and optimizer state in place (the JAX step
donates them). A model trained with ``pipeline_stages`` runs here on one
device, its blocks one after another in the reference's stage-major order,
as the JAX model runs them without a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels import chunked_ce
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.nn._remat import checkpoint_policy, remat
from deeplearning4j_tpu_torch.ops.moments import one_pass_moments
from deeplearning4j_tpu_torch.parallel.moe import MoEConfig, moe_ffn
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def quantize_kv_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of KV rows (…, H, hd) → (int8
    rows, f32 scale (…,)): scale = max|row| / 127, zeros keep scale 1 so
    their dequantization is exact (the plain version of K4w's arithmetic,
    ``kernels/paged_attention.py``). Module-level on purpose: the int8
    numerics-gate tests monkeypatch it with a corrupted scale to show the
    gate trips (on the CPU, where the decode writes call it)."""
    return pa.quantize_kv_rows_reference(rows)


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 256
    n_layers: int = 2
    n_heads: int = 4
    d_model: int = 128
    d_ff: Optional[int] = None
    max_len: int = 256
    dropout: float = 0.0              # applied only with an rng (training)
    dtype: Any = torch.float32        # torch.float32 / torch.bfloat16 or
                                      # the strings "float32" / "bfloat16"
    causal: bool = True
    scan_layers: bool = False         # a storage layout of the JAX params
                                      # only; from_jax_params unstacks it
    fused_qkv: bool = False
    remat: bool = False               # recompute each block's activations
                                      # in the backward (nn/_remat.py)
    remat_policy: Optional[str] = None  # which products stay saved under
                                      # remat: None / "nothing" (none),
                                      # "dots", "dots_no_batch"
    moe: Optional[MoEConfig] = None   # replace the dense FFN with the MoE
                                      # FFN (parallel/moe.py)
    moe_aux_weight: float = 0.01      # Switch load-balance aux-loss weight
    pipeline_stages: int = 0          # > 1: the JAX params stack the blocks
                                      # (S, L/S, ...); one device runs them
                                      # in order (weights.py unstacks)
    microbatches: int = 0             # the JAX pipeline's micro-batches (0
                                      # = 2·stages); no effect on one device
    pipeline_schedule: str = "gpipe"  # "gpipe" or "1f1b"; no effect on one
                                      # device
    ce_chunks: int = 0                # > 0: the chunked cross-entropy
                                      # (kernels/chunked_ce.py); the
                                      # (B, T, V) logits never materialise

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
        checkpoint_policy(self.remat_policy)      # an unknown name raises
        if self.moe is not None:
            if not isinstance(self.moe, MoEConfig):
                raise TypeError(f"moe must be a deeplearning4j_tpu_torch "
                                f"MoEConfig, got {type(self.moe).__name__}")
            self.moe = dataclasses.replace(
                self.moe, d_model=self.moe.d_model or self.d_model,
                d_ff=self.moe.d_ff or self.d_ff)
        if self.ce_chunks:
            if self.ce_chunks < 2:
                raise ValueError("ce_chunks must be >= 2 (1 = off)")
            if self.vocab_size % self.ce_chunks:
                raise ValueError(f"vocab_size {self.vocab_size} must divide "
                                 f"into ce_chunks {self.ce_chunks}")
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or '1f1b' "
                f"(got {self.pipeline_schedule!r})")
        if self.pipeline_stages > 1:
            if self.n_layers % self.pipeline_stages:
                raise ValueError("n_layers must divide into pipeline_stages")
            if self.scan_layers:
                raise ValueError("pipeline_stages and scan_layers are "
                                 "mutually exclusive")
            if self.moe is not None:
                raise ValueError(
                    "pipeline_stages + moe is not supported yet (the MoE aux "
                    "loss cannot cross the pipeline's shard_map boundary)")
            if not self.microbatches:
                self.microbatches = 2 * self.pipeline_stages


_M64 = 0xFFFFFFFFFFFFFFFF


def _fold_in(seed: int, i: int) -> int:
    """A 63-bit generator seed from (seed, i), the port's ``fold_in``:
    splitmix64 over ``seed·φ + i + 1``, so neighbouring (seed, i) give
    unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(i) + 1) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def dropout_mask(rng: int, i: int, keep: float, shape,
                 device: torch.device) -> torch.Tensor:
    """The keep mask of dropout site ``i`` for the integer seed ``rng``:
    uniform draws below ``keep`` from a fresh ``torch.Generator`` seeded
    from (rng, i), as ``bernoulli(fold_in(rng, i), keep)`` in the JAX
    package. A fresh generator per call draws the same mask again when
    remat recomputes the block (``torch.utils.checkpoint`` restores only
    the default generators). Module-level so a test can hand both packages
    the same masks."""
    g = torch.Generator(device=device)
    g.manual_seed(_fold_in(rng, i))
    return torch.rand(shape, generator=g, device=device) < keep


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

    def _ffn_aux(self, blk, h):
        """One block's feed-forward on (B, T, C): (y, aux), aux the MoE
        FFN's (aux_loss, dropped_fraction, expert_fraction) in f32, or None
        for the dense FFN."""
        if "moe" in blk:
            y, st = moe_ffn(blk["moe"], h, self.config.moe)
            return y, (st["aux_loss"].float(), st["dropped_fraction"].float(),
                       st["expert_fraction"].float())
        hdn = F.gelu(h @ blk["mlp"]["w_up"] + blk["mlp"]["b_up"],
                     approximate="tanh")       # jax.nn.gelu's default
        return hdn @ blk["mlp"]["w_down"] + blk["mlp"]["b_down"], None

    def _ffn(self, blk, h):
        """The feed-forward alone (the decode and prefill paths, which feed
        no aux loss)."""
        return self._ffn_aux(blk, h)[0]

    def _head(self, emb, x):
        """Tied LM head on the cast embedding ``emb``: f32 logits from
        f32-accumulated products of the compute-dtype operands (the JAX
        ``preferred_element_type=f32``): on the card a bf16 product with
        f32 output (``_TiedHead``), else the exact f32 cast of both
        operands (the CPU build has no ``mm.dtype``)."""
        if x.is_cuda and x.dtype == torch.bfloat16:
            return _TiedHead.apply(x, emb)
        return torch.matmul(x.float(), emb.float().T)

    def _dropout(self, x, rng, i):
        """``where(mask, x / keep, 0)`` in x's dtype for the mask of site
        ``i`` (:func:`dropout_mask`); x itself without an rng or at
        ``dropout == 0``."""
        if rng is None or self.config.dropout <= 0.0:
            return x
        keep = 1.0 - self.config.dropout
        mask = dropout_mask(rng, i, keep, x.shape, x.device)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)

    def _embed(self, params, tokens, rng=None):
        """Cast params, tokens (B, T) → (B, T, C) activations: token and
        learned position embeddings, then dropout site 0."""
        t = tokens.shape[1]
        x = params["tok_emb"][tokens.long()] + params["pos_emb"][:t]
        return self._dropout(x.to(self.config.dtype), rng, 0)

    def _block_math(self, blk, x, rng, li):
        """One pre-LN block: attention, dropout site 2·li + 1, the FFN,
        site 2·li + 2. Returns (x, aux) as :meth:`_ffn_aux` gives aux."""
        a, _k, _v = self._attn(blk["attn"], self._ln(blk["ln1"], x))
        x = x + self._dropout(a, rng, 2 * li + 1)
        y, aux = self._ffn_aux(blk, self._ln(blk["ln2"], x))
        return x + self._dropout(y, rng, 2 * li + 2), aux

    def _apply_trunk(self, params, tokens, rng=None):
        """Everything up to and including the final LayerNorm: (hidden
        (B, T, C), the cast ``tok_emb``, the aux dict). The chunked loss
        consumes the trunk directly, so no logits materialise. With
        ``config.remat`` each block is rematerialised under
        ``config.remat_policy``. The aux dict holds the MoE aux loss summed
        over the layers and per-layer means of the dropped and per-expert
        fractions (zeros, and an empty fraction, for the dense FFN)."""
        c = self.config
        params = self._cast_params(params)
        x = self._embed(params, tokens, rng)
        body = (remat(self._block_math, c.remat_policy) if c.remat
                else self._block_math)
        total = None
        for li, blk in enumerate(params["blocks"]):
            x, aux = body(blk, x, rng, li)
            if aux is not None:
                total = aux if total is None else tuple(
                    a + b for a, b in zip(total, aux))
        x = self._ln(params["ln_f"], x)
        if total is None:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            total = (zero, zero, torch.zeros((0,), dtype=torch.float32,
                                             device=x.device))
        n = max(1, c.n_layers)
        return x, params["tok_emb"], {"moe_aux_loss": total[0],
                                      "moe_dropped_fraction": total[1] / n,
                                      "moe_expert_fraction": total[2] / n}

    def apply(self, params, tokens: torch.Tensor, rng=None,
              return_aux: bool = False):
        """tokens (B, T) → logits (B, T, V) f32. ``rng``, an integer seed,
        turns dropout on (training mode); None is inference. With
        ``return_aux``, (logits, aux dict) as the JAX ``apply`` gives."""
        x, emb, aux = self._apply_trunk(params, tokens, rng)
        logits = self._head(emb, x)
        return (logits, aux) if return_aux else logits

    # ---------------------------------------------------------- training
    def loss_fn(self, params, tokens, targets, rng=None,
                with_aux: bool = False):
        """Mean token cross-entropy against ``targets`` (B, T), plus
        ``moe_aux_weight`` times the MoE aux loss for a MoE model, as the
        JAX ``loss_fn``: with ``ce_chunks`` the chunked cross-entropy on
        the trunk's output (``kernels/chunked_ce.py``: no logits), else
        logsumexp minus the target logit of ``apply``'s f32 logits. With
        ``with_aux``, (loss, aux) with the JAX aux keys (the MoE entries
        are zeros for the dense FFN)."""
        c = self.config
        x, emb, aux = self._apply_trunk(params, tokens, rng)
        if c.ce_chunks:
            lm_loss = chunked_ce.chunked_softmax_xent(x, emb, targets,
                                                      c.ce_chunks)
        else:
            logits = self._head(emb, x)
            correct = logits.gather(-1, targets.long()[..., None])[..., 0]
            lm_loss = (torch.logsumexp(logits, dim=-1) - correct).mean()
        loss = lm_loss
        if c.moe is not None:
            loss = loss + c.moe_aux_weight * aux["moe_aux_loss"]
        if not with_aux:
            return loss
        return loss, {"lm_loss": lm_loss, **aux}

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
        params = self._cast_params(params)
        x = self._embed(params, tokens)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for blk in params["blocks"]:
            a, k, v = self._attn(blk["attn"], self._ln(blk["ln1"], x))
            x = x + a
            x = x + self._ffn(blk, self._ln(blk["ln2"], x))
            ks.append(k)
            vs.append(v)
        logits = self._head(params["tok_emb"], self._ln(params["ln_f"], x))
        if not ks:
            # zero-layer trunk (an embedding-only draft): no attention, an
            # empty (0, B, T, H, hd) cache
            c = self.config
            b, t = tokens.shape
            empty = torch.zeros((0, b, t, c.n_heads, c.d_model // c.n_heads),
                                dtype=c.dtype, device=self.device)
            return logits, {"k": empty, "v": empty}
        return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}

    def _window_embed(self, params, tokens, positions):
        """(B, W) tokens at (B, W) positions → (B, W, C) activations.
        Positions past the position table (the tail of a verify window at
        the end of the cache, whose logits are never emitted and whose rows
        are dropped or sent to the trash page) read its last row, where an
        index past the table would fault on the card."""
        pos = positions.long().clamp(max=params["pos_emb"].shape[0] - 1)
        x = params["tok_emb"][tokens.long()] + params["pos_emb"][pos]
        return x.to(self.config.dtype)

    def _decode_layers(self, params, x, pools, tables, pos, dst,
                       scales=None):
        """Shared decode body: per layer, project the window, store its k/v
        rows into layer ``li`` of ``pools`` (k, v) at their flat rows
        ``dst`` (B, W) (-1: dropped) and attend through ``tables`` at
        ``pos`` (B, W), in one K4a+w launch (int8 pools with ``scales``,
        quantized by :func:`quantize_kv_rows` on the CPU); then the output
        projection and the FFN. Returns f32 logits."""
        c = self.config
        B, W, _ = x.shape
        tables, pos, dst = tables.int(), pos.int(), dst.int()
        for li, blk in enumerate(params["blocks"]):
            q, k, v = self._qkv(blk["attn"], self._ln(blk["ln1"], x))
            sk, sv = (None, None) if scales is None else (scales[0][li],
                                                          scales[1][li])
            o = pa.paged_attention_write(q, k, v, pools[0][li], pools[1][li],
                                         tables, pos, dst, sk, sv,
                                         quantize=quantize_kv_rows)
            x = x + o.reshape(B, W, c.d_model) @ blk["attn"]["wo"]
            x = x + self._ffn(blk, self._ln(blk["ln2"], x))
        return self._head(params["tok_emb"], self._ln(params["ln_f"], x))

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
        # the dense cache as B pages of S tokens: slot b's row at b·S + pos
        dst = torch.arange(B, device=x.device) * S + positions.clamp(0, S - 1)
        logits = self._decode_layers(
            params, x, (cache["k"], cache["v"]), pa.dense_tables(B, x.device),
            positions[:, None], dst[:, None])
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
        dst = torch.where(pos_w < S, torch.arange(
            B, device=x.device)[:, None] * S + pos_w, -1)
        return self._decode_layers(params, x, (cache["k"], cache["v"]),
                                   pa.dense_tables(B, x.device), pos_w,
                                   dst), cache

    # ------------------------------------------------------- paged cache
    def init_paged_cache(self, n_pages: int, page_tokens: int,
                         quant: bool = False,
                         dtype: Optional[torch.dtype] = None) -> Dict:
        """Page pool ``{"k","v"}``: (L, n_pages, P, H, hd); under ``quant``
        int8 plus per-row f32 scales ``{"k_scale","v_scale"}`` (L, n_pages,
        P). The last physical page is the trash page that no table row
        owns."""
        c = self.config
        shape = (c.n_layers, n_pages, page_tokens, c.n_heads,
                 c.d_model // c.n_heads)
        if quant:
            return {name: torch.zeros(shape if name in ("k", "v")
                                      else shape[:3],
                                      dtype=torch.int8 if name in ("k", "v")
                                      else torch.float32,
                                      device=self.device)
                    for name in ("k", "v", "k_scale", "v_scale")}
        dt = dtype if dtype is not None else c.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    def decode_window_paged(self, params, pool, tables, tokens, positions,
                            page_tokens: int):
        """Paged W-window decode: scatter the window's k/v rows into the
        pool through the per-slot page table ``tables`` (B,
        pages_per_slot) in place, then attend through the table under the
        causal mask, one K4a+w launch a layer. Rows past the last logical
        page go to the trash page (the last physical page). An int8 pool
        (``k_scale`` present) takes its rows quantized (on the CPU by
        :func:`quantize_kv_rows`) and is dequantized inside the attention.
        Returns (logits (B, W, V) f32, pool)."""
        params = self._cast_params(params)
        B, W = tokens.shape
        P = int(page_tokens)
        n_lp = tables.shape[1]
        S = n_lp * P
        pos_w = positions.long()[:, None] + torch.arange(
            W, device=tokens.device)[None, :]
        x = self._window_embed(params, tokens, pos_w)
        bidx = torch.arange(B, device=x.device)[:, None]
        trash = pool["k"].shape[1] - 1
        lp = torch.clamp(pos_w // P, max=n_lp - 1)
        phys = torch.where(pos_w < S, tables.long()[bidx, lp],
                           torch.full_like(pos_w, trash))
        scales = ((pool["k_scale"], pool["v_scale"]) if "k_scale" in pool
                  else None)
        return self._decode_layers(params, x, (pool["k"], pool["v"]), tables,
                                   pos_w, phys * P + pos_w % P,
                                   scales), pool
