"""DecodeEngine: KV-cache generation over the port's TransformerLM.

Counterpart of ``deeplearning4j_tpu/models/generation.py`` for single-
batch serving: prefill over a prompt padded to a power-of-two bucket (the
flash kernel runs there), then one decode step per token against a KV
cache, with sampling on the device. The cache is paged by default — k/v
live in a pool of fixed-size pages shared by every slot, a host-side
``PageAllocator`` hands pages out, and a per-slot page table maps logical
to physical pages, with the pool's last page as the trash page free slots
point at. ``DL4J_TPU_KV_PAGE_TOKENS`` sets the page size (0 = the dense
per-slot cache), read at engine construction.

PyTorch runs eagerly, so there is no executable set to compile: the JAX
engine's jit wrappers, compile-watch probes and cost-model accounting
have no counterpart here. Caches are updated in place. Sampling is greedy
argmax or top-k/temperature drawn from a ``torch.Generator`` seeded from
``(seed, step)``: deterministic within the port, not the JAX package's
threefry bits.

Not ported yet (see ``ROADMAP.md``): speculative decoding (``draft``),
int8 KV pages (``kv_quant``), and the serving pipeline on top.
"""
from __future__ import annotations

import bisect
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.resilience.policy import CachePagesExhausted

#: default KV page size in tokens (``DL4J_TPU_KV_PAGE_TOKENS``; 0 = dense)
KV_PAGE_TOKENS_DEFAULT = 64


def page_tokens_env() -> Optional[int]:
    """``DL4J_TPU_KV_PAGE_TOKENS``: page size in tokens, ``0`` = dense
    cache, unset = None (engine default). A malformed value raises."""
    raw = os.environ.get("DL4J_TPU_KV_PAGE_TOKENS")
    if raw is None or raw == "":
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        raise ValueError(
            f"DL4J_TPU_KV_PAGE_TOKENS={raw!r} is not an integer "
            "(0 = dense kill switch)")


def pack_kv_pages(arr: torch.Tensor, page_tokens: int) -> torch.Tensor:
    """(L, 1, Tb, H, hd) prefill k/v → (L, npb, P, H, hd) page rows,
    zero-padded up to whole pages."""
    L, _b, tb, h, hd = arr.shape
    npb = -(-tb // page_tokens)
    a = F.pad(arr[:, 0], (0, 0, 0, 0, 0, npb * page_tokens - tb))
    return a.reshape(L, npb, page_tokens, h, hd)


class PageAllocator:
    """Host-side LIFO free list over the physical page pool; the decode
    loop owns every alloc/free, so there is no lock."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"page pool must hold >= 1 page, got {total}")
        self.total = int(total)
        self._free: List[int] = list(range(self.total - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.total - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, or None when the pool cannot cover them (all
        or nothing)."""
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        got = self._free[-n:]
        del self._free[-n:]
        return got

    def free(self, pages: Sequence[int]):
        for p in pages:
            if not 0 <= p < self.total:
                raise ValueError(f"page {p} outside pool [0, {self.total})")
        if pages:
            if len(set(pages)) != len(pages):
                raise ValueError(f"duplicate pages in free: {list(pages)}")
            seen = set(self._free)
            dup = [p for p in pages if p in seen]
            if dup:
                raise ValueError(f"double free of pages {dup}")
        self._free.extend(int(p) for p in pages)


class DecodeState:
    """Cache state for one consumer: the cache tensors plus, in paged
    mode, the page allocator, per-slot page lists and the page table
    (host copy and a device mirror rebuilt when the table changes)."""

    __slots__ = ("mode", "slots", "arrays", "tables", "tables_dev",
                 "alloc", "slot_pages")

    def __init__(self, mode: str, slots: int, arrays: Dict,
                 tables: Optional[np.ndarray] = None,
                 alloc: Optional[PageAllocator] = None):
        self.mode = mode                   # "dense" | "paged"
        self.slots = int(slots)
        self.arrays = arrays               # dense cache or page pool
        self.tables = tables               # (slots, pages_per_slot) int32
        self.tables_dev = None
        self.alloc = alloc
        self.slot_pages: List[List[int]] = [[] for _ in range(slots)]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """``greedy`` = argmax; ``topk`` draws from the temperature-scaled
    top-``top_k`` logits (``top_k=0`` = full-vocab categorical)."""

    kind: str = "greedy"
    top_k: int = 0
    temperature: float = 1.0

    def __post_init__(self):
        if self.kind not in ("greedy", "topk"):
            raise ValueError(
                f"sampler kind must be 'greedy' or 'topk', got {self.kind!r}")
        if self.temperature <= 0.0:
            raise ValueError("temperature must be > 0 (use kind='greedy' "
                             "for deterministic decoding)")


def step_generator(seed: int, step: int,
                   device: torch.device) -> torch.Generator:
    """The sampling generator of one step: seeded from ``(seed, step)``
    through numpy's SeedSequence, so a run replays from its seed."""
    state = np.random.SeedSequence((int(seed), int(step))).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) & (2 ** 63 - 1))
    return g


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  sampler: SamplerConfig) -> torch.Tensor:
    """(…, V) logits → (…,) int64 tokens under ``sampler``."""
    if sampler.kind == "greedy":
        return logits.argmax(dim=-1)
    scaled = (logits / sampler.temperature).float()
    idxs = None
    if sampler.top_k and sampler.top_k > 0:
        scaled, idxs = torch.topk(scaled, sampler.top_k, dim=-1)
    probs = torch.softmax(scaled, dim=-1)
    choice = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                               generator=generator)
    choice = choice.reshape(*probs.shape[:-1], 1)
    if idxs is not None:
        choice = idxs.gather(-1, choice)
    return choice[..., 0]


def default_prefill_buckets(max_len: int, lo: int = 16) -> Tuple[int, ...]:
    """Power-of-two prompt-length buckets up to ``max_len`` (always
    including ``max_len`` itself)."""
    out: List[int] = []
    b = lo
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


class DecodeEngine:
    """One (model, params) pair + one sampler. ``device=None`` means the
    card; the model must live on the engine's device. Params are cast to
    the compute dtype once, here."""

    def __init__(self, model, params, max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 sampler: Optional[SamplerConfig] = None, seed: int = 0,
                 page_tokens: Optional[int] = None,
                 kv_quant: Optional[bool] = None, draft=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if draft is not None:
            raise NotImplementedError(
                "speculative decoding (draft=) is not ported yet "
                "(see ROADMAP.md, queue 1)")
        if kv_quant if kv_quant is not None else (
                os.environ.get("DL4J_TPU_KV_QUANT", "0") == "1"):
            raise NotImplementedError(
                "int8 KV pages (kv_quant / DL4J_TPU_KV_QUANT=1) are not "
                "ported yet (see ROADMAP.md, queue 1)")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        c = model.config
        self.model = model
        self.max_len = int(max_len if max_len is not None else c.max_len)
        if not 0 < self.max_len <= c.max_len:
            raise ValueError(
                f"max_len {self.max_len} must be in (0, "
                f"config.max_len={c.max_len}] — positions beyond the "
                "learned pos_emb table cannot decode")
        self.sampler = sampler if sampler is not None else SamplerConfig()
        if prefill_buckets:
            buckets = tuple(sorted({int(b) for b in prefill_buckets
                                    if 0 < int(b) <= self.max_len}))
            if not buckets:
                raise ValueError(
                    f"prefill_buckets {tuple(prefill_buckets)} has no "
                    f"entry in (0, max_len={self.max_len}]")
        else:
            buckets = default_prefill_buckets(self.max_len)
        self.prefill_buckets = buckets
        self._seed = int(seed)
        pt = page_tokens if page_tokens is not None else page_tokens_env()
        pt = KV_PAGE_TOKENS_DEFAULT if pt is None else int(pt)
        self.page_tokens = min(pt, self.max_len) if pt > 0 else 0
        self.paged = self.page_tokens > 0
        self.pages_per_slot = (-(-self.max_len // self.page_tokens)
                               if self.paged else 0)
        self.params = model._cast_params(
            _to_device(params, self.device))

    # ------------------------------------------------------------- cache
    def new_state(self, slots: int,
                  pages: Optional[int] = None) -> DecodeState:
        """Cache state for ``slots`` sequences. Paged: a pool of
        ``pages`` physical pages (default ``slots * pages_per_slot``) plus
        the trash page every free slot's table row points at."""
        if not self.paged:
            return DecodeState("dense", slots,
                               self.model.init_cache(slots, self.max_len))
        n = int(pages) if pages is not None else slots * self.pages_per_slot
        if n < 1:
            raise ValueError(f"page pool needs >= 1 page, got {n}")
        pool = self.model.init_paged_cache(n + 1, self.page_tokens)
        tables = np.full((slots, self.pages_per_slot), n, np.int32)
        return DecodeState("paged", slots, pool, tables=tables,
                           alloc=PageAllocator(n))

    @staticmethod
    def cache_bytes(cache) -> int:
        """Device bytes of a cache or state (worst-case footprint)."""
        arrays = cache.arrays if isinstance(cache, DecodeState) else cache
        return int(sum(a.numel() * a.element_size()
                       for a in arrays.values()))

    def page_bytes(self) -> int:
        """Device bytes one page costs across all layers (k + v)."""
        if not self.paged:
            return 0
        c = self.model.config
        per_row = c.d_model
        itemsize = torch.empty((), dtype=c.dtype).element_size()
        return c.n_layers * self.page_tokens * 2 * per_row * itemsize

    def resident_cache_bytes(self, state: DecodeState) -> int:
        """Actual resident cache bytes: dense = the whole allocation,
        paged = pages in use × page bytes."""
        if state.mode != "paged":
            return self.cache_bytes(state)
        return int(state.alloc.in_use * self.page_bytes())

    # ------------------------------------------------------ page plumbing
    def pages_for(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_tokens) if self.paged else 0

    def min_pages_for_prompt(self, prompt_len: int) -> int:
        """Pages a request needs to admit: its padded prefill bucket or
        the first decode write at ``prompt_len``, whichever is further."""
        if not self.paged:
            return 0
        bucket = self.prefill_bucket(prompt_len)
        return max(self.pages_for(bucket), self.pages_for(prompt_len + 1))

    def ensure_slot_pages(self, state: DecodeState, slot: int,
                          last_position: int) -> bool:
        """Grow ``slot``'s pages to cover a write at ``last_position``;
        False when the pool is exhausted (nothing allocated)."""
        if state.mode != "paged":
            return True
        needed = int(last_position) // self.page_tokens + 1
        have = len(state.slot_pages[slot])
        if needed <= have:
            return True
        got = state.alloc.alloc(needed - have)
        if got is None:
            return False
        state.slot_pages[slot].extend(got)
        state.tables[slot, have:needed] = got
        state.tables_dev = None
        return True

    def free_slot(self, state: DecodeState, slot: int):
        """Return ``slot``'s pages and point its table row at the trash
        page."""
        if state.mode != "paged":
            return
        pages = state.slot_pages[slot]
        if pages:
            state.alloc.free(pages)
            state.slot_pages[slot] = []
            state.tables[slot, :] = state.alloc.total
            state.tables_dev = None

    def _tables(self, state: DecodeState) -> torch.Tensor:
        if state.tables_dev is None:
            state.tables_dev = torch.as_tensor(
                state.tables, dtype=torch.long, device=self.device)
        return state.tables_dev

    # ----------------------------------------------------------- buckets
    def prefill_bucket(self, length: int) -> int:
        """Smallest bucket that fits a ``length``-token prompt (raises
        when none does)."""
        i = bisect.bisect_left(self.prefill_buckets, length)
        if i >= len(self.prefill_buckets):
            raise ValueError(
                f"prompt length {length} exceeds the largest prefill "
                f"bucket {self.prefill_buckets[-1]}")
        return self.prefill_buckets[i]

    def _pad_prompt(self, prompt) -> Tuple[np.ndarray, int]:
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 1:
            prompt = prompt[None]
        t = prompt.shape[1]
        bucket = self.prefill_bucket(t)
        if t < bucket:
            prompt = np.concatenate(
                [prompt, np.zeros((prompt.shape[0], bucket - t), np.int32)],
                axis=1)
        return prompt, t

    # ------------------------------------------------------ entry points
    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.long, device=self.device)

    def _sample(self, logits: torch.Tensor, step: int) -> torch.Tensor:
        g = (None if self.sampler.kind == "greedy"
             else step_generator(self._seed, step, self.device))
        return sample_tokens(logits, g, self.sampler)

    def prefill(self, prompt, step: int = 0):
        """Pad ``prompt`` (B, T) to its bucket and run the prefill.
        Returns (first_token (B,), logits (B, T_bucket, V), kv, t)."""
        padded, t = self._pad_prompt(prompt)
        logits, kv = self.model.prefill(self.params, self._ids(padded))
        first = self._sample(logits[:, t - 1], step)
        return first, logits, kv, t

    def decode(self, cache, tokens, positions, step: int):
        """One decode step; the cache is updated in place and returned.
        Returns (next_tokens (B,), logits (B, V), cache). Paged callers'
        occupied slots get pages for their write positions here."""
        if isinstance(cache, DecodeState) and cache.mode == "paged":
            pos_host = (positions.cpu().numpy() if torch.is_tensor(positions)
                        else np.asarray(positions))
            for b, pos in enumerate(pos_host):
                if not cache.slot_pages[b] or int(pos) >= self.max_len:
                    continue
                if not self.ensure_slot_pages(cache, b, int(pos)):
                    raise CachePagesExhausted(
                        f"page pool exhausted backing slot {b} at "
                        f"position {int(pos)}")
            logits, _ = self.model.decode_window_paged(
                self.params, cache.arrays, self._tables(cache),
                self._ids(tokens)[:, None], self._ids(positions),
                self.page_tokens)
            logits = logits[:, 0]
            return self._sample(logits, step), logits, cache
        arrays = cache.arrays if isinstance(cache, DecodeState) else cache
        logits, _ = self.model.decode_step_math(
            self.params, arrays, self._ids(tokens), self._ids(positions))
        return self._sample(logits, step), logits, cache

    def insert_slot(self, cache, kv, slot: int):
        """Write a prefill's (L, Bp, T_bucket, H, hd) k/v into the cache
        at ``slot``. Paged: allocates the slot's pages (raises
        :class:`CachePagesExhausted` when the pool cannot cover the
        bucket; nothing allocated, nothing written)."""
        if isinstance(cache, DecodeState) and cache.mode == "paged":
            npb = self.pages_for(kv["k"].shape[2])
            if cache.slot_pages[slot]:
                self.free_slot(cache, slot)
            pages = cache.alloc.alloc(npb)
            if pages is None:
                raise CachePagesExhausted(
                    f"KV page pool exhausted: prompt bucket needs {npb} "
                    f"pages, {cache.alloc.free_count} free of "
                    f"{cache.alloc.total}")
            cache.slot_pages[slot] = pages
            cache.tables[slot, :npb] = pages
            cache.tables_dev = None
            ids = self._ids(pages)
            for name in ("k", "v"):
                cache.arrays[name][:, ids] = pack_kv_pages(
                    kv[name], self.page_tokens)
            return cache
        arrays = cache.arrays if isinstance(cache, DecodeState) else cache
        bp, tb = kv["k"].shape[1], kv["k"].shape[2]
        for name in ("k", "v"):
            arrays[name][:, slot:slot + bp, :tb] = kv[name]
        return cache

    def warm(self, slots: int) -> List[int]:
        """Run one prefill + insert per bucket and one decode step at
        ``slots`` against a throwaway state (first-call costs such as
        library handles and allocator growth). Returns the buckets."""
        state = self.new_state(slots)
        for bucket in self.prefill_buckets:
            _first, _logits, kv, _t = self.prefill(
                np.zeros((1, bucket), np.int32))
            state = self.insert_slot(state, kv, 0)
        for s in range(slots):
            self.ensure_slot_pages(state, s, 0)
        zeros = np.zeros((slots,), np.int32)
        self.decode(state, zeros, zeros, 0)
        return list(self.prefill_buckets)

    # ------------------------------------------------- convenience loop
    def generate(self, prompts, max_new_tokens: int,
                 eos_id: Optional[int] = None, return_logits: bool = False,
                 on_token=None):
        """Prefill once, then ``max_new_tokens - 1`` decode steps.
        ``prompts`` (B, T) share one length. Returns (B, n) int32 tokens,
        or (tokens, per-step (B, V) logits list) with ``return_logits``.
        ``on_token(token, index)`` (B = 1 only) sees each token as it is
        made."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim == 1:
            prompts = prompts[None]
        B, T = prompts.shape
        if on_token is not None and B != 1:
            raise ValueError(
                f"on_token streams a single sequence; got batch of {B}")
        if T + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({T}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the cache length {self.max_len}")
        first, logits, kv, t = self.prefill(prompts, step=0)
        state = self.new_state(B)
        if self.paged:
            for b in range(B):
                state = self.insert_slot(
                    state, {"k": kv["k"][:, b:b + 1],
                            "v": kv["v"][:, b:b + 1]}, b)
        else:
            state = self.insert_slot(state, kv, 0)
        # one loop for both layouts: decode() grows each slot's pages to
        # its write position before the step
        out = [first]
        logit_steps = ([logits[:, t - 1].cpu().numpy()] if return_logits
                       else [])
        if on_token is not None:
            on_token(int(first[0]), 0)
        tokens = first
        positions = np.full((B,), t, np.int32)
        done = (first == eos_id).cpu().numpy() if eos_id is not None else None
        for step in range(1, max_new_tokens):
            if done is not None and bool(np.all(done)):
                break
            tokens, logits, state = self.decode(state, tokens, positions,
                                                step)
            positions = positions + 1
            out.append(tokens)
            if on_token is not None:
                on_token(int(tokens[0]), step)
            if return_logits:
                logit_steps.append(logits.cpu().numpy())
            if done is not None:
                done |= (tokens == eos_id).cpu().numpy()
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        if return_logits:
            return toks, logit_steps
        return toks


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def naive_generate(model, params, prompts, max_new_tokens: int,
                   pad_to: Optional[int] = None,
                   sampler: Optional[SamplerConfig] = None, seed: int = 0):
    """The full-recompute baseline: ``apply`` over the whole padded
    sequence per emitted token (greedy by default). Returns (B,
    max_new_tokens) int32."""
    prompts = np.asarray(prompts, np.int32)
    if prompts.ndim == 1:
        prompts = prompts[None]
    B, T = prompts.shape
    pad_to = int(pad_to or model.config.max_len)
    if T + max_new_tokens > pad_to:
        raise ValueError(f"prompt ({T}) + max_new_tokens "
                         f"({max_new_tokens}) exceeds pad_to {pad_to}")
    sampler = sampler or SamplerConfig()
    params = model._cast_params(params)
    seq = np.zeros((B, pad_to), np.int32)
    seq[:, :T] = prompts
    out = []
    for i in range(max_new_tokens):
        logits = model.apply(params, torch.as_tensor(
            seq, dtype=torch.long, device=model.device))
        g = (None if sampler.kind == "greedy"
             else step_generator(seed, i, model.device))
        nxt = sample_tokens(logits[:, T + i - 1], g, sampler).cpu().numpy()
        seq[:, T + i] = nxt
        out.append(nxt)
    return np.stack(out, axis=1).astype(np.int32)
