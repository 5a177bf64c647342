"""DecodeEngine: KV-cache generation over the port's TransformerLM.

Counterpart of ``deeplearning4j_tpu/models/generation.py`` for single-
batch serving: prefill over a prompt padded to a power-of-two bucket (the
flash kernel runs there), then one decode step per token against a KV
cache, with sampling on the device; each decode step's store and
attention run in one K4a+w launch a layer (``kernels/paged_attention.py``)
on every path. Three composing levers, as in the JAX engine:

- **Paged cache** (default; ``DL4J_TPU_KV_PAGE_TOKENS``, 0 = the dense
  per-slot cache): k/v live in a pool of fixed-size pages shared by every
  slot, a host-side ``PageAllocator`` hands pages out, and a per-slot page
  table maps logical to physical pages, with the pool's last page as the
  trash page free slots point at.
- **int8 pages** (``kv_quant`` / ``DL4J_TPU_KV_QUANT=1``, paged only):
  int8 rows with per-row f32 scales, written by K4w at the prefill insert
  and by K4a+w on decode, and dequantized inside K4a; a numerics gate at
  the first state build (an eager probe against the dense cache,
  teacher-forced) falls back to pages of the compute dtype with a loud
  warning when the logits diverge beyond ``quant_tol``.
- **Speculative decoding** (``draft=`` + ``spec_k``; kill switch
  ``DL4J_TPU_SPEC_DECODE=0``): the draft proposes ``spec_k`` tokens from
  its own dense cache, one W = k + 1 window verifies them on the target,
  and the host accept/resample loop, drawing from the JAX engine's own
  numpy generator, keeps the emitted distribution the target's (greedy:
  the plain decode's tokens).

PyTorch runs eagerly, so there is no executable set to compile: the JAX
engine's jit wrappers, compile-watch probes and cost-model accounting
(``account_spec``, ``account_decode``, ``decode_compile_count``) have no
counterpart here. Caches are updated in place. Sampling is greedy argmax
or top-k/temperature drawn from a ``torch.Generator`` seeded from ``(seed,
step)``: deterministic within the port, not the JAX package's threefry
bits. The serving pipeline on top is not ported yet (see ``ROADMAP.md``).
"""
from __future__ import annotations

import bisect
import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch._device import resolve_device
from deeplearning4j_tpu_torch.kernels import paged_attention as pa
from deeplearning4j_tpu_torch.models import transformer as _tr
from deeplearning4j_tpu_torch.resilience.policy import CachePagesExhausted

_log = logging.getLogger(__name__)

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


def kv_quant_env() -> bool:
    """``DL4J_TPU_KV_QUANT=1``: int8 KV pages (paged mode only), behind the
    numerics gate. Strictly ``"1"`` means on: a feature that changes the
    numbers never engages on ``false`` or ``off``."""
    return os.environ.get("DL4J_TPU_KV_QUANT", "0") == "1"


def spec_decode_env() -> bool:
    """``DL4J_TPU_SPEC_DECODE``: speculative decoding's switch, read only
    when an engine is built with a draft; ``0`` (or empty) forces plain
    one-token decode steps."""
    return os.environ.get("DL4J_TPU_SPEC_DECODE", "1") not in ("0", "")


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
                 "alloc", "slot_pages", "draft_cache")

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
        self.draft_cache = None            # the draft's dense KV (spec)


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


def _dist_probs(logits_row: np.ndarray, sampler: SamplerConfig) -> np.ndarray:
    """The probability vector a sampler draws from, on the host (the
    accept/resample loop needs p and q explicitly): greedy = a delta at the
    argmax, top-k/temperature = softmax over the scaled top-k."""
    v = logits_row.shape[-1]
    if sampler.kind == "greedy":
        p = np.zeros((v,), np.float64)
        p[int(np.argmax(logits_row))] = 1.0
        return p
    scaled = logits_row.astype(np.float64) / sampler.temperature
    if sampler.top_k and sampler.top_k > 0:
        kth = np.sort(scaled)[-sampler.top_k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    scaled -= scaled.max()
    e = np.exp(scaled)
    return e / e.sum()


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
    the compute dtype once, here. ``kv_quant`` (default
    ``DL4J_TPU_KV_QUANT``) asks for int8 pages behind the numerics gate
    (``quant_tol`` in max |logit diff|); ``draft``, a ``DecodeEngine`` of
    the same vocabulary on the same device reaching at least ``max_len``,
    turns on speculative decoding with ``spec_k`` proposals a round."""

    def __init__(self, model, params, max_len: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 sampler: Optional[SamplerConfig] = None, seed: int = 0,
                 page_tokens: Optional[int] = None,
                 kv_quant: Optional[bool] = None, quant_tol: float = 0.05,
                 draft: Optional["DecodeEngine"] = None, spec_k: int = 4,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
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
        self.kv_quant = bool(kv_quant if kv_quant is not None
                             else kv_quant_env())
        if self.kv_quant and not self.paged:
            _log.warning(
                "DL4J_TPU_KV_QUANT requested with the dense cache "
                "(DL4J_TPU_KV_PAGE_TOKENS=0): int8 storage is per page; "
                "keeping the dense cache")
            self.kv_quant = False
        self.quant_tol = float(quant_tol)
        #: the numerics gate's record (None until it has run); a failed
        #: gate flips ``kv_quant`` back to False with a loud warning
        self.quant_gate: Optional[dict] = None
        self.spec_k = int(spec_k)
        if draft is not None:
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            dc = draft.model.config
            if dc.vocab_size != c.vocab_size:
                raise ValueError(
                    f"draft vocab {dc.vocab_size} != target vocab "
                    f"{c.vocab_size}: accept/resample needs one "
                    "distribution support")
            if draft.max_len < self.max_len:
                raise ValueError(
                    f"draft max_len {draft.max_len} < target max_len "
                    f"{self.max_len}: the draft must reach every position "
                    "the target decodes")
            if draft.device != self.device:
                raise ValueError(f"draft runs on {draft.device}, the "
                                 f"engine on {self.device}")
        self.draft = draft
        #: speculative decoding engaged: a draft was given and the
        #: DL4J_TPU_SPEC_DECODE kill switch is not set
        self.spec = draft is not None and spec_decode_env()
        #: cumulative accept-loop counts
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0}
        self.params = model._cast_params(
            _to_device(params, self.device))

    # ------------------------------------------------------------- cache
    def new_state(self, slots: int,
                  pages: Optional[int] = None) -> DecodeState:
        """Cache state for ``slots`` sequences. Paged: a pool of
        ``pages`` physical pages (default ``slots * pages_per_slot``), int8
        once the numerics gate has passed, plus the trash page every free
        slot's table row points at. Spec mode adds the draft's dense
        cache."""
        if not self.paged:
            state = DecodeState("dense", slots,
                                self.model.init_cache(slots, self.max_len))
        else:
            n = (int(pages) if pages is not None
                 else slots * self.pages_per_slot)
            if n < 1:
                raise ValueError(f"page pool needs >= 1 page, got {n}")
            pool = self.model.init_paged_cache(
                n + 1, self.page_tokens, quant=self._quant_active())
            tables = np.full((slots, self.pages_per_slot), n, np.int32)
            state = DecodeState("paged", slots, pool, tables=tables,
                                alloc=PageAllocator(n))
        if self.spec:
            # every position the target decodes, and the draft's largest
            # prefill bucket for the longest admissible prompt
            draft_len = max(self.max_len,
                            self.draft.prefill_bucket(self.max_len))
            state.draft_cache = self.draft.model.init_cache(slots,
                                                            draft_len)
        return state

    @staticmethod
    def _bytes(arrays: Dict) -> int:
        return int(sum(a.numel() * a.element_size()
                       for a in arrays.values()))

    @classmethod
    def cache_bytes(cls, cache) -> int:
        """Device bytes of a cache or state (worst-case footprint: the
        dense cache or the whole page pool, and the draft's cache)."""
        if isinstance(cache, DecodeState):
            return cls._bytes(cache.arrays) + (
                cls._bytes(cache.draft_cache)
                if cache.draft_cache is not None else 0)
        return cls._bytes(cache)

    def page_bytes(self) -> int:
        """Device bytes one page costs across all layers (k + v, and their
        row scales for int8 pages)."""
        if not self.paged:
            return 0
        c = self.model.config
        per_row = c.d_model
        if self._quant_active():
            return c.n_layers * self.page_tokens * (2 * per_row + 8)
        itemsize = torch.empty((), dtype=c.dtype).element_size()
        return c.n_layers * self.page_tokens * 2 * per_row * itemsize

    def resident_cache_bytes(self, state: DecodeState) -> int:
        """Actual resident target-cache bytes: dense = the whole
        allocation, paged = pages in use × page bytes. The draft's fixed
        dense cache is not counted (``cache_bytes`` counts it)."""
        if state.mode != "paged":
            return self._bytes(state.arrays)
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
                state.tables, dtype=torch.int32, device=self.device)
        return state.tables_dev

    def _write_pages(self, pool: Dict, kv: Dict, pages: Sequence[int]):
        """A (L, 1, T_bucket, H, hd) prefill's k/v into whole pages of the
        pool, zero-padded (``pack_kv_pages``): K4w for an int8 pool (its
        zero rows get scale 1), plain copies otherwise."""
        ids = self._ids(pages)
        P = self.page_tokens
        if "k_scale" in pool:
            t = torch.arange(len(pages) * P, device=self.device)
            pa.kv_quant_write(kv["k"], kv["v"], ids[t // P][None],
                              (t % P)[None], pool["k"], pool["v"],
                              pool["k_scale"], pool["v_scale"],
                              quantize=_tr.quantize_kv_rows)
            return
        for name in ("k", "v"):
            pool[name][:, ids] = pack_kv_pages(kv[name], P)

    # ---------------------------------------------------- quant numerics
    def _quant_active(self) -> bool:
        """int8 storage is live only after the numerics gate has passed; a
        failed gate falls back to pages of the compute dtype."""
        if not self.kv_quant:
            return False
        if self.quant_gate is None:
            self._run_quant_gate()
        return self.kv_quant

    def _run_quant_gate(self):
        """Compare int8-paged decode logits with the dense cache's on a
        small probe: prefill the smallest bucket, teacher-force a few greedy
        steps through both, and compare each step's logits. Divergence
        beyond ``quant_tol`` flips the engine back to pages of the compute
        dtype."""
        model, params = self.model, self.params
        bucket = self.prefill_buckets[0]
        if self.max_len - bucket < 1:
            # the smallest bucket fills the cache: probe a shorter prompt
            # so the gate has room to decode
            bucket = self.prefill_bucket(max(1, self.max_len // 2))
        steps = max(1, min(4, self.max_len - bucket))
        rng = np.random.default_rng(1234)
        prompt = rng.integers(0, model.config.vocab_size,
                              (1, bucket)).astype(np.int32)
        logits_p, kv = model.prefill(params, self._ids(prompt))
        ref = model.init_cache(1, self.max_len)
        for name in ("k", "v"):
            ref[name][:, :, :bucket] = kv[name]
        n_pages = min(self.pages_for(bucket + steps), self.pages_per_slot)
        pool = model.init_paged_cache(n_pages + 1, self.page_tokens,
                                      quant=True)
        tables = np.full((1, self.pages_per_slot), n_pages, np.int32)
        tables[0, :n_pages] = np.arange(n_pages)
        self._write_pages(pool, kv, list(range(self.pages_for(bucket))))
        tok = logits_p[:, bucket - 1].argmax(dim=-1)
        pos = torch.full((1,), bucket, dtype=torch.long, device=self.device)
        tables_dev = torch.as_tensor(tables, device=self.device)
        max_diff, argmax_agree = 0.0, True
        for _ in range(steps):
            ref_logits, _ = model.decode_step_math(params, ref, tok, pos)
            q_logits, _ = model.decode_window_paged(
                params, pool, tables_dev, tok[:, None], pos,
                self.page_tokens)
            q_logits = q_logits[:, 0]
            max_diff = max(max_diff, float(
                (q_logits - ref_logits).abs().max()))
            if int(q_logits.argmax()) != int(ref_logits.argmax()):
                argmax_agree = False
            # teacher-force the dense continuation, so each step measures
            # the quantization alone and never a diverged token stream
            tok = ref_logits.argmax(dim=-1)
            pos = pos + 1
        passed = max_diff <= self.quant_tol
        self.quant_gate = {"checked": True, "passed": passed,
                           "max_abs_logit_diff": max_diff,
                           "tol": self.quant_tol,
                           "argmax_agree": argmax_agree}
        if not passed:
            self.kv_quant = False
            _log.warning(
                "int8 KV-cache numerics gate FAILED (max |logit diff| "
                "%.4g > tol %.4g): falling back to %s page storage",
                max_diff, self.quant_tol, self.model.config.dtype)

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
            self._write_pages(cache.arrays, kv, pages)
            return cache
        arrays = cache.arrays if isinstance(cache, DecodeState) else cache
        bp, tb = kv["k"].shape[1], kv["k"].shape[2]
        for name in ("k", "v"):
            arrays[name][:, slot:slot + bp, :tb] = kv[name]
        return cache

    def insert_draft_slot(self, state: DecodeState, slot: int, prompt,
                          step: int = 0):
        """Spec mode: the draft's prefill over the same prompt, its k/v
        written into the draft's dense cache at ``slot``."""
        _first, _logits, kv, _t = self.draft.prefill(prompt, step=step)
        tb = kv["k"].shape[2]
        for name in ("k", "v"):
            state.draft_cache[name][:, slot:slot + 1, :tb] = kv[name]

    # -------------------------------------------------- speculative step
    def _propose(self, state: DecodeState, tokens: torch.Tensor,
                 positions: torch.Tensor, step: int):
        """``spec_k`` draft decode steps from its dense cache: (proposals
        (B, k), the draft's logits (B, k, V)). Proposal j is drawn with the
        draft's sampler at step ``step·(k+1) + j``."""
        d, k = self.draft, self.spec_k
        t, pos = tokens, positions
        props, dlogits = [], []
        for j in range(k):
            logits, _ = d.model.decode_step_math(d.params, state.draft_cache,
                                                 t, pos)
            t = d._sample(logits, step * (k + 1) + j)
            props.append(t)
            dlogits.append(logits)
            pos = pos + 1
        return torch.stack(props, dim=1), torch.stack(dlogits, dim=1)

    def spec_step(self, state: DecodeState, tokens, positions, step: int,
                  active: Sequence[int]) -> Dict[int, List[int]]:
        """One speculative round for the slot batch: the draft proposes
        ``spec_k`` tokens a slot, the target scores carry + proposals in
        one W = k + 1 window, and the accept/resample loop on the host
        keeps the emitted distribution the target's (greedy: the tokens
        plain decode emits). Returns ``{slot: [emitted...]}`` for the
        active slots (1..spec_k tokens each; the last is the next carry).
        The all-accepted bonus token is forfeited, so the draft's cache
        never falls behind. Paged callers' pages through ``positions +
        spec_k`` are ensured here."""
        k = self.spec_k
        pos_host = np.asarray(positions)
        if state.mode == "paged":
            for b in active:
                last = min(int(pos_host[b]) + k, self.max_len - 1)
                if not self.ensure_slot_pages(state, b, last):
                    raise CachePagesExhausted(
                        f"page pool exhausted backing slot {b}'s verify "
                        f"window through position {last}")
        tok = self._ids(np.asarray(tokens))
        pos = self._ids(pos_host)
        props, dlog = self._propose(state, tok, pos, step)
        win = torch.cat([tok[:, None], props], dim=1)          # (B, k+1)
        if state.mode == "paged":
            logits, _ = self.model.decode_window_paged(
                self.params, state.arrays, self._tables(state), win, pos,
                self.page_tokens)
        else:
            logits, _ = self.model.decode_window_math(
                self.params, state.arrays, win, pos)
        props = props.cpu().numpy()
        logits = logits.cpu().numpy()                          # (B, k+1, V)
        greedy = (self.sampler.kind == "greedy"
                  and self.draft.sampler.kind == "greedy")
        dlog_h = None if greedy else dlog.cpu().numpy()
        # the JAX engine's own generator, so the draws repeat its own
        rng = (None if greedy
               else np.random.default_rng((self._seed, 0x5BEC, step)))
        emitted: Dict[int, List[int]] = {}
        for b in active:
            out: List[int] = []
            accepted = 0
            for j in range(k):
                d = int(props[b, j])
                if greedy:
                    g = int(np.argmax(logits[b, j]))
                    if d == g:
                        out.append(d)
                        accepted += 1
                        continue
                    out.append(g)       # the token plain decode emits
                    break
                p = _dist_probs(logits[b, j], self.sampler)
                q = _dist_probs(dlog_h[b, j], self.draft.sampler)
                if rng.random() < min(1.0, p[d] / max(q[d], 1e-20)):
                    out.append(d)
                    accepted += 1
                    continue
                resid = np.maximum(p - q, 0.0)
                z = float(resid.sum())
                if z <= 0.0:
                    # the draft's distribution is the target's: emit from
                    # the target directly
                    out.append(int(rng.choice(len(p), p=p)))
                else:
                    out.append(int(rng.choice(len(resid), p=resid / z)))
                break
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += accepted
            emitted[b] = out
        self.spec_stats["rounds"] += 1
        return emitted

    def spec_accept_ratio(self) -> Optional[float]:
        p = self.spec_stats["proposed"]
        return (self.spec_stats["accepted"] / p) if p else None

    def warm(self, slots: int) -> List[int]:
        """Run one prefill + insert per bucket (the draft's too in spec
        mode) and one decode step at ``slots`` against a throwaway state
        (first-call costs such as library handles and allocator growth;
        the quant gate runs at the state's build), then one speculative
        round, which leaves ``spec_stats`` as it found them. Returns the
        buckets."""
        state = self.new_state(slots)
        for bucket in self.prefill_buckets:
            _first, _logits, kv, _t = self.prefill(
                np.zeros((1, bucket), np.int32))
            state = self.insert_slot(state, kv, 0)
            if self.spec:
                self.insert_draft_slot(state, 0,
                                       np.zeros((1, bucket), np.int32))
        for s in range(slots):
            self.ensure_slot_pages(state, s, 0)
        zeros = np.zeros((slots,), np.int32)
        self.decode(state, zeros, zeros, 0)
        if self.spec:
            for s in range(slots):
                self.ensure_slot_pages(state, s, self.spec_k)
            stats = dict(self.spec_stats)
            self.spec_step(state, zeros, zeros, 0, range(slots))
            self.spec_stats = stats
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
        if self.spec:
            if B != 1:
                raise ValueError(
                    "speculative generate decodes one sequence (the "
                    "slot-batched path is the serving pipeline)")
            if return_logits:
                raise ValueError("return_logits is not available under "
                                 "speculative decoding (a verify step has "
                                 "no single per-token logits row for "
                                 "rejected proposals)")
            return self._generate_spec(prompts, max_new_tokens, eos_id,
                                       on_token)
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

    def _generate_spec(self, prompts, max_new_tokens: int, eos_id,
                       on_token):
        """Draft-accelerated generation of one sequence: prefill both
        models, then speculative rounds until the budget, eos, or the
        cache's end."""
        first, _logits, kv, t = self.prefill(prompts, step=0)
        state = self.new_state(1)
        state = self.insert_slot(state, kv, 0)
        self.insert_draft_slot(state, 0, prompts)
        carry = int(first[0])
        out = [carry]
        if on_token is not None:
            on_token(carry, 0)
        if eos_id is not None and carry == eos_id:
            return np.asarray([out], np.int32)
        pos, step = t, 0
        while len(out) < max_new_tokens:
            emitted = self.spec_step(
                state, np.asarray([carry], np.int32),
                np.asarray([pos], np.int32), step, [0])[0]
            stop = False
            for tok in emitted:
                if len(out) >= max_new_tokens:
                    stop = True
                    break
                out.append(tok)
                if on_token is not None:
                    on_token(tok, len(out) - 1)
                if eos_id is not None and tok == eos_id:
                    stop = True
                    break
            if stop:
                break
            pos += len(emitted)
            carry = emitted[-1]
            step += 1
            if pos + 1 >= self.max_len:
                break               # no room for another cache write
        return np.asarray([out], np.int32)


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
