"""The port's DecodeEngine against the JAX package's, at a tiny size.

Greedy generation is held to exact token equality with the JAX engine in
f32, dense and paged, for prompts in three prefill buckets and a batch of
two. Sampled generation cannot reproduce JAX's threefry bits, so top-k is
held to determinism per seed and to the JAX package's own sampling
distribution (``_dist_probs``) by frequency.
"""
import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import from_jax_params
from deeplearning4j_tpu_torch.resilience.policy import (CachePagesExhausted,
                                                        ShedError)

KW = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=32, max_len=64)
MAXLEN = 48
PAGE = 16
_CACHE = {}


def _models():
    if "m" not in _CACHE:
        jm = jtr.TransformerLM(jtr.TransformerConfig(**KW))
        jp = jm.init_params(jax.random.key(0))
        tcfg = ttr.TransformerConfig(**KW)
        tm = ttr.TransformerLM(tcfg, device="cpu")
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _CACHE["m"] = (jm, jp, tm, tp)
    return _CACHE["m"]


def _engine(side, page_tokens, **kw):
    key = (side, page_tokens, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jm, jp, tm, tp = _models()
        if side == "jax":
            _CACHE[key] = jgen.DecodeEngine(jm, jp, max_len=MAXLEN,
                                            page_tokens=page_tokens)
        else:
            _CACHE[key] = tgen.DecodeEngine(tm, tp, max_len=MAXLEN,
                                            page_tokens=page_tokens,
                                            device="cpu", **kw)
    return _CACHE[key]


def _prompt(b, n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, n)).astype(np.int32)


@pytest.mark.parametrize("page_tokens", [0, PAGE])
@pytest.mark.parametrize("b,n", [(1, 5), (1, 20), (1, 37), (2, 10)])
def test_greedy_generate_matches_jax_tokens(page_tokens, b, n):
    """Buckets 16, 32 and 48 (lengths 5, 20, 37) and a B = 2 batch."""
    prompt = _prompt(b, n, seed=n)
    ref = _engine("jax", page_tokens).generate(prompt, 8)
    got = _engine("torch", page_tokens).generate(prompt, 8)
    assert got.dtype == np.int32 and got.shape == (b, 8)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_naive_generate_equals_generate():
    _jm, _jp, tm, tp = _models()
    prompt = _prompt(1, 9, seed=1)
    naive = tgen.naive_generate(tm, tp, prompt, 6, pad_to=MAXLEN)
    np.testing.assert_array_equal(
        naive, _engine("torch", PAGE).generate(prompt, 6))


def test_generate_streams_tokens_and_returns_logits():
    eng = _engine("torch", PAGE)
    seen = []
    toks, logits = eng.generate(_prompt(1, 12, seed=2), 5,
                                return_logits=True,
                                on_token=lambda t, i: seen.append((i, t)))
    assert seen == [(i, int(t)) for i, t in enumerate(toks[0])]
    assert len(logits) == 5 and logits[0].shape == (1, KW["vocab_size"])
    assert [int(np.argmax(l[0])) for l in logits] == list(toks[0])


def test_page_allocator_alloc_free_reuse():
    a = tgen.PageAllocator(8)
    assert a.total == 8 and a.free_count == 8 and a.in_use == 0
    got = a.alloc(3)
    assert len(got) == 3 and len(set(got)) == 3 and a.in_use == 3
    assert a.alloc(6) is None                 # all or nothing
    assert a.in_use == 3
    a.free(got[:2])
    assert a.in_use == 1 and a.free_count == 7
    assert a.alloc(7) is not None and a.free_count == 0
    assert a.alloc(1) is None
    assert a.alloc(0) == []


def test_page_allocator_rejects_bad_frees():
    a = tgen.PageAllocator(4)
    got = a.alloc(2)
    with pytest.raises(ValueError):
        a.free([99])                          # outside the pool
    with pytest.raises(ValueError):
        a.free([got[0], got[0]])              # duplicate within the list
    assert a.in_use == 2                      # rejected frees freed nothing
    a.free(got)
    with pytest.raises(ValueError):
        a.free([got[0]])                      # double free
    with pytest.raises(ValueError):
        tgen.PageAllocator(0)


def test_engine_join_leave_returns_pages():
    eng = _engine("torch", PAGE)
    state = eng.new_state(3)
    _f, _l, kv, _t = eng.prefill(_prompt(1, 9, seed=3))
    for slot in (0, 1, 2, 1, 0):
        state = eng.insert_slot(state, kv, slot)
        assert state.alloc.in_use >= 1
    for slot in range(3):
        eng.free_slot(state, slot)
    assert state.alloc.in_use == 0
    assert (state.tables == state.alloc.total).all()
    assert eng.resident_cache_bytes(state) == 0
    assert eng.page_bytes() == 2 * PAGE * 2 * 32 * 4


def test_too_small_pool_raises_cache_pages_exhausted():
    eng = _engine("torch", PAGE)
    _f, _l, kv, t = eng.prefill(_prompt(1, 20, seed=4))   # bucket 32
    with pytest.raises(CachePagesExhausted) as ei:
        eng.insert_slot(eng.new_state(1, pages=1), kv, 0)
    assert isinstance(ei.value, ShedError)
    # admitted with one page, then the decode write at position 16 needs
    # a second one the pool does not have
    first, _l, kv, t = eng.prefill(_prompt(1, 12, seed=5))  # bucket 16
    state = eng.insert_slot(eng.new_state(1, pages=1), kv, 0)
    with pytest.raises(CachePagesExhausted):
        eng.decode(state, first, np.array([16], np.int32), 1)


def test_topk_is_deterministic_per_seed():
    sampler = tgen.SamplerConfig("topk", top_k=5, temperature=0.8)
    prompt = _prompt(1, 7, seed=6)
    a = _engine("torch", PAGE, sampler=sampler, seed=3).generate(prompt, 8)
    b = _engine("torch", 0, sampler=sampler, seed=3).generate(prompt, 8)
    np.testing.assert_array_equal(a, b)      # seed + step, not the mode
    np.testing.assert_array_equal(
        a, _engine("torch", PAGE, sampler=sampler, seed=3).generate(
            prompt, 8))
    c = _engine("torch", PAGE, sampler=sampler, seed=4).generate(prompt, 8)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("top_k", [0, 3])
def test_topk_frequencies_match_jax_distribution(top_k):
    sampler = jgen.SamplerConfig("topk", top_k=top_k, temperature=0.7)
    row = np.random.default_rng(8).standard_normal(6).astype(np.float32)
    want = jgen._dist_probs(row, sampler)
    n = 20000
    logits = torch.from_numpy(np.tile(row, (n, 1)))
    got = tgen.sample_tokens(
        logits, tgen.step_generator(0, 0, torch.device("cpu")),
        tgen.SamplerConfig("topk", top_k=top_k, temperature=0.7)).numpy()
    freq = np.bincount(got, minlength=6) / n
    # 5 binomial standard deviations per token
    assert np.all(np.abs(freq - want) <= 5 * np.sqrt(want * (1 - want) / n)
                  + 1e-12)


def test_bad_drafts_and_spec_k_raise_as_the_reference():
    """int8 pages and speculative decoding are ported: what remains to
    refuse is what the JAX engine refuses, a draft of another vocabulary or
    a shorter reach, and spec_k < 1, each as a ValueError on both sides."""
    jm, jp, tm, tp = _models()
    small = dict(KW, vocab_size=7, n_layers=1)
    jsm = jtr.TransformerLM(jtr.TransformerConfig(**small))
    tsm = ttr.TransformerLM(ttr.TransformerConfig(**small), device="cpu")
    drafts = {
        "vocab": (jgen.DecodeEngine(jsm, jsm.init_params(jax.random.key(1)),
                                    max_len=MAXLEN),
                  tgen.DecodeEngine(tsm, tsm.init_params(1), max_len=MAXLEN,
                                    device="cpu")),
        "max_len": (jgen.DecodeEngine(jm, jp, max_len=16),
                    tgen.DecodeEngine(tm, tp, max_len=16, device="cpu")),
    }
    for what, (jd, td) in drafts.items():
        with pytest.raises(ValueError, match=what):
            jgen.DecodeEngine(jm, jp, max_len=MAXLEN, draft=jd)
        with pytest.raises(ValueError, match=what):
            tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=td, device="cpu")
    good = _engine("torch", 0)
    with pytest.raises(ValueError, match="spec_k"):
        jgen.DecodeEngine(jm, jp, max_len=MAXLEN, draft=_engine("jax", 0),
                          spec_k=0)
    with pytest.raises(ValueError, match="spec_k"):
        tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=good, spec_k=0,
                          device="cpu")
    assert tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=good,
                             device="cpu").spec


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    _jm, jp, tm, tp = _models()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.DecodeEngine(tm, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.TransformerLM(tm.config)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_params(jax.tree.map(np.asarray, jp), tm.config)
