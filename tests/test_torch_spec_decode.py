"""The port's speculative decoding against the JAX package's, at a tiny size.

The same weights go through both engines, in f32 on the CPU. The draft is
the target itself (an identity draft: every proposal accepted) or a
truncation of it sharing its embeddings (``{"tok_emb", "pos_emb", "ln_f",
"blocks": blocks[:n]}``, as the JAX package's own tests build it).
Tolerances: greedy tokens exact (argmax of logits that agree to ~1e-6);
with a greedy draft and a top-k target the emitted tokens exact too, since
both accept loops draw from the same numpy generator and the proposals are
deterministic; a sampled draft's resampling only by distribution (threefry
bits cannot be reproduced): the first emitted token's total-variation
distance from the target's ``_dist_probs`` under 0.12 over 400 seeded
rounds, the bound the JAX package's test holds.
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

KW = dict(vocab_size=61, n_heads=2, d_model=32, max_len=64)
MAXLEN = 48
PAGE = 16
_CACHE = {}


def _models(n_layers=2):
    """(JAX model, JAX params, port model, port params); fewer than two
    layers is the two-layer target's truncation."""
    key = ("m", n_layers)
    if key not in _CACHE:
        jm = jtr.TransformerLM(jtr.TransformerConfig(n_layers=n_layers, **KW))
        tcfg = ttr.TransformerConfig(n_layers=n_layers, **KW)
        tm = ttr.TransformerLM(tcfg, device="cpu")
        if n_layers == 2:
            jp = jtr.TransformerLM(jtr.TransformerConfig(
                n_layers=2, **KW)).init_params(jax.random.key(0))
        else:
            full = _models(2)[1]
            jp = {"tok_emb": full["tok_emb"], "pos_emb": full["pos_emb"],
                  "ln_f": full["ln_f"], "blocks": full["blocks"][:n_layers]}
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _CACHE[key] = (jm, jp, tm, tp)
    return _CACHE[key]


def _engine(side, page_tokens=PAGE, draft_layers=None, spec_k=3,
            sampler=None, draft_sampler=None, seed=0, draft_seed=0):
    key = (side, page_tokens, draft_layers, spec_k, sampler, draft_sampler,
           seed, draft_seed)
    if key not in _CACHE:
        jm, jp, tm, tp = _models()
        draft = None
        if draft_layers is not None:
            djm, djp, dtm, dtp = _models(draft_layers)
            draft = (jgen.DecodeEngine(djm, djp, max_len=MAXLEN,
                                       page_tokens=0,
                                       sampler=_jax_sampler(draft_sampler),
                                       seed=draft_seed)
                     if side == "jax" else
                     tgen.DecodeEngine(dtm, dtp, max_len=MAXLEN,
                                       page_tokens=0, sampler=draft_sampler,
                                       seed=draft_seed, device="cpu"))
        if side == "jax":
            _CACHE[key] = jgen.DecodeEngine(
                jm, jp, max_len=MAXLEN, page_tokens=page_tokens, draft=draft,
                spec_k=spec_k, sampler=_jax_sampler(sampler), seed=seed)
        else:
            _CACHE[key] = tgen.DecodeEngine(
                tm, tp, max_len=MAXLEN, page_tokens=page_tokens, draft=draft,
                spec_k=spec_k, sampler=sampler, seed=seed, device="cpu")
    return _CACHE[key]


def _jax_sampler(s):
    return None if s is None else jgen.SamplerConfig(s.kind, s.top_k,
                                                     s.temperature)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (1, n)).astype(np.int32)


@pytest.mark.parametrize("page_tokens", [0, PAGE])
@pytest.mark.parametrize("draft_layers", [2, 1])
def test_greedy_spec_generate_matches_plain_and_jax(page_tokens,
                                                    draft_layers):
    """An identity draft (2 layers: every proposal accepted) and a 1-layer
    truncated draft (some rejected), paged and dense, over prompts in three
    buckets: the speculative tokens equal the port's plain greedy decode
    and the JAX engine's speculative generate exactly."""
    spec = _engine("torch", page_tokens, draft_layers)
    jspec = _engine("jax", page_tokens, draft_layers)
    plain = _engine("torch", page_tokens)
    assert spec.spec and spec.draft is not None
    for n in (5, 16, 20):
        prompt = _prompt(n, seed=n)
        got = spec.generate(prompt, 12)
        assert got.shape == (1, 12) and got.dtype == np.int32
        np.testing.assert_array_equal(got, plain.generate(prompt, 12))
        np.testing.assert_array_equal(got, np.asarray(jspec.generate(
            prompt, 12)))
    ratio = spec.spec_accept_ratio()
    assert ratio == jspec.spec_accept_ratio()
    assert ratio == 1.0 if draft_layers == 2 else 0.0 < ratio < 1.0
    assert spec.spec_stats == jspec.spec_stats


def test_spec_step_with_a_greedy_draft_and_topk_target_matches_jax():
    """Rounds of ``spec_step`` on both engines from the same prompt: the
    draft's greedy proposals are deterministic and both accept loops draw
    from ``default_rng((seed, 0x5BEC, step))``, so every round emits the
    same tokens; the stats agree."""
    sampler = tgen.SamplerConfig("topk", top_k=6, temperature=1.3)
    teng = _engine("torch", draft_layers=1, spec_k=2, sampler=sampler,
                   seed=4)
    jeng = _engine("jax", draft_layers=1, spec_k=2, sampler=sampler, seed=4)
    prompt = _prompt(9, seed=1)
    states, carries = [], []
    for eng in (teng, jeng):
        first, _l, kv, t = eng.prefill(prompt)
        st = eng.insert_slot(eng.new_state(1), kv, 0)
        eng.insert_draft_slot(st, 0, prompt)
        states.append(st)
        carries.append(int(np.asarray(first)[0]))
    carry, pos = carries[1], t      # the first token: the JAX one
    rounds = []
    for step in range(8):
        out = [eng.spec_step(st, np.asarray([carry], np.int32),
                             np.asarray([pos], np.int32), step, [0])[0]
               for eng, st in zip((teng, jeng), states)]
        assert out[0] == out[1], f"round {step}: {out}"
        rounds.append(out[0])
        pos += len(out[0])
        carry = out[0][-1]
    assert any(len(r) > 1 for r in rounds) and any(len(r) < 2 for r in rounds)
    assert teng.spec_stats == jeng.spec_stats


def test_resampling_with_a_sampled_draft_follows_the_target():
    """A top-4 draft at temperature 0.9 proposing for a top-6 target at
    1.3: over 400 seeded rounds the first emitted token's frequencies lie
    within total-variation 0.12 of the target's distribution after the
    carry (``_dist_probs`` of the verify window's first row, which agrees
    with the JAX engine's within 1e-5), and never leave its support."""
    sampler = tgen.SamplerConfig("topk", top_k=6, temperature=1.3)
    dsampler = tgen.SamplerConfig("topk", top_k=4, temperature=0.9)
    eng = _engine("torch", draft_layers=1, spec_k=2, sampler=sampler,
                  draft_sampler=dsampler, seed=4, draft_seed=9)
    jeng = _engine("jax", draft_layers=1, spec_k=2, sampler=sampler,
                   draft_sampler=dsampler, seed=4, draft_seed=9)
    prompt = _prompt(9, seed=1)
    first, _l, kv, t = eng.prefill(prompt)
    carry = int(first[0])
    ref = eng.insert_slot(eng.new_state(1), kv, 0)
    win = torch.full((1, eng.spec_k + 1), carry)
    logits, _ = eng.model.decode_window_paged(
        eng.params, ref.arrays, eng._tables(ref), win, torch.tensor([t]),
        PAGE)
    expected = tgen._dist_probs(logits[0, 0].numpy(), sampler)
    _f, _l, jkv, _t = jeng.prefill(prompt)
    jst = jeng.insert_slot(jeng.new_state(1), jkv, 0)
    jl, _ = jeng._verify_paged_jit(
        jeng.params, jst.arrays, jeng._tables(jst), win.numpy().astype(
            np.int32), np.asarray([t], np.int32), 0)
    np.testing.assert_allclose(
        expected, jgen._dist_probs(np.asarray(jl)[0, 0],
                                   _jax_sampler(sampler)), atol=1e-5)
    counts = np.zeros(KW["vocab_size"])
    n = 400
    for i in range(n):
        st = eng.insert_slot(eng.new_state(1), kv, 0)
        eng.insert_draft_slot(st, 0, prompt)
        emitted = eng.spec_step(st, np.asarray([carry], np.int32),
                                np.asarray([t], np.int32), i, [0])[0]
        counts[emitted[0]] += 1
    tv = 0.5 * np.abs(counts / n - expected).sum()
    assert tv < 0.12, f"resample distribution off: TV={tv:.3f}"
    assert set(np.nonzero(counts)[0]) <= set(np.nonzero(expected)[0])


def test_warm_leaves_spec_stats_and_cache_bytes_count_the_draft():
    jeng, eng = _engine("jax", draft_layers=1), _engine("torch",
                                                        draft_layers=1)
    eng.generate(_prompt(7, seed=2), 6)
    before = dict(eng.spec_stats)
    assert before["rounds"] > 0
    assert eng.warm(2) == list(eng.prefill_buckets)
    assert eng.spec_stats == before
    st, jst = eng.new_state(2), jeng.new_state(2)
    assert st.draft_cache["k"].shape == (1, 2, MAXLEN, 2, 16)
    assert eng.cache_bytes(st) == jeng.cache_bytes(jst)
    assert eng.resident_cache_bytes(st) == jeng.resident_cache_bytes(jst)
    assert eng.cache_bytes(st) == (eng.cache_bytes(st.arrays)
                                   + eng.cache_bytes(st.draft_cache))
    assert eng.resident_cache_bytes(st) == 0        # no page in use yet


def test_spec_decode_kill_switch_gives_plain_decode(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SPEC_DECODE", "0")
    assert not tgen.spec_decode_env()
    _jm, _jp, tm, tp = _models()
    draft = _engine("torch", page_tokens=0)
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=PAGE,
                            draft=draft, spec_k=3, device="cpu")
    assert not eng.spec and eng.new_state(1).draft_cache is None
    prompt = _prompt(7, seed=7)
    np.testing.assert_array_equal(eng.generate(prompt, 8),
                                  _engine("torch").generate(prompt, 8))
    assert eng.spec_stats["rounds"] == 0
    for raw, on in (("1", True), ("", False), ("0", False), ("yes", True)):
        monkeypatch.setenv("DL4J_TPU_SPEC_DECODE", raw)
        assert tgen.spec_decode_env() is on is jgen.spec_decode_env()


def test_draft_validation_raises_as_the_reference():
    _jm, _jp, tm, tp = _models()
    small = ttr.TransformerConfig(n_layers=1, vocab_size=7, n_heads=2,
                                  d_model=32, max_len=64)
    sm = ttr.TransformerLM(small, device="cpu")
    bad_vocab = tgen.DecodeEngine(sm, sm.init_params(1), max_len=MAXLEN,
                                  device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=bad_vocab,
                          device="cpu")
    dm, dp = _models(1)[2:]
    short = tgen.DecodeEngine(dm, dp, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=short, device="cpu")
    good = tgen.DecodeEngine(dm, dp, max_len=MAXLEN, device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=good, spec_k=0,
                          device="cpu")
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, draft=good,
                            device="cpu")
    with pytest.raises(ValueError, match="one sequence"):
        eng.generate(np.zeros((2, 5), np.int32), 4)
    with pytest.raises(ValueError, match="return_logits"):
        eng.generate(_prompt(5, seed=0), 4, return_logits=True)


@pytest.mark.parametrize("page_tokens", [0, PAGE])
def test_zero_layer_draft_runs_and_matches_jax(page_tokens):
    """An embedding-only draft (no blocks, an empty cache): its proposals
    come from the embeddings alone, and greedy speculative tokens still
    equal plain decode's and the JAX engine's."""
    spec = _engine("torch", page_tokens, draft_layers=0)
    jspec = _engine("jax", page_tokens, draft_layers=0)
    st = spec.new_state(1)
    assert st.draft_cache["k"].shape[0] == 0
    prompt = _prompt(11, seed=3)
    got = spec.generate(prompt, 10)
    np.testing.assert_array_equal(got, _engine("torch", page_tokens)
                                  .generate(prompt, 10))
    np.testing.assert_array_equal(got, np.asarray(jspec.generate(prompt,
                                                                 10)))
    assert spec.spec_stats == jspec.spec_stats


def test_int8_pages_with_spec_decode_match_jax():
    """Both levers together: an int8 target with a 1-layer draft gives the
    JAX engine's tokens (greedy) and stats."""
    _jm, _jp, tm, tp = _models()
    djm, djp, dtm, dtp = _models(1)
    jm, jp = _models()[:2]
    teng = tgen.DecodeEngine(
        tm, tp, max_len=MAXLEN, page_tokens=PAGE, kv_quant=True, spec_k=3,
        draft=tgen.DecodeEngine(dtm, dtp, max_len=MAXLEN, page_tokens=0,
                                device="cpu"), device="cpu")
    jeng = jgen.DecodeEngine(
        jm, jp, max_len=MAXLEN, page_tokens=PAGE, kv_quant=True, spec_k=3,
        draft=jgen.DecodeEngine(djm, djp, max_len=MAXLEN, page_tokens=0))
    prompt = _prompt(14, seed=12)
    np.testing.assert_array_equal(teng.generate(prompt, 12),
                                  np.asarray(jeng.generate(prompt, 12)))
    assert teng.quant_gate["passed"] and teng.spec_stats == jeng.spec_stats
    assert teng.new_state(1).arrays["k"].dtype == torch.int8
