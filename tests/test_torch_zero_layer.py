"""A zero-layer ``TransformerLM`` (embedding, final LayerNorm and the tied
head: the JAX package's embedding-only speculative draft) in the port
against the JAX package, on the CPU in f32.

``prefill`` returns the logits and an empty (0, B, T, H, hd) cache in the
compute dtype, as the reference does (``models/transformer.py``
``prefill``); ``DecodeEngine`` prefills, warms and generates on it, dense
and paged. Logits atol 1e-4 (f32 sums in another order); greedy tokens
exact.
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

KW = dict(vocab_size=32, n_layers=0, n_heads=2, d_model=16, max_len=32)
MAXLEN = 24
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


@pytest.mark.parametrize("b,t", [(1, 4), (2, 7)])
def test_zero_layer_prefill_matches_jax(b, t):
    jm, jp, tm, tp = _models()
    tokens = np.random.default_rng(t).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)
    j_logits, j_kv = jm.prefill(jp, tokens)
    logits, kv = tm.prefill(tp, torch.as_tensor(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=0)
    hd = KW["d_model"] // KW["n_heads"]
    for name in ("k", "v"):
        assert tuple(kv[name].shape) == tuple(j_kv[name].shape) == (
            0, b, t, KW["n_heads"], hd)
        assert kv[name].dtype == tm.config.dtype == torch.float32
        assert str(j_kv[name].dtype) == "float32"


@pytest.mark.parametrize("page_tokens", [0, 8])
@pytest.mark.parametrize("b,n", [(1, 5), (2, 9)])
def test_zero_layer_generate_matches_jax_tokens(page_tokens, b, n):
    """Greedy generation from the zero-layer model, dense and paged: the
    engine warms (a prefill and insert per bucket, a decode step), then
    generates the JAX engine's tokens exactly."""
    jm, jp, tm, tp = _models()
    prompt = np.random.default_rng(n).integers(
        0, KW["vocab_size"], (b, n)).astype(np.int32)
    ref = jgen.DecodeEngine(jm, jp, max_len=MAXLEN,
                            page_tokens=page_tokens).generate(prompt, 6)
    eng = tgen.DecodeEngine(tm, tp, max_len=MAXLEN, page_tokens=page_tokens,
                            device="cpu")
    assert eng.warm(b) == list(eng.prefill_buckets)
    first, logits, kv, t = eng.prefill(prompt)
    assert t == n and kv["k"].shape[0] == 0
    got = eng.generate(prompt, 6)
    assert got.dtype == np.int32 and got.shape == (b, 6)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got[:, 0], first.numpy())
