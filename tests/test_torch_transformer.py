"""The port's TransformerLM against the JAX package's, at a tiny size.

The same weights (the JAX ``init_params`` tree, through numpy and
``from_jax_params``) and the same int32 tokens go through both. Tolerances:
f32 forward atol 1e-4 (f32 sums in another order across 2 layers); the
decode steps atol 2e-4 (the tolerance the JAX package's own decode tests
hold); bf16 atol 5e-2 (both sides round every activation to bf16,
but at different points — the JAX bf16 matmuls and the port's torch CPU
bf16 matmuls round their outputs differently — and logits are ~0.1 in
magnitude at this init, so 5e-2 still fails any real divergence in
structure). JAX is forced onto its flash-kernel path for the bf16 case,
run in Pallas interpret mode.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (from_jax_params,
                                                     init_jax_layout)

KW = dict(vocab_size=97, n_layers=2, n_heads=2, d_model=32, max_len=64)


def _pair(fused=True, scan=False, dtype="float32", seed=0):
    jcfg = jtr.TransformerConfig(**KW, fused_qkv=fused, scan_layers=scan,
                                 dtype=getattr(jnp, dtype))
    jm = jtr.TransformerLM(jcfg)
    jp = jm.init_params(jax.random.key(seed))
    tcfg = ttr.TransformerConfig(**KW, fused_qkv=fused, scan_layers=scan,
                                 dtype=dtype)
    tm = ttr.TransformerLM(tcfg, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("fused,scan", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_from_jax_params_layouts_and_apply(fused, scan):
    jm, jp, tm, tp = _pair(fused, scan)
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 2
    for i, blk in enumerate(tp["blocks"]):
        jblk = (jax.tree.map(lambda a: a[i], jp["blocks"]) if scan
                else jp["blocks"][i])
        for name, w in blk["attn"].items():
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(jblk["attn"][name]))
        assert w.dtype == torch.float32
    toks = _tokens(2, 24)
    ref = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(toks)))
    got = tm.apply(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 97)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_from_jax_params_rejects_mismatched_layout():
    _jm, jp, _tm, _tp = _pair(fused=True)
    tree = jax.tree.map(np.asarray, jp)
    cfg = ttr.TransformerConfig(**KW, fused_qkv=False)
    with pytest.raises(ValueError, match="fused_qkv"):
        from_jax_params(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="n_layers"):
        from_jax_params(tree, ttr.TransformerConfig(
            **dict(KW, n_layers=3), fused_qkv=True), device="cpu")


def test_config_rejects_unported_features_and_takes_dtype_strings():
    """pipeline_stages > 1 (it needs a device mesh) is the one option that
    raises; a MoE config must be the port's own."""
    assert ttr.TransformerConfig(dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.TransformerConfig(pipeline_stages=2)
    with pytest.raises(TypeError, match="MoEConfig"):
        ttr.TransformerConfig(moe=object())
    assert ttr.TransformerConfig(ce_chunks=4).ce_chunks == 4


def test_init_params_layout_matches_numpy_tree():
    cfg = ttr.TransformerConfig(**KW, fused_qkv=True)
    p = ttr.TransformerLM(cfg, device="cpu").init_params(seed=5)
    tree = init_jax_layout(cfg, seed=5)
    np.testing.assert_array_equal(p["tok_emb"].numpy(), tree["tok_emb"])
    np.testing.assert_array_equal(p["blocks"][1]["mlp"]["w_down"].numpy(),
                                  tree["blocks"][1]["mlp"]["w_down"])


@pytest.mark.parametrize("fused", [True, False])
def test_prefill_logits_and_kv_match_jax_f32(fused):
    jm, jp, tm, tp = _pair(fused)
    toks = _tokens(2, 20, seed=1)
    jl, jkv = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    tl, tkv = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        assert tkv[name].shape == (2, 2, 20, 2, 16)
        np.testing.assert_allclose(tkv[name].numpy(),
                                   np.asarray(jkv[name]), atol=1e-4)


def test_bf16_apply_and_prefill_match_jax_flash_path():
    jm, jp, tm, tp = _pair(dtype="bfloat16")
    toks = _tokens(1, 40, seed=2)
    try:
        jtr.FLASH_ATTENTION = True
        # JAX prefill runs the same trunk as apply and also returns k/v
        jl, jkv = jax.jit(jm.prefill)(jp, jnp.asarray(toks))
    finally:
        jtr.FLASH_ATTENTION = None
    got = tm.apply(tp, torch.from_numpy(toks))
    tl, tkv = tm.prefill(tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tkv["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), atol=5e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2)
    np.testing.assert_allclose(tkv["v"].float().numpy(),
                               np.asarray(jkv["v"].astype(jnp.float32)),
                               atol=5e-2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32) * np.float32(0.5)


def test_decode_step_math_matches_jax():
    jm, jp, tm, tp = _pair()
    S = 32
    cache = {n: _rand((2, 2, S, 2, 16), seed=i)
             for i, n in enumerate(("k", "v"))}
    toks = np.array([3, 50], np.int32)
    pos = np.array([5, 31], np.int32)
    jl, jc = jax.jit(jm.decode_step_math)(
        jp, {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(toks), jnp.asarray(pos))
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tl, tc2 = tm.decode_step_math(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
    assert tc2 is tc                        # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=2e-4)


def test_decode_window_math_matches_jax():
    """W = 3 windows, one of them running past the cache end (its tail
    row is dropped on both sides)."""
    jm, jp, tm, tp = _pair(fused=False)
    S = 32
    cache = {n: _rand((2, 2, S, 2, 16), seed=10 + i)
             for i, n in enumerate(("k", "v"))}
    toks = _tokens(2, 3, seed=4)
    pos = np.array([4, 30], np.int32)
    jl, jc = jax.jit(jm.decode_window_math)(
        jp, {n: jnp.asarray(a) for n, a in cache.items()},
        jnp.asarray(toks), jnp.asarray(pos))
    tc = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    tl, _ = tm.decode_window_math(tp, tc, torch.from_numpy(toks),
                                  torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=2e-4)


def test_decode_window_paged_matches_jax_including_trash_page():
    """Page table with pages scattered over the pool; slot 1's window
    runs past its last logical page, so its tail row goes to the trash
    page (the last physical page). Logits and every non-trash page must
    match."""
    jm, jp, tm, tp = _pair()
    P, pps, n_pages = 8, 4, 9                 # 8 real pages + trash
    pool = {n: _rand((2, n_pages, P, 2, 16), seed=20 + i)
            for i, n in enumerate(("k", "v"))}
    tables = np.array([[7, 2, 5, 0], [1, 6, 3, 4]], np.int32)
    toks = _tokens(2, 3, seed=6)
    pos = np.array([9, 30], np.int32)         # slot 1: 30, 31, 32 (> S)
    jl, jpool = jax.jit(jm.decode_window_paged, static_argnums=5)(
        jp, {n: jnp.asarray(a) for n, a in pool.items()},
        jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos), P)
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tl, _ = tm.decode_window_paged(tp, tpool, torch.from_numpy(tables),
                                   torch.from_numpy(toks),
                                   torch.from_numpy(pos), P)
    assert tl.shape == (2, 3, 97)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n][:, :-1].numpy(),
                                   np.asarray(jpool[n])[:, :-1], atol=2e-4)
        # the out-of-range row landed in the trash page, not a real one
        assert not np.allclose(tpool[n][:, -1].numpy(), pool[n][:, -1])


@pytest.mark.parametrize("fused", [True, False])
def test_attn_hands_the_kernel_views_without_copies(monkeypatch, fused):
    """``_attn`` passes the flash wrapper (B, H, T, hd) views of the QKV
    projection (not contiguous, q/k/v of one storage when fused) and an
    ``out`` that is the (B, H, T, hd) view of a contiguous (B, T, H, hd)
    buffer, which it then reads as (B, T, C) — so the port still matches
    JAX to f32 atol 1e-4 with nothing copied around the kernel."""
    jm, jp, tm, tp = _pair(fused)
    seen = []
    real = fa.flash_attention_fwd

    def spy(q, k, v, causal=False, scale=None, out=None):
        seen.append((q, k, v, out))
        return real(q, k, v, causal, scale, out=out)

    monkeypatch.setattr(fa, "flash_attention_fwd", spy)
    toks = _tokens(2, 24, seed=3)
    got = tm.apply(tp, torch.from_numpy(toks))
    assert len(seen) == KW["n_layers"]
    hd = KW["d_model"] // KW["n_heads"]
    for q, k, v, out in seen:
        for x in (q, k, v, out):
            assert x.shape == (2, KW["n_heads"], 24, hd)
            assert not x.is_contiguous() and x.stride(-1) == 1
        storages = {x.untyped_storage().data_ptr() for x in (q, k, v)}
        assert len(storages) == (1 if fused else 3)
        if fused:   # q, k, v are the three column blocks of x @ wqkv
            assert k.data_ptr() - q.data_ptr() == KW["d_model"] * 4
            assert v.data_ptr() - k.data_ptr() == KW["d_model"] * 4
        buf = out.transpose(1, 2)
        assert buf.is_contiguous() and buf.data_ptr() == out.data_ptr()
        assert out.untyped_storage().nbytes() == buf.numel() * 4
    ref = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
