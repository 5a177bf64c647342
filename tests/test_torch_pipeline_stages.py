"""A pipeline-trained model (``pipeline_stages=2``) on one device, the port
against the JAX package at a tiny size (vocab 32, d_model 16, 2 heads, 4
layers).

The JAX model runs its stage-stacked (S, L/S, ...) params with no mesh,
one block after another, as its own tests run it; the port unstacks them
into per-layer blocks (``from_jax_params``) and runs the same order. The
same weights (numpy, through ``init_jax_layout`` or the JAX
``init_params``) and tokens go through both. Tolerances, as the f32 rows
of PERF.md: apply and prefill atol 1e-4 (f32 sums in another order over
4 layers); loss and every grad leaf atol 1e-5; three AdamW train steps,
params and the moments mu and nu atol 1e-5; greedy tokens exact; the
weight round trip bit-exact.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deeplearning4j_tpu.models import generation as jgen
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.parallel.moe import MoEConfig as JMoEConfig
from deeplearning4j_tpu_torch.models import generation as tgen
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (adamw_state_to_numpy,
                                                     from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)
from deeplearning4j_tpu_torch.optim.adamw import adamw
from deeplearning4j_tpu_torch.parallel.moe import MoEConfig

KW = dict(vocab_size=32, n_layers=4, n_heads=2, d_model=16, max_len=48)
STAGES = 2
LR = 3e-4


def _pair(seed=0, **kw):
    tcfg = ttr.TransformerConfig(**KW, pipeline_stages=STAGES, **kw)
    jcfg = jtr.TransformerConfig(**KW, pipeline_stages=STAGES, **kw)
    tree = init_jax_layout(tcfg, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = ttr.TransformerLM(tcfg, device="cpu")
    return jtr.TransformerLM(jcfg), jp, tm, from_jax_params(tree, tcfg, "cpu")


def _batch(b=2, t=20, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(want, got, atol):
    want, got = _paths(want), _paths(got)
    assert set(want) == set(got)
    for path, a in want.items():
        assert got[path].shape == a.shape, path
        np.testing.assert_allclose(got[path], a, atol=atol, err_msg=path)


def test_init_layout_is_the_jax_stage_stacking():
    """init_jax_layout stacks (S, L/S, ...) as the JAX init_params does, and
    the port runs block s·L/S + i as the JAX model's i-th layer of stage s."""
    jm, jp, _tm, tp = _pair()
    ref = jm.init_params(jax.random.key(0))
    assert jax.tree.structure(ref) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(jp)):
        assert a.shape == b.shape
    for a in jax.tree.leaves(jp["blocks"]):
        assert a.shape[:2] == (STAGES, 2)
    assert len(tp["blocks"]) == 4
    np.testing.assert_array_equal(
        tp["blocks"][3]["attn"]["wq"].numpy(),
        np.asarray(jp["blocks"]["attn"]["wq"][1, 1]))


def test_apply_and_prefill_match_jax():
    jm, jp, tm, tp = _pair()
    toks, _ = _batch()
    ref = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(toks)))
    got = tm.apply(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    jl, jkv = jm.prefill(jp, jnp.asarray(toks))
    tl, tkv = tm.prefill(tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name in ("k", "v"):
        assert tkv[name].shape == jkv[name].shape == (4, 2, 20, 2, 8)
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   atol=1e-4)


def test_loss_and_grads_match_jax():
    jm, jp, tm, tp = _pair(seed=2)
    toks, tgts = _batch(seed=3)
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert abs(float(tl) - float(jl)) <= 1e-5
    _assert_trees_close(jg, to_jax_params(tg, tm.config), atol=1e-5)


def test_three_adamw_steps_match_jax():
    jm, jp, tm, tp = _pair(seed=4)
    toks, tgts = _batch(seed=5)
    jstep = jm.make_train_step(optax.adamw(LR))
    tstep = tm.make_train_step(adamw(LR))
    js, ts = optax.adamw(LR).init(jp), adamw(LR).init(tp)
    for i in range(3):
        jp, js, jl = jstep(jp, js, jnp.asarray(toks), jnp.asarray(tgts))
        tp, ts, tl = tstep(tp, ts, torch.from_numpy(toks),
                           torch.from_numpy(tgts))
        assert abs(float(tl) - float(jl)) <= 1e-5, i
    _assert_trees_close(jp, to_jax_params(tp, tm.config), atol=1e-5)
    moments = adamw_state_to_numpy(ts, tm.config)
    assert int(moments["count"]) == int(js[0].count) == 3
    for name in ("mu", "nu"):
        _assert_trees_close(getattr(js[0], name), moments[name], atol=1e-5)


@pytest.mark.parametrize("page_tokens", [0, 16])
def test_greedy_decode_matches_jax_tokens(page_tokens):
    jm, jp, tm, tp = _pair(seed=6)
    prompt = np.random.default_rng(7).integers(
        0, KW["vocab_size"], (1, 13)).astype(np.int32)
    ref = jgen.DecodeEngine(jm, jp, max_len=32,
                            page_tokens=page_tokens).generate(prompt, 8)
    got = tgen.DecodeEngine(tm, tp, max_len=32, page_tokens=page_tokens,
                            device="cpu").generate(prompt, 8)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("fused", [True, False])
def test_weight_round_trip_is_bit_exact(fused):
    """The JAX init_params tree → the port → back: the same tree, leaf for
    leaf, to the bit."""
    cfg = ttr.TransformerConfig(**KW, pipeline_stages=STAGES,
                                fused_qkv=fused)
    jm = jtr.TransformerLM(jtr.TransformerConfig(
        **KW, pipeline_stages=STAGES, fused_qkv=fused))
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(8)))
    back = to_jax_params(from_jax_params(tree, cfg, "cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_trees_that_disagree_with_the_config_raise():
    """A stage-stacked tree loads only into the config of its stages and
    layers, never by broadcasting: one layer a stage included, where a
    plain config would have unstacked (1, ...) leaves."""
    cfg = ttr.TransformerConfig(**KW, pipeline_stages=STAGES)
    tree = init_jax_layout(cfg, 9)
    for other in (dict(pipeline_stages=4), dict(pipeline_stages=0),
                  dict(scan_layers=True)):
        with pytest.raises(ValueError):
            from_jax_params(tree, ttr.TransformerConfig(**dict(KW, **other)),
                            "cpu")
    one_per_stage = dict(KW, n_layers=2)
    tree2 = init_jax_layout(ttr.TransformerConfig(
        **one_per_stage, pipeline_stages=2), 9)
    with pytest.raises(ValueError, match="shapes"):
        from_jax_params(tree2, ttr.TransformerConfig(**one_per_stage), "cpu")
    plain = init_jax_layout(ttr.TransformerConfig(**KW), 9)
    with pytest.raises(ValueError, match="list of blocks"):
        from_jax_params(plain, cfg, "cpu")


@pytest.mark.parametrize("bad,message", [
    (dict(n_layers=3), "n_layers must divide into pipeline_stages"),
    (dict(scan_layers=True), "mutually exclusive"),
    (dict(moe=True), "moe is not supported yet"),
    (dict(pipeline_schedule="x"), "pipeline_schedule must be"),
])
def test_config_raises_where_the_reference_raises(bad, message):
    jkw, tkw = dict(KW, pipeline_stages=STAGES), dict(KW,
                                                       pipeline_stages=STAGES)
    if bad.pop("moe", False):
        jkw["moe"], tkw["moe"] = JMoEConfig(num_experts=2), MoEConfig(
            num_experts=2)
    jkw.update(bad)
    tkw.update(bad)
    with pytest.raises((AssertionError, ValueError), match=message):
        jtr.TransformerConfig(**jkw)
    with pytest.raises(ValueError, match=message):
        ttr.TransformerConfig(**tkw)
    ok = ttr.TransformerConfig(**KW, pipeline_stages=STAGES,
                               pipeline_schedule="1f1b", microbatches=3)
    assert (ok.pipeline_schedule, ok.microbatches) == ("1f1b", 3)
