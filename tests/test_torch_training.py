"""The port's training path against the JAX package's, at a tiny size.

The same weights (numpy, through ``init_jax_layout`` / ``from_jax_params``),
tokens and targets go through ``TransformerLM.loss_fn`` and its gradient on
both sides, through the AdamW update, and through whole train steps.
Tolerances (PERF.md states them):

- f32 loss atol 1e-5 and each grad leaf atol 1e-5: the same arithmetic,
  f32 sums in another order (the grads are O(1e-2) at this init);
- bf16, JAX forced onto its flash path (Pallas interpret mode and
  ``_bwd_blockwise``): loss atol 2e-2, and each grad leaf's relative L2
  error <= 5e-2 — both sides round every activation and every gradient
  product to bf16, but at different points;
- ``adamw`` vs ``optax.adamw`` fed identical grads: mu, nu and params atol
  1e-6 over 3 updates;
- 3 train steps at f32: losses atol 1e-5; params within lr of each other
  per step, since Adam turns reduction-order noise on near-zero grads into
  moves of up to lr.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models.weights import (adamw_state_from_numpy,
                                                     adamw_state_to_numpy,
                                                     from_jax_params,
                                                     init_jax_layout,
                                                     to_jax_params)
from deeplearning4j_tpu_torch.optim.adamw import adamw, apply_updates
from deeplearning4j_tpu_torch.tree import tree_leaves, tree_unflatten

KW = dict(vocab_size=61, n_layers=2, n_heads=2, d_model=32, max_len=32)
LR = 3e-4


def _pair(fused=True, dtype="float32", scan=False, seed=0):
    tcfg = ttr.TransformerConfig(**KW, fused_qkv=fused, dtype=dtype,
                                 scan_layers=scan)
    jcfg = jtr.TransformerConfig(**KW, fused_qkv=fused, scan_layers=scan,
                                 dtype=getattr(jnp, dtype))
    tree = init_jax_layout(tcfg, seed)
    jp = jax.tree.map(jnp.asarray, tree)
    tm = ttr.TransformerLM(tcfg, device="cpu")
    return jtr.TransformerLM(jcfg), jp, tm, from_jax_params(tree, tcfg, "cpu")


def _batch(b=2, t=24, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, KW["vocab_size"], (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _flat(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _pairs_of_leaves(jtree, ttree, cfg):
    """(path, JAX leaf, port leaf) in the JAX layout."""
    mine = dict((jax.tree_util.keystr(p), a)
                for p, a in _flat(to_jax_params(ttree, cfg)))
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float32),
             mine[jax.tree_util.keystr(p)]) for p, a in _flat(jtree)]


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_grads_match_jax_f32(fused):
    jm, jp, tm, tp = _pair(fused)
    toks, tgts = _batch()
    jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, jnp.asarray(toks), jnp.asarray(tgts))
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert tl.shape == () and not tl.requires_grad
    assert abs(float(tl) - float(jl)) <= 1e-5
    for path, j, t in _pairs_of_leaves(jg, tg, tm.config):
        np.testing.assert_allclose(t, j, atol=1e-5, err_msg=path)
    # the params were left as they were
    assert not any(a.requires_grad for a in tree_leaves(tp))


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_grads_match_jax_flash_path_bf16(fused):
    jm, jp, tm, tp = _pair(fused, dtype="bfloat16")
    toks, tgts = _batch(seed=2)
    try:
        jtr.FLASH_ATTENTION = True
        jl, jg = jax.jit(jax.value_and_grad(jm.loss_fn))(
            jp, jnp.asarray(toks), jnp.asarray(tgts))
    finally:
        jtr.FLASH_ATTENTION = None
    tl, tg = tm.loss_and_grads(tp, torch.from_numpy(toks),
                               torch.from_numpy(tgts))
    assert abs(float(tl) - float(jl)) <= 2e-2
    for path, j, t in _pairs_of_leaves(jg, tg, tm.config):
        assert t.dtype == np.float32
        rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-30)
        assert rel <= 5e-2, (path, rel)


def test_loss_with_aux_has_the_jax_keys():
    jm, jp, tm, tp = _pair()
    toks, tgts = _batch()
    (jl, jaux), _ = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), None, True)
    (tl, taux), _ = tm.loss_and_grads(tp, torch.from_numpy(toks),
                                      torch.from_numpy(tgts), with_aux=True)
    assert set(taux) == set(jaux)
    assert abs(float(taux["lm_loss"]) - float(jaux["lm_loss"])) <= 1e-5
    assert float(taux["moe_aux_loss"]) == 0.0
    assert taux["moe_expert_fraction"].shape == (0,)


def test_adamw_matches_optax_for_three_updates():
    cfg = ttr.TransformerConfig(**KW, fused_qkv=True)
    tree = init_jax_layout(cfg, 3)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = from_jax_params(tree, cfg, "cpu")
    opt_j, opt_t = optax.adamw(LR), adamw(LR)
    sj, st = opt_j.init(jp), opt_t.init(tp)
    rng = np.random.default_rng(4)
    for i in range(3):
        g = jax.tree.map(
            lambda a: rng.standard_normal(a.shape, dtype=np.float32)
            * np.float32(10.0 ** -(i + 1)), tree)
        uj, sj = opt_j.update(jax.tree.map(jnp.asarray, g), sj, jp)
        jp = optax.apply_updates(jp, uj)
        ut, st = opt_t.update(from_jax_params(g, cfg, "cpu"), st, tp)
        tp = apply_updates(tp, ut)
    assert st.count == 3 and int(sj[0].count) == 3
    got = adamw_state_to_numpy(st, cfg)
    for name in ("mu", "nu"):
        for (_p, a), (_q, b) in zip(_flat(getattr(sj[0], name)),
                                    _flat(got[name])):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6)
    for path, j, t in _pairs_of_leaves(jp, tp, cfg):
        np.testing.assert_allclose(t, j, atol=1e-6, err_msg=path)


def test_adamw_defaults_are_optax_s():
    opt = adamw(1e-3)
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay) == (0.9, 0.999, 1e-8,
                                                           1e-4)


def test_adamw_decays_every_leaf_without_a_mask():
    """A zero grad still moves every leaf by −lr·wd·p, LN gains and
    biases included."""
    p = {"g": torch.ones(3), "b": torch.full((2,), 2.0)}
    opt = adamw(0.1, weight_decay=0.5)
    upd, _ = opt.update({"g": torch.zeros(3), "b": torch.zeros(2)},
                        opt.init(p), p)
    np.testing.assert_allclose(upd["g"].numpy(), -0.05, rtol=1e-6)
    np.testing.assert_allclose(upd["b"].numpy(), -0.1, rtol=1e-6)


@pytest.mark.parametrize("return_metrics", [False, True])
def test_three_train_steps_match_jax_step_f32(return_metrics):
    jm, jp, tm, tp = _pair()
    toks, tgts = _batch(seed=5)
    jstep = jm.make_train_step(optax.adamw(LR), return_metrics)
    tstep = tm.make_train_step(adamw(LR), return_metrics)
    js = optax.adamw(LR).init(jp)
    ts = adamw(LR).init(tp)
    t_toks, t_tgts = torch.from_numpy(toks), torch.from_numpy(tgts)
    leaves_before = tree_leaves(tp)
    for i in range(3):
        jp, js, jout = jstep(jp, js, jnp.asarray(toks), jnp.asarray(tgts))
        tp2, ts, tout = tstep(tp, ts, t_toks, t_tgts)
        assert tp2 is tp                        # updated in place
        jl = float(jout["loss"] if return_metrics else jout)
        tl = float(tout["loss"] if return_metrics else tout)
        assert abs(tl - jl) <= 1e-5, (i, tl, jl)
        for path, j, t in _pairs_of_leaves(jp, tp, tm.config):
            assert np.abs(t - j).max() <= LR * (i + 1), path
    assert all(a is b for a, b in zip(tree_leaves(tp), leaves_before))
    assert ts.count == 3


@pytest.mark.parametrize("fused,scan", [(True, False), (False, False),
                                        (True, True), (False, True)])
def test_to_jax_params_round_trip(fused, scan):
    cfg = ttr.TransformerConfig(**KW, fused_qkv=fused, scan_layers=scan)
    tree = init_jax_layout(cfg, 6)
    back = to_jax_params(from_jax_params(tree, cfg, "cpu"), cfg)
    flat_a, def_a = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_from_jax_params_copies_so_training_leaves_the_tree_alone():
    """The train step updates params in place; on the CPU the params must
    not share memory with the numpy tree they came from."""
    cfg = ttr.TransformerConfig(**KW, fused_qkv=True)
    tree = init_jax_layout(cfg, 9)
    before = jax.tree.map(np.copy, tree)
    tm = ttr.TransformerLM(cfg, device="cpu")
    tp = from_jax_params(tree, cfg, "cpu")
    step = tm.make_train_step(adamw(LR))
    toks, tgts = (torch.from_numpy(a) for a in _batch())
    step(tp, adamw(LR).init(tp), toks, tgts)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)


def test_to_jax_params_loads_into_the_jax_model():
    """Params carried back from the port drive the JAX model's apply."""
    jm, _jp, tm, tp = _pair(scan=True)
    toks, _ = _batch()
    back = jax.tree.map(jnp.asarray, to_jax_params(tp, tm.config))
    ref = np.asarray(jm.apply(back, jnp.asarray(toks)))
    np.testing.assert_allclose(tm.apply(tp, torch.from_numpy(toks)).numpy(),
                               ref, atol=1e-4)


def test_adamw_state_round_trip():
    cfg = ttr.TransformerConfig(**KW, scan_layers=True)
    tp = from_jax_params(init_jax_layout(cfg, 7), cfg, "cpu")
    opt = adamw(LR)
    st = opt.init(tp)
    g = tree_unflatten(tp, [torch.full_like(a, 0.5)
                                for a in tree_leaves(tp)])
    _u, st = opt.update(g, st, tp)
    back = adamw_state_from_numpy(adamw_state_to_numpy(st, cfg), cfg, "cpu")
    assert back.count == 1
    for a, b in zip(tree_leaves(st.nu), tree_leaves(back.nu)):
        assert torch.equal(a, b)


def test_unported_training_options_raise():
    """Every single-device option trains now; only pipeline_stages > 1,
    which needs a device mesh, still raises."""
    tm = ttr.TransformerLM(ttr.TransformerConfig(**KW, dropout=0.1),
                           device="cpu")
    tp = tm.init_params(0)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with_rng = tm.loss_fn(tp, toks, toks, rng=0)
    no_rng = tm.loss_fn(tp, toks, toks)     # no rng: no dropout, as in JAX
    assert bool(torch.isfinite(with_rng)) and float(with_rng) != float(no_rng)
    from deeplearning4j_tpu_torch.parallel.moe import MoEConfig
    for ok in (dict(remat=True), dict(remat=True, remat_policy="dots"),
               dict(ce_chunks=61), dict(moe=MoEConfig(num_experts=2))):
        ttr.TransformerConfig(**KW, **ok)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.TransformerConfig(**KW, pipeline_stages=2)
